"""Schema validation.

Behavioral twin of bullet-js src/bullet-validation.js: named schemas
with normalization (:71-101), path→schema binding with ancestor fallback
(:159-208), nested-property validation for sub-path puts (:218-248), the
type/constraint/format checks (:333-534), typed errors with ``is_fatal``
(:545-553) and per-type + "all" error handlers (:592-604).

Unlike the reference — whose write hook is dead code (SURVEY quirk Q1) —
``check_write`` is actually called from the Bullet write path.

The port's own copy of ``bullet_tpu/db/validation.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional
from urllib.parse import urlparse

_EMAIL_RE = re.compile(r"^[^\s@]+@[^\s@]+\.[^\s@]+$")
_UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[1-5][0-9a-f]{3}-[89ab][0-9a-f]{3}-[0-9a-f]{12}$", re.I
)
_IPV4_RE = re.compile(r"^(\d{1,3}\.){3}\d{1,3}$")
_IPV6_RE = re.compile(r"^[0-9a-fA-F:.%]+$")
_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}([T ].*)?$")


class ValidationError(Exception):
    def __init__(self, error_type: str, message: str, is_fatal: bool, original=None):
        super().__init__(message)
        self.is_validation_error = True
        self.type = error_type
        self.is_fatal = is_fatal
        self.original_error = original


class BulletValidation:
    def __init__(self, bullet) -> None:
        self.bullet = bullet
        self.schemas: Dict[str, dict] = {}
        self.path_schemas: Dict[str, str] = {}
        self.error_handlers: Dict[str, List] = {
            "validation": [],
            "type": [],
            "required": [],
            "format": [],
            "custom": [],
            "all": [],
        }

    # ------------------------------------------------------------ definitions

    def define_schema(self, name: str, schema: dict) -> "BulletValidation":
        if not isinstance(schema, dict):
            raise TypeError("Schema must be an object")
        self.schemas[name] = self._normalize_schema(schema)
        return self

    def _normalize_schema(self, schema: dict) -> dict:
        """Schema normalization (bullet-validation.js:71-101)."""
        normalized = {
            "type": schema.get("type", "object"),
            "properties": {},
            "required": list(schema.get("required", ())),
            "additionalProperties": schema.get("additionalProperties") is not False,
            "validators": list(schema.get("validators", ())),
        }
        for prop, prop_schema in (schema.get("properties") or {}).items():
            if prop_schema.get("type") == "object" and prop_schema.get("properties"):
                normalized["properties"][prop] = self._normalize_schema(prop_schema)
            else:
                normalized["properties"][prop] = {
                    "type": prop_schema.get("type", "any"),
                    "required": bool(prop_schema.get("required", False)),
                    "default": prop_schema.get("default"),
                    "has_default": "default" in prop_schema,
                    "validators": list(prop_schema.get("validators", ())),
                    "format": prop_schema.get("format"),
                    "enum": prop_schema.get("enum"),
                    "min": prop_schema.get("min"),
                    "max": prop_schema.get("max"),
                    "pattern": re.compile(prop_schema["pattern"])
                    if prop_schema.get("pattern")
                    else None,
                }
        return normalized

    def apply_schema(self, path: str, schema_name: str) -> "BulletValidation":
        if schema_name not in self.schemas:
            raise KeyError(f"Schema '{schema_name}' does not exist")
        self.path_schemas[path] = schema_name
        return self

    def remove_schema(self, path: str) -> "BulletValidation":
        self.path_schemas.pop(path, None)
        return self

    # -------------------------------------------------------------- validation

    def validate(self, schema_name: str, data: Any) -> bool:
        """Explicit validation; raises ValidationError on failure
        (bullet-validation.js:142-150)."""
        schema = self.schemas.get(schema_name)
        if schema is None:
            raise KeyError(f"Schema '{schema_name}' does not exist")
        return self._validate_against_schema(schema, data, schema_name)

    def check_write(self, path: str, data: Any, report: bool = True) -> bool:
        """Write-path gate (the repaired version of the reference's dead
        ``_setData`` hook, bullet-validation.js:25-45): invalid writes are
        blocked and error handlers fire. ``None`` always passes — deletes are
        null puts (bullet.js:755-758) and must work on schema-bound paths.
        ``report=False`` checks silently (used where another stage owns the
        typed-error reporting for the same row)."""
        if data is None:
            return True
        return self._validate_data_for_path(path, data, report)

    def _validate_data_for_path(
        self, path: str, data: Any, report: bool = True
    ) -> bool:
        """Find the governing schema via ancestor walk and validate
        (bullet-validation.js:159-208)."""
        schema_path = schema_name = None
        if path in self.path_schemas:
            schema_path, schema_name = path, self.path_schemas[path]
        else:
            parts = [p for p in path.split("/") if p]
            while parts:
                parent = "/".join(parts)
                if parent in self.path_schemas:
                    schema_path, schema_name = parent, self.path_schemas[parent]
                    break
                parts.pop()

        if not schema_path or not schema_name:
            return True
        schema = self.schemas.get(schema_name)
        if schema is None:
            return True

        try:
            if path != schema_path:
                rel = path[len(schema_path) + 1 :]
                prop_path = [p for p in rel.split("/") if p]
                if prop_path:
                    # Collection semantics (the documented intent of
                    # examples/bullet-validation-example.js:103-104 +
                    # docs/validation.md, which the reference's dead hook never
                    # exercised): a first segment that is NOT a schema property
                    # is a member id — the member object validates against the
                    # whole schema, deeper segments against its properties.
                    # additionalProperties governs the member's *contents*,
                    # not the member ids (else strict collection schemas
                    # would reject every member write).
                    if prop_path[0] not in schema["properties"]:
                        member_rest = prop_path[1:]
                        if not member_rest:
                            return self._validate_against_schema(
                                schema, data, schema_name
                            )
                        return self._validate_nested_property(
                            schema, member_rest, data
                        )
                    return self._validate_nested_property(schema, prop_path, data)
            return self._validate_against_schema(schema, data, schema_name)
        except ValidationError as error:
            if report:
                self._handle_error(error)
            return False

    def _validate_nested_property(self, schema: dict, prop_path: List[str], data: Any) -> bool:
        """Sub-path put validation (bullet-validation.js:218-248)."""
        prop, rest = prop_path[0], prop_path[1:]
        prop_schema = schema["properties"].get(prop)
        if prop_schema is None:
            if not schema["additionalProperties"]:
                raise ValidationError(
                    "validation",
                    f"Property '{prop}' is not defined in the schema and "
                    "additionalProperties is false",
                    False,
                )
            return True
        if rest:
            if prop_schema.get("type") != "object":
                raise ValidationError(
                    "type",
                    f"Expected '{prop}' to be an object but it's defined as "
                    f"'{prop_schema.get('type')}'",
                    False,
                )
            return self._validate_nested_property(prop_schema, rest, data)
        return self._validate_value(prop_schema, data, prop)

    def _validate_against_schema(self, schema: dict, data: Any, schema_name: str) -> bool:
        """Whole-object validation (bullet-validation.js:259-323)."""
        if schema.get("type") and not self._check_type(data, schema["type"]):
            raise ValidationError(
                "type",
                f"Expected {schema_name} to be {schema['type']} but got "
                f"{_js_typeof(data)}",
                False,
            )
        if not isinstance(data, dict):
            return True
        for required in schema["required"]:
            if required not in data:
                raise ValidationError(
                    "required", f"Missing required property: {required}", True
                )
        for prop, value in data.items():
            if prop in schema["properties"]:
                if not self._validate_value(schema["properties"][prop], value, prop):
                    return False
            elif not schema["additionalProperties"]:
                raise ValidationError("validation", f"Unknown property: {prop}", False)
        for validator in schema["validators"]:
            self._run_custom(validator, data, schema_name)
        return True

    def _validate_value(self, prop_schema: dict, value: Any, prop: str) -> bool:
        """Single-property validation (bullet-validation.js:333-463)."""
        if value is None and prop_schema.get("has_default"):
            return True
        if prop_schema.get("required") and value is None:
            raise ValidationError("required", f"Property {prop} is required", True)
        if value is None:
            return True
        ptype = prop_schema.get("type")
        if ptype and not self._check_type(value, ptype):
            raise ValidationError(
                "type",
                f"Expected {prop} to be {ptype} but got {_js_typeof(value)}",
                False,
            )
        enum = prop_schema.get("enum")
        if isinstance(enum, list) and value not in enum:
            raise ValidationError(
                "validation",
                f"Value of {prop} must be one of [{', '.join(map(str, enum))}]",
                False,
            )
        pmin, pmax = prop_schema.get("min"), prop_schema.get("max")
        if ptype in ("number", "integer"):
            if isinstance(pmin, (int, float)) and value < pmin:
                raise ValidationError(
                    "validation", f"Value of {prop} must be at least {pmin}", False
                )
            if isinstance(pmax, (int, float)) and value > pmax:
                raise ValidationError(
                    "validation", f"Value of {prop} must be at most {pmax}", False
                )
        if ptype == "string" and prop_schema.get("pattern"):
            if not prop_schema["pattern"].search(value):
                raise ValidationError(
                    "format", f"Value of {prop} does not match required pattern", False
                )
        if ptype == "string" and prop_schema.get("format"):
            if not self._check_format(value, prop_schema["format"]):
                raise ValidationError(
                    "format",
                    f"Value of {prop} does not match format {prop_schema['format']}",
                    False,
                )
        if ptype in ("string", "array"):
            if isinstance(pmin, (int, float)) and len(value) < pmin:
                raise ValidationError(
                    "validation", f"Length of {prop} must be at least {pmin}", False
                )
            if isinstance(pmax, (int, float)) and len(value) > pmax:
                raise ValidationError(
                    "validation", f"Length of {prop} must be at most {pmax}", False
                )
        if ptype == "object" and isinstance(value, dict) and "properties" in prop_schema:
            return self._validate_against_schema(prop_schema, value, prop)
        for validator in prop_schema.get("validators", ()):
            self._run_custom(validator, value, prop)
        return True

    def _run_custom(self, validator, value, name: str) -> None:
        """Custom validators (bullet-validation.js:298-320, 438-460)."""
        try:
            is_valid = validator(value)
        except ValidationError:
            raise
        except Exception as error:  # noqa: BLE001
            raise ValidationError(
                "custom", f"Custom validator error for {name}: {error}", False, error
            )
        if not is_valid:
            raise ValidationError("custom", f"Custom validation failed for {name}", False)

    # ------------------------------------------------------------------ checks

    @staticmethod
    def _check_type(value: Any, type_name: str) -> bool:
        """JS typeof-based type checks (bullet-validation.js:472-497)."""
        if type_name == "string":
            return isinstance(value, str)
        if type_name == "number":
            return (
                isinstance(value, (int, float))
                and not isinstance(value, bool)
                and not (isinstance(value, float) and math.isnan(value))
            )
        if type_name == "integer":
            return (
                isinstance(value, (int, float))
                and not isinstance(value, bool)
                and float(value).is_integer()
            )
        if type_name == "boolean":
            return isinstance(value, bool)
        if type_name == "array":
            return isinstance(value, list)
        if type_name == "object":
            return isinstance(value, dict)
        if type_name == "null":
            return value is None
        if type_name == "any":
            return True
        return False

    @staticmethod
    def _check_format(value: str, fmt: str) -> bool:
        """String formats (bullet-validation.js:506-534)."""
        if fmt == "email":
            return bool(_EMAIL_RE.search(value))
        if fmt == "url":
            try:
                parsed = urlparse(value)
                return bool(parsed.scheme and (parsed.netloc or parsed.path))
            except ValueError:
                return False
        if fmt in ("date", "date-time"):
            return bool(_DATE_RE.search(value))
        if fmt == "uuid":
            return bool(_UUID_RE.search(value))
        if fmt == "ipv4":
            return bool(_IPV4_RE.search(value))
        if fmt == "ipv6":
            return bool(_IPV6_RE.search(value)) and ":" in value
        return True

    # ------------------------------------------------------------------ errors

    def _handle_error(self, error: ValidationError) -> None:
        """Dispatch to per-type then "all" handlers (bullet-validation.js:560-583)."""
        if not getattr(error, "is_validation_error", False):
            return
        for handler in self.error_handlers.get(error.type, ()):
            try:
                handler(error)
            except Exception:  # noqa: BLE001
                pass
        for handler in self.error_handlers["all"]:
            try:
                handler(error)
            except Exception:  # noqa: BLE001
                pass

    def on_error(self, error_type: str, handler) -> "BulletValidation":
        if not callable(handler):
            raise TypeError("Error handler must be a function")
        self.error_handlers.setdefault(error_type, []).append(handler)
        return self

    defineSchema = define_schema
    applySchema = apply_schema
    removeSchema = remove_schema
    onError = on_error


def _js_typeof(value: Any) -> str:
    if value is None:
        return "object"  # typeof null === "object"
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, (int, float)):
        return "number"
    if isinstance(value, str):
        return "string"
    return "object"
