"""Serialization: JSON / CSV / XML import-export with custom-type registry.

Behavioral twin of bullet-js src/bullet-serializer.js: the JSON envelope
``{data, metadata, path, format: "bullet-json", version: "1.0"}`` (:123-129),
``__type``-tagged custom types with defaults for Date/RegExp/Set/Map/bytes
(:22-78), a maxDepth guard (:705-732), quote-aware CSV with type coercion
(:197-442), and the same XML element shapes (:451-640). XML import uses the
stdlib parser — an upgrade over the reference, whose XML import requires a
browser DOMParser (:549-557).

The port's own copy of ``bullet_tpu/db/serializer.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import json
import math
import re
from datetime import datetime, timezone
from typing import Any, Callable, Dict, Optional
from xml.etree import ElementTree

from ..utils.jsvalues import _string_to_number, js_parse_float, js_parse_int, to_string


class BulletSerializer:
    def __init__(self, bullet) -> None:
        self.bullet = bullet
        self.options = {
            "pretty_print": False,
            "include_metadata": True,
            "max_depth": float("inf"),
        }
        self.type_serializers: Dict[str, Callable] = {}
        self.type_deserializers: Dict[str, Callable] = {}
        self.python_types: Dict[type, str] = {}
        self._register_default_serializers()

    # --------------------------------------------------------- type registry

    def _register_default_serializers(self) -> None:
        """Defaults mirroring bullet-serializer.js:22-78."""
        self.register_type(
            "Date",
            lambda v: {
                "__type": "Date",
                "value": v.astimezone(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]
                + "Z"
                if v.tzinfo
                else v.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z",
            },
            lambda d: _parse_iso(d["value"]),
            python_type=datetime,
        )
        self.register_type(
            "RegExp",
            lambda v: {"__type": "RegExp", "source": v.pattern, "flags": _js_flags(v)},
            lambda d: re.compile(d["source"], _py_flags(d.get("flags", ""))),
            python_type=re.Pattern,
        )
        self.register_type(
            "Set",
            lambda v: {"__type": "Set", "value": sorted(v, key=repr)},
            lambda d: set(d["value"]),
            python_type=set,
        )
        self.register_type(
            "Map",
            lambda v: {"__type": "Map", "value": [[k, x] for k, x in v.items()]},
            lambda d: dict((k, x) for k, x in d["value"]),
        )
        self.register_type(
            "Buffer",
            lambda v: {
                "__type": "Buffer",
                "value": base64.b64encode(bytes(v)).decode("ascii"),
            },
            lambda d: base64.b64decode(d["value"]),
            python_type=bytes,
        )
        self.register_type(
            "ArrayBuffer",
            lambda v: {
                "__type": "ArrayBuffer",
                "value": base64.b64encode(bytes(v)).decode("ascii"),
            },
            lambda d: bytearray(base64.b64decode(d["value"])),
            python_type=bytearray,
        )

    def register_type(
        self,
        type_name: str,
        serializer: Callable,
        deserializer: Callable,
        python_type: Optional[type] = None,
    ) -> "BulletSerializer":
        self.type_serializers[type_name] = serializer
        self.type_deserializers[type_name] = deserializer
        if python_type is not None:
            self.python_types[python_type] = type_name
        return self

    def configure(self, options: dict) -> "BulletSerializer":
        for k, v in options.items():
            self.options[_snake(k)] = v
        return self

    def _merged_options(self, options: Optional[dict]) -> dict:
        out = dict(self.options)
        for k, v in (options or {}).items():
            out[_snake(k)] = v
        return out

    # ------------------------------------------------------------------ JSON

    def _encode_value(self, value: Any, depth: int, max_depth) -> Any:
        """Apply custom type serializers recursively with a depth guard
        (the reference's JSON replacer, bullet-serializer.js:705-732)."""
        if depth > max_depth:
            return "[max depth reached]"
        for ptype, name in self.python_types.items():
            if isinstance(value, ptype):
                return self.type_serializers[name](value)
        if isinstance(value, dict):
            return {
                k: self._encode_value(v, depth + 1, max_depth) for k, v in value.items()
            }
        if isinstance(value, (list, tuple)):
            return [self._encode_value(v, depth + 1, max_depth) for v in value]
        return value

    def _decode_value(self, value: Any) -> Any:
        """Revive ``__type``-tagged values (bullet-serializer.js:741-749)."""
        if isinstance(value, dict):
            decoded = {k: self._decode_value(v) for k, v in value.items()}
            tag = decoded.get("__type")
            if tag and tag in self.type_deserializers:
                return self.type_deserializers[tag](decoded)
            return decoded
        if isinstance(value, list):
            return [self._decode_value(v) for v in value]
        return value

    def export_to_json(self, path: str = "", options: Optional[dict] = None) -> str:
        opts = self._merged_options(options)
        data = self.bullet._get_data(path)
        metadata = self._metadata_for_path(path) if opts["include_metadata"] else None
        export_obj = {
            "data": self._encode_value(data, 0, opts["max_depth"]),
            "metadata": metadata,
            "path": path,
            "format": "bullet-json",
            "version": "1.0",
        }
        return json.dumps(
            export_obj, indent=2 if opts["pretty_print"] else None, default=str
        )

    def import_from_json(self, json_str: str, target_path=None, options=None) -> dict:
        opts = self._merged_options(options)
        try:
            parsed = json.loads(json_str)
            if parsed.get("format") != "bullet-json":
                raise ValueError("Invalid Bullet JSON format")
            path = target_path or parsed.get("path")
            if not path:
                raise ValueError("No target path specified")
            data = self._decode_value(parsed.get("data"))
            self.bullet.set_data(path, data)
            if parsed.get("metadata") and opts["include_metadata"]:
                self._import_metadata(path, parsed["metadata"])
            return {"success": True, "path": path, "data": data}
        except Exception as err:  # noqa: BLE001
            return {"success": False, "error": str(err)}

    # ------------------------------------------------------------------- CSV

    def export_to_csv(self, path: str, options: Optional[dict] = None) -> str:
        """Children-as-rows CSV export (bullet-serializer.js:197-273)."""
        opts = {"delimiter": ",", "include_headers": True, **_snake_keys(options)}
        data = self.bullet._get_data(path)
        if not isinstance(data, (dict, list)):
            raise TypeError("Data must be an object to export as CSV")
        if isinstance(data, list):
            rows = data
        else:
            rows = [
                {"id": key, **value}
                for key, value in data.items()
                if isinstance(value, dict)
            ]
        return self._rows_to_csv(rows, opts)

    def _rows_to_csv(self, rows, opts) -> str:
        if not rows:
            return ""
        headers: list = []
        for row in rows:
            if isinstance(row, dict):
                for key in row:
                    if key not in headers:
                        headers.append(key)
        delim = opts["delimiter"]
        out_rows = []
        if opts["include_headers"]:
            out_rows.append(delim.join(headers))
        for row in rows:
            cells = []
            for h in headers:
                v = row.get(h) if isinstance(row, dict) else None
                if v is None:
                    cells.append("")
                elif isinstance(v, str):
                    escaped = v.replace('"', '""')
                    if delim in escaped or "\n" in escaped or '"' in escaped:
                        cells.append(f'"{escaped}"')
                    else:
                        cells.append(escaped)
                else:
                    cells.append(to_string(v) if not isinstance(v, (dict, list)) else json.dumps(v))
            out_rows.append(delim.join(cells))
        return "\n".join(out_rows)

    def import_from_csv(self, csv_str: str, target_path: str, options=None) -> dict:
        """Quote-aware CSV import with type coercion
        (bullet-serializer.js:283-442)."""
        opts = {"delimiter": ",", "first_row_headers": True, **_snake_keys(options)}
        try:
            rows = _parse_csv_rows(csv_str)
            if not rows:
                raise ValueError("Empty CSV data")
            delim = opts["delimiter"]
            if opts["first_row_headers"]:
                headers = _parse_csv_row(rows[0], delim)
                start = 1
            else:
                headers = [f"field{i}" for i in range(len(rows[0].split(delim)))]
                start = 0
            result: Dict[str, Any] = {}
            for i in range(start, len(rows)):
                fields = _parse_csv_row(rows[i], delim)
                if not fields or (len(fields) == 1 and fields[0] == ""):
                    continue
                row_id = fields[0] or f"row{i}"
                obj = {
                    headers[j]: _convert_csv_value(fields[j])
                    for j in range(min(len(headers), len(fields)))
                }
                result[row_id] = obj
            self.bullet.set_data(target_path, result)
            return {"success": True, "path": target_path, "data": result}
        except Exception as err:  # noqa: BLE001
            return {"success": False, "error": str(err)}

    # ------------------------------------------------------------------- XML

    def export_to_xml(self, path: str, options: Optional[dict] = None) -> str:
        """XML export with the reference's element shapes
        (bullet-serializer.js:451-520)."""
        opts = {"root_name": "bullet", "indent": "  ", **_snake_keys(options)}
        data = self.bullet._get_data(path)
        xml = '<?xml version="1.0" encoding="UTF-8"?>\n'
        xml += f'<{opts["root_name"]} path="{path or ""}">\n'
        xml += self._object_to_xml(data, 1, opts)
        xml += f'</{opts["root_name"]}>'
        return xml

    def _object_to_xml(self, obj: Any, level: int, opts) -> str:
        indent = opts["indent"] * level
        if obj is None:
            return f"{indent}<null/>\n"
        if not isinstance(obj, (dict, list)):
            return (
                f'{indent}<value type="{_xml_type(obj)}">'
                f"{_escape_xml(to_string(obj))}</value>\n"
            )
        if isinstance(obj, list):
            xml = f"{indent}<array>\n"
            for i, item in enumerate(obj):
                xml += f'{indent}{opts["indent"]}<item index="{i}">\n'
                xml += self._object_to_xml(item, level + 2, opts)
                xml += f'{indent}{opts["indent"]}</item>\n'
            xml += f"{indent}</array>\n"
            return xml
        xml = ""
        for key, value in obj.items():
            tag = _escape_xml(str(key))
            if value is None:
                xml += f'{indent}<{tag} null="true"/>\n'
            elif not isinstance(value, (dict, list)):
                xml += (
                    f'{indent}<{tag} type="{_xml_type(value)}">'
                    f"{_escape_xml(to_string(value))}</{tag}>\n"
                )
            else:
                xml += f"{indent}<{tag}>\n"
                xml += self._object_to_xml(value, level + 1, opts)
                xml += f"{indent}</{tag}>\n"
        return xml

    def import_from_xml(self, xml_str: str, target_path: str, options=None) -> dict:
        try:
            root = ElementTree.fromstring(xml_str)
            parsed = self._xml_node_to_object(root)
            self.bullet.set_data(target_path, parsed)
            return {"success": True, "path": target_path, "data": parsed}
        except Exception as err:  # noqa: BLE001
            return {"success": False, "error": str(err)}

    def _xml_node_to_object(self, node) -> Any:
        """Inverse of the export shapes (bullet-serializer.js:580-640)."""
        if node.get("null") == "true":
            return None
        if node.tag == "value":
            return _coerce_xml(node.get("type"), node.text or "")
        if node.tag == "array":
            items: list = []
            for child in node:
                if child.tag == "item":
                    idx = int(child.get("index", len(items)))
                    value = self._xml_node_to_object(list(child)[0]) if len(child) else None
                    while len(items) <= idx:
                        items.append(None)
                    items[idx] = value
            return items
        if node.tag in ("null",):
            return None
        result: Dict[str, Any] = {}
        for child in node:
            key = child.tag
            if key == "bullet":
                continue
            if child.get("null") == "true":
                result[key] = None
            elif child.get("type"):
                result[key] = _coerce_xml(child.get("type"), child.text or "")
            elif len(child):
                inner = list(child)
                # lossless unwrap of wrapped arrays/values (the reference's
                # browser-only import keeps the wrapper — ours round-trips)
                if len(inner) == 1 and inner[0].tag in ("array", "value", "null"):
                    result[key] = self._xml_node_to_object(inner[0])
                else:
                    result[key] = self._xml_node_to_object(child)
            else:
                result[key] = child.text or None
        return result

    # -------------------------------------------------------------- metadata

    def _metadata_for_path(self, path: str) -> dict:
        """Vector clocks + index definitions (bullet-serializer.js:648-672)."""
        metadata: Dict[str, Any] = {}
        metadata["meta"] = self.bullet.meta.get(path, {})
        if self.bullet.query is not None:
            indices = {
                key: True
                for key in self.bullet.query.indices
                if key == path
                or key.startswith(path + ":")
                or key.startswith(path + "/")
            }
            if indices:
                metadata["indices"] = indices
        return metadata

    def _import_metadata(self, path: str, metadata: dict) -> None:
        if metadata.get("meta"):
            self.bullet.meta[path] = metadata["meta"]
        if metadata.get("indices") and self.bullet.query is not None:
            for index_key in metadata["indices"]:
                base, _, field = index_key.partition(":")
                self.bullet.query.index(base, field or None)

    # camelCase aliases
    exportToJSON = export_to_json
    importFromJSON = import_from_json
    exportToCSV = export_to_csv
    importFromCSV = import_from_csv
    exportToXML = export_to_xml
    importFromXML = import_from_xml
    registerType = register_type


# ------------------------------------------------------------------- helpers


def _snake(key: str) -> str:
    out = re.sub(r"([A-Z])", r"_\1", key).lower()
    return out


def _snake_keys(options: Optional[dict]) -> dict:
    return {_snake(k): v for k, v in (options or {}).items()}


def _parse_iso(value: str) -> datetime:
    value = value.replace("Z", "+00:00")
    return datetime.fromisoformat(value)


def _js_flags(pattern) -> str:
    flags = ""
    if pattern.flags & re.IGNORECASE:
        flags += "i"
    if pattern.flags & re.MULTILINE:
        flags += "m"
    if pattern.flags & re.DOTALL:
        flags += "s"
    return flags


def _py_flags(flags: str) -> int:
    out = 0
    if "i" in flags:
        out |= re.IGNORECASE
    if "m" in flags:
        out |= re.MULTILINE
    if "s" in flags:
        out |= re.DOTALL
    return out


def _parse_csv_rows(csv_str: str):
    """Split rows respecting quotes (bullet-serializer.js:348-377)."""
    rows, current, in_quote = [], [], False
    i = 0
    while i < len(csv_str):
        ch = csv_str[i]
        nxt = csv_str[i + 1] if i + 1 < len(csv_str) else ""
        if ch == '"':
            if nxt == '"':
                current.append('"')
                i += 1
            else:
                in_quote = not in_quote
        elif ch == "\n" and not in_quote:
            rows.append("".join(current))
            current = []
        else:
            current.append(ch)
        i += 1
    if "".join(current).strip():
        rows.append("".join(current))
    return rows


def _parse_csv_row(row: str, delimiter: str):
    """Split one row into fields respecting quotes
    (bullet-serializer.js:386-413)."""
    fields, current, in_quote = [], [], False
    i = 0
    while i < len(row):
        ch = row[i]
        nxt = row[i + 1] if i + 1 < len(row) else ""
        if ch == '"':
            if nxt == '"':
                current.append('"')
                i += 1
            else:
                in_quote = not in_quote
        elif ch == delimiter and not in_quote:
            fields.append("".join(current))
            current = []
        else:
            current.append(ch)
        i += 1
    fields.append("".join(current))
    return fields


def _convert_csv_value(value: str):
    """CSV string → typed value (bullet-serializer.js:421-442). The numeric
    gate is JS ``!isNaN(value)`` (ToNumber, StringNumericLiteral grammar) and
    the conversion is ``parseFloat``/``parseInt(·,10)`` — NOT Python
    int()/float(): "1_000" stays a string, "1e5" imports as parseInt's 1,
    "Infinity" imports as NaN."""
    if value == "":
        return None
    low = value.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if not math.isnan(_string_to_number(value)) and value.strip() != "":
        return js_parse_float(value) if "." in value else js_parse_int(value)
    if re.match(r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}", value):
        try:
            return _parse_iso(value)
        except ValueError:
            pass
    return value


def _xml_type(value) -> str:
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, (int, float)):
        return "number"
    return "string"


def _coerce_xml(type_name, text: str):
    if type_name == "number":
        try:
            f = float(text)
            return int(f) if f.is_integer() else f
        except ValueError:
            return float("nan")
    if type_name == "boolean":
        return text == "true"
    return text


def _escape_xml(s: str) -> str:
    return (
        s.replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
        .replace('"', "&quot;")
        .replace("'", "&apos;")
    )
