"""JavaScript value semantics on Python values.

The reference's default conflict comparator is JS ``<``/``===``
(bullet-js src/bullet-crt.js:11-15) and its concurrent-merge helper is a
deep object merge (bullet-js src/bullet-crt.js:122-153). The host db
layer reproduces those semantics exactly for JSON-shaped Python values
(None, bool, int/float, str, list, dict).

The port's own copy of ``bullet_tpu/utils/jsvalues.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Any

JSON_SCALARS = (type(None), bool, int, float, str)


def js_falsy(v: Any) -> bool:
    """JS falsiness: null/undefined, false, 0, NaN, "" — but NOT [] or {}."""
    if v is None or v is False:
        return True
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)):
        return v == 0 or (isinstance(v, float) and math.isnan(v))
    if isinstance(v, str):
        return v == ""
    return False


def is_object(v: Any) -> bool:
    """JS ``typeof v === "object" && v !== null && !Array.isArray(v)``."""
    return isinstance(v, dict)


def is_array(v: Any) -> bool:
    return isinstance(v, list)


import re as _re

# JS StringNumericLiteral grammar (ToNumber): decimal with optional exponent,
# or unsigned 0x/0b/0o literals. Notably NO underscores ("1_000" is NaN in
# JS but valid for Python float()), and only exact-case "Infinity".
_JS_DECIMAL_RE = _re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_JS_INFINITY_RE = _re.compile(r"^[+-]?Infinity$")
_JS_HEX_RE = _re.compile(r"^0[xX][0-9a-fA-F]+$")
_JS_BIN_RE = _re.compile(r"^0[bB][01]+$")
_JS_OCT_RE = _re.compile(r"^0[oO][0-7]+$")


def _string_to_number(s: str) -> float:
    sv = s.strip(" \t\n\r\f\v ﻿")
    if sv == "":
        return 0.0
    if _JS_INFINITY_RE.match(sv):
        return -math.inf if sv[0] == "-" else math.inf
    if _JS_HEX_RE.match(sv):
        return float(int(sv, 16))
    if _JS_BIN_RE.match(sv):
        return float(int(sv, 2))
    if _JS_OCT_RE.match(sv):
        return float(int(sv, 8))
    if _JS_DECIMAL_RE.match(sv):
        return float(sv)
    return math.nan


_JS_WS = " \t\n\r\f\v ﻿"

_JS_PARSEINT_RE = _re.compile(r"^[+-]?\d+")
_JS_PARSEFLOAT_RE = _re.compile(
    r"^[+-]?(Infinity|\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)"
)


def js_parse_int(s: str):
    """JS ``parseInt(s, 10)``: trim, optional sign, then the longest decimal
    digit prefix; NaN when no digits ("1e5" → 1, "Infinity" → NaN).

    The result is a JS Number, i.e. a float64 — long digit strings round
    to the nearest double (parseInt("9007199254740993") === 9007199254740992)
    and ~1e309-scale strings overflow to Infinity. Integral in-range values
    come back as Python ints (how integral doubles print/JSON-serialize)."""
    m = _JS_PARSEINT_RE.match(s.strip(_JS_WS))
    if not m:
        return math.nan
    exact = int(m.group(0))
    try:
        f = float(exact)  # nearest float64, like any JS Number
    except OverflowError:
        return -math.inf if exact < 0 else math.inf
    return int(f) if abs(f) < 2**63 else f


def js_parse_float(s: str) -> float:
    """JS ``parseFloat(s)``: trim, then the longest StrDecimalLiteral prefix
    (sign, digits, '.', exponent, or "Infinity"); NaN when none."""
    m = _JS_PARSEFLOAT_RE.match(s.strip(_JS_WS))
    if not m:
        return math.nan
    tok = m.group(0)
    if tok.endswith("Infinity"):
        return -math.inf if tok[0] == "-" else math.inf
    return float(tok)


def to_number(v: Any) -> float:
    """JS ToNumber for the value shapes we store (JSON-compatible)."""
    if v is None:
        return 0.0
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return _string_to_number(v)
    if isinstance(v, list):
        # ToPrimitive(array) -> elements joined by ","
        return to_number(",".join("" if e is None else to_string(e) for e in v))
    return math.nan  # plain objects -> "[object Object]" -> NaN


def js_number_string(v: float) -> str:
    """Spec-exact JS Number-to-string (ECMA-262 Number::toString base 10):
    decimal notation for 1e-6 ≤ |v| < 1e21, exponent form otherwise with an
    unpadded exponent ("1e-7", not Python's "1e-07")."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == 0:
        return "0"
    sign = "-" if v < 0 else ""
    r = repr(abs(v))  # shortest round-trip digits, like JS
    if "e" in r:
        mant, _, exp_s = r.partition("e")
        exp = int(exp_s)
    else:
        mant, exp = r, 0
    int_part, _, frac = mant.partition(".")
    digits = (int_part + frac).lstrip("0")
    e10 = exp - len(frac)
    stripped = digits.rstrip("0")
    e10 += len(digits) - len(stripped)
    digits = stripped
    k = len(digits)
    n = k + e10  # value = 0.digits × 10^n
    if k <= n <= 21:
        return sign + digits + "0" * (n - k)
    if 0 < n <= 21:
        return sign + digits[:n] + "." + digits[n:]
    if -6 < n <= 0:
        return sign + "0." + "0" * (-n) + digits
    mantissa = digits[0] + ("." + digits[1:] if k > 1 else "")
    return f"{sign}{mantissa}e{'+' if n - 1 >= 0 else '-'}{abs(n - 1)}"


def to_string(v: Any) -> str:
    """JS String(v) for JSON-compatible values."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return js_number_string(float(v))
    if isinstance(v, str):
        return v
    if isinstance(v, list):
        return ",".join("" if e is None else to_string(e) for e in v)
    return "[object Object]"


def utf16_key(s: str) -> bytes:
    """Sort key reproducing JS string comparison: JS ``<`` compares UTF-16
    code units, and big-endian UTF-16 bytes order identically. (Python's
    str ``<`` compares code points, which differs for astral-plane chars:
    U+1F600 > U+FFFD by code point but its surrogate D83D < FFFD in JS.)"""
    return s.encode("utf-16-be", "surrogatepass")


def strict_equals(a: Any, b: Any) -> bool:
    """JS ``===``. Booleans and numbers are distinct types; objects compare by
    identity."""
    if isinstance(a, (dict, list)) or isinstance(b, (dict, list)):
        return a is b
    if a is None or b is None:
        return a is None and b is None
    a_bool, b_bool = isinstance(a, bool), isinstance(b, bool)
    if a_bool or b_bool:
        return a_bool and b_bool and a == b
    a_num = isinstance(a, (int, float))
    b_num = isinstance(b, (int, float))
    if a_num or b_num:
        if not (a_num and b_num):
            return False
        fa, fb = float(a), float(b)
        return not math.isnan(fa) and not math.isnan(fb) and fa == fb
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b


def less_than(a: Any, b: Any) -> bool:
    """JS abstract ``<``: string/string compares by UTF-16 code units,
    everything else via ToNumber (NaN comparisons are false)."""
    if isinstance(a, str) and isinstance(b, str):
        return utf16_key(a) < utf16_key(b)
    fa, fb = to_number(a), to_number(b)
    if math.isnan(fa) or math.isnan(fb):
        return False
    return fa < fb


def js_compare(incoming: Any, existing: Any) -> int:
    """The reference default comparator (bullet-js src/bullet-crt.js:11-15):
    0 if ``===``, -1 if ``<``, else 1 (so incomparable pairs favor incoming)."""
    if strict_equals(incoming, existing):
        return 0
    if less_than(incoming, existing):
        return -1
    return 1


def _float_order_bits(f: float) -> int:
    """Monotone u64 key over floats (same transform as the engine's
    ``utils.encode.number_key``): negatives bit-flipped, non-negatives get
    the sign bit forced, NaN canonicalized above +Infinity."""
    import struct

    if f != f:  # NaN: one canonical slot, above every ordered float
        u = 0x7FF8000000000000
    else:
        if f == 0.0:
            f = 0.0  # -0.0 === 0 in JS: one canonical zero
        u = struct.unpack("<Q", struct.pack("<d", f))[0]
    if u >> 63:
        u = (~u) & 0xFFFFFFFFFFFFFFFF
    else:
        u |= 1 << 63
    return u


def total_order_key(v: Any):
    """Deterministic total-order key over JSON-shaped values. Type-tag order
    matches the engine's value classes (utils/encode.py CLS_*: null < number
    < string < opaque); numbers order numerically (booleans sort just above
    their numeric equal so ``true`` vs ``1`` still has a winner), strings by
    UTF-16 code units, and opaque values (arrays/objects) by canonical JSON —
    the one piece the engine resolves by global vid instead (host replicas
    have no shared vid space, canonical bytes are the portable equivalent)."""
    if v is None:
        return (1,)
    if isinstance(v, bool):
        return (2, _float_order_bits(1.0 if v else 0.0), 1)
    if isinstance(v, (int, float)):
        return (2, _float_order_bits(float(v)), 0)
    if isinstance(v, str):
        return (3, utf16_key(v))
    import json

    canon = json.dumps(v, sort_keys=True, separators=(",", ":"), default=str)
    return (4, utf16_key(canon))


def total_compare(incoming: Any, existing: Any) -> int:
    """Total-order comparator closing the reference's last divergence hole:
    ``js_compare`` (bullet-crt.js:11-15) returns "incoming wins" for
    JS-incomparable pairs (string-vs-number, bool-vs-number, NaN), so
    identical-clock conflicts between such values resolve by ARRIVAL ORDER
    and replicas can permanently disagree. This comparator is antisymmetric
    over all value pairs — every identical-clock conflict has one global
    winner regardless of delivery order. Opt in with ``compare: "total"``
    (default stays ``js_compare`` for reference parity). Same-type pairs
    order exactly as JS does (numeric / UTF-16 string order); cross-type
    pairs order by type tag like the engine's rank order, NOT by JS's
    ToNumber coercion (which is not antisymmetric: ``"2" < 3`` but
    ``"2" > "12"``, so no total order can honor it)."""
    ka, kb = total_order_key(incoming), total_order_key(existing)
    return -1 if ka < kb else (1 if ka > kb else 0)


def deep_merge_values(incoming: Any, current: Any, compare=js_compare) -> Any:
    """``mergeValues`` (bullet-js src/bullet-crt.js:122-153): deep merge
    when both are plain objects; otherwise comparator-LWW (ties keep incoming).
    Arrays are opaque comparator inputs (SURVEY quirk Q4)."""
    if not is_object(incoming) or not is_object(current):
        return incoming if compare(incoming, current) >= 0 else current
    result = dict(current)
    for key, value in incoming.items():
        if key in result:
            result[key] = deep_merge_values(value, result[key], compare)
        else:
            result[key] = value
    return result


def deep_copy(v: Any) -> Any:
    """Structure-preserving deep copy of JSON-shaped values (the reference uses
    ``JSON.parse(JSON.stringify(...))``, e.g. bullet-memory-storage.js:82-84)."""
    if isinstance(v, dict):
        return {k: deep_copy(x) for k, x in v.items()}
    if isinstance(v, list):
        return [deep_copy(x) for x in v]
    return v
