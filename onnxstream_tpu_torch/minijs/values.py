"""minijs runtime value model.

JS value -> Python representation:
    undefined       UNDEF (sentinel)        null      NULL (sentinel)
    boolean         bool                    number    float (ALWAYS float)
    bigint          int                     string    str
    Array           JSArray                 Object    JSObject
    Map / Set       JSMap / JSSet           function  JSFunction | callable
    TypedArray      JSTypedArray (numpy-backed, so f32 store-rounding and
                    float64 reads match the browser bit-for-bit)

Numbers are always Python float so `typeof` and BigInt mixing rules stay
sound (Python bool/int would alias). BigInt is Python int — arbitrary
precision, exactly like the spec.
"""

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .errors import MiniJsError, JSThrow


class _Sentinel:
    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __repr__(self):
        return self._name

    def __bool__(self):
        return False


UNDEF = _Sentinel("undefined")
NULL = _Sentinel("null")


class JSArray:
    __slots__ = ("items",)

    def __init__(self, items: Optional[List[Any]] = None):
        self.items = items if items is not None else []

    def __repr__(self):
        return f"JSArray({self.items!r})"


class JSObject:
    __slots__ = ("props", "klass")

    def __init__(self, props: Optional[Dict[str, Any]] = None, klass=None):
        self.props = props if props is not None else {}
        self.klass = klass  # JSClass for instances, None for plain objects

    def __repr__(self):
        return f"JSObject({list(self.props)[:6]})"


class JSMap:
    __slots__ = ("data",)

    def __init__(self):
        self.data: Dict[Any, Any] = {}

    @staticmethod
    def _key(k):
        # SameValueZero for our value set; floats/strings hash natively.
        # bool is a dict-key alias of 0/1 in Python but numbers here are
        # float, so True != 1.0 collisions can't happen silently... except
        # they can (True == 1.0 hashes equal). Wrap bools.
        return ("bool", k) if isinstance(k, bool) else k

    def get(self, k, d=UNDEF):
        return self.data.get(self._key(k), d)

    def set(self, k, v):
        self.data[self._key(k)] = v

    def has(self, k) -> bool:
        return self._key(k) in self.data

    def delete(self, k) -> bool:
        return self.data.pop(self._key(k), _MISS) is not _MISS

    def clear(self):
        self.data.clear()

    @staticmethod
    def _unkey(k):
        return k[1] if isinstance(k, tuple) and len(k) == 2 and k[0] == "bool" else k

    def keys(self):
        return [self._unkey(k) for k in self.data]


_MISS = object()


class JSSet:
    __slots__ = ("data",)

    def __init__(self, items=None):
        self.data: Dict[Any, None] = {}
        for it in items or ():
            self.add(it)

    def add(self, v):
        self.data[JSMap._key(v)] = None
        return self

    def has(self, v) -> bool:
        return JSMap._key(v) in self.data

    def delete(self, v) -> bool:
        return self.data.pop(JSMap._key(v), _MISS) is not _MISS

    def values(self):
        return [JSMap._unkey(k) for k in self.data]


_TA_KINDS = {
    "Float32Array": np.float32,
    "Float64Array": np.float64,
    "Int32Array": np.int32,
    "Int16Array": np.int16,
    "Int8Array": np.int8,
    "Uint8Array": np.uint8,
    "Uint16Array": np.uint16,
    "Uint32Array": np.uint32,
    "BigInt64Array": np.int64,
    "BigUint64Array": np.uint64,
}
_BIG_KINDS = ("BigInt64Array", "BigUint64Array")


def _element_convert(vals, dt) -> np.ndarray:
    """Spec ToIntN/ToUintN element conversion: truncate toward zero, then
    wrap modulo 2**bits (Int8Array([200])[0] is -56, not an OverflowError);
    NaN/Infinity store as 0. Float kinds take IEEE store-rounding directly.
    Exact for |value| < 2**53 — the spec range where wrapping is observable."""
    dt = np.dtype(dt)
    if dt.itemsize == 8 and dt.kind in "iu":
        # BigInt64/BigUint64: exact integer path (float64 would round above
        # 2**53); ToBigInt64 wraps modulo 2**64
        out = np.zeros(len(vals), dt)
        for i, v in enumerate(vals):
            n = int(v) & 0xFFFFFFFFFFFFFFFF
            if dt.kind == "i" and n >= 1 << 63:
                n -= 1 << 64
            out[i] = n
        return out
    f = np.array([js_to_number(v) if not isinstance(v, (int, float)) or
                  isinstance(v, bool) else float(v) for v in vals]
                 if not isinstance(vals, np.ndarray) else vals, np.float64)
    if dt.kind == "f":
        return f.astype(dt)
    bits = 8 * dt.itemsize
    out = np.zeros(f.shape, np.float64)
    finite = np.isfinite(f)
    t = np.mod(np.trunc(f[finite]), 2.0 ** bits)  # [0, 2**bits)
    t = np.where(t < 0, t + 2.0 ** bits, t)
    if dt.kind == "i":
        t = np.where(t >= 2.0 ** (bits - 1), t - 2.0 ** bits, t)
    out[finite] = t
    return out.astype(dt)


class JSTypedArray:
    """numpy-backed typed array. subarray() returns a VIEW (JS semantics);
    slice() copies. Element reads return float (or int for BigInt64Array)."""

    __slots__ = ("kind", "arr")

    def __init__(self, kind: str, arr: np.ndarray):
        self.kind = kind
        self.arr = arr

    @classmethod
    def new(cls, kind: str, arg=None) -> "JSTypedArray":
        dt = _TA_KINDS[kind]
        if arg is None:
            return cls(kind, np.zeros(0, dt))
        if isinstance(arg, (int, float)) and not isinstance(arg, bool):
            return cls(kind, np.zeros(int(arg), dt))
        if isinstance(arg, JSTypedArray):
            return cls(kind, _element_convert(arg.arr, dt))
        if isinstance(arg, JSArray):
            return cls(kind, _element_convert(arg.items, dt))
        if isinstance(arg, np.ndarray):
            return cls(kind, np.ascontiguousarray(arg, dt).reshape(-1))
        if isinstance(arg, (list, tuple)):
            return cls(kind, _element_convert(arg, dt))
        raise MiniJsError(f"cannot construct {kind} from {type(arg).__name__}")

    @property
    def big(self) -> bool:
        return self.kind in _BIG_KINDS

    def __len__(self):
        return self.arr.shape[0]

    def read(self, i: int):
        v = self.arr[i]
        return int(v) if self.big else float(v)

    def write(self, i: int, v):
        if self.big:
            if isinstance(v, float):
                raise JSThrow(_type_error("cannot convert number to BigInt element"))
            self.arr[i] = int(v)
        else:
            if isinstance(v, int) and not isinstance(v, bool):
                raise JSThrow(_type_error("cannot convert BigInt to number element"))
            if self.arr.dtype.kind in "iu":
                self.arr[i] = _element_convert([v], self.arr.dtype)[0]
            else:
                self.arr[i] = v  # numpy performs the dtype store-rounding

    def tolist(self) -> list:
        if self.big:
            return [int(v) for v in self.arr]
        return [float(v) for v in self.arr]

    def __repr__(self):
        return f"{self.kind}(len={len(self)})"


def _type_error(msg: str) -> JSObject:
    return JSObject({"name": "TypeError", "message": msg})


class JSFunction:
    __slots__ = ("name", "params", "body", "env", "is_arrow", "is_async",
                 "this_val", "is_expr_body")

    def __init__(self, name, params, body, env, is_arrow=False, is_async=False,
                 this_val=UNDEF, is_expr_body=False):
        self.name = name or ""
        self.params = params
        self.body = body
        self.env = env
        self.is_arrow = is_arrow
        self.is_async = is_async
        self.this_val = this_val  # lexical this (arrows)
        self.is_expr_body = is_expr_body

    def __repr__(self):
        return f"JSFunction({self.name or '<anon>'})"


class JSBoundMethod:
    """obj.method extracted as a value: carries its `this`."""

    __slots__ = ("fn", "this_val")

    def __init__(self, fn, this_val):
        self.fn = fn
        self.this_val = this_val


class JSClass:
    __slots__ = ("name", "methods", "statics", "fields", "static_props", "scope")

    def __init__(self, name: str, scope=None):
        self.name = name or "<anon class>"
        self.methods: Dict[str, JSFunction] = {}
        self.statics: Dict[str, JSFunction] = {}
        self.fields: List[tuple] = []  # (name, init_ast)
        self.static_props: Dict[str, Any] = {}
        self.scope = scope  # defining scope (field initializers close over it)

    def __repr__(self):
        return f"JSClass({self.name})"


class JSPromise:
    """Synchronous promise: created already settled (minijs never suspends —
    interp.js's API is async for browser symmetry only)."""

    __slots__ = ("value", "error")

    def __init__(self, value=UNDEF, error=None):
        self.value = value
        self.error = error  # a JSThrow or None


class JSAccessor:
    """Property accessor pair from `{get x(){...}, set x(v){...}}` literals.
    Stored as the prop VALUE; every read path resolves it through
    runtime.resolve_prop_value (get_prop, Object.values/entries/assign,
    spread, JSON.stringify)."""

    __slots__ = ("get_fn", "set_fn")

    def __init__(self, get_fn=None, set_fn=None):
        self.get_fn = get_fn
        self.set_fn = set_fn


class NativeFunction:
    """Host (Python) function exposed to JS. fn(this, args) -> value.
    `props` holds static properties (Array.from, Float32Array.BYTES_PER_ELEMENT)."""

    __slots__ = ("name", "fn", "props")

    def __init__(self, name: str, fn: Callable, props: Optional[dict] = None):
        self.name = name
        self.fn = fn
        self.props = props

    def __repr__(self):
        return f"NativeFunction({self.name})"


# ------------------------------------------------------------- conversions

def js_truthy(v) -> bool:
    if v is UNDEF or v is NULL:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        return not (v == 0.0 or v != v)  # 0, -0, NaN
    if isinstance(v, int):
        return v != 0
    if isinstance(v, str):
        return v != ""
    return True


def js_typeof(v) -> str:
    if v is UNDEF:
        return "undefined"
    if v is NULL:
        return "object"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, int):
        return "bigint"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (JSFunction, NativeFunction, JSBoundMethod, JSClass)):
        return "function"
    return "object"


def num_to_str(v: float) -> str:
    """ECMA-262 Number::toString(10): shortest round-trip digits, decimal
    notation for exponents in (-7, 21], exponential outside — NOT Python's
    repr, which switches to 1e-05 where JS prints 0.00001 (a divergence the
    conformance corpus caught, tests/data/es_conformance.json)."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "Infinity"
    if v == float("-inf"):
        return "-Infinity"
    if v == 0.0:
        return "0"
    sign = "-" if v < 0 else ""
    # shortest round-trip digits via repr, normalized to (digits, n) with
    # value = 0.digits * 10**n
    r = repr(abs(v))
    if "e" in r or "E" in r:
        mant, _, exp = r.lower().partition("e")
        e10 = int(exp)
    else:
        mant, e10 = r, 0
    if "." in mant:
        ip, _, fp = mant.partition(".")
    else:
        ip, fp = mant, ""
    digits = (ip + fp).lstrip("0")
    n = e10 + len(ip) - (len(ip + fp) - len((ip + fp).lstrip("0")))
    digits = digits.rstrip("0") or "0"
    k = len(digits)
    if k <= n <= 21:
        return sign + digits + "0" * (n - k)
    if 0 < n <= 21:
        return sign + digits[:n] + "." + digits[n:]
    if -6 < n <= 0:
        return sign + "0." + "0" * (-n) + digits
    # exponential: d.ddd e+/- (n-1)
    e = n - 1
    head = digits[0] + ("." + digits[1:] if k > 1 else "")
    return f"{sign}{head}e{'+' if e >= 0 else '-'}{abs(e)}"


def js_to_string(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return num_to_str(v)
    if isinstance(v, int):
        return str(v)
    if v is UNDEF:
        return "undefined"
    if v is NULL:
        return "null"
    if isinstance(v, JSArray):
        return ",".join("" if (x is UNDEF or x is NULL) else js_to_string(x)
                        for x in v.items)
    if isinstance(v, JSTypedArray):
        return ",".join(num_to_str(float(x)) if not v.big else str(int(x))
                        for x in v.arr)
    if isinstance(v, JSObject):
        if "message" in v.props:  # Error-like
            name = v.props.get("name", "Error")
            return f"{name}: {js_to_string(v.props['message'])}"
        return "[object Object]"
    if isinstance(v, (JSFunction, NativeFunction, JSBoundMethod)):
        return f"function {getattr(v, 'name', '')}() {{ [minijs] }}"
    if isinstance(v, JSClass):
        return f"class {v.name} {{ [minijs] }}"
    return str(v)


def js_to_number(v) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, float):
        return v
    if isinstance(v, int):
        raise JSThrow(_type_error("cannot convert a BigInt to a number"))
    if v is NULL:
        return 0.0
    if v is UNDEF:
        return float("nan")
    if isinstance(v, str):
        s = v.strip()
        if s == "":
            return 0.0
        # spec StringNumericLiteral: 0x/0o/0b radix forms, 'Infinity' (exact
        # spelling), or a decimal literal. Python's float() must NOT be fed
        # raw: it accepts 'inf'/'nan'/'1_000', which JS rejects as NaN.
        try:
            if s[:2].lower() in ("0x", "0o", "0b") and len(s) > 2:
                return float(int(s[2:], {"x": 16, "o": 8, "b": 2}[s[1].lower()]))
            body = s[1:] if s[0] in "+-" else s
            if body == "Infinity":
                return float("-inf") if s[0] == "-" else float("inf")
            if body and "_" not in body and (body[0].isdigit() or body[0] == "."):
                return float(s)
            return float("nan")
        except ValueError:
            return float("nan")
    if isinstance(v, JSArray):
        if not v.items:
            return 0.0
        if len(v.items) == 1:
            return js_to_number(v.items[0])
    return float("nan")


def js_pow(a: float, b: float) -> float:
    """JS exponentiation: negative base with fractional exponent is NaN (not
    complex), overflow saturates to +/-Infinity, NaN**0 is 1. Spec edge
    numpy misses: |base| == 1 with an infinite exponent is NaN (IEEE pow
    says 1; ES Number::exponentiate says NaN)."""
    if abs(a) == 1.0 and (b == float("inf") or b == float("-inf")):
        return float("nan")
    with np.errstate(all="ignore"):
        return float(np.power(np.float64(a), np.float64(b)))


def to_int32(v: float) -> int:
    if v != v or v in (float("inf"), float("-inf")):
        return 0
    n = int(v) & 0xFFFFFFFF
    return n - 0x100000000 if n >= 0x80000000 else n


def to_uint32(v: float) -> int:
    if v != v or v in (float("inf"), float("-inf")):
        return 0
    return int(v) & 0xFFFFFFFF
