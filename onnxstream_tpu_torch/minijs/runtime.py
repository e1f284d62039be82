"""minijs runtime: property dispatch, iteration protocol, and the global
environment (Math, Array, Map/Set, typed arrays, Error, console, ...).

Only the surface api/interp.js needs is implemented; unknown properties on
primitives raise JSThrow(TypeError) so gaps surface loudly instead of
mis-executing.
"""

import math
from typing import Any, List

import numpy as np

from .errors import MiniJsError, JSThrow
from .values import (
    NULL, UNDEF, JSAccessor, JSArray, JSBoundMethod, JSClass, JSFunction,
    JSMap, JSObject, JSPromise, JSSet, JSTypedArray, NativeFunction,
    _TA_KINDS, js_to_number, js_to_string, js_truthy, js_typeof, num_to_str,
    _type_error,
)


class JSArrayBuffer:
    __slots__ = ("data",)

    def __init__(self, data: np.ndarray):
        self.data = np.ascontiguousarray(data.view(np.uint8).reshape(-1))


def _nf(name):
    def deco(fn):
        return NativeFunction(name, fn)
    return deco


def _method(name, obj, fn):
    """Bind a python impl as a JS method value: fn(args) -> value."""
    return NativeFunction(name, lambda this, args, _f=fn, _o=obj: _f(_o, args))


def _arg(args: List[Any], i: int, d=UNDEF):
    return args[i] if i < len(args) else d


def _int_arg(args, i, d):
    # spec ToIntegerOrInfinity: NaN -> 0, +-Infinity clamps (2**53 is past
    # any reachable length, so clamped values behave identically downstream)
    v = _arg(args, i, UNDEF)
    if v is UNDEF:
        return d
    n = js_to_number(v)
    if n != n:
        return 0
    if n == float("inf"):
        return 1 << 53
    if n == float("-inf"):
        return -(1 << 53)
    return int(n)


# ------------------------------------------------------------- iteration

def js_iter(v):
    if isinstance(v, JSArray):
        return list(v.items)
    if isinstance(v, str):
        return list(v)
    if isinstance(v, JSTypedArray):
        return v.tolist()
    if isinstance(v, JSMap):
        return [JSArray([JSMap._unkey(k), val]) for k, val in v.data.items()]
    if isinstance(v, JSSet):
        return v.values()
    raise JSThrow(_type_error(f"{js_to_string(v)} is not iterable"))


# ------------------------------------------------------------- array methods

def _norm_slice(n: int, start, end) -> tuple:
    s = 0 if start is UNDEF else int(js_to_number(start))
    e = n if end is UNDEF else int(js_to_number(end))
    if s < 0:
        s += n
    if e < 0:
        e += n
    s = max(0, min(n, s))
    e = max(0, min(n, e))
    return s, max(s, e)


def _array_prop(interp, arr: JSArray, name: str):
    items = arr.items
    if name == "length":
        return float(len(items))
    if name == "push":
        return _method(name, arr, lambda a, args: (a.items.extend(args),
                                                   float(len(a.items)))[1])
    if name == "pop":
        return _method(name, arr, lambda a, args: a.items.pop() if a.items else UNDEF)
    if name == "map":
        def _map(a, args):
            fn = args[0]
            return JSArray([interp.call(fn, UNDEF, [v, float(i), a])
                            for i, v in enumerate(list(a.items))])
        return _method(name, arr, _map)
    if name == "filter":
        def _filter(a, args):
            fn = args[0]
            return JSArray([v for i, v in enumerate(list(a.items))
                            if js_truthy(interp.call(fn, UNDEF, [v, float(i), a]))])
        return _method(name, arr, _filter)
    if name == "forEach":
        def _each(a, args):
            fn = args[0]
            for i, v in enumerate(list(a.items)):
                interp.call(fn, UNDEF, [v, float(i), a])
            return UNDEF
        return _method(name, arr, _each)
    if name == "reduce":
        def _reduce(a, args):
            fn = args[0]
            it = list(a.items)
            if len(args) >= 2:
                acc = args[1]
                start = 0
            else:
                if not it:
                    raise JSThrow(_type_error("reduce of empty array with no initial value"))
                acc = it[0]
                start = 1
            for i in range(start, len(it)):
                acc = interp.call(fn, UNDEF, [acc, it[i], float(i), a])
            return acc
        return _method(name, arr, _reduce)
    if name == "slice":
        def _slice(a, args):
            s, e = _norm_slice(len(a.items), _arg(args, 0), _arg(args, 1))
            return JSArray(a.items[s:e])
        return _method(name, arr, _slice)
    if name == "splice":
        def _splice(a, args):
            n = len(a.items)
            s = _int_arg(args, 0, 0)
            if s < 0:
                s += n
            s = max(0, min(n, s))
            cnt = _int_arg(args, 1, n - s)
            cnt = max(0, min(cnt, n - s))
            removed = a.items[s:s + cnt]
            a.items[s:s + cnt] = list(args[2:])
            return JSArray(removed)
        return _method(name, arr, _splice)
    if name == "concat":
        def _concat(a, args):
            out = list(a.items)
            for x in args:
                if isinstance(x, JSArray):
                    out.extend(x.items)
                else:
                    out.append(x)
            return JSArray(out)
        return _method(name, arr, _concat)
    if name == "fill":
        def _fill(a, args):
            v = _arg(args, 0)
            s, e = _norm_slice(len(a.items), _arg(args, 1), _arg(args, 2))
            for i in range(s, e):
                a.items[i] = v
            return a
        return _method(name, arr, _fill)
    if name == "at":
        def _at(a, args):
            i = _int_arg(args, 0, 0)
            if i < 0:
                i += len(a.items)
            return a.items[i] if 0 <= i < len(a.items) else UNDEF
        return _method(name, arr, _at)
    if name == "indexOf":
        def _indexof(a, args):
            from .interp import strict_equals
            t = _arg(args, 0)
            start = _int_arg(args, 1, 0)
            if start < 0:
                start = max(0, len(a.items) + start)
            for i in range(start, len(a.items)):
                if strict_equals(a.items[i], t):
                    return float(i)
            return -1.0
        return _method(name, arr, _indexof)
    if name == "includes":
        def _includes(a, args):
            # SameValueZero, NOT strict equality: [NaN].includes(NaN) is true
            from .interp import strict_equals
            t = _arg(args, 0)
            t_nan = isinstance(t, float) and t != t
            return any(strict_equals(v, t)
                       or (t_nan and isinstance(v, float) and v != v)
                       for v in a.items)
        return _method(name, arr, _includes)
    if name == "findIndex":
        def _find_index(a, args):
            fn = args[0]
            for i, v in enumerate(list(a.items)):
                if js_truthy(interp.call(fn, UNDEF, [v, float(i), a])):
                    return float(i)
            return -1.0
        return _method(name, arr, _find_index)
    if name == "shift":
        def _shift(a, args):
            return a.items.pop(0) if a.items else UNDEF
        return _method(name, arr, _shift)
    if name == "unshift":
        def _unshift(a, args):
            a.items[:0] = list(args)
            return float(len(a.items))
        return _method(name, arr, _unshift)
    if name == "join":
        def _join(a, args):
            sep = _arg(args, 0)
            sep = "," if sep is UNDEF else js_to_string(sep)
            return sep.join("" if (v is UNDEF or v is NULL) else js_to_string(v)
                            for v in a.items)
        return _method(name, arr, _join)
    if name == "keys":
        return _method(name, arr, lambda a, args: JSArray(
            [float(i) for i in range(len(a.items))]))
    if name == "values":
        return _method(name, arr, lambda a, args: JSArray(list(a.items)))
    if name == "entries":
        return _method(name, arr, lambda a, args: JSArray(
            [JSArray([float(i), v]) for i, v in enumerate(a.items)]))
    if name == "sort":
        def _sort(a, args):
            fn = _arg(args, 0)
            if fn is UNDEF:
                a.items.sort(key=js_to_string)
            else:
                import functools

                def cmp(x, y):
                    r = js_to_number(interp.call(fn, UNDEF, [x, y]))
                    return -1 if r < 0 else (1 if r > 0 else 0)
                a.items.sort(key=functools.cmp_to_key(cmp))
            return a
        return _method(name, arr, _sort)
    if name == "reverse":
        def _rev(a, args):
            a.items.reverse()
            return a
        return _method(name, arr, _rev)
    if name == "every":
        def _every(a, args):
            fn = args[0]
            return all(js_truthy(interp.call(fn, UNDEF, [v, float(i), a]))
                       for i, v in enumerate(list(a.items)))
        return _method(name, arr, _every)
    if name == "some":
        def _some(a, args):
            fn = args[0]
            return any(js_truthy(interp.call(fn, UNDEF, [v, float(i), a]))
                       for i, v in enumerate(list(a.items)))
        return _method(name, arr, _some)
    if name == "find":
        def _find(a, args):
            fn = args[0]
            for i, v in enumerate(list(a.items)):
                if js_truthy(interp.call(fn, UNDEF, [v, float(i), a])):
                    return v
            return UNDEF
        return _method(name, arr, _find)
    if name == "flat":
        def _flat(a, args):
            out = []
            for v in a.items:
                if isinstance(v, JSArray):
                    out.extend(v.items)
                else:
                    out.append(v)
            return JSArray(out)
        return _method(name, arr, _flat)
    # numeric index arrives as a string here only via obj["0"]-style access
    try:
        i = int(name)
        return arr.items[i] if 0 <= i < len(arr.items) else UNDEF
    except ValueError:
        pass
    return UNDEF


# --------------------------------------------------------- string methods

def _pad(s: str, args, left: bool) -> str:
    n = _int_arg(args, 0, 0)
    fill_v = _arg(args, 1, UNDEF)
    # an explicitly-passed undefined fill means ' ' (spec StringPad step 4)
    fill = " " if fill_v is UNDEF else js_to_string(fill_v)
    if n <= len(s) or not fill:
        return s
    if n > (1 << 30):
        raise JSThrow(JSObject({"name": "RangeError",
                                "message": "Invalid string length"}))
    pad = (fill * ((n - len(s)) // len(fill) + 1))[: n - len(s)]
    return pad + s if left else s + pad


def _substring(s: str, args) -> str:
    def clamp(v):
        n = js_to_number(v) if v is not UNDEF else float(len(s))
        if n != n:
            n = 0.0
        return int(min(max(n, 0), len(s)))

    a, b = clamp(_arg(args, 0, 0.0)), clamp(_arg(args, 1))
    if a > b:
        a, b = b, a
    return s[a:b]


def _get_substitution(match: str, s: str, pos: int, rep: str) -> str:
    """Spec GetSubstitution for string patterns (no capture groups):
    $$ -> $, $& -> match, $` -> before, $' -> after; lone $ passes through."""
    out = []
    i = 0
    while i < len(rep):
        c = rep[i]
        if c == "$" and i + 1 < len(rep):
            n = rep[i + 1]
            if n == "$":
                out.append("$"); i += 2; continue
            if n == "&":
                out.append(match); i += 2; continue
            if n == "`":
                out.append(s[:pos]); i += 2; continue
            if n == "'":
                out.append(s[pos + len(match):]); i += 2; continue
        out.append(c)
        i += 1
    return "".join(out)


def _js_replace(interp, s: str, args, all_occurrences: bool) -> str:
    pat = js_to_string(_arg(args, 0, ""))
    rep = _arg(args, 1, UNDEF)
    rep_is_fn = js_typeof(rep) == "function"
    out = []
    i = 0
    while True:
        j = s.find(pat, i) if pat else (i if i <= len(s) else -1)
        if j == -1:
            out.append(s[i:])
            return "".join(out)
        out.append(s[i:j])
        if rep_is_fn:
            out.append(js_to_string(interp.call(rep, UNDEF, [pat, float(j), s])))
        else:
            out.append(_get_substitution(pat, s, j, js_to_string(rep)))
        if pat:
            i = j + len(pat)
        else:
            # zero-length match: the char at j is NOT part of the match —
            # emit it and advance ('abc'.replaceAll('', '-') == '-a-b-c-')
            if j < len(s):
                out.append(s[j])
            i = j + 1
        if not all_occurrences:
            out.append(s[i:])
            return "".join(out)
        if not pat and j >= len(s):
            return "".join(out)


def _js_fixed(n: float, f: int) -> str:
    """Fixed-point per spec ToFixed: ties on the EXACT binary double pick
    the larger candidate after sign extraction (half-away-from-zero), not
    Python's half-even — (0.125).toFixed(2) is '0.13' in every browser.
    |x| >= 1e21 falls back to ToString (spec step 10); the quantize runs
    in a widened local context (a double's exact expansion + 100 digits
    overflows the default 28-digit context with InvalidOperation)."""
    import decimal

    if n != n or abs(n) == float("inf") or abs(n) >= 1e21:
        return num_to_str(n)
    sign = "-" if (n < 0 or (n == 0 and math.copysign(1.0, n) < 0)) else ""
    with decimal.localcontext() as ctx:
        ctx.prec = 1200  # exact double expansion (~1080 digits) + headroom
        d = decimal.Decimal(abs(n)).quantize(
            decimal.Decimal(1).scaleb(-f), rounding=decimal.ROUND_HALF_UP)
    return sign + f"{d:.{f}f}"


def _js_to_precision(n: float, p: int) -> str:
    """Spec Number.prototype.toPrecision (21.1.3.5): exponential when the
    decimal exponent e < -6 or e >= p, else fixed with p-1-e fraction
    digits; exponent rendered without a leading zero."""
    if n != n:
        return "NaN"
    if n in (float("inf"), float("-inf")):
        return num_to_str(n)
    if p < 1 or p > 100:
        raise JSThrow(JSObject({"name": "RangeError",
                                "message": "toPrecision() argument must be between 1 and 100"}))
    if n == 0:
        return f"{0.0:.{p - 1}f}"
    e = math.floor(math.log10(abs(n)))
    # rounding at p significant digits can bump the exponent (9.99 -> 10)
    scaled = round(abs(n) / (10.0 ** e), p - 1)
    if scaled >= 10.0:
        e += 1
    if e < -6 or e >= p:
        mant = _js_fixed(n / (10.0 ** e), p - 1)
        return f"{mant}e{'+' if e >= 0 else '-'}{abs(e)}"
    return _js_fixed(n, max(p - 1 - e, 0))


def _string_prop(interp, s: str, name: str):
    if name == "length":
        return float(len(s))
    table = {
        "split": lambda s, args: JSArray(list(s) if _arg(args, 0) is UNDEF
                                         else s.split(js_to_string(args[0]))
                                         if js_to_string(args[0]) != ""
                                         else list(s)),
        "slice": lambda s, args: s[slice(*_norm_slice(len(s), _arg(args, 0),
                                                      _arg(args, 1)))],
        "indexOf": lambda s, args: float(s.find(js_to_string(_arg(args, 0, "")),
                                                _int_arg(args, 1, 0))),
        "lastIndexOf": lambda s, args: float(s.rfind(js_to_string(_arg(args, 0, "")))),
        "startsWith": lambda s, args: s.startswith(js_to_string(_arg(args, 0, ""))),
        "endsWith": lambda s, args: s.endswith(js_to_string(_arg(args, 0, ""))),
        "includes": lambda s, args: js_to_string(_arg(args, 0, "")) in s,
        "trim": lambda s, args: s.strip(),
        "toLowerCase": lambda s, args: s.lower(),
        "toUpperCase": lambda s, args: s.upper(),
        "charCodeAt": lambda s, args: (float(ord(s[_int_arg(args, 0, 0)]))
                                       if 0 <= _int_arg(args, 0, 0) < len(s)
                                       else float("nan")),
        "charAt": lambda s, args: (s[_int_arg(args, 0, 0)]
                                   if 0 <= _int_arg(args, 0, 0) < len(s) else ""),
        "repeat": lambda s, args: s * _int_arg(args, 0, 0),
        "padStart": lambda s, args: _pad(s, args, left=True),
        "padEnd": lambda s, args: _pad(s, args, left=False),
        # spec GetSubstitution ($$/$&/$`/$') + function replacements
        "replace": lambda s, args: _js_replace(interp, s, args, False),
        "replaceAll": lambda s, args: _js_replace(interp, s, args, True),
        "at": lambda s, args: (s[i] if -len(s) <= (i := _int_arg(args, 0, 0)) < len(s)
                               else UNDEF),
        # substring clamps to [0, len] and SWAPS out-of-order args — slice
        # semantics (negatives from the end) are wrong here:
        # 'abc'.substring(2, 0) is 'ab'
        "substring": lambda s, args: _substring(s, args),
        "concat": lambda s, args: s + "".join(js_to_string(a) for a in args),
        "toString": lambda s, args: s,
    }
    if name in table:
        return _method(name, s, table[name])
    try:
        i = int(name)
        return s[i] if 0 <= i < len(s) else UNDEF
    except ValueError:
        pass
    return UNDEF


# ------------------------------------------------------ typed array methods

def _typed_prop(interp, ta: JSTypedArray, name: str):
    if name == "length":
        return float(len(ta))
    if name == "buffer":
        return JSArrayBuffer(ta.arr)
    if name == "byteLength":
        return float(ta.arr.nbytes)
    if name == "byteOffset":
        # the engine's typed arrays always own a fresh copy of their buffer
        # slice, so the view offset is spec-correctly 0
        return 0.0
    if name == "BYTES_PER_ELEMENT":
        return float(ta.arr.dtype.itemsize)
    if name == "set":
        def _set(a, args):
            src = args[0]
            off = _int_arg(args, 1, 0)
            if isinstance(src, JSTypedArray):
                a.arr[off:off + len(src)] = src.arr
            elif isinstance(src, JSArray):
                for i, v in enumerate(src.items):
                    a.write(off + i, v)
            else:
                raise JSThrow(_type_error("invalid source for TypedArray.set"))
            return UNDEF
        return _method(name, ta, _set)
    if name == "fill":
        def _fill(a, args):
            s, e = _norm_slice(len(a), _arg(args, 1), _arg(args, 2))
            v = args[0]
            a.arr[s:e] = int(v) if a.big else js_to_number(v)
            return a
        return _method(name, ta, _fill)
    if name == "subarray":
        def _sub(a, args):
            s, e = _norm_slice(len(a), _arg(args, 0), _arg(args, 1))
            return JSTypedArray(a.kind, a.arr[s:e])  # VIEW
        return _method(name, ta, _sub)
    if name == "slice":
        def _slice(a, args):
            s, e = _norm_slice(len(a), _arg(args, 0), _arg(args, 1))
            return JSTypedArray(a.kind, a.arr[s:e].copy())
        return _method(name, ta, _slice)
    if name == "indexOf":
        def _indexof(a, args):
            t = js_to_number(args[0]) if not a.big else int(args[0])
            w = np.where(a.arr == t)[0]
            return float(w[0]) if len(w) else -1.0
        return _method(name, ta, _indexof)
    if name == "map":
        def _map(a, args):
            fn = args[0]
            out = np.empty_like(a.arr)
            for i in range(len(a)):
                v = interp.call(fn, UNDEF, [a.read(i), float(i), a])
                out[i] = int(v) if a.big else js_to_number(v)
            return JSTypedArray(a.kind, out)
        return _method(name, ta, _map)
    if name == "reduce":
        def _reduce(a, args):
            fn = args[0]
            if len(args) >= 2:
                acc, start = args[1], 0
            else:
                if len(a) == 0:
                    raise JSThrow(_type_error("reduce of empty TypedArray"))
                acc, start = a.read(0), 1
            for i in range(start, len(a)):
                acc = interp.call(fn, UNDEF, [acc, a.read(i), float(i), a])
            return acc
        return _method(name, ta, _reduce)
    if name == "join":
        def _join(a, args):
            sep = _arg(args, 0)
            sep = "," if sep is UNDEF else js_to_string(sep)
            return sep.join(num_to_str(float(x)) if not a.big else str(int(x))
                            for x in a.arr)
        return _method(name, ta, _join)
    if name == "forEach":
        def _each(a, args):
            fn = args[0]
            for i in range(len(a)):
                interp.call(fn, UNDEF, [a.read(i), float(i), a])
            return UNDEF
        return _method(name, ta, _each)
    if name == "keys":
        return _method(name, ta, lambda a, args: JSArray(
            [float(i) for i in range(len(a))]))
    if name == "values":
        return _method(name, ta, lambda a, args: JSArray(a.tolist()))
    try:
        i = int(name)
        return ta.read(i) if 0 <= i < len(ta) else UNDEF
    except ValueError:
        pass
    return UNDEF


# ------------------------------------------------------------ map/set/promise

def _map_prop(interp, m: JSMap, name: str):
    if name == "size":
        return float(len(m.data))
    table = {
        "get": lambda m, args: m.get(_arg(args, 0)),
        "set": lambda m, args: (m.set(_arg(args, 0), _arg(args, 1)), m)[1],
        "has": lambda m, args: m.has(_arg(args, 0)),
        "delete": lambda m, args: m.delete(_arg(args, 0)),
        "clear": lambda m, args: (m.clear(), UNDEF)[1],
        "keys": lambda m, args: JSArray(m.keys()),
        "values": lambda m, args: JSArray(list(m.data.values())),
        "entries": lambda m, args: JSArray(
            [JSArray([JSMap._unkey(k), v]) for k, v in m.data.items()]),
        "forEach": lambda m, args: ([interp.call(args[0], UNDEF,
                                                 [v, JSMap._unkey(k), m])
                                     for k, v in list(m.data.items())],
                                    UNDEF)[1],
    }
    if name in table:
        return _method(name, m, table[name])
    return UNDEF


def _set_prop_(interp, s: JSSet, name: str):
    if name == "size":
        return float(len(s.data))
    table = {
        "add": lambda s, args: s.add(_arg(args, 0)),
        "has": lambda s, args: s.has(_arg(args, 0)),
        "delete": lambda s, args: s.delete(_arg(args, 0)),
        "clear": lambda s, args: (s.data.clear(), UNDEF)[1],
        "values": lambda s, args: JSArray(s.values()),
        "keys": lambda s, args: JSArray(s.values()),
        "forEach": lambda s, args: ([interp.call(args[0], UNDEF, [v, v, s])
                                     for v in s.values()], UNDEF)[1],
    }
    if name in table:
        return _method(name, s, table[name])
    return UNDEF


# ------------------------------------------------------------ dispatch

def resolve_prop_value(interp, obj, name: str, v):
    """Accessor-aware property READ: a JSAccessor value invokes its getter
    with `obj` as this (undefined when there is no getter)."""
    if isinstance(v, JSAccessor):
        if v.get_fn is None:
            return UNDEF
        return interp.call(v.get_fn, obj, [])
    return v


def get_prop(interp, obj, name: str):
    if obj is UNDEF or obj is NULL:
        raise JSThrow(_type_error(
            f"cannot read properties of {js_to_string(obj)} (reading '{name}')"))
    if isinstance(obj, JSObject):
        if name in obj.props:
            return resolve_prop_value(interp, obj, name, obj.props[name])
        if obj.klass is not None and name in obj.klass.methods:
            return JSBoundMethod(obj.klass.methods[name], obj)
        if name == "constructor":
            return obj.klass if obj.klass is not None else UNDEF
        if name == "hasOwnProperty":
            return _method(name, obj, lambda o, args:
                           js_to_string(_arg(args, 0, "")) in o.props)
        if name == "toString":
            return _method(name, obj, lambda o, args: js_to_string(o))
        return UNDEF
    if isinstance(obj, JSArray):
        return _array_prop(interp, obj, name)
    if isinstance(obj, str):
        return _string_prop(interp, obj, name)
    if isinstance(obj, JSTypedArray):
        return _typed_prop(interp, obj, name)
    if isinstance(obj, JSMap):
        return _map_prop(interp, obj, name)
    if isinstance(obj, JSSet):
        return _set_prop_(interp, obj, name)
    if isinstance(obj, JSClass):
        if name in obj.statics:
            return JSBoundMethod(obj.statics[name], obj)
        if name in obj.static_props:
            return obj.static_props[name]
        if name == "name":
            return obj.name
        return UNDEF
    if isinstance(obj, JSArrayBuffer):
        if name == "byteLength":
            return float(obj.data.nbytes)
        if name == "slice":
            def _slice(b, args):
                s, e = _norm_slice(len(b.data), _arg(args, 0), _arg(args, 1))
                return JSArrayBuffer(b.data[s:e].copy())
            return _method(name, obj, _slice)
        return UNDEF
    if isinstance(obj, JSPromise):
        if name == "then":
            def _then(p, args):
                if p.error is not None:
                    if len(args) >= 2:
                        return JSPromise(value=interp.call(args[1], UNDEF,
                                                           [p.error.value]))
                    return p
                v = interp.call(args[0], UNDEF, [p.value]) if args else p.value
                return v if isinstance(v, JSPromise) else JSPromise(value=v)
            return _method(name, obj, _then)
        if name == "catch":
            def _catch(p, args):
                if p.error is not None and args:
                    return JSPromise(value=interp.call(args[0], UNDEF,
                                                       [p.error.value]))
                return p
            return _method(name, obj, _catch)
        return UNDEF
    if isinstance(obj, NativeFunction):
        props = getattr(obj, "props", None)
        if props and name in props:
            return props[name]
        if name == "name":
            return obj.name
        return UNDEF
    if isinstance(obj, (JSFunction, JSBoundMethod)):
        if name == "name":
            return getattr(obj, "name", "")
        if name == "call":
            def _call(f, args):
                return interp.call(f, _arg(args, 0), list(args[1:]))
            return _method(name, obj, _call)
        if name == "apply":
            def _apply(f, args):
                rest = _arg(args, 1)
                return interp.call(f, _arg(args, 0),
                                   list(js_iter(rest)) if rest is not UNDEF else [])
            return _method(name, obj, _apply)
        if name == "bind":
            def _bind(f, args):
                return JSBoundMethod(f, _arg(args, 0))
            return _method(name, obj, _bind)
        return UNDEF
    if isinstance(obj, float):
        if name == "toFixed":
            return _method(name, obj, lambda n, args:
                           _js_fixed(n, _int_arg(args, 0, 0)))
        if name == "toPrecision":
            return _method(name, obj, lambda n, args:
                           num_to_str(n) if _arg(args, 0) is UNDEF
                           else _js_to_precision(n, _int_arg(args, 0, 0)))
        if name == "toString":
            return _method(name, obj, lambda n, args: num_to_str(n))
        return UNDEF
    if isinstance(obj, (bool, int)):
        if name == "toString":
            return _method(name, obj, lambda v, args: js_to_string(v))
        return UNDEF
    raise JSThrow(_type_error(f"cannot read '{name}' of {type(obj).__name__}"))


def get_index(interp, obj, idx):
    # fractional indices are PROPERTY keys in JS (arr[1.5] is undefined, not
    # arr[1]) — truncating would hide divide-without-floor bugs in the JS
    if (isinstance(idx, float) and not isinstance(idx, bool)
            and math.isfinite(idx) and idx == int(idx)):
        i = int(idx)
        if isinstance(obj, JSArray):
            return obj.items[i] if 0 <= i < len(obj.items) else UNDEF
        if isinstance(obj, JSTypedArray):
            return obj.read(i) if 0 <= i < len(obj) else UNDEF
        if isinstance(obj, str):
            return obj[i] if 0 <= i < len(obj) else UNDEF
    elif isinstance(idx, float) and isinstance(obj, (JSArray, JSTypedArray, str)):
        return UNDEF
    return get_prop(interp, obj, js_to_string(idx))


def set_prop(interp, obj, name: str, value):
    if isinstance(obj, JSObject):
        cur = obj.props.get(name)
        if isinstance(cur, JSAccessor):
            if cur.set_fn is not None:
                interp.call(cur.set_fn, obj, [value])
            return  # getter-only: silent no-op (non-strict semantics)
        obj.props[name] = value
        return
    if isinstance(obj, JSArray):
        if name == "length":
            n = int(js_to_number(value))
            cur = len(obj.items)
            if n < cur:
                del obj.items[n:]
            else:
                obj.items.extend([UNDEF] * (n - cur))
            return
        try:
            i = int(name)
        except ValueError:
            return  # expando props on arrays unsupported (not needed)
        _array_set_index(obj, i, value)
        return
    if isinstance(obj, JSTypedArray):
        try:
            i = int(name)
        except ValueError:
            return
        if 0 <= i < len(obj):
            obj.write(i, value)
        return
    if isinstance(obj, JSClass):
        obj.static_props[name] = value
        return
    if isinstance(obj, NativeFunction):
        if not hasattr(obj, "props") or obj.props is None:
            raise JSThrow(_type_error(f"cannot extend native {obj.name}"))
        obj.props[name] = value
        return
    raise JSThrow(_type_error(f"cannot set '{name}' on {type(obj).__name__}"))


def _array_set_index(arr: JSArray, i: int, value):
    if i < 0:
        return
    if i >= len(arr.items):
        arr.items.extend([UNDEF] * (i + 1 - len(arr.items)))
    arr.items[i] = value


def set_index(interp, obj, idx, value):
    if (isinstance(idx, float) and not isinstance(idx, bool)
            and math.isfinite(idx) and idx == int(idx)):
        if isinstance(obj, JSArray):
            _array_set_index(obj, int(idx), value)
            return
        if isinstance(obj, JSTypedArray):
            i = int(idx)
            if 0 <= i < len(obj):
                obj.write(i, value)
            return
    elif isinstance(idx, float) and isinstance(obj, (JSArray, JSTypedArray)):
        return  # fractional index: JS expando we don't model; never truncate
    set_prop(interp, obj, js_to_string(idx), value)


def native_instanceof(l, ctor: NativeFunction) -> bool:
    n = ctor.name
    if n == "Array":
        return isinstance(l, JSArray)
    if n == "Error":
        # all error species are instanceof Error (prototype chain analog)
        return (isinstance(l, JSObject) and "message" in l.props
                and str(l.props.get("name", "")).endswith("Error"))
    if n in ("TypeError", "RangeError", "SyntaxError", "ReferenceError"):
        # exact species: new RangeError() is NOT instanceof TypeError
        return (isinstance(l, JSObject) and "message" in l.props
                and l.props.get("name") == n)
    if n == "Map":
        return isinstance(l, JSMap)
    if n == "Set":
        return isinstance(l, JSSet)
    if n in _TA_KINDS:
        return isinstance(l, JSTypedArray) and l.kind == n
    if n == "ArrayBuffer":
        return isinstance(l, JSArrayBuffer)
    if n == "Promise":
        return isinstance(l, JSPromise)
    return False


# ------------------------------------------------------------- global env

def _ordered_keys(props: dict) -> list:
    """Spec OrdinaryOwnPropertyKeys order: array-index-like keys ascending
    FIRST, then string keys in insertion order — Object.keys({b:1, 2:2,
    a:3, 1:4}) is ['1','2','b','a'], not insertion order."""
    def is_index(k: str) -> bool:
        # ASCII decimal only: '²'.isdigit() is True but int('²') raises,
        # and the spec's array index grammar is ASCII anyway
        return (k and all("0" <= c <= "9" for c in k)
                and (k == "0" or not k.startswith("0")))

    ints = sorted((k for k in props if is_index(k)), key=int)
    return ints + [k for k in props if not is_index(k)]


def _math_obj() -> JSObject:
    # numpy float64 semantics ARE JS number semantics at the edges:
    # exp(1000)=Infinity (not OverflowError), floor(Infinity)=Infinity,
    # sqrt(-1)=NaN, log(0)=-Infinity — so every unary routes through np
    # under errstate-ignore instead of Python's raising math module.
    fns = {
        "abs": np.abs, "ceil": np.ceil, "floor": np.floor,
        # JS half-up, not banker's; a zero result keeps the operand's sign
        # (Math.round(-0.5) is -0, so 1/Math.round(-0.5) is -Infinity)
        "round": lambda v: np.copysign(np.floor(v + 0.5), v)
        if np.floor(v + 0.5) == 0 else np.floor(v + 0.5),
        "trunc": np.trunc, "sqrt": np.sqrt, "exp": np.exp,
        "sin": np.sin, "cos": np.cos, "tan": np.tan, "tanh": np.tanh,
        "atan": np.arctan, "asin": np.arcsin, "acos": np.arccos,
        "sinh": np.sinh, "cosh": np.cosh,
        "log": np.log, "log2": np.log2, "log10": np.log10,
        "log1p": np.log1p, "expm1": np.expm1,
        "sign": np.sign, "cbrt": np.cbrt,
        "fround": lambda v: np.float64(np.float32(v)),
    }
    props = {}
    for n, f in fns.items():
        def mk(f):
            def impl(this, args):
                with np.errstate(all="ignore"):
                    return float(f(np.float64(js_to_number(
                        _arg(args, 0, float("nan"))))))
            return impl
        props[n] = NativeFunction(n, mk(f))

    def _binary(name, f):
        def impl(this, args):
            with np.errstate(all="ignore"):
                return float(f(np.float64(js_to_number(_arg(args, 0))),
                               np.float64(js_to_number(_arg(args, 1)))))
        return NativeFunction(name, impl)

    props["pow"] = _binary("pow", np.power)
    props["atan2"] = _binary("atan2", np.arctan2)
    props["hypot"] = NativeFunction("hypot", lambda t, a: float(
        np.hypot.reduce([np.float64(js_to_number(x)) for x in a])
        if a else 0.0))

    def _max(this, args):
        if not args:
            return float("-inf")
        vals = [js_to_number(v) for v in args]
        return float("nan") if any(v != v for v in vals) else max(vals)

    def _min(this, args):
        if not args:
            return float("inf")
        vals = [js_to_number(v) for v in args]
        return float("nan") if any(v != v for v in vals) else min(vals)

    props["max"] = NativeFunction("max", _max)
    props["min"] = NativeFunction("min", _min)
    props["random"] = NativeFunction("random", lambda t, a: 0.5)  # determinism
    props["PI"] = math.pi
    props["E"] = math.e
    props["LN2"] = math.log(2.0)
    props["SQRT2"] = math.sqrt(2.0)
    return JSObject(props)


def _object_assign(interp, target, sources):
    """Spec Object.assign: reads resolve source getters, writes go through
    [[Set]] so TARGET setters are invoked (not clobbered)."""
    for s in sources:
        if isinstance(s, JSObject):
            for k in _ordered_keys(s.props):
                set_prop(interp, target, k,
                         resolve_prop_value(interp, s, k, s.props[k]))
    return target


def _mk_error_ctor(name: str) -> NativeFunction:
    def ctor(this, args):
        msg = _arg(args, 0, UNDEF)
        return JSObject({"name": name,
                         "message": "" if msg is UNDEF else js_to_string(msg),
                         "stack": f"{name} (minijs)"})
    return NativeFunction(name, ctor)


def _typed_ctor(engine, kind: str) -> NativeFunction:
    def ctor(this, args):
        arg = _arg(args, 0, None)
        if arg is None or arg is UNDEF:
            return JSTypedArray.new(kind)
        if isinstance(arg, JSArrayBuffer):
            dt = _TA_KINDS[kind]
            off = _int_arg(args, 1, 0)
            nbytes = arg.data.nbytes - off
            n = _int_arg(args, 2, nbytes // np.dtype(dt).itemsize)
            view = arg.data[off:off + n * np.dtype(dt).itemsize].view(dt)
            return JSTypedArray(kind, view)  # shares the buffer (JS semantics)
        return JSTypedArray.new(kind, arg)
    nf = NativeFunction(kind, ctor)

    def _from(this, args):
        src = _arg(args, 0)
        fn = _arg(args, 1)
        items = js_iter(src) if not isinstance(src, JSObject) else _arraylike(src)
        if fn is not UNDEF:
            items = [engine.interp.call(fn, UNDEF, [v, float(i)])
                     for i, v in enumerate(items)]
        return JSTypedArray.new(kind, list(items))

    def _of(this, args):
        return JSTypedArray.new(kind, list(args))

    nf.props = {"from": NativeFunction("from", _from),
                "of": NativeFunction("of", _of),
                "BYTES_PER_ELEMENT": float(np.dtype(_TA_KINDS[kind]).itemsize)}
    return nf


def _arraylike(obj: JSObject) -> list:
    n = int(js_to_number(obj.props.get("length", 0.0)))
    return [obj.props.get(str(i), UNDEF) for i in range(n)]


def make_globals(engine) -> dict:
    """Build the global bindings dict for an Engine."""
    g: dict = {}
    g["Infinity"] = float("inf")
    g["NaN"] = float("nan")
    g["undefined"] = UNDEF
    g["Math"] = _math_obj()

    console_lines: list = engine.console_lines

    def _console(level):
        def impl(this, args):
            console_lines.append((level, " ".join(js_to_string(a) for a in args)))
            return UNDEF
        return NativeFunction(level, impl)

    g["console"] = JSObject({lv: _console(lv) for lv in
                             ("log", "info", "warn", "error", "debug")})

    for name in ("Error", "TypeError", "RangeError"):
        g[name] = _mk_error_ctor(name)

    def _array_ctor(this, args):
        if len(args) == 1 and isinstance(args[0], float):
            return JSArray([UNDEF] * int(args[0]))
        return JSArray(list(args))
    arr_ctor = NativeFunction("Array", _array_ctor)

    def _array_from(this, args):
        src = _arg(args, 0)
        fn = _arg(args, 1)
        if isinstance(src, JSObject):
            items = _arraylike(src)
        else:
            items = js_iter(src)
        if fn is not UNDEF:
            items = [engine.interp.call(fn, UNDEF, [v, float(i)])
                     for i, v in enumerate(items)]
        return JSArray(list(items))

    arr_ctor.props = {
        "from": NativeFunction("from", _array_from),
        "isArray": NativeFunction("isArray",
                                  lambda t, a: isinstance(_arg(a, 0), JSArray)),
        "of": NativeFunction("of", lambda t, a: JSArray(list(a))),
    }
    g["Array"] = arr_ctor

    def _object_ctor(this, args):
        return JSObject()
    obj_ctor = NativeFunction("Object", _object_ctor)
    obj_ctor.props = {
        "keys": NativeFunction("keys", lambda t, a: JSArray(
            _ordered_keys(_arg(a, 0).props)
            if isinstance(_arg(a, 0), JSObject) else [])),
        "values": NativeFunction("values", lambda t, a: JSArray(
            [resolve_prop_value(engine.interp, _arg(a, 0), k,
                                _arg(a, 0).props[k])
             for k in _ordered_keys(_arg(a, 0).props)]
            if isinstance(_arg(a, 0), JSObject) else [])),
        "entries": NativeFunction("entries", lambda t, a: JSArray(
            [JSArray([k, resolve_prop_value(engine.interp, _arg(a, 0), k,
                                            _arg(a, 0).props[k])])
             for k in _ordered_keys(_arg(a, 0).props)]
            if isinstance(_arg(a, 0), JSObject) else [])),
        "assign": NativeFunction("assign", lambda t, a: _object_assign(
            engine.interp, a[0], a[1:])),
        "freeze": NativeFunction("freeze", lambda t, a: _arg(a, 0)),
    }
    g["Object"] = obj_ctor

    def _map_ctor(this, args):
        m = JSMap()
        src = _arg(args, 0)
        if src is not UNDEF and src is not NULL:
            if isinstance(src, JSMap):
                m.data.update(src.data)
            else:
                for pair in js_iter(src):
                    kv = list(js_iter(pair))
                    m.set(kv[0], kv[1] if len(kv) > 1 else UNDEF)
        return m
    g["Map"] = NativeFunction("Map", _map_ctor)

    def _set_ctor(this, args):
        src = _arg(args, 0)
        s = JSSet()
        if src is not UNDEF and src is not NULL:
            for v in js_iter(src):
                s.add(v)
        return s
    g["Set"] = NativeFunction("Set", _set_ctor)

    for kind in _TA_KINDS:
        g[kind] = _typed_ctor(engine, kind)

    def _ab_ctor(this, args):
        return JSArrayBuffer(np.zeros(_int_arg(args, 0, 0), np.uint8))
    g["ArrayBuffer"] = NativeFunction("ArrayBuffer", _ab_ctor, props={
        "isView": NativeFunction(
            "isView", lambda this, args: isinstance(_arg(args, 0), JSTypedArray)),
    })

    def _number(this, args):
        v = _arg(args, 0, 0.0)
        if isinstance(v, int) and not isinstance(v, bool):
            return float(v)  # Number(BigInt) converts
        return js_to_number(v)
    num = NativeFunction("Number", _number)
    num.props = {
        "isInteger": NativeFunction("isInteger", lambda t, a: (
            isinstance(_arg(a, 0), float) and _arg(a, 0) == _arg(a, 0)
            and _arg(a, 0) not in (float("inf"), float("-inf"))
            and float(_arg(a, 0)).is_integer())),
        "isFinite": NativeFunction("isFinite", lambda t, a: (
            isinstance(_arg(a, 0), float) and _arg(a, 0) == _arg(a, 0)
            and _arg(a, 0) not in (float("inf"), float("-inf")))),
        "isNaN": NativeFunction("isNaN", lambda t, a: (
            isinstance(_arg(a, 0), float) and _arg(a, 0) != _arg(a, 0))),
        "MAX_SAFE_INTEGER": 9007199254740991.0,
        "MIN_SAFE_INTEGER": -9007199254740991.0,
        "EPSILON": 2.220446049250313e-16,
        "POSITIVE_INFINITY": float("inf"),
        "NEGATIVE_INFINITY": float("-inf"),
        "NaN": float("nan"),
        "parseFloat": None,  # filled below
    }
    g["Number"] = num

    def _string_fn(this, args):
        return js_to_string(_arg(args, 0, ""))
    sf = NativeFunction("String", _string_fn)
    sf.props = {"fromCharCode": NativeFunction("fromCharCode", lambda t, a:
                                               "".join(chr(int(js_to_number(x)))
                                                       for x in a))}
    g["String"] = sf

    def _boolean(this, args):
        return js_truthy(_arg(args, 0, UNDEF))
    g["Boolean"] = NativeFunction("Boolean", _boolean)

    def _bigint(this, args):
        v = _arg(args, 0)
        if isinstance(v, int) and not isinstance(v, bool):
            return v
        if isinstance(v, bool):
            return 1 if v else 0
        if isinstance(v, float):
            if v != v or not float(v).is_integer():
                raise JSThrow(JSObject({
                    "name": "RangeError",
                    "message": f"{num_to_str(v)} cannot be converted to BigInt"}))
            return int(v)
        if isinstance(v, str):
            try:
                return int(v.strip() or "0", 0) if v.strip().startswith(("0x", "0X")) \
                    else int(v.strip() or "0")
            except ValueError:
                raise JSThrow(JSObject({"name": "SyntaxError",
                                        "message": f"invalid BigInt: {v}"}))
        raise JSThrow(_type_error("cannot convert to BigInt"))
    g["BigInt"] = NativeFunction("BigInt", _bigint)

    def _parse_int(this, args):
        s = js_to_string(_arg(args, 0, "")).strip()
        radix = _int_arg(args, 1, 0)
        neg = s.startswith("-")
        if s[:1] in "+-":
            s = s[1:]
        # spec: radix 0/undefined auto-detects an 0x prefix as hex
        if radix == 0:
            radix = 16 if s[:2] in ("0x", "0X") else 10
        if radix == 16 and s[:2] in ("0x", "0X"):
            s = s[2:]
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:radix]
        i = 0
        while i < len(s) and s[i].lower() in digits:
            i += 1
        if i == 0:
            return float("nan")
        v = float(int(s[:i], radix))
        return -v if neg else v
    g["parseInt"] = NativeFunction("parseInt", _parse_int)

    def _parse_float(this, args):
        s = js_to_string(_arg(args, 0, "")).strip()
        import re
        m = re.match(r"[+-]?(Infinity|\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)", s)
        if not m:
            return float("nan")
        t = m.group(0)
        if t.endswith("Infinity"):
            return float("-inf") if t[0] == "-" else float("inf")
        return float(t)
    g["parseFloat"] = NativeFunction("parseFloat", _parse_float)
    num.props["parseFloat"] = g["parseFloat"]
    num.props["parseInt"] = g["parseInt"]

    g["isNaN"] = NativeFunction("isNaN", lambda t, a: (
        lambda n: n != n)(js_to_number(_arg(a, 0, float("nan")))))
    g["isFinite"] = NativeFunction("isFinite", lambda t, a: (
        lambda n: n == n and n not in (float("inf"), float("-inf")))(
            js_to_number(_arg(a, 0, float("nan")))))

    def _promise_resolve(this, args):
        v = _arg(args, 0)
        return v if isinstance(v, JSPromise) else JSPromise(value=v)
    pr = NativeFunction("Promise", lambda t, a: JSPromise())
    pr.props = {
        "resolve": NativeFunction("resolve", _promise_resolve),
        "all": NativeFunction("all", lambda t, a: JSPromise(value=JSArray(
            [v.value if isinstance(v, JSPromise) else v
             for v in js_iter(_arg(a, 0))]))),
    }
    g["Promise"] = pr

    def _json_stringify(this, args):
        v = _arg(args, 0)
        # spec: stringify(undefined) and stringify(function) return
        # undefined, not the string "null"
        if v is UNDEF or js_typeof(v) == "function":
            return UNDEF
        return _to_json(v, engine.interp)

    def _json_parse(this, args):
        import json as _json
        try:
            data = _json.loads(js_to_string(_arg(args, 0, "")))
        except ValueError as e:
            raise JSThrow(JSObject({"name": "SyntaxError",
                                    "message": f"JSON.parse: {e}"}))

        def conv(x):
            if isinstance(x, bool):
                return x
            if isinstance(x, (int, float)):
                return float(x)
            if x is None:
                return NULL
            if isinstance(x, str):
                return x
            if isinstance(x, list):
                return JSArray([conv(i) for i in x])
            return JSObject({k: conv(v) for k, v in x.items()})
        return conv(data)

    g["JSON"] = JSObject({
        "stringify": NativeFunction("stringify", _json_stringify),
        "parse": NativeFunction("parse", _json_parse),
    })

    # the UMD factory probes these
    globalthis = JSObject()
    g["globalThis"] = globalthis
    module = JSObject({"exports": JSObject()})
    g["module"] = module
    return g


def _to_json(v, interp=None) -> str:
    import json as _json
    if isinstance(v, (bool,)):
        return "true" if v else "false"
    if isinstance(v, float):
        # spec: non-finite numbers serialize as null; -0 as 0
        return num_to_str(v) if v == v and abs(v) != float("inf") else "null"
    if isinstance(v, str):
        return _json.dumps(v)
    if v is NULL or v is UNDEF:
        return "null"
    if isinstance(v, JSArray):
        return "[" + ",".join(_to_json(x, interp) for x in v.items) + "]"
    if isinstance(v, JSTypedArray):
        return "{" + ",".join(f'"{i}":{num_to_str(float(x))}'
                              for i, x in enumerate(v.arr)) + "}"
    if isinstance(v, JSObject):
        # spec: undefined- and function-valued properties are OMITTED from
        # objects (in arrays, the fallthrough below serializes them as
        # null); accessor properties are resolved through their getters
        def _rv(k):
            pv = v.props[k]
            if interp is not None:
                pv = resolve_prop_value(interp, v, k, pv)
            return pv

        pairs = []
        for k in _ordered_keys(v.props):
            pv = _rv(k)
            if pv is UNDEF or js_typeof(pv) == "function":
                continue
            pairs.append(f"{_json.dumps(k)}:{_to_json(pv, interp)}")
        return "{" + ",".join(pairs) + "}"
    return "null"
