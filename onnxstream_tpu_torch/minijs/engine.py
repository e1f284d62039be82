"""minijs Engine — the host-facing wrapper.

    eng = Engine()
    eng.run_file("onnxstream_tpu_torch/api/interp.js")
    InterpModel = eng.global_get("InterpModel")
    model = eng.await_(eng.call_method(InterpModel, "create"))
    eng.call_method(model, "read_string", model_txt)

Python<->JS marshalling: str/bool pass through; Python int/float -> JS
number; list -> JSArray (recursively); dict -> JSObject; 1-D numpy
float32/int64 arrays -> Float32Array/BigInt64Array (shared memory, no copy).
"""

from typing import Any

import numpy as np

from .errors import MiniJsError
from .interp import Interp, Scope
from .parser import parse
from .runtime import JSArrayBuffer, make_globals
from .values import (
    NULL, UNDEF, JSArray, JSMap, JSObject, JSPromise, JSSet, JSTypedArray,
)

_TA_BY_DTYPE = {
    np.dtype(np.float32): "Float32Array",
    np.dtype(np.float64): "Float64Array",
    np.dtype(np.int32): "Int32Array",
    np.dtype(np.uint8): "Uint8Array",
    np.dtype(np.int64): "BigInt64Array",
}


class Engine:
    def __init__(self):
        self.console_lines: list = []
        self.scope = Scope()
        self.interp = Interp(self.scope)
        for name, val in make_globals(self).items():
            self.scope.declare(name, val)

    # ----------------------------------------------------------- execution
    def run(self, source: str) -> None:
        ast = parse(source)
        self.interp.exec_block(ast[1], self.scope, UNDEF)

    def run_file(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            self.run(f.read())

    def eval(self, source: str) -> Any:
        """Evaluate a single expression and return its JS value."""
        from .parser import Parser

        p = Parser(source)
        e = p.parse_expression()
        if not p.at("eof"):
            raise MiniJsError("trailing tokens after expression")
        return self.interp.eval(e, self.scope, UNDEF)

    # ------------------------------------------------------------- plumbing
    def global_get(self, name: str) -> Any:
        gt = self.scope.vars.get("globalThis")
        if isinstance(gt, JSObject) and name in gt.props:
            return gt.props[name]
        mod = self.scope.vars.get("module")
        if isinstance(mod, JSObject):
            exp = mod.props.get("exports")
            if isinstance(exp, JSObject) and name in exp.props:
                return exp.props[name]
        return self.scope.lookup(name)

    def get(self, obj: Any, name: str) -> Any:
        from . import runtime

        return runtime.get_prop(self.interp, obj, name)

    def call(self, fn: Any, *args, this=UNDEF) -> Any:
        return self.interp.call(fn, this, [self.to_js(a) for a in args])

    def call_method(self, obj: Any, name: str, *args) -> Any:
        fn = self.get(obj, name)
        return self.interp.call(fn, obj, [self.to_js(a) for a in args])

    def construct(self, ctor: Any, *args) -> Any:
        return self.interp.construct(ctor, [self.to_js(a) for a in args])

    def await_(self, v: Any) -> Any:
        if isinstance(v, JSPromise):
            if v.error is not None:
                raise v.error
            return v.value
        return v

    # ---------------------------------------------------------- marshalling
    def to_js(self, v: Any) -> Any:
        if v is None:
            return NULL
        if isinstance(v, (bool, str, float)):
            return v
        if isinstance(v, int):
            return float(v)  # Python int -> JS number (use BigInt explicitly)
        if isinstance(v, np.ndarray):
            arr = np.ascontiguousarray(v).reshape(-1)
            kind = _TA_BY_DTYPE.get(arr.dtype)
            if kind is None:
                raise MiniJsError(f"no typed-array mapping for dtype {arr.dtype}")
            return JSTypedArray(kind, arr)
        if isinstance(v, (list, tuple)):
            return JSArray([self.to_js(x) for x in v])
        if isinstance(v, dict):
            return JSObject({str(k): self.to_js(x) for k, x in v.items()})
        if isinstance(v, (JSArray, JSObject, JSTypedArray, JSMap, JSSet,
                          JSArrayBuffer, JSPromise)) or v is UNDEF or v is NULL:
            return v
        return v  # functions/classes pass through

    def from_js(self, v: Any) -> Any:
        if v is UNDEF or v is NULL:
            return None
        if isinstance(v, (bool, str, float, int)):
            return v
        if isinstance(v, JSTypedArray):
            return v.arr
        if isinstance(v, JSArray):
            return [self.from_js(x) for x in v.items]
        if isinstance(v, JSObject):
            return {k: self.from_js(x) for k, x in v.props.items()}
        if isinstance(v, JSMap):
            return {k: self.from_js(x) for k, x in
                    zip(v.keys(), v.data.values())}
        if isinstance(v, JSSet):
            return set(v.values())
        return v
