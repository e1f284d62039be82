"""One-op graphs of the op types that converted ONNX graphs need, on the card.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu`` there). It
holds ``OP_CASES``: one-op model.txt graphs with seeded inputs and weights for
the op types the port took from the JAX registry with the Whisper and YOLO
slice, and Conv of rank 3. ``tests/test_torch_ops.py`` runs each of them
through the JAX Session and the port's Session on the CPU; the test here runs
the port's Session on the card against the port's on the CPU, and
``chip_smoke.py`` (``phase_ops``) does the same. Keys are op types; a second
case of one op type names its variant in brackets (``Gelu[tanh]``).
Tolerances on the card: float32 1e-5 * max|out|, bfloat16 1e-2 * max|out|;
integer and bool results equal.
"""

import math

import numpy as np
import pytest
import torch

from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.dtypes import DType
from onnxstream_tpu_torch.ir import Graph, OpNode, TensorSpec
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

INT64_MAX = np.iinfo(np.int64).max


def rng(seed=0):
    return np.random.default_rng(seed)


def rand(*shape, seed=0):
    return rng(seed).standard_normal(shape, dtype=np.float32)


def op_case(op_type, inputs, weights, outs, attrs=None, order=None):
    """(model.txt, graph inputs, weights) of a one-op graph. inputs: name ->
    array; weights: name -> array; outs: output shapes; order: input names
    in op order ("" for an absent optional input)."""
    specs = []
    for name in order or list(inputs) + list(weights):
        if not name:
            specs.append(TensorSpec(name=""))
        elif name in weights:
            arr = weights[name]
            specs.append(TensorSpec(name=name, shape=arr.shape, dtype=DType.from_np(arr.dtype)))
        else:
            specs.append(TensorSpec(name=name, shape=inputs[name].shape))
    op = OpNode(name=f"t/{op_type}", op_type=op_type, inputs=specs,
                outputs=[TensorSpec(name=f"y{i}", shape=tuple(s)) for i, s in enumerate(outs)],
                attrs={k: str(v) for k, v in (attrs or {}).items()})
    return Graph(ops=[op]).to_text(), inputs, weights


def op_type_of(key: str) -> str:
    return key.split("[")[0]


def _i64(*v):
    return np.array(v, np.int64)


def _op_cases():
    x = rand(2, 3, 4)
    y = rand(2, 3, 4, seed=1)
    bits = rng(2).random((2, 3, 4)) > 0.5
    c = {}
    # comparison and logic: bool out; Equal on rounded values so that ties occur
    c["Greater"] = op_case("Greater", {"a": x}, {"w": rand(4, seed=3)}, [(2, 3, 4)])
    c["Equal"] = op_case("Equal", {"a": np.round(x), "b": np.round(y)}, {}, [(2, 3, 4)])
    c["And"] = op_case("And", {"a": bits, "b": rng(4).random((2, 3, 4)) > 0.5}, {}, [(2, 3, 4)])
    c["Or"] = op_case("Or", {"a": bits, "b": rng(5).random((3, 4)) > 0.5}, {}, [(2, 3, 4)])
    c["Not"] = op_case("Not", {"a": bits}, {}, [(2, 3, 4)])
    c["Min"] = op_case("Min", {"a": x, "b": rand(3, 1, seed=6)}, {}, [(2, 3, 4)])
    c["Max"] = op_case("Max", {"a": x}, {"w": rand(4, seed=7)}, [(2, 3, 4)])
    # unary
    c["Exp"] = op_case("Exp", {"a": x}, {}, [(2, 3, 4)])
    c["Log"] = op_case("Log", {"a": np.abs(x) + 0.1}, {}, [(2, 3, 4)])
    c["Abs"] = op_case("Abs", {"a": x}, {}, [(2, 3, 4)])
    c["Tanh"] = op_case("Tanh", {"a": 2 * x}, {}, [(2, 3, 4)])
    c["Relu"] = op_case("Relu", {"a": x}, {}, [(2, 3, 4)])
    c["Floor"] = op_case("Floor", {"a": 3 * x}, {}, [(2, 3, 4)])
    c["Ceil"] = op_case("Ceil", {"a": 3 * x}, {}, [(2, 3, 4)])
    c["LeakyRelu"] = op_case("LeakyRelu", {"a": x}, {}, [(2, 3, 4)], {"alpha": 0.1})
    c["Gelu"] = op_case("Gelu", {"a": 2 * x}, {}, [(2, 3, 4)])
    c["Gelu[tanh]"] = op_case("Gelu", {"a": 2 * x}, {}, [(2, 3, 4)], {"approximate": "tanh"})
    c["HardSigmoid"] = op_case("HardSigmoid", {"a": 3 * x}, {}, [(2, 3, 4)], {"alpha": 0.3, "beta": 0.4})
    c["Clip"] = op_case("Clip", {"a": x}, {"lo": np.array([-0.5], np.float32), "hi": np.array([0.7], np.float32)},
                        [(2, 3, 4)])
    c["Clip[max_only]"] = op_case("Clip", {"a": x}, {"hi": np.array([0.2], np.float32)}, [(2, 3, 4)],
                                  order=["a", "", "hi"])
    # shape and index math (host ops, here on a device input)
    c["Squeeze"] = op_case("Squeeze", {"a": rand(2, 1, 3, 1, seed=8)}, {"axes": _i64(1, -1)}, [(2, 3)])
    c["Flatten"] = op_case("Flatten", {"a": x}, {}, [(6, 4)], {"axis": -1})
    # negative start, an end beyond the dim, a step of 2, axes as an input (one negative)
    x3 = rand(3, 7, 6, seed=9)
    c["Slice"] = op_case("Slice", {"a": x3}, {"st": _i64(-6, 1), "en": _i64(1000, 5), "ax": _i64(1, -1),
                                              "sp": _i64(2, 1)}, [(3, 3, 4)])
    c["Slice[reverse]"] = op_case("Slice", {"a": x3}, {"st": _i64(INT64_MAX, -2), "en": _i64(-1000, 1),
                                                       "ax": _i64(0, 2), "sp": _i64(-1, -2)}, [(3, 7, 2)])
    c["Shape"] = op_case("Shape", {"a": x}, {}, [(3,)])
    c["Shape[window]"] = op_case("Shape", {"a": x}, {}, [(2,)], {"start": -2})
    c["Trilu"] = op_case("Trilu", {"a": rand(2, 4, 5, seed=10)}, {}, [(2, 4, 5)])
    c["Trilu[lower_k]"] = op_case("Trilu", {"a": rand(2, 4, 5, seed=10)}, {"k": _i64(-1)}, [(2, 4, 5)],
                                  {"upper": 0})
    c["ConstantOfShape"] = op_case("ConstantOfShape", {}, {"shape": _i64(2, 3)}, [(2, 3)],
                                   {"value": "float32:1.5"})
    c["ConstantOfShape[bare]"] = op_case("ConstantOfShape", {}, {"shape": _i64(4)}, [(4,)], {"value": "2"})
    c["Range"] = op_case("Range", {}, {"s": _i64(2), "l": _i64(11), "d": _i64(3)}, [(3,)])
    # float operands are weights that the planner pins for the op: a device op
    c["Range[float]"] = op_case("Range", {}, {"s": np.array([0.5], np.float32), "l": np.array([3.0], np.float32),
                                              "d": np.array([0.75], np.float32)}, [(4,)])
    c["Cast"] = op_case("Cast", {"a": 3 * x}, {}, [(2, 3, 4)], {"to": 6})
    c["Cast[bool]"] = op_case("Cast", {"a": np.round(x)}, {}, [(2, 3, 4)], {"to": 9})
    # reductions and normalization
    c["ReduceSum"] = op_case("ReduceSum", {"a": x}, {"axes": _i64(-1, 0)}, [(3,)], {"keepdims": 0})
    c["ReduceMax"] = op_case("ReduceMax", {"a": x}, {}, [(2, 1, 4)], {"axes": "1", "keepdims": 1})
    c["Softmax"] = op_case("Softmax", {"a": 3 * x}, {}, [(2, 3, 4)], {"axis": -1})
    c["LayerNormalization"] = op_case(
        "LayerNormalization", {"a": rand(2, 3, 8, seed=11) * 2 + 0.5},
        {"s": 1 + 0.1 * rand(8, seed=12), "b": 0.1 * rand(8, seed=13)}, [(2, 3, 8)], {"axis": -1, "epsilon": 1e-5})
    c["Gemm"] = op_case("Gemm", {"a": rand(6, 4, seed=14)},
                        {"b": rand(5, 6, seed=15) / math.sqrt(6), "c": rand(5, seed=16)}, [(4, 5)],
                        {"transA": 1, "transB": 1, "alpha": 0.5, "beta": 2.0})
    # pooling: ceil_mode adds a high pad (8 -> 4 windows, not 3); the average excludes pads
    xp = rand(1, 2, 8, 8, seed=17)
    c["MaxPool"] = op_case("MaxPool", {"a": xp}, {}, [(1, 2, 4, 4)],
                           {"kernel_shape": "3,3", "strides": "2,2", "pads": "0,0,0,0", "ceil_mode": 1})
    c["AveragePool"] = op_case("AveragePool", {"a": xp}, {}, [(1, 2, 5, 5)],
                               {"kernel_shape": "3,3", "strides": "2,2", "pads": "1,1,1,1", "ceil_mode": 1})
    c["AveragePool[include_pad]"] = op_case(
        "AveragePool", {"a": xp}, {}, [(1, 2, 5, 5)],
        {"kernel_shape": "2,2", "strides": "2,2", "pads": "1,1,1,1", "count_include_pad": 1})
    c["GlobalAveragePool"] = op_case("GlobalAveragePool", {"a": rand(2, 3, 4, 5, seed=18)}, {}, [(2, 3, 1, 1)])
    # Conv1D: (O, I, k) weight, pads and strides of one spatial dim
    c["Conv[rank3]"] = op_case(
        "Conv", {"x": rand(1, 4, 10, seed=19)},
        {"w": rand(6, 4, 3, seed=20) / math.sqrt(12), "b": rand(6, seed=21)}, [(1, 6, 5)],
        {"dilations": "1", "group": 1, "kernel_shape": "3", "pads": "1,1", "strides": "2"})
    return c


OP_CASES = _op_cases()


def run_case(case, dtype: str, device) -> dict:
    """The port's Session on one case: outputs as numpy (floats as float32)."""
    text, inputs, weights = case[:3]
    s = Session(SessionConfig(compute_dtype=dtype, device=torch.device(device)),
                weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    for name, arr in inputs.items():
        s.add_tensor(name, arr)
    return s.run()


def card_agrees(got: dict, want: dict, dtype: str):
    """(ok, worst relative error): floats within 1e-5 (float32) or 1e-2
    (bfloat16) of max|want|, integers and bools equal; the same names,
    dtypes and shapes."""
    if sorted(got) != sorted(want):
        return False, math.inf
    ok, worst = True, 0.0
    for name, w in want.items():
        g = got[name]
        if g.dtype != w.dtype or g.shape != w.shape:
            return False, math.inf
        if w.dtype.kind == "f":
            top = max(float(np.abs(w).max()), 1e-30) if w.size else 1.0
            err = float(np.abs(g - w).max()) / top if w.size else 0.0
            worst = max(worst, err)
            ok = ok and np.isfinite(g).all() and err <= (1e-5 if dtype == "float32" else 1e-2)
        else:
            ok = ok and np.array_equal(g, w)
    return bool(ok), worst


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", sorted(OP_CASES))
def test_op_on_card_matches_cpu(key, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    want = run_case(OP_CASES[key], dtype, "cpu")
    got = run_case(OP_CASES[key], dtype, "cuda:0")
    ok, worst = card_agrees(got, want, dtype)
    assert ok, f"{key} {dtype}: worst relative error {worst:.3e}"
