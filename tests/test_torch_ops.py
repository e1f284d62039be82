"""The port's op library against the JAX package, one op at a time.

Each case is a one-op model.txt graph run through the JAX Session and the
port's Session, both on the CPU, with the same seeded inputs and weights.
Tolerances: float32 rtol = atol = 1e-5; bfloat16 rtol = atol = 1e-2 (the two
frameworks round bf16 at different points). The cases of the op types that
converted ONNX graphs need (and Conv of rank 3) come from the JAX-free
tests/test_torch_ops_card.py, which also runs them on the card; a key names
its op type, and a second case of one op type its variant in brackets.
"""

import math

import numpy as np
import pytest
import torch

from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.ops import registered_ops
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

from test_torch_ops_card import OP_CASES, op_type_of
from test_torch_ops_card import op_case as _case
from test_torch_ops_card import rand as _rand
from test_torch_ops_card import rng as _rng


def _cases():
    x = _rand(2, 3, 4)
    c = {}
    c["Add"] = _case("Add", {"a": x, "b": _rand(3, 1, seed=1)}, {}, [(2, 3, 4)])
    c["Sub"] = _case("Sub", {"a": x}, {"w": _rand(4, seed=2)}, [(2, 3, 4)])
    c["Mul"] = _case("Mul", {"a": x, "b": _rand(2, 3, 4, seed=3)}, {}, [(2, 3, 4)])
    c["Div"] = _case("Div", {"a": x}, {"w": np.array([1.5], np.float32)}, [(2, 3, 4)])
    c["Pow"] = _case("Pow", {"a": x}, {"w": np.array([2.0], np.float32)}, [(2, 3, 4)])
    c["Sqrt"] = _case("Sqrt", {"a": np.abs(x) + 0.1}, {}, [(2, 3, 4)])
    c["Cos"] = _case("Cos", {"a": 3 * x}, {}, [(2, 3, 4)])
    c["Sin"] = _case("Sin", {"a": 3 * x}, {}, [(2, 3, 4)])
    c["Erf"] = _case("Erf", {"a": x}, {}, [(2, 3, 4)])
    c["Sigmoid"] = _case("Sigmoid", {"a": 2 * x}, {}, [(2, 3, 4)])
    c["Unsqueeze"] = _case("Unsqueeze", {"a": x}, {"axes": np.array([1], np.int64)}, [(2, 1, 3, 4)])
    c["Reshape"] = _case("Reshape", {"a": x}, {"shape": np.array([2, -1], np.int64)}, [(2, 12)])
    c["Transpose"] = _case("Transpose", {"a": x}, {}, [(4, 2, 3)], {"perm": "2,0,1"})
    c["Concat"] = _case("Concat", {"a": x, "b": _rand(2, 5, 4, seed=4)}, {}, [(2, 8, 4)], {"axis": 1})
    c["Split"] = _case("Split", {"a": _rand(2, 6, seed=5)}, {"split": np.array([2, 4], np.int64)},
                       [(2, 2), (2, 4)], {"axis": 1})
    c["ReduceMean"] = _case("ReduceMean", {"a": x}, {}, [(2, 3, 1)], {"axes": "-1", "keepdims": 1})
    c["InstanceNormalization"] = _case(
        "InstanceNormalization", {"a": _rand(2, 4, 10, seed=6) * 3 + 1},
        {"s": _rand(4, seed=7), "b": _rand(4, seed=8)}, [(2, 4, 10)], {"epsilon": 1e-5})
    c["MatMul"] = _case("MatMul", {"a": _rand(2, 5, 8, seed=9)},
                        {"w": _rand(8, 6, seed=10) / math.sqrt(8)}, [(2, 5, 6)])
    c["Conv"] = _case(
        "Conv", {"x": _rand(1, 3, 8, 8, seed=11)},
        {"w": _rand(4, 3, 3, 3, seed=12) / math.sqrt(27), "b": _rand(4, seed=13)}, [(1, 4, 4, 4)],
        {"dilations": "1,1", "group": 1, "kernel_shape": "3,3", "pads": "1,1,1,1", "strides": "2,2"})
    c["Resize"] = _case(
        "Resize", {"x": _rand(1, 2, 4, 4, seed=14)}, {"scales": np.array([1, 1, 2, 2], np.float32)},
        [(1, 2, 8, 8)],
        {"coordinate_transformation_mode": "asymmetric", "mode": "nearest", "nearest_mode": "floor"},
        order=["x", "", "scales"])
    # the op types the llama graphs add (models/llm/llama.py)
    c["Less"] = _case("Less", {"a": x}, {"w": _rand(4, seed=20)}, [(2, 3, 4)])
    c["Neg"] = _case("Neg", {"a": x}, {}, [(2, 3, 4)])
    c["Identity"] = _case("Identity", {"a": x}, {}, [(2, 3, 4)])
    c["Expand"] = _case("Expand", {"a": _rand(3, 1, seed=21)}, {"shape": np.array([2, 1, 4], np.int64)},
                        [(2, 3, 4)])
    # int64 ids (one negative) into a float table, as the embedding and rope lookups
    c["Gather"] = _case("Gather", {"ids": np.array([[0, 9, 3], [-1, 2, 2]], np.int64)},
                        {"table": _rand(10, 4, seed=22)}, [(2, 3, 4)], {"axis": 0},
                        order=["table", "ids"])
    c["Where"] = _case("Where", {"c": _rng(23).random((2, 3, 4)) > 0.5, "a": x},
                       {"w": np.full(1, -1e9, np.float32)}, [(2, 3, 4)])
    # KV-cache write: depth-2 int64 indices (head, position) into (heads, P, hd)
    c["ScatterND"] = _case(
        "ScatterND", {"data": _rand(4, 5, 3, seed=24), "idx": np.array([[0, 1], [3, 4], [2, 0]], np.int64),
                      "upd": _rand(3, 3, seed=25)}, {}, [(4, 5, 3)])
    # ties (rounded values): the first maximum wins, as jnp.argmax
    c["ArgMax"] = _case("ArgMax", {"a": np.round(x)}, {}, [(2, 3)], {"axis": -1, "keepdims": 0})
    h, d = 2, 8
    c["ostpu.sdpa"] = _case(
        "ostpu.sdpa", {"q": _rand(1, 16, h * d, seed=15), "k": _rand(1, 12, h * d, seed=16),
                       "v": _rand(1, 12, h * d, seed=17)}, {}, [(1, 16, h * d)],
        {"scale": 1 / math.sqrt(d), "k_transposed": 0, "causal": 0, "heads": h})
    # the fused GroupNorm ops (runtime/fusion.py): 2 groups of 4 channels, the
    # affine shaped (C, 1, 1) as the converter stores it, the conv weight tap-major
    gn = {"sg": 1 + 0.1 * _rand(2, seed=31), "sb": 0.1 * _rand(2, seed=32),
          "gamma": 1 + 0.2 * _rand(8, 1, 1, seed=33), "beta": 0.1 * _rand(8, 1, 1, seed=34)}
    xg = _rand(2, 8, 4, 4, seed=30) * 2 + 0.5
    c["ostpu.gn_silu"] = _case("ostpu.gn_silu", {"x": xg}, gn, [(2, 8, 4, 4)],
                               {"groups": 2, "epsilon": 1e-5, "silu": 1})
    c["ostpu.gn_silu_conv"] = _case(
        "ostpu.gn_silu_conv", {"x": xg},
        {**gn, "w9": _rand(9, 6, 8, seed=35) / math.sqrt(72), "bias": _rand(6, seed=36)}, [(2, 6, 4, 4)],
        {"groups": 2, "epsilon": 1e-5})
    # the small-conv rewrite's op (runtime/fusion.rewrite_smallconv): the weight in its (9 C, O) upload
    # form. The JAX package keeps such a conv a Conv op, so its side of the case is the plain Conv of
    # the same OIHW weight.
    wc, bc, xc = _rand(6, 8, 3, 3, seed=37) / math.sqrt(72), _rand(6, seed=38), _rand(2, 8, 4, 4, seed=39)
    conv_attrs = {"dilations": "1,1", "group": 1, "kernel_shape": "3,3", "pads": "1,1,1,1", "strides": "1,1"}
    jax_text, _, jax_weights = _case("Conv", {"x": xc}, {"w": wc, "bias": bc}, [(2, 6, 4, 4)], conv_attrs)
    c["ostpu.conv3x3_im2col"] = (*_case(
        "ostpu.conv3x3_im2col", {"x": xc},
        {"w9co": np.ascontiguousarray(wc.transpose(2, 3, 1, 0).reshape(72, 6)), "bias": bc}, [(2, 6, 4, 4)]),
        jax_text, jax_weights)
    c.update(OP_CASES)
    return c


CASES = _cases()


def test_cases_cover_exactly_the_ported_ops():
    assert sorted({op_type_of(k) for k in CASES}) == registered_ops()


def test_layout_pass_ops_are_refused():
    """The two op types only the channel-last layout pass emits, and any op
    that pass rewrote (layout:NHWC), raise until the pass is ported."""
    for op_type in ("ostpu.groupnorm", "ostpu.reshape"):
        assert op_type not in registered_ops()
    for key, attrs in (("MaxPool", {"kernel_shape": "2,2", "layout": "NHWC"}),
                       ("GlobalAveragePool", {"layout": "NHWC"})):
        text, inputs, _ = _case(key, {"a": _rand(1, 4, 4, 2)}, {}, [(1, 2, 2, 2)], attrs)
        ps = Session(SessionConfig(device=torch.device("cpu")), weights_provider=DictWeightsProvider({}))
        ps.read_string(text)
        ps.add_tensor("a", _rand(1, 4, 4, 2))
        with pytest.raises(Exception, match="Queue 1 item 7"):
            ps.run()


def test_maxpool_dilations_are_refused_as_in_jax():
    text, inputs, _ = _case("MaxPool", {"a": _rand(1, 2, 6, 6)}, {}, [(1, 2, 2, 2)],
                            {"kernel_shape": "3,3", "strides": "2,2", "dilations": "2,2"})
    ps = Session(SessionConfig(device=torch.device("cpu")), weights_provider=DictWeightsProvider({}))
    ps.read_string(text)
    ps.add_tensor("a", inputs["a"])
    with pytest.raises(Exception, match="dilations"):
        ps.run()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax(op_type, dtype):
    text, inputs, weights, *jax_side = CASES[op_type]
    jax_text, jax_weights = jax_side or (text, weights)  # an op only the port has names its JAX graph
    js = JaxSession(JaxConfig(compute_dtype=dtype), weights_provider=JaxDict(dict(jax_weights)))
    js.read_string(jax_text)
    ps = Session(SessionConfig(compute_dtype=dtype, device=torch.device("cpu")),
                 weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    ps.read_string(text)
    for name, arr in inputs.items():
        js.add_tensor(name, arr)
        ps.add_tensor(name, arr)
    want, got = js.run(), ps.run()
    assert sorted(got) == sorted(want)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=tol)
