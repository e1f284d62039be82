"""Post-hoc uint8 quantization of an already-converted text-IR graph.

Counterpart of ``onnxstream_tpu/convert/quantize.py`` on the port's ``ir``
and ``dtypes``; it writes the same text and arrays as the JAX package's.

The reference quantizes at conversion time (onnx2txt.ipynb quantize() with
per-(op,input) exclusions); this utility applies the same percentile
quantization + exclusion rules to a graph that is already in model.txt form —
the path used to produce a `vae_decoder_qu8`-style model from the fp32 one
without re-running the converter (reference ships the qu8 decoder as a
separate converted artifact, src/sd.cpp:1174-1256).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set, Tuple

import numpy as np

from onnxstream_tpu_torch.dtypes import DType
from onnxstream_tpu_torch.ir import Graph, parse_model_txt
from onnxstream_tpu_torch.runtime.quantization import quantize_weight_percentile

# (op_type, input_index) never quantized — matches convert/onnx2txt._QUANT_EXCLUDED
QUANT_EXCLUDED: Set[Tuple[str, int]] = {
    ("Conv", 2),
    ("InstanceNormalization", 1),
    ("InstanceNormalization", 2),
    ("Resize", 2),
}


def quantize_graph_weights(
    text: str,
    weights: Dict[str, np.ndarray],
    min_elements: int = 256,
    exclude_names: Optional[Iterable[str]] = None,
) -> Tuple[str, Dict[str, np.ndarray]]:
    """Quantize every eligible float32 weight of a text-IR graph to uint8.

    Returns (new model text with `uint8[scale,zp]` dtype prefixes, new weight
    dict with the quantized arrays). Weights smaller than `min_elements`, the
    excluded (op_type, input_index) pairs, non-float weights, and
    `exclude_names` stay untouched. A weight consumed by several ops is
    quantized only if EVERY consuming position is eligible (the notebook
    quantizes per-initializer, with the same effect).
    """
    g: Graph = parse_model_txt(text)
    excl = set(exclude_names or ())

    eligible: Dict[str, bool] = {}
    for op in g.ops:
        for idx, t in enumerate(op.inputs):
            if not (t.is_weight and t.name):
                continue
            ok = (
                (op.op_type, idx) not in QUANT_EXCLUDED
                and t.dtype == DType.float32
                and t.name in weights
                and np.asarray(weights[t.name]).size >= min_elements
                and t.name not in excl
            )
            eligible[t.name] = eligible.get(t.name, True) and ok

    new_weights = dict(weights)
    qparams: Dict[str, Tuple[float, int]] = {}
    for name, ok in eligible.items():
        if not ok:
            continue
        q, scale, zero = quantize_weight_percentile(np.asarray(weights[name], np.float32))
        new_weights[name] = q
        qparams[name] = (scale, zero)

    for op in g.ops:
        for t in op.inputs:
            if t.is_weight and t.name in qparams:
                t.dtype = DType.uint8
                t.scale, t.zero_point = qparams[t.name]
    return g.to_text(), new_weights


def mark_weights_uint8(
    text: str,
    shapes: Dict[str, tuple],
    min_elements: int = 256,
    exclude_names: Optional[Iterable[str]] = None,
    scale: float = 0.02 * 4.0 / 255.0,
    zero_point: int = 128,
) -> Tuple[str, list]:
    """Data-free variant of quantize_graph_weights for perf harnesses.

    Rewrites eligible weight tensor specs to `uint8[scale,zp]` WITHOUT
    touching (or even materializing) the weight data — every marked weight is
    expected to be device-synthesized, so timing-only runs of the W8A8 path
    never pay host quantization of a multi-GB checkpoint. `shapes` maps
    weight name -> shape; the same (op_type, input_index) exclusions as real
    quantization apply (converter rule, onnx2txt.ipynb). Returns
    (new_text, marked_names). NOT for accuracy runs: the synthetic (scale,
    zp) make outputs numerically meaningless.
    """
    g: Graph = parse_model_txt(text)
    excl = set(exclude_names or ())

    def _nelem(name: str) -> int:
        shp = shapes.get(name)
        return int(np.prod(shp)) if shp else 0

    eligible: Dict[str, bool] = {}
    for op in g.ops:
        for idx, t in enumerate(op.inputs):
            if not (t.is_weight and t.name):
                continue
            ok = (
                (op.op_type, idx) not in QUANT_EXCLUDED
                and t.dtype == DType.float32
                and t.name in shapes
                and _nelem(t.name) >= min_elements
                and t.name not in excl
            )
            eligible[t.name] = eligible.get(t.name, True) and ok

    marked = sorted(name for name, ok in eligible.items() if ok)
    mset = set(marked)
    for op in g.ops:
        for t in op.inputs:
            if t.is_weight and t.name in mset:
                t.dtype = DType.uint8
                t.scale, t.zero_point = float(scale), int(zero_point)
    return g.to_text(), marked
