"""onnxstream_tpu_torch — the PyTorch/CUDA port of onnxstream_tpu.

It runs the same model.txt text IR through the same Session API
(read_string / read_file -> add_tensor -> run) and WeightsProvider chain as
the JAX package, eagerly, op by op, on an explicit ``torch.device``. Attention
runs through a hand-written CUDA flash kernel for Hopper
(``kernels/csrc/flash_attention.cu``). It imports neither JAX nor
``ml_dtypes``: the JAX-free modules it shares with the JAX package (dtypes,
ir, builder, weights, fusion, the SD UNet graph) are carried here as its own.
"""

from onnxstream_tpu_torch.dtypes import DType, demangle_name, mangle_name
from onnxstream_tpu_torch.ir import Graph, OpNode, TensorSpec, parse_model_txt
from onnxstream_tpu_torch.runtime.session import Session, SessionConfig

__version__ = "0.1.0"

__all__ = [
    "DType",
    "mangle_name",
    "demangle_name",
    "TensorSpec",
    "OpNode",
    "Graph",
    "parse_model_txt",
    "Session",
    "SessionConfig",
]
