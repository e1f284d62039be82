"""Session configuration.

Counterpart of ``onnxstream_tpu/runtime/config.py``. It keeps the reference
option flags the UNet, TinyLlama and SD1.5 image slices read (the calibrated
W8A8 options and the GroupNorm / small-conv kernel routes among them) and the
``set_option`` names that apply.
The TPU-only knobs (AUTO weight layouts, meshes, pipeline stages, XLA
compiler options, Pallas interpret mode) have no counterpart here.

Every option of the JAX package that the graph or the executor reads is
taken. ``use_ops_cache`` and ``use_next_op_cache`` (the reference's operator
caches) are accepted at either value and change nothing, as in the JAX
package: the port always keeps its executors (per shape bucket), their
weights and constants between runs.

``device=None`` means the first CUDA card (``default_device``); with no card
that raises, so nothing runs on the CPU unless the caller asks for it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set

import torch


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none: the
    first CUDA card. Raises when there is none; the CPU is used only when
    asked for (``torch.device("cpu")``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: onnxstream_tpu_torch runs on an NVIDIA GPU card unless the caller "
            "asks for the CPU (device=torch.device('cpu'), or --device cpu)")
    return torch.device("cuda", 0)


@dataclasses.dataclass
class SessionConfig:
    # --- reference-parity flags -------------------------------------------
    support_dynamic_shapes: bool = False  # onnxstream.h:949
    # use_fp16_arithmetic in the reference: "float16" | "bfloat16" | "float32"
    compute_dtype: str = "float32"
    fuse_ops_in_attention: bool = True  # AttentionFusedOps recognizer
    use_scaled_dp_attn_op: bool = False  # LLM SDPA recognizers
    ops_printf: bool = False  # per-op log (onnxstream.cpp:3759)
    ops_times_printf: bool = False  # cumulative per-op-type ms (onnxstream.cpp:8199)
    extra_outputs: List[str] = dataclasses.field(default_factory=list)
    weights_exclusion_set: Set[str] = dataclasses.field(default_factory=set)
    # float weights quantized at first fetch and stored as uint8 (int8 with
    # int8_symmetric_storage), dequantized on read or run by the kernels of
    # kernels/qmatmul.py (reference force_uint8_storage, onnxstream.cpp:3764)
    force_uint8_storage_set: Set[str] = dataclasses.field(default_factory=set)
    # per-output-channel (scale, zp) when force-quantizing 2-D weights (the
    # reference quantizes per tensor); consumed by w8_matmul's epilogue
    uint8_per_channel: bool = False
    # (op_type, op_name) -> bool: run that op in float32 and cast its float
    # outputs back to the compute dtype (the reference's m_requires_upcast;
    # the llama pipeline's RMSNorms)
    requires_upcast: Optional[Callable[[str, str], bool]] = None
    # W8A8: a Conv (group 1) or MatMul with a uint8 weight from the file and a
    # calibrated range runs with uint8 activations through kernels/qmatmul.py
    # qmatmul and kernels/qconv.py qconv (reference static-W8A8 MatMul and qu8
    # Conv, onnxstream.cpp:5790-5795, 4631-4689)
    use_uint8_arithmetic: bool = False
    # quantize-dequantize every pushed float intermediate to uint8 precision
    # (reference push_tensor, onnxstream.cpp:3022-3034)
    use_uint8_qdq: bool = False
    # record per-op activation ranges in run_eager (onnxstream.cpp:2983);
    # Session.run goes eager while it is set
    range_data_calibrate: bool = False
    # calibration data: op or tensor name -> (min, max) (range_data.txt)
    range_data: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    # --- port knobs --------------------------------------------------------
    # packed flash attention (kernels/flash_attention.py) at the sites the
    # size predicate picks (ops/attention.py _use_flash_packed)
    use_flash_attention: bool = True
    # absorb the head-split Reshape+Transpose around recognized attention
    # into ostpu.sdpa (packed Q/K/V), the layout the flash kernel reads
    fuse_attention_heads: bool = True
    # weights of consecutive device ops are grouped into segments whose
    # upload bytes fit this budget (0 = one segment, weights stay resident)
    hbm_budget_bytes: int = 0
    strict_shapes: bool = True  # enforce model.txt declared shapes (check_output_shape)
    # where device ops run; None = the first CUDA card (default_device)
    device: Optional[torch.device] = None
    # share resident device weights across Sessions/executors (the LLM
    # prefill and decode-bucket graphs reuse one upload); see
    # executor.SHARED_CACHE_MIN_BYTES for which weights it holds
    shared_device_weight_cache: Optional[dict] = None
    # MatMuls whose weight is 2-D uint8 (from the file or forced) run through
    # the weight-only kernel (kernels/qmatmul.w8_matmul): the weight stays 1
    # byte per element on the device and is dequantized inside the product
    use_w8_matmul: bool = True
    # store force-quantized 2-D weights as symmetric per-channel int8 (zero
    # point 0) instead of asymmetric uint8 ...
    int8_symmetric_storage: bool = False
    # ... and run their MatMuls through the dynamic-activation int8 kernel
    # (kernels/qmatmul.w8a8_dyn_matmul): activations quantize per row to s8
    # inside the launch and the dot runs s8 x s8 -> s32
    use_w8a8_dyn_matmul: bool = True

    # --- optional kernel routes, off until an A/B on the card says otherwise --
    # collapse each GroupNorm (+ SiLU) chain into one ostpu.gn_silu op
    # (kernels/gn_silu.py)
    fuse_groupnorm: bool = False
    # GroupNorm -> SiLU -> Conv3x3(s1 p1 g1) chains as one ostpu.gn_silu_conv
    # op (kernels/gn_conv.py); runs before fuse_groupnorm, which takes the rest
    fuse_gn_conv: bool = False
    # small-spatial 3x3 convs (C and O multiples of 128, H*W <= 1024) as
    # im2col + the tiled matmul kernel (kernels/matmul.py); the JAX package's
    # option name is kept
    use_pallas_smallconv: bool = False

    # --- synthetic weights (timing runs, numerically meaningless) -----------
    # big float weights (and symmetric int8 / file-quantized uint8 ones) are
    # generated on the device at fetch time instead of fetched from the
    # provider and uploaded (executor._synthesize); with the builder's
    # lazy_weights the host never materializes them either. NOT for accuracy
    # runs
    synthetic_device_weights: bool = False
    # smallest weight (in elements) that is synthesized; smaller tensors stay
    # real (they may steer control structure)
    synthetic_min_elements: int = 1 << 18

    # packed flash attention with a head dim that is not a multiple of 128
    # (the SD1.5 UNet's d = 40, 80): run the head-major kernel
    # (kernels/flash_attention.py flash_attention, kernel 2) on head-major
    # views of the packed operands instead of the packed kernel (kernel 1)
    flash_packed_nopad: bool = False
    # float weights resident in float16 under float32 compute (reference
    # onnxstream.cpp:3764); the executor casts each to float32 at its read
    force_fp16_storage: bool = False
    # channel-last graph rewrite (runtime/layout.py): 4-D activations flow
    # NHWC from the first Conv to the last
    use_nhwc_layout: bool = False
    # the reference's operator caches: accepted at either value, no effect
    use_ops_cache: bool = True
    use_next_op_cache: bool = True

    def __post_init__(self) -> None:
        self.torch_compute_dtype  # validates compute_dtype

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        dt = {"float32": torch.float32, "float16": torch.float16,
              "bfloat16": torch.bfloat16}.get(self.compute_dtype)
        if dt is None:
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype!r}")
        return dt

    # --- reference model_set_option surface (src/exports.cpp:276-301) -------
    def set_option(self, name: str, value: bool) -> None:
        mapping = {
            "use_fp16_arithmetic": lambda v: setattr(self, "compute_dtype", "float16" if v else "float32"),
            "use_bf16_arithmetic": lambda v: setattr(self, "compute_dtype", "bfloat16" if v else "float32"),
            "use_uint8_qdq": lambda v: setattr(self, "use_uint8_qdq", v),
            "use_uint8_arithmetic": lambda v: setattr(self, "use_uint8_arithmetic", v),
            "fuse_ops_in_attention": lambda v: setattr(self, "fuse_ops_in_attention", v),
            "support_dynamic_shapes": lambda v: setattr(self, "support_dynamic_shapes", v),
            "use_scaled_dp_attn_op": lambda v: setattr(self, "use_scaled_dp_attn_op", v),
            "ops_printf": lambda v: setattr(self, "ops_printf", v),
            "ops_times_printf": lambda v: setattr(self, "ops_times_printf", v),
            "use_flash_attention": lambda v: setattr(self, "use_flash_attention", v),
            "fuse_attention_heads": lambda v: setattr(self, "fuse_attention_heads", v),
            "use_w8_matmul": lambda v: setattr(self, "use_w8_matmul", v),
            "int8_symmetric_storage": lambda v: setattr(self, "int8_symmetric_storage", v),
            "use_w8a8_dyn_matmul": lambda v: setattr(self, "use_w8a8_dyn_matmul", v),
            "fuse_groupnorm": lambda v: setattr(self, "fuse_groupnorm", v),
            "fuse_gn_conv": lambda v: setattr(self, "fuse_gn_conv", v),
            "use_pallas_smallconv": lambda v: setattr(self, "use_pallas_smallconv", v),
            "flash_packed_nopad": lambda v: setattr(self, "flash_packed_nopad", v),
            "force_fp16_storage": lambda v: setattr(self, "force_fp16_storage", v),
            "use_nhwc_layout": lambda v: setattr(self, "use_nhwc_layout", v),
            "use_ops_cache": lambda v: setattr(self, "use_ops_cache", v),
            "use_next_op_cache": lambda v: setattr(self, "use_next_op_cache", v),
        }
        if name not in mapping:
            raise ValueError(f"unknown option {name!r}")
        mapping[name](bool(value))
