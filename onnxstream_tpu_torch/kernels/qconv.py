"""Calibrated W8A8 uint8 convolution: the wrapper of the hand-written CUDA kernel and its twin.

Replaces the TPU kernel ``qconv`` of ``onnxstream_tpu/kernels/qconv.py``: u8
NCHW x u8 OIHW with per-tensor (scale, zero point), group 1, the window
padded with the input zero point, the model's float bias rescaled to
accumulator units by ``1 / (a_scale * w_scale)`` and truncated toward zero
(the reference's int32 bias, onnxstream.cpp:4645-4660), then a float output
or a requantized uint8 one (onnxstream.cpp:4664-4689).

The TPU version extracts the patches in XLA and hands them to ``qmatmul``.
Here the launch is kernel 3's own (``csrc/qlinear.cu``) as an implicit GEMM:
each tile of the patch matrix is gathered from the input inside the kernel
and the output is written in NCHW, so neither the patch matrix (604 MB of
uint8 at the SD VAE's largest conv) nor a transposed output ever exists in
device memory. Which variant runs follows from the operands' layouts
(``qconv_variant``): a channels-last input and weight (``quantize_activation``
with ``channels_last``, the ``ohwi`` upload; C a multiple of 16) take the u8
``wgmma`` pipeline, whose gather copies 16 channels of a tap at a time;
NCHW / OIHW operands take the ``mma.sync`` kernel, which gathers bytes. The
shapes keep their NCHW / OIHW meaning either way.

``qconv_reference`` is the plain twin: the zero-point-shifted convolution in
float64 (exact: the sums stay below 2^53), the int32 bias and the kernel's
epilogue, so kernel and twin agree bit for bit.

On CUDA tensors ``qconv`` launches the kernel, or raises; on CPU tensors it
computes the twin. Every launch adds one to ``qconv.launches`` and, as the
launch is kernel 3's, to ``kernels.qmatmul.qmatmul.launches``. Under
``torch.func.vmap`` its batching rule folds the mapped axis into N (a
channels-last input stays channels-last): one launch a call. Like
``qmatmul`` it is a ``torch.autograd.Function`` with a ``vmap`` rule;
``qconv_impl`` launches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from onnxstream_tpu_torch.kernels import KernelFunction, closed_over, count, folded, register, unfolded
from onnxstream_tpu_torch.kernels.qmatmul import _acc_bias, _check_k, _qepilogue, _qgemm, _scales, qgemm_variant


def _geometry(x_q: torch.Tensor, w_q: torch.Tensor, strides, pads, dilations) -> Tuple[int, ...]:
    """(ho, wo) of the output; raises on what the kernel does not take."""
    if x_q.dtype != torch.uint8 or w_q.dtype != torch.uint8:
        raise TypeError(f"qconv: uint8 input and weight, got {x_q.dtype} and {w_q.dtype}")
    if x_q.ndim != 4 or w_q.ndim != 4:
        raise ValueError(f"qconv: NCHW input and OIHW weight, got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"qconv: group 1 only ({x_q.shape[1]} input channels, weight {tuple(w_q.shape)})")
    if len(strides) != 2 or len(dilations) != 2 or len(pads) != 4:
        raise ValueError("qconv: two strides, two dilations and four pads")
    _, c, h, w = x_q.shape
    _, _, kh, kw = w_q.shape
    _check_k(c * kh * kw, "qconv")
    pt, pl, pb, pr = pads  # ONNX order: top, left, bottom, right
    ho = (h + pt + pb - ((kh - 1) * dilations[0] + 1)) // strides[0] + 1
    wo = (w + pl + pr - ((kw - 1) * dilations[1] + 1)) // strides[1] + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"qconv: empty output {ho} x {wo}")
    return ho, wo


def _conv_bias(bias, a_scale: float, w_scale: float, n: int, device) -> Optional[torch.Tensor]:
    """The model's float bias in accumulator units as int32: JAX's float32
    division by ``a_scale * w_scale``, truncated toward zero
    (``qconv.py:96-98``)."""
    if bias is None:
        return None
    b = torch.as_tensor(bias, device=device).float().reshape(-1)
    d = torch.full((), float(a_scale) * float(w_scale), dtype=torch.float32, device=device)
    return _acc_bias(b / d, n, device)


def qconv_reference(x_q: torch.Tensor, w_q: torch.Tensor, a_scale: float, a_zero: int, w_scale: float,
                    w_zero: int, bias=None, strides: Sequence[int] = (1, 1),
                    pads: Sequence[int] = (0, 0, 0, 0), dilations: Sequence[int] = (1, 1),
                    out_scale: Optional[float] = None, out_zero: Optional[int] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of the conv form of kernel 3, computed in float64."""
    o = w_q.shape[0]
    _geometry(x_q, w_q, strides, pads, dilations)
    za, zw, alpha, beta = _scales(a_scale, a_zero, w_scale, w_zero, out_scale, out_zero)
    pt, pl, pb, pr = pads
    # shifted by the zero point first, so the padding is 0 = za - za
    x = F.pad(x_q.double() - za, (pl, pr, pt, pb))
    acc = F.conv2d(x, w_q.double() - zw, stride=tuple(strides), dilation=tuple(dilations))
    b = _conv_bias(bias, a_scale, w_scale, o, x_q.device)
    if b is not None:
        acc += b.double()[None, :, None, None]
    return _qepilogue(acc, alpha, beta, out_scale is not None, out_dtype)


def qconv_impl(x_q: torch.Tensor, w_q: torch.Tensor, a_scale: float, a_zero: int, w_scale: float,
               w_zero: int, bias=None, strides: Sequence[int] = (1, 1), pads: Sequence[int] = (0, 0, 0, 0),
               dilations: Sequence[int] = (1, 1), out_scale: Optional[float] = None,
               out_zero: Optional[int] = None, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``qconv`` on real tensors: the launch."""
    if not x_q.is_cuda:
        if x_q.device.type == "cpu":
            return qconv_reference(x_q, w_q, a_scale, a_zero, w_scale, w_zero, bias, strides, pads,
                                   dilations, out_scale, out_zero, out_dtype)
        raise ValueError(f"qconv runs on CUDA or CPU tensors, not {x_q.device}")
    ho, wo = _geometry(x_q, w_q, strides, pads, dilations)
    bsz, c, h, w = x_q.shape
    o, _, kh, kw = w_q.shape
    za, zw, alpha, beta = _scales(a_scale, a_zero, w_scale, w_zero, out_scale, out_zero)
    out = torch.empty((bsz, o, ho, wo), dtype=torch.uint8 if out_scale is not None else out_dtype,
                      device=x_q.device)
    if out.numel():
        nhwc = qconv_variant(x_q, w_q) == "wgmma"
        if not nhwc:  # the mma.sync kernel reads NCHW and OIHW
            x_q, w_q = x_q.contiguous(), w_q.contiguous()
        geo = (c, h, w, kh, kw, strides[0], strides[1], pads[0], pads[1], dilations[0], dilations[1], ho, wo,
               int(nhwc))
        # the weight's memory is the (N, K) B operand: (O, C kh kw), or
        # (O, kh kw C) channels-last
        _qgemm(x_q, w_q, _conv_bias(bias, a_scale, w_scale, o, x_q.device), out,
               bsz * ho * wo, c * kh * kw, o, za, zw, alpha, beta, geo)
        count("qconv")
    return out


class _QConv(KernelFunction):
    """``qconv`` with a batching rule (``vmap``): the mapped axis folded into
    N, (V, N, C, H, W) -> (V N, C, H, W), a view that keeps a channels-last
    input channels-last; one launch. No backward."""

    @staticmethod
    def forward(*args):
        return qconv_impl(*args)

    @staticmethod
    def vmap(info, in_dims, x_q, w_q, *rest):
        closed_over("qconv", (in_dims[1], in_dims[6]), ("the weight", "the bias"))
        (x_q,) = folded(info.batch_size, in_dims[:1], x_q)
        return unfolded(_QConv.apply(x_q, w_q, *rest), info.batch_size)


def qconv(x_q: torch.Tensor, w_q: torch.Tensor, a_scale: float, a_zero: int, w_scale: float,
          w_zero: int, bias=None, strides: Sequence[int] = (1, 1), pads: Sequence[int] = (0, 0, 0, 0),
          dilations: Sequence[int] = (1, 1), out_scale: Optional[float] = None,
          out_zero: Optional[int] = None, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u8 NCHW (B, C, H, W) x u8 OIHW (O, C, kh, kw) -> NCHW (B, O, Ho, Wo),
    C kh kw at most ``kernels.qmatmul.QGEMM_MAX_K``: float in ``out_dtype``, or requantized
    uint8 with ``out_scale`` / ``out_zero``. ``bias`` is the model's float (O,) vector.

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``qconv.launches`` (and to ``qmatmul.launches``); under
    ``torch.func.vmap``, one launch a call with the examples in N."""
    return _QConv.apply(x_q, w_q, a_scale, a_zero, w_scale, w_zero, bias, strides, pads, dilations, out_scale,
                        out_zero, out_dtype)


def _channels_last(t: torch.Tensor) -> bool:
    return t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last)


def qconv_variant(x_q: torch.Tensor, w_q: torch.Tensor) -> str:
    """Which kernel of ``csrc/qlinear.cu`` ``qconv`` takes for this u8 input
    and weight (``qgemm_variant``'s answer for a conv): ``"wgmma"`` where both
    are channels-last (``quantize_activation(..., channels_last=True)``, the
    ``ohwi`` upload), ``qconv_takes_nhwc`` and 16-byte aligned, else
    ``"mma"``, which reads NCHW / OIHW (copying a tensor laid out otherwise)."""
    return qgemm_variant(0, 0, w_q.shape[0], False, x_q.data_ptr(), w_q.data_ptr(), conv=True,
                         nhwc=_channels_last(x_q) and _channels_last(w_q), c=x_q.shape[1])


# its launches are kernel 3's, counted under qmatmul too (and held to the graph there)
register("qconv", qconv, ())
