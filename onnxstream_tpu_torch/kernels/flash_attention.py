"""Flash attention: the hand-written CUDA kernel, its two wrappers and its twin.

One kernel, ``csrc/flash_attention.cu``, replaces both TPU flash kernels of
``onnxstream_tpu/kernels/flash_attention.py``:

  * ``flash_attention_packed`` (``_flash_call_packed`` -> ``_fa_kernel``):
    heads packed in the last dim, ``(B, L, H*D)``, no mask; with ``nopad``
    a head dim that is not a multiple of 128 goes to ``flash_attention`` on
    head-major views instead, as the JAX wrapper's ``nopad`` does;
  * ``flash_attention`` (``_flash_call`` -> ``_fa_kernel``): head-major
    ``(B, H, M, D)`` with an additive mask that broadcasts over batch and
    heads, K optionally given transposed.

The kernel reads every operand in place through strides, so unlike the TPU
wrappers it makes no padded copy of Q, K, V or the mask (the TPU wrapper's
lane padding and VMEM clamp have no meaning here). Both wrappers share one
dispatcher, which picks the variant from dtype, head dims, mask, strides and
alignment (``flash_variant`` mirrors it): 16-bit operands with 16-byte
aligned rows and K read by rows take the ``wgmma`` pipeline at head dims up
to 128 (the SD1.5 UNet's packed 8 x 40 and 8 x 80 sites, the TinyLlama
prefill) and the ``wgmma_wide`` one at 257..512 without a mask (the SD VAE's
1 x 512 site); where a packed call's query tiles leave SMs idle, its keys
are split over blocks (``flash_splits``) and the partials combined in a
fixed order.
See the source for the variants' design and what bounds them.

``flash_attention_reference`` is the plain PyTorch twin: the same function
computed in float32 with materialized scores, in the kernel's order of
operations (log2-domain scores, unnormalized probabilities cast to V's dtype
before the PV product, row sums in float32), and with the same convention
that a row with no valid key is exactly 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from onnxstream_tpu_torch.kernels import build

LOG2_E = 1.4426950408889634
MAX_HEAD_DIM = 512  # largest head dim of the packed form (the SD VAE's 1 x 512)
# largest head dim of the head-major form (masks): the kernel's d > 256 variants
# are built and checked without a mask only
HEAD_MAJOR_MAX_HEAD_DIM = 256

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _lift_mask(mask: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (1, 1, M, N); (B, M, N) -> (B, 1, M, N), the batch mask of
    ONNX models, as the TPU wrapper lifts them."""
    if mask.ndim == 2:
        return mask[None, None]
    if mask.ndim == 3:
        return mask[:, None]
    return mask


def mask_fits(mask: torch.Tensor, shape: Sequence[int]) -> bool:
    """Whether the (lifted) additive mask broadcasts to (B, H, M, N)."""
    m = _lift_mask(mask)
    return m.ndim == 4 and all(a in (1, b) for a, b in zip(m.shape, shape))


def flash_attention_reference(q, k, v, mask=None, scale: Optional[float] = None,
                              k_transposed: bool = False, causal: bool = False) -> torch.Tensor:
    """Plain twin of the kernel: q (B, H, M, D), k (B, Hkv, N, D) (or
    (B, Hkv, D, N) with ``k_transposed``), v (B, Hkv, N, Dv), an optional
    additive mask -> (B, H, M, Dv) in q's dtype, computed in float32. Rank-3
    inputs are lifted to batch 1."""
    if k_transposed:
        k = k.transpose(-1, -2)
    if q.ndim == 3:
        return flash_attention_reference(q[None], k[None], v[None], mask=mask, scale=scale,
                                         causal=causal)[0]
    b, h, m, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(h // hkv, dim=1)
    vf = v.float().repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * (scale * LOG2_E)
    if mask is not None:
        s = s + _lift_mask(mask).float() * LOG2_E
    if causal:
        row = torch.arange(m, device=q.device)[:, None]
        col = torch.arange(n, device=q.device)[None, :]
        s = s.masked_fill(col > row + (n - m), float("-inf"))
    mx = s.amax(dim=-1, keepdim=True)
    mx = torch.where(mx == float("-inf"), torch.zeros((), device=q.device), mx)
    p = torch.exp2(s - mx)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vf) / torch.where(l == 0, torch.ones((), device=q.device), l)
    return out.to(q.dtype)


def flash_attention_packed_reference(q, k, v, heads: int, scale: Optional[float] = None,
                                     causal: bool = False) -> torch.Tensor:
    """Plain twin of the packed form: q (B, M, H*D), k (B, N, Hkv*D), v (B, N,
    Hkv*Dv) -> (B, M, H*Dv) in q's dtype, computed in float32."""
    b, m, hd = q.shape
    d = hd // heads
    n = k.shape[1]
    hkv = k.shape[-1] // d
    dv = v.shape[-1] // hkv
    out = flash_attention_reference(
        q.reshape(b, m, heads, d).transpose(1, 2), k.reshape(b, n, hkv, d).transpose(1, 2),
        v.reshape(b, n, hkv, dv).transpose(1, 2), scale=scale, causal=causal)
    return out.transpose(1, 2).reshape(b, m, heads * dv)


def _head_dims_ok(d: int, dv: int, limit: int = MAX_HEAD_DIM) -> bool:
    return d % 8 == 0 and dv % 8 == 0 and 0 < d <= limit and 0 < dv <= limit


def _check_packed(q, k, v, heads: int):
    """Shapes the kernel takes in the packed form; raises on anything else.
    Returns (d, hkv, dv)."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention_packed: q, k, v must be (B, L, heads*D)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_packed: unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_packed: q, k, v on different devices")
    b, m, hd = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] != v.shape[1]:
        raise ValueError(f"flash_attention_packed: shapes {q.shape}, {k.shape}, {v.shape}")
    if hd % heads:
        raise ValueError(f"packed q width {hd} not divisible by heads {heads}")
    d = hd // heads
    if d == 0 or k.shape[-1] % d:
        raise ValueError("packed k width inconsistent with the head dim")
    hkv = k.shape[-1] // d
    if hkv == 0 or heads % hkv or v.shape[-1] % hkv:
        raise ValueError("GQA requires q_heads % kv_heads == 0 and v divisible by kv_heads")
    dv = v.shape[-1] // hkv
    if not _head_dims_ok(d, dv):
        raise ValueError(f"head dims must be multiples of 8 up to {MAX_HEAD_DIM}, got {d}, {dv}")
    return d, hkv, dv


def head_major_problem(q, k, v, mask=None, k_transposed: bool = False) -> Optional[str]:
    """Why the kernel cannot take these (B, H, M, D) operands, or None when
    it can. The one statement of the kernel's limits: ``flash_attention``
    raises with this reason and ``ops/attention.py _use_flash`` routes such
    shapes to the reference."""
    if not (q.ndim == k.ndim == v.ndim == 4):
        return f"q, k, v must be rank 4 (B, H, L, D), got ranks {q.ndim}, {k.ndim}, {v.ndim}"
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        return f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}"
    if not (q.device == k.device == v.device):
        return "q, k, v on different devices"
    b, h, m, d = q.shape
    hkv = k.shape[1]
    kd, n = (k.shape[2], k.shape[3]) if k_transposed else (k.shape[3], k.shape[2])
    dv = v.shape[-1]
    if k.shape[0] != b or v.shape[0] != b or v.shape[1] != hkv or v.shape[2] != n or kd != d:
        return f"inconsistent shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
    if hkv == 0 or h % hkv:
        return "GQA requires q_heads % kv_heads == 0"
    if not _head_dims_ok(d, dv, HEAD_MAJOR_MAX_HEAD_DIM):
        return f"head dims must be multiples of 8 up to {HEAD_MAJOR_MAX_HEAD_DIM}, got {d}, {dv}"
    if q.stride(-1) != 1 or v.stride(-1) != 1:
        return "the last dim of q and v must be contiguous"
    if mask is not None:
        if mask.dtype not in _DTYPE_CODE:
            return f"unsupported mask dtype {mask.dtype}"
        if mask.device != q.device:
            return "mask on another device"
        if not mask_fits(mask, (b, h, m, n)):
            return f"mask {tuple(mask.shape)} does not broadcast to {(b, h, m, n)}"
    return None


# (query rows, keys) of a block's tiles: the wgmma variant by its widths
# (csrc FaWgCfg: 64 keys above head dim 64), the wide one (FaWideCfg)
WGMMA_TILES = {"wgmma": (128, 128), "wgmma_wide": (64, 32)}
MAX_SPLITS = 256  # csrc kMaxSplits


def _rows_aligned16(ptrs, strides, k_by_rows: bool) -> bool:
    """csrc rows_aligned16: q, v, o (and k when read by rows) start at 16-byte
    boundaries and every batch, head and row stride is a multiple of 8
    elements. ``ptrs`` are q, k, v, o; ``strides`` the 17 of the launch."""
    q, k, v, o = ptrs
    rows = [strides[i] for i in (0, 1, 2, 7, 8, 9, 10, 11, 12)] + (list(strides[3:6]) if k_by_rows else [])
    return all(p % 16 == 0 for p in (q, v, o, *((k,) if k_by_rows else ()))) and all(x % 8 == 0 for x in rows)


def _mask_staged(mask_ptr: int, mask_dtype: torch.dtype, mask_strides, n: int) -> bool:
    """csrc mask_staged: the mask's rows are whole 16-byte pieces (unit
    column stride, 16-byte aligned start, batch / head / row strides and the
    key count multiples of 16 bytes), so the wgmma variant stages its tiles."""
    elt = mask_dtype.itemsize
    smb, smh, smm, smn = mask_strides
    return smn == 1 and mask_ptr % 16 == 0 and all(x * elt % 16 == 0 for x in (smb, smh, smm, n))


def _variant(dtype: torch.dtype, d: int, dv: int, ptrs, strides, mask_ptr: Optional[int],
             mask_dtype: Optional[torch.dtype], n: int) -> str:
    """The kernel of ``csrc/flash_attention.cu`` that a launch takes, as its
    dispatcher (``dispatch_all``) decides from the dtype, head dims, mask,
    strides and pointers."""
    k_by_rows = strides[6] == 1
    aligned = _rows_aligned16(ptrs, strides, k_by_rows)
    kd = max(d, dv)
    if dtype != torch.float32 and aligned:
        if k_by_rows and kd <= 128 and (mask_ptr is None or _mask_staged(
                mask_ptr, mask_dtype, strides[13:], n)):
            return "wgmma"
        if k_by_rows and mask_ptr is None and 256 < kd <= 512:
            return "wgmma_wide"
        if kd <= 128:
            return "mma"
    return "fma"


def flash_splits(variant: str, b: int, m: int, h: int, n: int, kd: int, sms: int) -> int:
    """The key split of an unmasked ``wgmma`` or ``wgmma_wide`` launch: as
    many splits as fill the card's ``sms`` SMs once with the variant's blocks
    of query rows (one block an SM), at most one a key tile; 1 when the query
    tiles fill the card alone, and for every other variant. ``kd`` is the
    larger head dim."""
    if variant not in WGMMA_TILES:
        return 1
    bm, bn = WGMMA_TILES[variant]
    if variant == "wgmma" and kd > 64:
        bn = 64
    q_tiles = -(-m // bm) * h * b
    return max(1, min(sms // q_tiles, -(-n // bn), MAX_SPLITS, 65535 // b))


def _launch(q, k, v, out, mask, dims, strides, scale: float, causal: bool, wgmma: bool = True,
            splits: int = 1, part: Optional[torch.Tensor] = None) -> None:
    """One launch on the current stream; raises when CUDA refuses it.
    ``wgmma=False`` keeps the wgmma variants out (timing side by side)."""
    lib = build.load("flash_attention")
    fn = lib.ostt_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])
    arr = (ctypes.c_longlong * 17)(*[int(s) for s in strides])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(int(wgmma), _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if mask is None else mask.data_ptr(),
                0 if mask is None else _DTYPE_CODE[mask.dtype], *dims, arr,
                float(scale) * LOG2_E, int(bool(causal)), splits, None if part is None else part.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"flash attention: kernel launch failed with CUDA error {rc}")


def _packed_launch(q, k, v, heads: int, d: int, dv: int):
    """(dims, strides) of a packed launch whose output is a fresh contiguous
    (B, M, heads * Dv) tensor: head h starts h * D columns into its row (head
    stride D, unit column stride)."""
    b, m, _ = q.shape
    n, hkv = k.shape[1], k.shape[-1] // d
    strides = (q.stride(0), d, q.stride(1), k.stride(0), d, k.stride(1), 1,
               v.stride(0), dv, v.stride(1), m * heads * dv, dv, heads * dv, 0, 0, 0, 0)
    return (b, m, n, heads, hkv, d, dv), strides


def _split_workspace(variant: str, dims, device: torch.device):
    """(splits, float32 workspace or None) of an unmasked launch: the key
    split over the card's SMs (``flash_splits``) and its partials."""
    if variant not in WGMMA_TILES:
        return 1, None
    b, m, n, h, _, d, dv = dims
    splits = flash_splits(variant, b, m, h, n, max(d, dv),
                          torch.cuda.get_device_properties(device).multi_processor_count)
    if splits == 1:
        return 1, None
    return splits, torch.empty(splits * b * h * m * (dv + 2), dtype=torch.float32, device=device)


def _packed_on_head_major(q, k, v, heads: int, d: int, hkv: int, dv: int, scale: float,
                          causal: bool) -> torch.Tensor:
    """The packed call through ``flash_attention`` (kernel 2) on head-major
    views of the packed operands: (B, L, H*D) seen as (B, H, L, D) with head
    stride D and row stride H*D, no copy. Raises with kernel 2's reason
    (``head_major_problem``) where it cannot take them. Kernel 2 writes the
    packed (B, M, H*Dv) output through a head-major view of it (``out``)."""
    b, m, _ = q.shape
    qh = q.unflatten(-1, (heads, d)).transpose(1, 2)
    kh = k.unflatten(-1, (hkv, d)).transpose(1, 2)
    vh = v.unflatten(-1, (hkv, dv)).transpose(1, 2)
    problem = head_major_problem(qh, kh, vh)
    if problem is not None:
        raise ValueError(f"flash_attention_packed(nopad=True): the head-major kernel cannot take "
                         f"head dims {d}, {dv}: {problem}")
    out = torch.empty((b, m, heads * dv), dtype=q.dtype, device=q.device)
    flash_attention(qh, kh, vh, scale=scale, causal=causal, out=out.unflatten(-1, (heads, dv)).transpose(1, 2))
    return out


def flash_attention_packed(q, k, v, heads: int, scale: Optional[float] = None,
                           causal: bool = False, nopad: bool = False) -> torch.Tensor:
    """Flash SDPA over packed projections: q (B, M, H*D), k (B, N, Hkv*D),
    v (B, N, Hkv*Dv) -> (B, M, H*Dv) in q's dtype. Also accepts 2-D (L, H*D).

    ``nopad`` (``SessionConfig.flash_packed_nopad``, the JAX wrapper's
    option): where a head dim is not a multiple of 128 (the SD1.5 UNet's
    d = 40 and 80), the call runs ``flash_attention`` (kernel 2) on
    head-major views of the operands instead of this kernel, and raises where
    kernel 2 cannot take them; other head dims keep this kernel.

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``flash_attention_packed.launches``."""
    if q.ndim == 2:
        return flash_attention_packed(q[None], k[None], v[None], heads, scale=scale, causal=causal,
                                      nopad=nopad)[0]
    d, hkv, dv = _check_packed(q, k, v, heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if nopad and (d % 128 or dv % 128):
        return _packed_on_head_major(q, k, v, heads, d, hkv, dv, scale, causal)
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, heads, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed runs on CUDA or CPU tensors, not {q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_packed: the last dim of q, k, v must be contiguous")
    dims, strides = _packed_launch(q, k, v, heads, d, dv)
    out = torch.empty((dims[0], dims[1], heads * dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    variant = _variant(q.dtype, d, dv, (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()), strides,
                       None, None, dims[2])
    splits, part = _split_workspace(variant, dims, q.device)
    _launch(q, k, v, out, None, dims, strides, scale, causal, splits=splits, part=part)
    flash_attention_packed.launches += 1
    return out


def _head_major_launch(q, k, v, mask, k_transposed: bool, out_strides=None):
    """(dims, strides, the mask as a (B, H, M, N) view) of a head-major launch
    whose output is a fresh contiguous (B, H, M, Dv) tensor, or has the
    (B, H, M) strides ``out_strides`` and a unit last stride."""
    b, h, m, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    n = k.shape[3] if k_transposed else k.shape[2]
    skn, skd = (k.stride(3), k.stride(2)) if k_transposed else (k.stride(2), k.stride(3))
    # a broadcast view has stride 0 on the dims the mask does not have
    m4 = None if mask is None else _lift_mask(mask).expand(b, h, m, n)
    strides = (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), skn, skd,
               v.stride(0), v.stride(1), v.stride(2), *(out_strides or (h * m * dv, m * dv, dv)),
               *((0, 0, 0, 0) if m4 is None else m4.stride()))
    return (b, m, n, h, hkv, d, dv), strides, m4


def flash_variant(q, k, v, mask=None, k_transposed: bool = False, form: str = "head_major") -> str:
    """Which kernel of ``csrc/flash_attention.cu`` a call of ``flash_attention``
    (``form="head_major"``) or ``flash_attention_packed`` (``"packed"``: the
    operands then head-major views of the packed tensors, no mask, K by rows)
    takes. Both wrappers share one dispatcher, which decides from dtype, head
    dims, mask, strides and pointers:

      * ``"wgmma"``: bf16 / fp16, head dims up to 128, K read by rows,
        16-byte aligned Q / K / V / O rows, and no mask or one whose rows are
        whole 16-byte pieces (staged by 16-byte copies);
      * ``"wgmma_wide"``: bf16 / fp16 head dims 257..512 with those rows and
        no mask;
      * ``"mma"``: bf16 / fp16, head dims up to 128, aligned rows (a K given
        transposed, a mask whose rows are not 16-byte granular);
      * ``"fma"``: everything else (float32, misaligned rows, a K given
        transposed at head dims 257..512)."""
    if form not in ("head_major", "packed"):
        raise ValueError(f"flash_variant: form is 'head_major' or 'packed', not {form!r}")
    if form == "packed" and (mask is not None or k_transposed):
        raise ValueError("flash_variant: the packed entry takes no mask and K by rows")
    if q.ndim == 3:
        q, k, v = q[None], k[None], v[None]
    dims, strides, m4 = _head_major_launch(q, k, v, mask, k_transposed)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0)  # the output is a fresh, aligned tensor
    return _variant(q.dtype, dims[5], dims[6], ptrs, strides,
                    None if m4 is None else m4.data_ptr(), None if m4 is None else m4.dtype, dims[2])


def flash_attention(q, k, v, mask=None, scale: Optional[float] = None,
                    k_transposed: bool = False, causal: bool = False,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash SDPA, head-major: q (B, H, M, D), k (B, Hkv, N, D) (or
    (B, Hkv, D, N) with ``k_transposed``), v (B, Hkv, N, Dv) -> (B, H, M, Dv)
    in q's dtype. Rank-3 (H, L, D) inputs are lifted to batch 1. ``mask`` is
    an additive mask that broadcasts to (B, H, M, N) after lifting: (M, N),
    (B, M, N) as (B, 1, M, N), (1|B, 1|H, M, N), ...; GQA when H != Hkv.
    ``out``, where given, is the (B, H, M, Dv) tensor written and returned:
    q's dtype and device, any strides with a unit last one (the nopad route
    passes a head-major view of its packed output). Which kernel variant
    runs is ``flash_variant``'s answer.

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``flash_attention.launches``."""
    if q.ndim == 3:
        return flash_attention(q[None], k[None], v[None], mask=mask, scale=scale, k_transposed=k_transposed,
                               causal=causal, out=None if out is None else out[None])[0]
    problem = head_major_problem(q, k, v, mask, k_transposed)
    if problem is not None:
        raise ValueError(f"flash_attention: {problem}")
    want = (q.shape[0], q.shape[1], q.shape[2], v.shape[-1])
    if out is not None and (tuple(out.shape) != want or out.dtype != q.dtype or out.device != q.device
                            or out.stride(-1) != 1):
        raise ValueError(f"flash_attention: out must be {want} in {q.dtype} on {q.device} with a unit last "
                         f"stride, got {tuple(out.shape)} {out.dtype} strides {out.stride()}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        ref = flash_attention_reference(q, k, v, mask=mask, scale=scale, k_transposed=k_transposed, causal=causal)
        return ref if out is None else out.copy_(ref)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    dims, strides, m4 = _head_major_launch(q, k, v, mask, k_transposed,
                                           None if out is None else out.stride()[:3])
    b, m, _, h, _, _, dv = dims
    if out is None:
        out = torch.empty((b, h, m, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _launch(q, k, v, out, m4, dims, strides, scale, causal)
    _flash_attention_counted.launches += 1
    return out


flash_attention_packed.launches = 0
flash_attention.launches = 0
# the count stays on the function defined here when something else is bound to the module's name for it
_flash_attention_counted = flash_attention
