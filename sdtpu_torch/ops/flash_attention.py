"""Flash attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``sdtpu/ops/flash_attention.py``.  CUDA tensors run the kernel
in ``csrc/flash_attention.cu``; CPU tensors run ``plain_attention``, the same
math in plain PyTorch (the XLA softmax-attention of ``sdtpu/ops/attention.py``:
f32 scores, probabilities cast to q's dtype before P.V).

Layout [B, H, L, D]; the optional mask is an additive bias broadcastable to
[Lq, Lk] (shared across batch and heads).  ``flash_supported`` states what
the kernel takes, as the reference's does; ``ops.attention`` routes the rest
to ``plain_attention``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

# 40, 80 and 160: the SD1.5 UNet's 8 heads over 320, 640 and 1280 channels;
# 64: CLIP-L; 128: the FLUX DiT; 512: the VAE mid-block
SUPPORTED_HEAD_DIMS = (40, 64, 80, 128, 160, 512)


def plain_attention(q, k, v, mask=None, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q.k^T * scale + mask) . v with f32 scores; output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype), v.to(q.dtype))


def flash_supported(q, k, v, mask) -> bool:
    """The kernel's constraints, the reference's rule: 4-D [B,H,L,D]; a mask
    must broadcast as [Lq, Lk] (every leading dim 1)."""
    if q.dim() != 4:
        return False
    if mask is not None and mask.dim() > 2 and any(d != 1 for d in mask.shape[:-2]):
        return False
    return True


def flash_attention(q, k, v, mask=None, scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Lq,D], k/v: [B,H,Lk,D] → [B,H,Lq,D] in q.dtype.

    k and v are cast to q's dtype first, as on the TPU.  CUDA tensors launch
    the kernel (bf16 or f32, D in SUPPORTED_HEAD_DIMS) or raise.  Every launch
    counts in ``launches``; bf16 at D 512 also in ``launches_d512``, bf16 at
    D 64 (CLIP's) in ``launches_d64``, float32 in ``launches_f32``, and
    either dtype at the UNet's D 40, 80 and 160 in ``launches_d40``,
    ``launches_d80`` and ``launches_d160``."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    if q.device.type == "cpu":
        return plain_attention(q, k, v, mask=mask, scale=scale)
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError("flash_attention: batch*heads exceeds the grid limit")
    if not flash_supported(q, k, v, mask):
        raise ValueError("flash_attention: mask must broadcast as [Lq, Lk]")
    bias = None
    if mask is not None:
        bias = mask.reshape(mask.shape[-2], mask.shape[-1]).float().expand(lq, lk).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    code = _build.DTYPE_CODES[q.dtype]
    ws = None
    if d == 512:  # f32 scratch for the partial outputs of a key split, sized by the library
        ws_bytes = _build.query("sdtpu_flash_workspace_bytes", code, b * h, lq, lk, d)
        ws = torch.empty((ws_bytes // 4,), dtype=torch.float32, device=q.device) if ws_bytes else None
    _build.check_cuda("flash_attention", q, k, v, out, *(t for t in (bias, ws) if t is not None))
    _build.launch(
        "sdtpu_flash_attention", code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _build.ptr(bias), out.data_ptr(), _build.ptr(ws), b * h, lq, lk, d, float(scale),
        _build.stream_ptr(q),
    )
    flash_attention.launches += 1
    # counted apart as well: the bf16 D 512 kernel (the VAE's), bf16 D 64
    # (CLIP's) and the f32 kernel
    flash_attention.launches_d512 += d == 512 and q.dtype == torch.bfloat16
    flash_attention.launches_d64 += d == 64 and q.dtype == torch.bfloat16
    flash_attention.launches_f32 += q.dtype == torch.float32
    flash_attention.launches_d40 += d == 40
    flash_attention.launches_d80 += d == 80
    flash_attention.launches_d160 += d == 160
    return out


flash_attention.launches = flash_attention.launches_d512 = flash_attention.launches_f32 = 0
flash_attention.launches_d64 = 0
flash_attention.launches_d40 = flash_attention.launches_d80 = flash_attention.launches_d160 = 0
