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

import functools
import math
from typing import Optional

import torch

from . import _build

# 40, 80 and 160: the SD1.5 UNet's 8 heads over 320, 640 and 1280 channels;
# 64: CLIP-L; 128: the FLUX DiT; 320: SDXS-0.9's one head over 320 channels;
# 512: the VAE mid-block
SUPPORTED_HEAD_DIMS = (40, 64, 80, 128, 160, 320, 512)


def plain_attention(q, k, v, mask=None, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q.k^T * scale + mask) . v with f32 scores; output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype), v.to(q.dtype))


def key_split_partials(q, k, v, mask=None, scale: Optional[float] = None, splits: int = 1,
                       tile: int = 16) -> list:
    """The key split of the float32 kernel (D 160 and 512) in plain PyTorch:
    the keys cut into ``tile``-key tiles, ``ceil(tiles / splits)`` whole
    tiles a split (the last split ragged, and empty splits dropped), each
    split an online softmax over its tiles in log2 units (scale·log2(e)
    folded into the scores).  Returns each split's (O, m, l): the
    unnormalised [..., Lq, D] output, its row max and row sum ([..., Lq, 1]),
    all float32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lk = k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * math.log2(math.e))
    if mask is not None:
        s = s + mask.float() * math.log2(math.e)
    ntiles = -(-lk // tile)
    per = -(-ntiles // splits) * tile  # keys a split
    parts = []
    for start in range(0, lk, per):
        m = s.new_full(s.shape[:-1] + (1,), -1e30)
        l = torch.zeros_like(m)
        o = s.new_zeros(s.shape[:-1] + (v.shape[-1],))
        for t in range(start, min(start + per, lk), tile):
            st = s[..., t:t + tile]
            m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(st - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.matmul(p, v[..., t:t + tile, :].float())
            m = m_new
        parts.append((o, m, l))
    return parts


def combine_key_splits(parts, dtype=torch.float32) -> torch.Tensor:
    """Merge ``key_split_partials``' splits as the combine kernel does:
    o = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s, M the largest m_s."""
    mx = functools.reduce(torch.maximum, [m for _, m, _ in parts])
    o = sum(torch.exp2(m - mx) * po for po, m, _ in parts)
    l = sum(torch.exp2(m - mx) * pl for _, m, pl in parts)
    return (o / l).to(dtype)


def flash_supported(q, k, v, mask) -> bool:
    """The kernel's constraints, the reference's rule: 4-D [B,H,L,D]; a mask
    must broadcast as [Lq, Lk] (every leading dim 1)."""
    if q.dim() != 4:
        return False
    if mask is not None and mask.dim() > 2 and any(d != 1 for d in mask.shape[:-2]):
        return False
    return True


@functools.lru_cache(maxsize=1024)
def _workspace_bytes(code: int, bh: int, lq: int, lk: int, d: int) -> int:
    """f32 scratch a call needs (0 unless the library splits its keys: bf16
    at D 320 and 512, float32 at D 160, 320 and 512), asked once per shape."""
    return _build.query("sdtpu_flash_workspace_bytes", code, bh, lq, lk, d)


def flash_attention(q, k, v, mask=None, scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Lq,D], k/v: [B,H,Lk,D] → [B,H,Lq,D] in q.dtype.

    k and v are cast to q's dtype first, as on the TPU.  CUDA tensors launch
    the kernel (bf16 or f32, D in SUPPORTED_HEAD_DIMS) or raise.  Every launch
    counts in ``launches``; bf16 at D 512 also in ``launches_d512``, bf16 at
    D 64 (CLIP's) in ``launches_d64``, float32 in ``launches_f32``, and
    either dtype at the UNet's D 40, 80, 160 and 320 in ``launches_d40``,
    ``launches_d80``, ``launches_d160`` and ``launches_d320``."""
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
    ws_bytes = _workspace_bytes(code, b * h, lq, lk, d)
    if ws_bytes:  # f32 scratch for the partial outputs of a key split, sized by the library
        ws = torch.empty((ws_bytes // 4,), dtype=torch.float32, device=q.device)
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
    flash_attention.launches_d320 += d == 320
    return out


flash_attention.launches = flash_attention.launches_d512 = flash_attention.launches_f32 = 0
flash_attention.launches_d64 = 0
flash_attention.launches_d40 = flash_attention.launches_d80 = flash_attention.launches_d160 = 0
flash_attention.launches_d320 = 0
