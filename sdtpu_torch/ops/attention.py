"""Attention dispatch (counterpart of ``sdtpu/ops/attention.py``).

CUDA tensors go to the flash kernel where ``flash_supported`` holds (q 4-D,
a mask broadcastable as [Lq, Lk]); the rest, ``flash=False`` (T5's biased
attention) and CPU tensors take the plain softmax attention.  That is the
reference's routing rule by shape (``sdtpu/ops/attention.py``: what
``flash_supported`` refuses goes to ``_xla_attention``), not a fallback on
failure: ``flash_attention`` itself still raises on what it does not take.
Shapes are [B, H, L, D].
"""
from __future__ import annotations

from typing import Optional

from .flash_attention import flash_attention, flash_supported, plain_attention


def attention(q, k, v, mask=None, scale: Optional[float] = None,
              flash: Optional[bool] = None):
    """Scaled dot-product attention; mask is an additive bias."""
    if flash is False or q.device.type == "cpu" or not flash_supported(q, k, v, mask):
        return plain_attention(q, k, v, mask=mask, scale=scale)
    return flash_attention(q, k, v, mask=mask, scale=scale)
