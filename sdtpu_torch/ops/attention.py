"""Attention dispatch (counterpart of ``sdtpu/ops/attention.py``).

CUDA tensors go to the flash kernel; ``flash=False`` (T5's biased attention)
and CPU tensors take the plain softmax attention.  Shapes are [B, H, L, D].
"""
from __future__ import annotations

from typing import Optional

from .flash_attention import flash_attention, plain_attention


def attention(q, k, v, mask=None, scale: Optional[float] = None,
              flash: Optional[bool] = None):
    """Scaled dot-product attention; mask is an additive bias."""
    if flash is False or q.device.type == "cpu":
        return plain_attention(q, k, v, mask=mask, scale=scale)
    return flash_attention(q, k, v, mask=mask, scale=scale)
