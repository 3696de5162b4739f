"""NN ops on a dict of checkpoint-named tensors (counterpart of
``sdtpu/ops/basic.py``).

Conventions kept from the JAX package, so both compare like with like:
  linear weight: [out, in]; conv2d weight: OIHW; activations NHWC
  norms accumulate in float32 regardless of the activation dtype
Convolutions run as NCHW views of the NHWC tensor (channels-last memory), so
no layout copy is made.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .quant import (GroupQuantTensor, LoraTensor, Q4Tensor, QuantLoraTensor, QuantTensor,
                    group_quant_matmul, q4_matmul, quant_matmul)


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def linear(x: torch.Tensor, weight, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., in], weight: [out, in] (dense, int8 QuantTensor, packed 4-bit
    Q4Tensor, GGUF-block GroupQuantTensor, or a LoraTensor / QuantLoraTensor
    with runtime LoRA factors) → [..., out].

    Runtime factors go in the JAX package's order: the base product (W8A8 or
    W8A16 for a QuantLoraTensor), then h = x·downᵀ in x's dtype, then
    y + (h·upᵀ) cast to y's dtype, then the bias.  The factors are attached
    in the compute dtype, so they are cast here only where x has another."""
    if isinstance(weight, Q4Tensor):
        y = q4_matmul(x, weight)
    elif isinstance(weight, GroupQuantTensor):
        y = group_quant_matmul(x, weight)
    elif isinstance(weight, (QuantTensor, QuantLoraTensor)):
        y = quant_matmul(x, weight)
    elif isinstance(weight, LoraTensor):
        y = F.linear(x, _as(weight.w, x.dtype))
    else:
        y = F.linear(x, _as(weight, x.dtype))
    if isinstance(weight, (LoraTensor, QuantLoraTensor)):
        h = torch.matmul(x, _as(weight.lora_down, x.dtype).T)
        y = y + _as(torch.matmul(h, _as(weight.lora_up, x.dtype).T), y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding=1, groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """NHWC conv. x: [B,H,W,C], weight: OIHW [out, in/groups, kh, kw].
    padding: int, or ((top, bottom), (left, right))."""
    xc = x.permute(0, 3, 1, 2)
    if not isinstance(padding, int):
        (pt, pb), (pl, pr) = padding
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            padding = 0
    y = F.conv2d(xc, weight.to(x.dtype), None, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def group_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """NHWC group norm over channel groups; stats in float32."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    if weight is not None:
        xf = xf * weight.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        xf = xf * weight.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        xf = xf * weight.float()
    return xf.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702x) — OpenAI CLIP-L activation."""
    return x * torch.sigmoid(1.702 * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000,
                       flip_sin_to_cos: bool = True) -> torch.Tensor:
    """Sinusoidal embedding, CompVis layout [cos | sin]: [N] → [N, dim] f32.

    Frequencies are computed on the host in f64 and rounded once; arguments
    are range-reduced mod 2π with a two-term split (Cody-Waite) before the
    f32 trig, exactly as the JAX package does."""
    half = dim // 2
    freqs = np.exp(-math.log(max_period) * np.arange(half, dtype=np.float64) / half)
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(timesteps.device)
    args = timesteps.float()[:, None] * freqs[None, :]
    two_pi = args.new_tensor(2 * math.pi)
    two_pi_hi = args.new_tensor(6.28125)  # high bits of 2π, exactly representable
    two_pi_lo = args.new_tensor(2 * math.pi - 6.28125)
    kq = torch.round(args / two_pi)
    red = (args - kq * two_pi_hi) - kq * two_pi_lo
    if flip_sin_to_cos:
        emb = torch.cat([torch.cos(red), torch.sin(red)], dim=-1)
    else:
        emb = torch.cat([torch.sin(red), torch.cos(red)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
