"""Quantized weights and their matmuls (counterpart of ``sdtpu/ops/quant.py``).

Two memory classes, as on the TPU:

* ``QuantTensor`` -- per-row int8 weight [out, in] with f32 scales [out]
  (the q8_0 class).  ``linear`` runs it as W8A8: dynamic per-token int8
  activations, int32 accumulation, f32 epilogue (``quant_matmul_w8a8``).
* ``Q4Tensor`` -- packed 4-bit weight with f32 scales per group of 64 along K
  (the q4_0 class), run by ``q4_matmul``.

Each matmul launches its Hopper kernel (``csrc/w8a8_matmul.cu``,
``csrc/q4_matmul.cu``) for CUDA tensors and runs its plain version for CPU
tensors.  The plain W8A8 accumulates exactly (float64 products of int8
values, exact far below 2**53), so kernel and plain version are bit-equal.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import _build

Q4_GROUP = 64


class QuantTensor(NamedTuple):
    """int8 weight [out, in] + f32 per-output-channel scale [out]."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return tuple(self.q.shape)


@dataclasses.dataclass(frozen=True)
class Q4Tensor:
    """4-bit packed weight, logical shape [N, k].

    packed: uint8 [N, Kp/2] -- byte j of a row holds k = 2j in the low nibble
      and k = 2j + 1 in the high nibble (values are nibble - 8).
    scale:  f32 [N, Kp/group] -- symmetric per-(row, K-group) scales.
    Kp is k padded to a multiple of the group; padded weights are zero.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    group: int = Q4_GROUP

    @property
    def shape(self):
        return (self.packed.shape[0], self.k)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    # true division by a tensor: dividing a CUDA tensor by a Python number
    # multiplies by its reciprocal, which is not bit-equal to x / s
    return a / a.new_tensor(b)


def quantize_per_channel(w: torch.Tensor) -> QuantTensor:
    """float [out, in] → symmetric int8 with a per-row scale (amax / 127)."""
    w = w.float()
    amax = w.abs().amax(dim=1, keepdim=True)
    scale = _div(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantTensor(q=q, scale=scale.reshape(-1))


def dequantize(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.float() * qt.scale[:, None]).to(dtype)


def quantize_q4(w: torch.Tensor, group: int = Q4_GROUP) -> Q4Tensor:
    """float [N, K] → packed 4-bit with per-group scales (amax / 7)."""
    w = w.float()
    n, k = w.shape
    kp = -(-k // group) * group
    if kp != k:
        w = torch.nn.functional.pad(w, (0, kp - k))
    g = w.reshape(n, kp // group, group)
    scale = _div(g.abs().amax(dim=2), 7.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(g / scale[:, :, None]), -8, 7).to(torch.int16) + 8
    q = q.reshape(n, kp)
    packed = (q[:, 0::2] | (q[:, 1::2] << 4)).to(torch.uint8)
    return Q4Tensor(packed=packed.contiguous(), scale=scale.contiguous(), k=k, group=group)


def dequantize_q4(qt: Q4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """→ dense logical [N, k]."""
    n = qt.packed.shape[0]
    p = qt.packed.to(torch.int16)
    q = torch.stack([(p & 0xF) - 8, (p >> 4) - 8], dim=-1).reshape(n, -1)
    s = qt.scale.repeat_interleave(qt.group, dim=1)
    return (q.float() * s)[:, : qt.k].to(dtype)


def quantize_activations(x: torch.Tensor):
    """Dynamic per-row symmetric int8: [..., K] → (int8 [..., K], f32 [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax == 0, torch.ones_like(amax), _div(amax, 127.0))
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quant_matmul_w8a8_plain(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """Plain version of the W8A8 kernel: exact int sums, the same epilogue."""
    k = x.shape[-1]
    xq, sx = quantize_activations(x.reshape(-1, k))
    acc = torch.matmul(xq.double(), qt.q.double().T).float()
    out = (acc * sx * qt.scale[None, :]).to(x.dtype)
    return out.reshape(*x.shape[:-1], qt.q.shape[0])


def quant_matmul_w8a8(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """W8A8: x [..., K] × int8 weight [N, K] → [..., N] in x.dtype.

    out[m, n] = (Σ_k xq[m, k]·wq[n, k]) · s_x[m] · s_w[n]"""
    if x.device.type == "cpu":
        return quant_matmul_w8a8_plain(x, qt)
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"quant_matmul_w8a8: unsupported dtype {x.dtype}")
    k = x.shape[-1]
    n = qt.q.shape[0]
    if k % 16 or qt.q.shape[1] != k:
        raise ValueError(f"quant_matmul_w8a8: K={k} must match the weight and be a multiple of 16")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.check_cuda("quant_matmul_w8a8", x2, qt.q, qt.scale, xq, sx, out)
    code = _build.DTYPE_CODES[x.dtype]
    stream = _build.stream_ptr(x)
    _build.launch("sdtpu_w8a8_quantize_rows", code, x2.data_ptr(), xq.data_ptr(),
                  sx.data_ptr(), m, k, stream)
    _build.launch("sdtpu_w8a8_matmul", code, xq.data_ptr(), qt.q.data_ptr(), sx.data_ptr(),
                  qt.scale.data_ptr(), out.data_ptr(), m, n, k, stream)
    quant_matmul_w8a8.launches += 1
    return out.reshape(*x.shape[:-1], n)


quant_matmul_w8a8.launches = 0


def q4_matmul_plain(x: torch.Tensor, qt: Q4Tensor) -> torch.Tensor:
    """Plain version of the 4-bit kernel: dequantize to x.dtype, then x·Wᵀ."""
    return torch.matmul(x, dequantize_q4(qt, x.dtype).T)


def q4_matmul(x: torch.Tensor, qt: Q4Tensor) -> torch.Tensor:
    """x [..., K] × packed 4-bit weight (logical [N, K]) → [..., N] in x.dtype."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, qt)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"q4_matmul: the kernel takes bf16 activations, got {x.dtype}")
    k = x.shape[-1]
    n, kp = qt.packed.shape[0], qt.packed.shape[1] * 2
    if k != qt.k or k % 8 or qt.group != Q4_GROUP or kp % Q4_GROUP:
        raise ValueError(f"q4_matmul: unsupported shape K={k}, Kp={kp}, group={qt.group}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.check_cuda("q4_matmul", x2, qt.packed, qt.scale, out)
    _build.launch("sdtpu_q4_matmul", x2.data_ptr(), qt.packed.data_ptr(), qt.scale.data_ptr(),
                  out.data_ptr(), m, n, k, kp, qt.group, _build.stream_ptr(x))
    q4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


q4_matmul.launches = 0
