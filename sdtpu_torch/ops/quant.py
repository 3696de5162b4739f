"""Quantized weights and their matmuls (counterpart of ``sdtpu/ops/quant.py``).

Three memory classes, as on the TPU:

* ``QuantTensor`` -- per-row int8 weight [out, in] with f32 scales [out]
  (the q8_0 class; ``QuantLoraTensor`` adds runtime LoRA factors to it,
  ``LoraTensor`` to a dense weight).  ``quant_matmul`` runs it as W8A8 (dynamic per-token
  int8 activations, int32 accumulation, f32 epilogue; ``quant_matmul_w8a8``)
  by default, or as W8A16 (``w8a16_matmul``: bf16 or float32 activations,
  the int8 weight widened in the tile, the row scale in the epilogue) when
  ``SDTPU_QUANT_MODE`` names another mode.
* ``Q4Tensor`` -- packed 4-bit weight with f32 scales per group of 16, 32
  or 64 along K (the q4_0 / q3_k class), run by ``q4_matmul``.
* ``GroupQuantTensor`` -- int8 weight on a GGUF checkpoint's own block grid:
  f32 scales (and, for the affine types, zeros) per group of 16 or 32 along
  K, run by ``group_quant_matmul``.

``from_host_quant`` and ``host_params_to_device`` stage a GGUF's
``sdtpu_torch.io.gguf.HostQuant`` blocks onto a device without an f32 round
trip.

Each matmul launches its Hopper kernel (``csrc/w8a8_matmul.cu``,
``csrc/q4_matmul.cu``, ``csrc/gq_matmul.cu``) for CUDA tensors and runs its
plain version for CPU tensors.  The plain W8A8 accumulates exactly (float64
products of int8 values, exact far below 2**53), so kernel and plain version
are bit-equal.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from sdtpu_torch.io.gguf import _parallel_map

from . import _build

Q4_GROUP = 64
Q4_GROUPS = (16, 32, 64)
Q4_K_MULTIPLE = 64  # the 4-bit kernel's K tile: packed rows are padded to it
Q4_MIN_K = 512  # symmetric 4-bit-range blocks with K >= this pack to Q4Tensor (JAX block_k)
Q4_WGMMA_MIN_M = 128  # q4_matmul calls with at least this many rows run the wgmma kernel (kQ4MinM)
Q4_GEMV_MAX_M = 8  # q4_matmul calls with at most this many rows run the GEMV (kQ4GemvMaxM)
# W8A8 calls with at most this many rows and K at most W8A8_GEMV_MAX_K run
# the GEMV (kW8a8GemvMaxM, kW8a8GemvMaxK: x is quantized into shared memory),
# those with at least W8A8_WGMMA_MIN_M the wgmma kernel (kWgmmaMinM), the
# rest the split-K form
W8A8_GEMV_MAX_M = 8
W8A8_GEMV_MAX_K = 16384
W8A8_WGMMA_MIN_M = 128
# K columns a stage of the split-K forms: 64 (bf16 x; kSplitBK) and W8A8's
# 128 (int8 x; kS8BK); a split takes whole stages
SPLITK_STAGE = Q4_K_MULTIPLE
W8A8_SPLITK_STAGE = 128
GQ_GROUPS = (16, 32)
# symmetric group-dequant and W8A16 bf16 calls with at most this many rows run
# the GEMV (kGqGemvMaxM), those with at least GQ_WGMMA_MIN_M the wgmma kernel
# (kGqMinM), the rest the split-K form (the affine mode: the mma.sync form);
# the library's codes for the weight's mode (csrc/gq_matmul.cu, enum WMode),
# which ``sdtpu_gq_form`` takes
GQ_GEMV_MAX_M = 8
GQ_WGMMA_MIN_M = 128
GQ_MODE_GROUP, GQ_MODE_AFFINE, GQ_MODE_ROW_SCALE = 0, 1, 2
# group_quant_matmul: symmetric bf16 calls with at least this many rows go
# through gq_matmul_ws (FLUX image tokens); M = 1 (modulation), M = 256 (text
# tokens) through gq_matmul, affine weights through gq_zero_matmul
GQ_WS_MIN_M = 512


class QuantTensor(NamedTuple):
    """int8 weight [out, in] + f32 per-output-channel scale [out]."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return tuple(self.q.shape)


class QuantLoraTensor(NamedTuple):
    """Per-row int8 weight with runtime LoRA factors (``sdtpu.ops.quant.
    QuantLoraTensor``): the int8 base stays as it is and ``linear`` adds
    (x · downᵀ) · upᵀ to its product.  down: [r, in], up: [out, r] (the ranks
    of stacked LoRAs concatenated, the multiplier folded into up), in the
    dtype they were attached in (``models.lora.apply_lora``'s
    ``factor_dtype``).  ``quant_matmul`` takes it as it takes a
    ``QuantTensor``."""

    q: torch.Tensor
    scale: torch.Tensor
    lora_down: torch.Tensor
    lora_up: torch.Tensor

    @property
    def shape(self):
        return tuple(self.q.shape)


class LoraTensor(NamedTuple):
    """Dense weight with runtime LoRA factors (``sdtpu.ops.quant.LoraTensor``,
    ``--lora-apply-mode at_runtime`` on an unquantized base): w stays as it
    is; down [r, in] and up [out, r] as in ``QuantLoraTensor``."""

    w: torch.Tensor
    lora_down: torch.Tensor
    lora_up: torch.Tensor

    @property
    def shape(self):
        return tuple(self.w.shape)

    @property
    def dtype(self):
        return self.w.dtype

    @property
    def ndim(self):
        return self.w.ndim


@dataclasses.dataclass(frozen=True)
class Q4Tensor:
    """4-bit packed weight, logical shape [N, k].

    packed: uint8 [N, Kp/2] -- byte j of a row holds k = 2j in the low nibble
      and k = 2j + 1 in the high nibble (values are nibble - 8).
    scale:  f32 [N, Kp/group] -- symmetric per-(row, K-group) scales.
    Kp is k padded to a multiple of 64 (the kernel's K tile); padded weights
    are zero.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    group: int = Q4_GROUP

    @property
    def shape(self):
        return (self.packed.shape[0], self.k)


@dataclasses.dataclass(frozen=True)
class GroupQuantTensor:
    """int8 weight on a GGUF checkpoint's block grid, logical shape [N, k].

    q:     int8 [N, Kp]          (Kp = k padded to a multiple of ``group``)
    scale: f32  [N, Kp / group]
    zero:  f32  [N, Kp / group] or None

    value[n, j] = q[n, j] · scale[n, j // group] − zero[n, j // group]

    The JAX package stores the transpose ([Kp, N]) for Mosaic; rows of K
    are what the Hopper kernel reads, as for the other classes.
    """

    q: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    k: int
    group: int = 32

    @property
    def shape(self):
        return (self.q.shape[0], self.k)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    # true division by a tensor: dividing a CUDA tensor by a Python number
    # multiplies by its reciprocal, which is not bit-equal to x / s
    return a / a.new_tensor(b)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int [N, Kp] in [-8, 7] → uint8 [N, Kp/2], even k in the low nibble."""
    u = (q.to(torch.int16) + 8)
    return (u[:, 0::2] | (u[:, 1::2] << 4)).to(torch.uint8).contiguous()


def quantize_q4(w: torch.Tensor, group: int = Q4_GROUP) -> Q4Tensor:
    """float [N, K] → packed 4-bit with per-group scales (amax / 7)."""
    if group not in Q4_GROUPS:
        raise ValueError(f"quantize_q4: group {group} not in {Q4_GROUPS}")
    w = w.float()
    n, k = w.shape
    kp = _round_up(k, Q4_K_MULTIPLE)
    if kp != k:
        w = torch.nn.functional.pad(w, (0, kp - k))
    g = w.reshape(n, kp // group, group)
    scale = _div(g.abs().amax(dim=2), 7.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(g / scale[:, :, None]), -8, 7).reshape(n, kp)
    return Q4Tensor(packed=_pack_nibbles(q), scale=scale.contiguous(), k=k, group=group)


def dequantize_q4(qt: Q4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """→ dense logical [N, k]."""
    n = qt.packed.shape[0]
    p = qt.packed.to(torch.int16)
    q = torch.stack([(p & 0xF) - 8, (p >> 4) - 8], dim=-1).reshape(n, -1)
    s = qt.scale.repeat_interleave(qt.group, dim=1)
    return (q.float() * s)[:, : qt.k].to(dtype)


def quantize_group(w: torch.Tensor, group: int = 32) -> GroupQuantTensor:
    """float [N, K] → symmetric int8 with per-(row, K-group) scales on the
    ggml q8_0 grid (amax / 127 per group), as ``sdtpu.ops.quant.quantize_group``."""
    w = w.float()
    n, k = w.shape
    kp = _round_up(k, group)
    if kp != k:
        w = torch.nn.functional.pad(w, (0, kp - k))
    g = w.reshape(n, kp // group, group)
    scale = _div(g.abs().amax(dim=2), 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(g / scale[:, :, None]), -127, 127).to(torch.int8)
    return GroupQuantTensor(q=q.reshape(n, kp), scale=scale.contiguous(), zero=None, k=k,
                            group=group)


def dequantize_group(qt: GroupQuantTensor, dtype=torch.float32) -> torch.Tensor:
    """→ dense logical [N, k]: q·scale − zero in float32, then one rounding."""
    w = qt.q.float() * qt.scale.repeat_interleave(qt.group, dim=1)
    if qt.zero is not None:
        w = w - qt.zero.repeat_interleave(qt.group, dim=1)
    return w[:, : qt.k].to(dtype)


QUANTIZE_MIN_SIZE = 1 << 16  # elements a 2-D weight needs to be quantized


def quantize_params(params: dict, bits: int = 8) -> dict:
    """Quantize every large 2-D weight of a param dict, as
    ``sdtpu.ops.quant.quantize_params`` does: bits=8 → per-row int8
    ``QuantTensor`` (the q8_0 class, ``quantize_per_channel``), bits=4 →
    packed 4-bit ``Q4Tensor`` at group 64 (``quantize_q4``: the JAX
    function's nibbles and scales; its K padded to the port's 64-wide tile
    where the JAX one pads to its 512-wide Mosaic tile, zero weights either
    way, as ``from_jax_params`` repacks a JAX one).  A weight qualifies when it
    is 2-D, named ``*.weight`` and holds at least ``QUANTIZE_MIN_SIZE``
    elements; every other entry comes back as it was.  Each weight is
    quantized on its own device."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = {}
    for name, v in params.items():
        if (isinstance(v, torch.Tensor) and v.ndim == 2 and v.numel() >= QUANTIZE_MIN_SIZE
                and name.endswith(".weight")):
            out[name] = quantize_per_channel(v) if bits == 8 else quantize_q4(v, Q4_GROUP)
        else:
            out[name] = v
    return out


# ----------------------------------------------------------- GGUF staging


def _host_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _q4_0_elements(h, device) -> torch.Tensor:
    """q4_0's packed bytes (each 32-element block's byte i holding elements i
    and i + 16, stored as value + 8) → uint8 [N, K] of value + 8 in element
    order, reordered on ``device`` after the bytes have moved there."""
    p = _host_tensor(h.q, device).reshape(-1, 16)
    return torch.cat([p & 0x0F, p >> 4], dim=1).reshape(h.shape)


def host_quant_values(h, device="cuda") -> torch.Tensor:
    """A ``HostQuant``'s values as float32 on ``device``: q · scale − zero
    per group, the float32 product and difference of
    ``HostQuant.dequantize``, computed after the blocks (q4_0's still
    nibble-packed) have moved to the device."""
    q = _q4_0_elements(h, device).to(torch.int8) - 8 if h.qbits == 4 else _host_tensor(h.q, device)
    v = q.reshape(-1, h.group).float() * _host_tensor(h.scale, device).reshape(-1, 1)
    if h.zero is not None:
        v = v - _host_tensor(h.zero, device).reshape(-1, 1)
    return v.reshape(h.shape)


def from_host_quant(h, device="cuda"):
    """``sdtpu_torch.io.gguf.HostQuant`` (a checkpoint's own blocks) → ``Q4Tensor``
    or ``GroupQuantTensor`` on ``device``, with the checkpoint's integers and
    scales unchanged.

    As in the JAX package: symmetric blocks whose values fit [−8, 7] (q4_0,
    q3_k) with K >= 512 pack to 4 bits; everything else keeps int8 with its
    group scales (and zeros for the affine types).  q4_0's nibbles are
    reordered on ``device`` (``_q4_0_elements``), never widened on the
    host."""
    n, k = h.shape
    group = h.group
    if k % group:
        raise ValueError(f"K={k} not a multiple of group={group}")
    scale = h.scale.reshape(n, k // group)
    kp = _round_up(k, Q4_K_MULTIPLE)
    scale_p = np.pad(scale, ((0, 0), (0, (kp - k) // group)), constant_values=1.0)
    if h.qbits == 4 and h.zero is None and group in Q4_GROUPS and k >= Q4_MIN_K:
        e = torch.nn.functional.pad(_q4_0_elements(h, device), (0, kp - k), value=8)  # + 8: zeros
        return Q4Tensor(packed=(e[:, 0::2] | (e[:, 1::2] << 4)).contiguous(),
                        scale=_host_tensor(scale_p, device), k=k, group=group)
    q = h.unpack_q().reshape(n, k)  # element order, whatever ggml's packing was
    if h.zero is None and group in Q4_GROUPS and k >= Q4_MIN_K and q.min() >= -8 and q.max() <= 7:
        packed = _pack_nibbles(torch.from_numpy(np.pad(q, ((0, 0), (0, kp - k)))))
        return Q4Tensor(packed=packed.to(device), scale=_host_tensor(scale_p, device), k=k,
                        group=group)
    zero = None if h.zero is None else _host_tensor(h.zero.reshape(n, k // group), device)
    return GroupQuantTensor(q=_host_tensor(q, device), scale=_host_tensor(scale, device),
                            zero=zero, k=k, group=group)


def _rowwise_requant_dev(q: torch.Tensor, s: torch.Tensor, group: int):
    """int8 [n, k] on group scales [n, k/group] → per-row int8 and scales,
    with the math of ``sdtpu.ops.quant._rowwise_requant_dev``."""
    n, k = q.shape
    w = q.float().reshape(n, k // group, group) * s[:, :, None]
    amax = w.abs().reshape(n, -1).amax(dim=1)
    rs = torch.where(amax == 0, torch.ones_like(amax), _div(amax, 127.0))
    qr = torch.clamp(torch.round(w.reshape(n, k) / rs[:, None]), -127, 127)
    return qr.to(torch.int8), rs


def rowwise_requant_from_host_quant(h, device="cuda") -> QuantTensor:
    """q8_0 ``HostQuant`` → per-row ``QuantTensor``, re-quantized on ``device``
    (the host uploads only the checkpoint's int8 payload and group scales)."""
    n, k = h.shape
    q = _host_tensor(h.q.reshape(n, k), device)
    s = _host_tensor(h.scale.reshape(n, k // h.group).astype(np.float32), device)
    qr, rs = _rowwise_requant_dev(q, s, h.group)
    return QuantTensor(q=qr, scale=rs)


def host_params_to_device(params: dict, device="cuda", min_size: int = 1 << 16,
                          skip_patterns: tuple = ("embed", "norm"),
                          rowwise: bool = False) -> dict:
    """Stage a param dict holding ``HostQuant`` entries: large 2-D linear
    weights keep their checkpoint blocks on ``device`` (``GroupQuantTensor`` /
    ``Q4Tensor``), or, with ``rowwise``, q8_0 blocks are re-quantized per row
    onto the W8A8 path; other ``HostQuant``s come back dequantized as numpy
    float32, and every other entry as it was.  The eligibility rule is
    ``sdtpu.ops.quant.host_params_to_device``'s."""
    def stage_one(item):
        name, v = item
        if type(v).__name__ != "HostQuant":
            return name, v
        if (v.ndim == 2 and v.size >= min_size and name.endswith(".weight")
                and not any(s in name for s in skip_patterns)):
            if rowwise and v.type_name == "q8_0":
                return name, rowwise_requant_from_host_quant(v, device)
            return name, from_host_quant(v, device)
        return name, np.asarray(v)

    return dict(_parallel_map(stage_one, list(params.items())))


# ------------------------------------------------------------------- W8A8


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

    out[m, n] = (Σ_k xq[m, k]·wq[n, k]) · s_x[m] · s_w[n].  The library
    picks the form by shape (``sdtpu_w8a8_form``): calls of at most
    ``W8A8_GEMV_MAX_M`` rows (and K at most ``W8A8_GEMV_MAX_K``) run the
    weight-streaming GEMV, which quantizes x itself in its one launch
    (counted in ``launches_gemv``); the others quantize x per row first
    (``sdtpu_w8a8_quantize_rows``) and run the split-K form
    (``launches_splitk``: K split across a cluster's blocks, started as the
    quantize's dependent launch) or, from ``W8A8_WGMMA_MIN_M`` rows, the
    wgmma kernel (``launches_wgmma``).  Every call counts in ``launches``."""
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
    gemv = m <= W8A8_GEMV_MAX_M and k <= W8A8_GEMV_MAX_K
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    code = _build.DTYPE_CODES[x.dtype]
    stream = _build.stream_ptr(x)
    if gemv:
        xq = sx = None
        _build.check_cuda("quant_matmul_w8a8", x2, qt.q, qt.scale, out)
    else:
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        sx = torch.empty((m,), dtype=torch.float32, device=x.device)
        _build.check_cuda("quant_matmul_w8a8", x2, qt.q, qt.scale, xq, sx, out)
        _build.launch("sdtpu_w8a8_quantize_rows", code, x2.data_ptr(), xq.data_ptr(),
                      sx.data_ptr(), m, k, stream)
    _build.launch("sdtpu_w8a8_matmul", code, x2.data_ptr(), _build.ptr(xq), qt.q.data_ptr(),
                  _build.ptr(sx), qt.scale.data_ptr(), out.data_ptr(), m, n, k, stream)
    quant_matmul_w8a8.launches += 1
    quant_matmul_w8a8.launches_gemv += gemv
    quant_matmul_w8a8.launches_splitk += not gemv and m < W8A8_WGMMA_MIN_M
    quant_matmul_w8a8.launches_wgmma += m >= W8A8_WGMMA_MIN_M
    return out.reshape(*x.shape[:-1], n)


quant_matmul_w8a8.launches = quant_matmul_w8a8.launches_gemv = 0
quant_matmul_w8a8.launches_splitk = quant_matmul_w8a8.launches_wgmma = 0


# ------------------------------------------------------------------ W8A16


def w8a16_matmul_plain(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """Plain version of the W8A16 kernel: dequantize to x.dtype, then x·Wᵀ."""
    return torch.matmul(x, dequantize(qt, x.dtype).T)


def _count_form(wrapper, m: int, dtype: torch.dtype) -> None:
    """Count a launch of ``m`` rows of ``gq_matmul`` or ``w8a16_matmul`` by
    the form the library runs for it (``sdtpu_gq_form``, by dtype and
    shape): the float32 form (``launches_f32``), or for bf16 the GEMV
    (``launches_gemv``), the split-K form (``launches_splitk``) or the wgmma
    kernel (``launches_wgmma``)."""
    if dtype == torch.float32:
        wrapper.launches_f32 += 1
    elif m <= GQ_GEMV_MAX_M:
        wrapper.launches_gemv += 1
    elif m < GQ_WGMMA_MIN_M:
        wrapper.launches_splitk += 1
    else:
        wrapper.launches_wgmma += 1


def w8a16_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """W8A16: bf16 or float32 x [..., K] × int8 weight [N, K] → [..., N] in
    x.dtype.

    out[m, n] = (Σ_k x[m, k]·q[n, k]) · s[n], the sum in float32.  Each
    launch counts in ``launches`` and in its form's count (``_count_form``):
    bf16 calls of at most ``GQ_GEMV_MAX_M`` rows run the weight-streaming
    GEMV, of fewer than ``GQ_WGMMA_MIN_M`` the split-K form, the rest the
    wgmma kernel; float32 calls run the float32 form at every M."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, qt)
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"w8a16_matmul: unsupported dtype {x.dtype}")
    k = x.shape[-1]
    n = qt.q.shape[0]
    if k % 16 or qt.q.shape[1] != k:
        raise ValueError(f"w8a16_matmul: K={k} must match the weight and be a multiple of 16")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.check_cuda("w8a16_matmul", x2, qt.q, qt.scale, out)
    _build.launch("sdtpu_w8a16_matmul", _build.DTYPE_CODES[x.dtype], x2.data_ptr(),
                  qt.q.data_ptr(), qt.scale.data_ptr(), out.data_ptr(), m, n, k,
                  _build.stream_ptr(x))
    w8a16_matmul.launches += 1
    _count_form(w8a16_matmul, m, x.dtype)
    return out.reshape(*x.shape[:-1], n)


w8a16_matmul.launches = w8a16_matmul.launches_gemv = w8a16_matmul.launches_splitk = 0
w8a16_matmul.launches_wgmma = w8a16_matmul.launches_f32 = 0


def quant_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """x [..., K] × per-row int8 weight (a ``QuantTensor``, or the base of a
    ``QuantLoraTensor``) → [..., N].  ``SDTPU_QUANT_MODE``, read at each
    call as in the JAX package: ``w8a8`` (the default) runs W8A8, any other
    value W8A16."""
    if os.environ.get("SDTPU_QUANT_MODE", "w8a8") == "w8a8":
        return quant_matmul_w8a8(x, qt)
    return w8a16_matmul(x, qt)


# ------------------------------------------------------------------ 4-bit


def q4_matmul_plain(x: torch.Tensor, qt: Q4Tensor) -> torch.Tensor:
    """Plain version of the 4-bit kernel: dequantize to x.dtype, then x·Wᵀ."""
    return torch.matmul(x, dequantize_q4(qt, x.dtype).T)


def split_k_partials(x: torch.Tensor, qt, splits: int, w8a8: bool = False) -> list:
    """The K split of the split-K forms (8 < M < 128) in plain PyTorch: K
    cut into stages (``SPLITK_STAGE`` columns; W8A8's ``W8A8_SPLITK_STAGE``),
    ``ceil(stages / splits)`` whole stages a split (the last split ragged,
    empty splits dropped), and each split's partial product over its
    columns, [..., N]:

    * ``Q4Tensor`` / ``GroupQuantTensor``: x·Wᵀ with the weight dequantized
      to x.dtype, in float32;
    * ``QuantTensor`` (W8A16): x·qᵀ in float32, the row scale left to
      ``combine_splits``;
    * ``QuantTensor`` with ``w8a8``: xq·wqᵀ of x quantized per row
      (``quantize_activations``), exact, as int64 (the kernel's int32; the
      product runs in float64, exact far below 2**53, as no device sums
      int64)."""
    k = x.shape[-1]
    stage = W8A8_SPLITK_STAGE if w8a8 else SPLITK_STAGE
    if isinstance(qt, QuantTensor):
        if w8a8:
            xq, _ = quantize_activations(x)
            a, w = xq.double(), qt.q.double()
        else:
            a, w = x.float(), qt.q.float()
    else:
        w = (dequantize_q4(qt, x.dtype) if isinstance(qt, Q4Tensor)
             else dequantize_group(qt, x.dtype)).float()
        a = x.float()
    stages = -(-k // stage)
    per = -(-stages // splits) * stage  # K columns a split
    parts = [torch.matmul(a[..., c:c + per], w[:, c:c + per].T) for c in range(0, k, per)]
    return [p.long() for p in parts] if w8a8 else parts


def combine_splits(parts, dtype=torch.float32, row_scale: Optional[torch.Tensor] = None,
                   sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``split_k_partials``' splits in split order, as the kernels'
    reduction does, apply the epilogue and round once to ``dtype``: W8A8
    (``sx``, the activations' row scales [..., 1], and ``row_scale``, the
    weight's [N]) takes the int sum to float32, · s_x, then · s_w; W8A16
    (``row_scale`` alone) multiplies the float32 sum by s[n]."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    if sx is not None:
        out = out.float() * sx
    if row_scale is not None:
        out = out * row_scale
    return out.to(dtype)


def split_k_matmul(x: torch.Tensor, qt, splits: int, w8a8: bool = False,
                   keep: Optional[int] = None) -> torch.Tensor:
    """A split-K form's whole function in plain PyTorch at ``splits`` splits,
    in x.dtype: ``split_k_partials`` summed by ``combine_splits`` with the
    class's epilogue (a ``QuantTensor``: W8A8 with ``w8a8``, else W8A16).
    ``keep`` sums only the first ``keep`` splits (a fault that must show)."""
    parts = split_k_partials(x, qt, splits, w8a8)[:keep]
    if not parts:
        return torch.zeros((*x.shape[:-1], qt.shape[0]), dtype=x.dtype, device=x.device)
    if not isinstance(qt, QuantTensor):
        return combine_splits(parts, x.dtype)
    sx = quantize_activations(x)[1] if w8a8 else None
    return combine_splits(parts, x.dtype, row_scale=qt.scale, sx=sx)


def q4_matmul(x: torch.Tensor, qt: Q4Tensor) -> torch.Tensor:
    """bf16 or float32 x [..., K] × packed 4-bit weight (logical [N, K]) →
    [..., N] in x.dtype.

    The form is chosen by dtype and the row count M alone: float32 calls run
    the float32 form at every M (counted in ``launches_f32``); bf16 calls of
    at most ``Q4_GEMV_MAX_M`` rows the weight-streaming GEMV
    (``launches_gemv``), of at least ``Q4_WGMMA_MIN_M`` rows the TMA + wgmma
    kernel (``launches_wgmma``), the rest the split-K kernel
    (``launches_splitk``: K split across a cluster's blocks, reduced in
    split order inside the one launch); every launch counts in
    ``launches``."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, qt)
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"q4_matmul: unsupported dtype {x.dtype}")
    k = x.shape[-1]
    n, kp = qt.packed.shape[0], qt.packed.shape[1] * 2
    if (k != qt.k or k % 8 or k > kp or qt.group not in Q4_GROUPS or kp % Q4_K_MULTIPLE
            or qt.scale.shape != (n, kp // qt.group)):
        raise ValueError(f"q4_matmul: unsupported shape K={k}, Kp={kp}, group={qt.group}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.check_cuda("q4_matmul", x2, qt.packed, qt.scale, out)
    _build.launch("sdtpu_q4_matmul", _build.DTYPE_CODES[x.dtype], x2.data_ptr(),
                  qt.packed.data_ptr(), qt.scale.data_ptr(), out.data_ptr(), m, n, k, kp,
                  qt.group, _build.stream_ptr(x))
    q4_matmul.launches += 1
    if x.dtype == torch.float32:
        q4_matmul.launches_f32 += 1
    elif m <= Q4_GEMV_MAX_M:
        q4_matmul.launches_gemv += 1
    elif m >= Q4_WGMMA_MIN_M:
        q4_matmul.launches_wgmma += 1
    else:
        q4_matmul.launches_splitk += 1
    return out.reshape(*x.shape[:-1], n)


q4_matmul.launches = q4_matmul.launches_wgmma = q4_matmul.launches_gemv = 0
q4_matmul.launches_splitk = q4_matmul.launches_f32 = 0


# ------------------------------------------------------------- group quant


def group_quant_matmul_plain(x: torch.Tensor, qt: GroupQuantTensor) -> torch.Tensor:
    """Plain version of the group-dequant kernels: dequantize to x.dtype,
    then x·Wᵀ."""
    return torch.matmul(x, dequantize_group(qt, x.dtype).T)


def _gq_launch(name: str, wrapper, x: torch.Tensor, qt: GroupQuantTensor, dtypes) -> torch.Tensor:
    """Check what the group-dequant kernels take, allocate the output and
    launch ``name`` (the zero point is passed when the weight has one);
    raises on anything the kernel does not take."""
    if x.dtype not in dtypes:
        raise ValueError(f"{wrapper.__name__}: unsupported dtype {x.dtype}")
    k = x.shape[-1]
    n, kp = qt.q.shape
    zero = () if qt.zero is None else (qt.zero,)
    if (k != qt.k or k % 8 or k > kp or qt.group not in GQ_GROUPS or kp % qt.group
            or any(t.shape != (n, kp // qt.group) for t in (qt.scale, *zero))):
        raise ValueError(f"{wrapper.__name__}: unsupported shape K={k}, Kp={kp}, group={qt.group}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    tensors = (x2, qt.q, qt.scale, *zero, out)
    _build.check_cuda(wrapper.__name__, *tensors)
    _build.launch(name, _build.DTYPE_CODES[x.dtype], *(t.data_ptr() for t in tensors),
                  m, n, k, kp, qt.group, _build.stream_ptr(x))
    wrapper.launches += 1
    return out.reshape(*x.shape[:-1], n)


def gq_matmul(x: torch.Tensor, qt: GroupQuantTensor) -> torch.Tensor:
    """Symmetric group-dequant matmul; bf16 or float32 x [..., K] → [..., N]
    in x.dtype.  Each launch counts in ``launches`` and in its form's count
    (``_count_form``): bf16 calls of at most ``GQ_GEMV_MAX_M`` rows run the
    weight-streaming GEMV, of fewer than ``GQ_WGMMA_MIN_M`` the split-K form,
    the rest the wgmma kernel; float32 calls run the float32 form."""
    if x.device.type == "cpu":
        return group_quant_matmul_plain(x, qt)
    if qt.zero is not None:
        raise ValueError("gq_matmul: affine weights go to gq_zero_matmul")
    out = _gq_launch("sdtpu_gq_matmul", gq_matmul, x, qt, tuple(_build.DTYPE_CODES))
    _count_form(gq_matmul, x.numel() // x.shape[-1], x.dtype)
    return out


def gq_matmul_ws(x: torch.Tensor, qt: GroupQuantTensor) -> torch.Tensor:
    """Symmetric group-dequant matmul, the counterpart of the TPU's
    weight-stationary ``_gq_matmul_ws_kernel``; bf16 x [..., K] → [..., N].
    It launches the same kernels as ``gq_matmul`` (each block of the
    large-M kernel already reads its weight tile once per 256 rows) and keeps
    its own entry and launch count."""
    if x.device.type == "cpu":
        return group_quant_matmul_plain(x, qt)
    if qt.zero is not None:
        raise ValueError("gq_matmul_ws: takes symmetric weights only")
    return _gq_launch("sdtpu_gq_matmul_ws", gq_matmul_ws, x, qt, (torch.bfloat16,))


def gq_zero_matmul(x: torch.Tensor, qt: GroupQuantTensor) -> torch.Tensor:
    """Affine group-dequant matmul (value = q·scale − zero); bf16 or float32
    x [..., K] → [..., N] in x.dtype.  float32 calls are counted in
    ``launches_f32`` too, bf16 calls of fewer than ``GQ_WGMMA_MIN_M`` rows
    in ``launches_mma`` (the ``mma.sync`` form, the one the port still
    runs)."""
    if x.device.type == "cpu":
        return group_quant_matmul_plain(x, qt)
    if qt.zero is None:
        raise ValueError("gq_zero_matmul: needs a zero point")
    out = _gq_launch("sdtpu_gq_zero_matmul", gq_zero_matmul, x, qt, tuple(_build.DTYPE_CODES))
    m = x.numel() // x.shape[-1]
    gq_zero_matmul.launches_f32 += x.dtype == torch.float32
    gq_zero_matmul.launches_mma += x.dtype == torch.bfloat16 and m < GQ_WGMMA_MIN_M
    return out


gq_matmul.launches = gq_matmul.launches_gemv = gq_matmul.launches_splitk = 0
gq_matmul.launches_wgmma = gq_matmul.launches_f32 = 0
gq_matmul_ws.launches = gq_zero_matmul.launches = 0
gq_zero_matmul.launches_f32 = gq_zero_matmul.launches_mma = 0


def group_quant_matmul(x: torch.Tensor, qt: GroupQuantTensor) -> torch.Tensor:
    """x [..., K] × group-quant int8 weight (logical [N, K]) → [..., N].

    Affine weights take ``gq_zero_matmul``; symmetric bf16 calls of at least
    ``GQ_WS_MIN_M`` rows take ``gq_matmul_ws``, the rest ``gq_matmul``.  The
    two symmetric entries launch the same kernels, so the split decides only
    which count goes up."""
    if x.device.type == "cpu":
        return group_quant_matmul_plain(x, qt)
    if qt.zero is not None:
        return gq_zero_matmul(x, qt)
    m = math.prod(x.shape[:-1])
    if x.dtype == torch.bfloat16 and m >= GQ_WS_MIN_M:
        return gq_matmul_ws(x, qt)
    return gq_matmul(x, qt)
