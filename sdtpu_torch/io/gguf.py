"""GGUF checkpoint reading and writing, ggml quant blocks in vectorized numpy
(this package's copy of ``sdtpu/io/gguf.py``, numpy paths only).

Dequantization follows ggml's dequant_row_* semantics (block layouts, nibble
order, 6-bit k-quant scale packing).  ``load_gguf(keep_quant=True)`` keeps
2-D quantized tensors in their own blocks as ``HostQuant``s, which
``sdtpu_torch.ops.quant.from_host_quant`` stages onto the card without an f32
round trip.  The JAX package's threaded C extractor (``sdtpu/native``) has no
counterpart here yet: block extraction and dequantization run in numpy.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"

# ggml type ids
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = 10, 11, 12, 13, 14, 15
GGML_I8, GGML_I16, GGML_I32, GGML_I64, GGML_F64 = 24, 25, 26, 27, 28
GGML_BF16 = 30

TYPE_NAMES = {
    GGML_F32: "f32", GGML_F16: "f16", GGML_BF16: "bf16",
    GGML_Q4_0: "q4_0", GGML_Q4_1: "q4_1", GGML_Q5_0: "q5_0", GGML_Q5_1: "q5_1",
    GGML_Q8_0: "q8_0", GGML_Q2_K: "q2_k", GGML_Q3_K: "q3_k", GGML_Q4_K: "q4_k",
    GGML_Q5_K: "q5_k", GGML_Q6_K: "q6_k",
}

# (block_elems, block_bytes)
BLOCK_INFO = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2), GGML_F64: (1, 8),
    GGML_I8: (1, 1), GGML_I16: (1, 2), GGML_I32: (1, 4), GGML_I64: (1, 8),
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
    GGML_Q2_K: (256, 2 + 2 + 16 + 64),            # 84
    GGML_Q3_K: (256, 32 + 64 + 12 + 2),           # 110
    GGML_Q4_K: (256, 2 + 2 + 12 + 128),           # 144
    GGML_Q5_K: (256, 2 + 2 + 12 + 32 + 128),      # 176
    GGML_Q6_K: (256, 128 + 64 + 16 + 2),          # 210
}


def _f16(raw: np.ndarray) -> np.ndarray:
    return raw.view(np.float16).astype(np.float32)


def dequant_q4_0(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 18)
    d = _f16(b[:, :2].copy().view(np.uint8)).reshape(n_blocks, 1)
    qs = b[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d).reshape(-1)


def dequant_q4_1(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 20)
    d = _f16(b[:, :2]).reshape(n_blocks, 1)
    m = _f16(b[:, 2:4]).reshape(n_blocks, 1)
    qs = b[:, 4:]
    q = np.concatenate([(qs & 0x0F), (qs >> 4)], axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)


def dequant_q5_0(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 22)
    d = _f16(b[:, :2]).reshape(n_blocks, 1)
    qh = b[:, 2:6].copy().view(np.uint32).reshape(n_blocks, 1)
    qs = b[:, 6:]
    i = np.arange(16, dtype=np.uint32)
    lo_h = ((qh >> i) & 1) << 4
    hi_h = ((qh >> (i + 16)) & 1) << 4
    lo = ((qs & 0x0F).astype(np.int16) | lo_h.astype(np.int16)) - 16
    hi = ((qs >> 4).astype(np.int16) | hi_h.astype(np.int16)) - 16
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d).reshape(-1)


def dequant_q5_1(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 24)
    d = _f16(b[:, :2]).reshape(n_blocks, 1)
    m = _f16(b[:, 2:4]).reshape(n_blocks, 1)
    qh = b[:, 4:8].copy().view(np.uint32).reshape(n_blocks, 1)
    qs = b[:, 8:]
    i = np.arange(16, dtype=np.uint32)
    lo_h = ((qh >> i) & 1) << 4
    hi_h = ((qh >> (i + 16)) & 1) << 4
    lo = (qs & 0x0F).astype(np.uint16) | lo_h.astype(np.uint16)
    hi = (qs >> 4).astype(np.uint16) | hi_h.astype(np.uint16)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)


def dequant_q8_0(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 34)
    d = _f16(b[:, :2]).reshape(n_blocks, 1)
    q = b[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


def dequant_q2_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 84)
    scales = b[:, :16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82]).reshape(n_blocks, 1)
    dmin = _f16(b[:, 82:84]).reshape(n_blocks, 1)
    y = np.empty((n_blocks, 256), dtype=np.float32)
    is_ = 0
    for half in range(2):  # n = 0, 128
        q = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            shift = 2 * j
            for sub in range(2):
                sc = scales[:, is_].reshape(n_blocks, 1)
                is_ += 1
                dl = d * (sc & 0xF)
                ml = dmin * (sc >> 4)
                ql = (q[:, sub * 16 : sub * 16 + 16] >> shift) & 3
                y[:, half * 128 + j * 32 + sub * 16 : half * 128 + j * 32 + sub * 16 + 16] = (
                    dl * ql - ml
                )
    return y.reshape(-1)


def dequant_q3_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 110)
    hmask = b[:, :32]
    qs = b[:, 32:96]
    raw_scales = b[:, 96:108]
    d_all = _f16(b[:, 108:110]).reshape(n_blocks, 1)
    # unpack 16 6-bit scales (ggml kmask scheme)
    aux = raw_scales.copy().view(np.uint32)  # [n, 3]
    tmp = aux[:, 2].copy()
    a0 = (aux[:, 0] & 0x0F0F0F0F) | (((tmp >> 0) & 0x03030303) << 4)
    a1 = (aux[:, 1] & 0x0F0F0F0F) | (((tmp >> 2) & 0x03030303) << 4)
    a2 = ((aux[:, 0] >> 4) & 0x0F0F0F0F) | (((tmp >> 4) & 0x03030303) << 4)
    a3 = ((aux[:, 1] >> 4) & 0x0F0F0F0F) | (((tmp >> 6) & 0x03030303) << 4)
    scales = (
        np.stack([a0, a1, a2, a3], axis=1).view(np.uint8).astype(np.int16) - 32
    )  # [n, 16]
    y = np.empty((n_blocks, 256), dtype=np.float32)
    is_ = 0
    m = np.uint8(1)
    for half in range(2):
        q = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            shift = 2 * j
            for sub in range(2):
                sc = scales[:, is_].reshape(n_blocks, 1).astype(np.float32)
                is_ += 1
                dl = d_all * sc
                qseg = (q[:, sub * 16 : sub * 16 + 16] >> shift) & 3
                # hmask bytes are shared across both 128-halves; the bit
                # plane m advances through all 8 (half, j) combinations
                hseg = hmask[:, sub * 16 : sub * 16 + 16]
                hm = (hseg & m) == 0
                qv = qseg.astype(np.int16) - np.where(hm, 4, 0)
                y[:, half * 128 + j * 32 + sub * 16 : half * 128 + j * 32 + sub * 16 + 16] = (
                    dl * qv
                )
            m = np.uint8(m << 1)
    return y.reshape(-1)


def _unpack_k_scales(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ggml get_scale_min_k4: 12 bytes → 8×(6-bit scale, 6-bit min)."""
    n = scales.shape[0]
    sc = np.empty((n, 8), dtype=np.uint8)
    mn = np.empty((n, 8), dtype=np.uint8)
    for j in range(4):
        sc[:, j] = scales[:, j] & 63
        mn[:, j] = scales[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (scales[:, j + 4] & 0xF) | ((scales[:, j - 4] >> 6) << 4)
        mn[:, j] = (scales[:, j + 4] >> 4) | ((scales[:, j] >> 6) << 4)
    return sc, mn


def dequant_q4_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 144)
    d = _f16(b[:, :2]).reshape(n_blocks, 1)
    dmin = _f16(b[:, 2:4]).reshape(n_blocks, 1)
    sc, mn = _unpack_k_scales(b[:, 4:16])
    qs = b[:, 16:]
    y = np.empty((n_blocks, 256), dtype=np.float32)
    for j in range(4):  # 64-element chunks
        q = qs[:, 32 * j : 32 * j + 32]
        d1 = d * sc[:, 2 * j].reshape(n_blocks, 1)
        m1 = dmin * mn[:, 2 * j].reshape(n_blocks, 1)
        d2 = d * sc[:, 2 * j + 1].reshape(n_blocks, 1)
        m2 = dmin * mn[:, 2 * j + 1].reshape(n_blocks, 1)
        y[:, 64 * j : 64 * j + 32] = d1 * (q & 0xF) - m1
        y[:, 64 * j + 32 : 64 * j + 64] = d2 * (q >> 4) - m2
    return y.reshape(-1)


def dequant_q5_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 176)
    d = _f16(b[:, :2]).reshape(n_blocks, 1)
    dmin = _f16(b[:, 2:4]).reshape(n_blocks, 1)
    sc, mn = _unpack_k_scales(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:]
    y = np.empty((n_blocks, 256), dtype=np.float32)
    for j in range(4):
        q = qs[:, 32 * j : 32 * j + 32]
        u1, u2 = np.uint8(1 << (2 * j)), np.uint8(2 << (2 * j))
        d1 = d * sc[:, 2 * j].reshape(n_blocks, 1)
        m1 = dmin * mn[:, 2 * j].reshape(n_blocks, 1)
        d2 = d * sc[:, 2 * j + 1].reshape(n_blocks, 1)
        m2 = dmin * mn[:, 2 * j + 1].reshape(n_blocks, 1)
        y[:, 64 * j : 64 * j + 32] = d1 * ((q & 0xF) + np.where(qh & u1, 16, 0)) - m1
        y[:, 64 * j + 32 : 64 * j + 64] = d2 * ((q >> 4) + np.where(qh & u2, 16, 0)) - m2
    return y.reshape(-1)


def dequant_q6_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    b = raw.reshape(n_blocks, 210)
    ql = b[:, :128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].copy().view(np.int8)
    d = _f16(b[:, 208:210]).reshape(n_blocks, 1)
    y = np.empty((n_blocks, 256), dtype=np.float32)
    for half in range(2):
        qlh = ql[:, half * 64 : half * 64 + 64]
        qhh = qh[:, half * 32 : half * 32 + 32]
        l = np.arange(32)
        is_ = half * 8 + l // 16  # [32]
        q1 = ((qlh[:, :32] & 0xF) | (((qhh >> 0) & 3) << 4)).astype(np.int16) - 32
        q2 = ((qlh[:, 32:] & 0xF) | (((qhh >> 2) & 3) << 4)).astype(np.int16) - 32
        q3 = ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int16) - 32
        q4 = ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int16) - 32
        s = scales[np.arange(n_blocks)[:, None], is_[None, :]].astype(np.float32)
        s2 = scales[np.arange(n_blocks)[:, None], (is_ + 2)[None, :]].astype(np.float32)
        s4 = scales[np.arange(n_blocks)[:, None], (is_ + 4)[None, :]].astype(np.float32)
        s6 = scales[np.arange(n_blocks)[:, None], (is_ + 6)[None, :]].astype(np.float32)
        y[:, half * 128 : half * 128 + 32] = d * s * q1
        y[:, half * 128 + 32 : half * 128 + 64] = d * s2 * q2
        y[:, half * 128 + 64 : half * 128 + 96] = d * s4 * q3
        y[:, half * 128 + 96 : half * 128 + 128] = d * s6 * q4
    return y.reshape(-1)


# ------------------------------------------------- direct block extraction
#
# Every ggml quant format decomposes as  value = q · scale − zero  on a
# per-(block, sub-group) grid with q fitting int8.  Extracting (q, scale,
# zero) directly — instead of materializing f32 — lets the device keep the
# checkpoint's own quantization blocks end-to-end.
# Each extractor returns (q int8 [nb, 256|32], scale f32 [nb, n_sub],
# zero f32 [nb, n_sub] | None, group) in ggml element order.


def _extract_q4_0(raw, nb):
    # stays nibble-packed on the host (qbits=4): byte i of a block holds
    # elems i (lo) and i+16 (hi) as val+8 — host RSS ≈ file size
    b = raw.reshape(nb, 18)
    d = _f16(b[:, :2].copy().view(np.uint8)).reshape(nb, 1)
    return b[:, 2:].copy(), d, None, 32, 4


def _extract_q4_1(raw, nb):
    b = raw.reshape(nb, 20)
    d = _f16(b[:, :2]).reshape(nb, 1)
    m = _f16(b[:, 2:4]).reshape(nb, 1)
    qs = b[:, 4:]
    q = np.concatenate([(qs & 0x0F), (qs >> 4)], axis=1).astype(np.int8)
    return q, d, -m, 32


def _extract_q5_0(raw, nb):
    b = raw.reshape(nb, 22)
    d = _f16(b[:, :2]).reshape(nb, 1)
    qh = b[:, 2:6].copy().view(np.uint32).reshape(nb, 1)
    qs = b[:, 6:]
    i = np.arange(16, dtype=np.uint32)
    lo_h = ((qh >> i) & 1) << 4
    hi_h = ((qh >> (i + 16)) & 1) << 4
    lo = ((qs & 0x0F).astype(np.int16) | lo_h.astype(np.int16)) - 16
    hi = ((qs >> 4).astype(np.int16) | hi_h.astype(np.int16)) - 16
    return np.concatenate([lo, hi], axis=1).astype(np.int8), d, None, 32


def _extract_q5_1(raw, nb):
    b = raw.reshape(nb, 24)
    d = _f16(b[:, :2]).reshape(nb, 1)
    m = _f16(b[:, 2:4]).reshape(nb, 1)
    qh = b[:, 4:8].copy().view(np.uint32).reshape(nb, 1)
    qs = b[:, 8:]
    i = np.arange(16, dtype=np.uint32)
    lo_h = ((qh >> i) & 1) << 4
    hi_h = ((qh >> (i + 16)) & 1) << 4
    lo = (qs & 0x0F).astype(np.uint16) | lo_h.astype(np.uint16)
    hi = (qs >> 4).astype(np.uint16) | hi_h.astype(np.uint16)
    return np.concatenate([lo, hi], axis=1).astype(np.int8), d, -m, 32


def _extract_q8_0(raw, nb):
    b = raw.reshape(nb, 34)
    d = _f16(b[:, :2]).reshape(nb, 1)
    return b[:, 2:].copy().view(np.int8), d, None, 32


def _extract_q2_k(raw, nb):
    b = raw.reshape(nb, 84)
    scales = b[:, :16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82]).reshape(nb, 1)
    dmin = _f16(b[:, 82:84]).reshape(nb, 1)
    q = np.empty((nb, 256), dtype=np.int8)
    sc = np.empty((nb, 16), dtype=np.float32)
    zr = np.empty((nb, 16), dtype=np.float32)
    is_ = 0
    for half in range(2):
        qseg = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            shift = 2 * j
            for sub in range(2):
                s8 = scales[:, is_]
                sc[:, is_] = (d * (s8 & 0xF).reshape(nb, 1).astype(np.float32))[:, 0]
                zr[:, is_] = (dmin * (s8 >> 4).reshape(nb, 1).astype(np.float32))[:, 0]
                o = half * 128 + j * 32 + sub * 16
                q[:, o : o + 16] = (qseg[:, sub * 16 : sub * 16 + 16] >> shift) & 3
                is_ += 1
    return q, sc, zr, 16


def _extract_q3_k(raw, nb):
    b = raw.reshape(nb, 110)
    hmask = b[:, :32]
    qs = b[:, 32:96]
    raw_scales = b[:, 96:108]
    d_all = _f16(b[:, 108:110]).reshape(nb, 1)
    aux = raw_scales.copy().view(np.uint32)
    tmp = aux[:, 2].copy()
    a0 = (aux[:, 0] & 0x0F0F0F0F) | (((tmp >> 0) & 0x03030303) << 4)
    a1 = (aux[:, 1] & 0x0F0F0F0F) | (((tmp >> 2) & 0x03030303) << 4)
    a2 = ((aux[:, 0] >> 4) & 0x0F0F0F0F) | (((tmp >> 4) & 0x03030303) << 4)
    a3 = ((aux[:, 1] >> 4) & 0x0F0F0F0F) | (((tmp >> 6) & 0x03030303) << 4)
    scales6 = np.stack([a0, a1, a2, a3], axis=1).view(np.uint8).astype(np.int16) - 32
    q = np.empty((nb, 256), dtype=np.int8)
    sc = np.empty((nb, 16), dtype=np.float32)
    is_ = 0
    m = np.uint8(1)
    for half in range(2):
        qseg = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            shift = 2 * j
            for sub in range(2):
                sc[:, is_] = (d_all * scales6[:, is_].reshape(nb, 1).astype(np.float32))[:, 0]
                hseg = hmask[:, sub * 16 : sub * 16 + 16]
                hm = (hseg & m) == 0
                qv = ((qseg[:, sub * 16 : sub * 16 + 16] >> shift) & 3).astype(
                    np.int16
                ) - np.where(hm, 4, 0)
                o = half * 128 + j * 32 + sub * 16
                q[:, o : o + 16] = qv.astype(np.int8)
                is_ += 1
            m = np.uint8(m << 1)
    return q, sc, None, 16


def _extract_q4_k(raw, nb):
    b = raw.reshape(nb, 144)
    d = _f16(b[:, :2]).reshape(nb, 1)
    dmin = _f16(b[:, 2:4]).reshape(nb, 1)
    sc6, mn6 = _unpack_k_scales(b[:, 4:16])
    qs = b[:, 16:]
    q = np.empty((nb, 256), dtype=np.int8)
    sc = np.empty((nb, 8), dtype=np.float32)
    zr = np.empty((nb, 8), dtype=np.float32)
    for j in range(4):
        qseg = qs[:, 32 * j : 32 * j + 32]
        q[:, 64 * j : 64 * j + 32] = qseg & 0xF
        q[:, 64 * j + 32 : 64 * j + 64] = qseg >> 4
        sc[:, 2 * j] = (d * sc6[:, 2 * j].reshape(nb, 1).astype(np.float32))[:, 0]
        sc[:, 2 * j + 1] = (d * sc6[:, 2 * j + 1].reshape(nb, 1).astype(np.float32))[:, 0]
        zr[:, 2 * j] = (dmin * mn6[:, 2 * j].reshape(nb, 1).astype(np.float32))[:, 0]
        zr[:, 2 * j + 1] = (dmin * mn6[:, 2 * j + 1].reshape(nb, 1).astype(np.float32))[:, 0]
    return q, sc, zr, 32


def _extract_q5_k(raw, nb):
    b = raw.reshape(nb, 176)
    d = _f16(b[:, :2]).reshape(nb, 1)
    dmin = _f16(b[:, 2:4]).reshape(nb, 1)
    sc6, mn6 = _unpack_k_scales(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:]
    q = np.empty((nb, 256), dtype=np.int8)
    sc = np.empty((nb, 8), dtype=np.float32)
    zr = np.empty((nb, 8), dtype=np.float32)
    for j in range(4):
        qseg = qs[:, 32 * j : 32 * j + 32]
        u1, u2 = np.uint8(1 << (2 * j)), np.uint8(2 << (2 * j))
        q[:, 64 * j : 64 * j + 32] = (qseg & 0xF) + np.where(qh & u1, 16, 0).astype(np.uint8)
        q[:, 64 * j + 32 : 64 * j + 64] = (qseg >> 4) + np.where(qh & u2, 16, 0).astype(np.uint8)
        sc[:, 2 * j] = (d * sc6[:, 2 * j].reshape(nb, 1).astype(np.float32))[:, 0]
        sc[:, 2 * j + 1] = (d * sc6[:, 2 * j + 1].reshape(nb, 1).astype(np.float32))[:, 0]
        zr[:, 2 * j] = (dmin * mn6[:, 2 * j].reshape(nb, 1).astype(np.float32))[:, 0]
        zr[:, 2 * j + 1] = (dmin * mn6[:, 2 * j + 1].reshape(nb, 1).astype(np.float32))[:, 0]
    return q, sc, zr, 32


def _extract_q6_k(raw, nb):
    b = raw.reshape(nb, 210)
    ql = b[:, :128]
    qh = b[:, 128:192]
    scales8 = b[:, 192:208].copy().view(np.int8)
    d = _f16(b[:, 208:210]).reshape(nb, 1)
    q = np.empty((nb, 256), dtype=np.int8)
    sc = np.empty((nb, 16), dtype=np.float32)
    for half in range(2):
        qlh = ql[:, half * 64 : half * 64 + 64]
        qhh = qh[:, half * 32 : half * 32 + 32]
        o = half * 128
        q[:, o : o + 32] = ((qlh[:, :32] & 0xF) | (((qhh >> 0) & 3) << 4)).astype(np.int16) - 32
        q[:, o + 32 : o + 64] = ((qlh[:, 32:] & 0xF) | (((qhh >> 2) & 3) << 4)).astype(np.int16) - 32
        q[:, o + 64 : o + 96] = ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int16) - 32
        q[:, o + 96 : o + 128] = ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int16) - 32
    for g in range(16):
        sc[:, g] = (d[:, 0] * scales8[:, g].astype(np.float32))
    return q, sc, None, 16


EXTRACT_FNS = {
    GGML_Q4_0: _extract_q4_0,
    GGML_Q4_1: _extract_q4_1,
    GGML_Q5_0: _extract_q5_0,
    GGML_Q5_1: _extract_q5_1,
    GGML_Q8_0: _extract_q8_0,
    GGML_Q2_K: _extract_q2_k,
    GGML_Q3_K: _extract_q3_k,
    GGML_Q4_K: _extract_q4_k,
    GGML_Q5_K: _extract_q5_k,
    GGML_Q6_K: _extract_q6_k,
}


class HostQuant:
    """A GGUF tensor's own quantization blocks, kept quantized on the host.

    value[i] = q[i] · scale[i // group] − zero[i // group]  (element order).

    Quacks enough like an ndarray (shape/ndim/size/__array__/reshape/…)
    that the name-conversion path passes it through untouched; anything that
    actually does math on it triggers the f32 fallback via ``__array__``.
    ``sdtpu_torch.ops.quant.from_host_quant`` maps 2-D linear weights onto
    device GroupQuantTensor / Q4Tensor without any f32 round-trip.

    qbits=8: q is int8 [n_elems].  qbits=4 (q4_0): q stays nibble-packed
    uint8 [n_elems // 2] in ggml block order (byte i of each 32-elem block
    = elems i | (i+16)<<4, stored val+8) — host RSS ≈ file size."""

    __slots__ = ("q", "scale", "zero", "shape", "group", "type_name", "qbits")

    def __init__(self, q, scale, zero, shape, group, type_name="", qbits=8):
        self.q = q                    # int8 [n_elems] | packed uint8 [n/2]
        self.scale = scale            # f32 [n_elems // group]
        self.zero = zero              # f32 [n_elems // group] | None
        self.shape = tuple(shape)
        self.group = int(group)
        self.type_name = type_name
        self.qbits = int(qbits)

    def unpack_q(self) -> np.ndarray:
        """→ int8 [n_elems] in element order (transient; one tensor at a
        time during device conversion)."""
        if self.qbits == 4:
            p = self.q.reshape(-1, 16)
            lo = (p & 0x0F).astype(np.int8) - 8
            hi = (p >> 4).astype(np.int8) - 8
            return np.concatenate([lo, hi], axis=1).reshape(-1)
        return self.q

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def dtype(self):
        return np.dtype(np.float32)  # logical dtype after dequant

    def dequantize(self) -> np.ndarray:
        v = self.unpack_q().reshape(-1, self.group).astype(np.float32) \
            * self.scale.reshape(-1, 1)
        if self.zero is not None:
            v = v - self.zero.reshape(-1, 1)
        return v.reshape(self.shape)

    # ---- ndarray-compatibility fallbacks (dequantize then delegate) ----
    def __array__(self, dtype=None, copy=None):
        v = self.dequantize()
        return v.astype(dtype) if dtype is not None else v

    def astype(self, dtype):
        return self.dequantize().astype(dtype)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.dequantize().reshape(shape)

    def transpose(self, *axes):
        return self.dequantize().transpose(*axes)

    @property
    def T(self):
        return self.dequantize().T

    def __getitem__(self, idx):
        return self.dequantize()[idx]

    def __getattr__(self, name):
        # any ndarray attribute we don't carry natively (ravel, copy,
        # squeeze, …) falls back to the dequantized array; dunder protocol
        # probes are excluded — returning e.g. __array_interface__ of a
        # temporary would dangle its buffer
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.dequantize(), name)


def extract_blocks(raw: np.ndarray, ggml_type: int, n_elems: int,
                   shape) -> Optional[HostQuant]:
    """uint8 buffer of one quantized tensor → HostQuant on the checkpoint's
    own (q, scale, zero, group) grid, or None if the type has no extractor."""
    fn = EXTRACT_FNS.get(ggml_type)
    if fn is None:
        return None
    block_elems, block_bytes = BLOCK_INFO[ggml_type]
    nb = n_elems // block_elems
    res = fn(raw[: nb * block_bytes], nb)
    q, scale, zero, group = res[:4]
    qbits = res[4] if len(res) > 4 else 8
    return HostQuant(
        q=np.ascontiguousarray(q).reshape(-1),
        scale=np.ascontiguousarray(scale, dtype=np.float32).reshape(-1),
        zero=(None if zero is None
              else np.ascontiguousarray(zero, dtype=np.float32).reshape(-1)),
        shape=shape,
        group=group,
        type_name=TYPE_NAMES.get(ggml_type, str(ggml_type)),
        qbits=qbits,
    )


DEQUANT_FNS = {
    GGML_Q4_0: dequant_q4_0,
    GGML_Q4_1: dequant_q4_1,
    GGML_Q5_0: dequant_q5_0,
    GGML_Q5_1: dequant_q5_1,
    GGML_Q8_0: dequant_q8_0,
    GGML_Q2_K: dequant_q2_k,
    GGML_Q3_K: dequant_q3_k,
    GGML_Q4_K: dequant_q4_k,
    GGML_Q5_K: dequant_q5_k,
    GGML_Q6_K: dequant_q6_k,
}


def dequantize(raw: np.ndarray, ggml_type: int, n_elems: int) -> np.ndarray:
    """raw uint8 buffer of one tensor → float32[n_elems]."""
    if ggml_type == GGML_F32:
        return raw.view(np.float32)[:n_elems].copy()
    if ggml_type == GGML_F16:
        return raw.view(np.float16)[:n_elems].astype(np.float32)
    if ggml_type == GGML_BF16:
        return (raw.view(np.uint16)[:n_elems].astype(np.uint32) << 16).view(np.float32)
    if ggml_type == GGML_F64:
        return raw.view(np.float64)[:n_elems].astype(np.float32)
    if ggml_type in (GGML_I8, GGML_I16, GGML_I32, GGML_I64):
        dt = {GGML_I8: np.int8, GGML_I16: np.int16, GGML_I32: np.int32, GGML_I64: np.int64}[
            ggml_type
        ]
        return raw.view(dt)[:n_elems].astype(np.float32)
    fn = DEQUANT_FNS.get(ggml_type)
    if fn is None:
        raise ValueError(f"unsupported ggml type {ggml_type}")
    block_elems, block_bytes = BLOCK_INFO[ggml_type]
    n_blocks = n_elems // block_elems
    return fn(raw[: n_blocks * block_bytes], n_blocks)[:n_elems]


# ------------------------------------------------------------- GGUF container

_GGUF_VALUE_FMT = {
    0: "<B", 1: "<b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f", 7: "<?",
    10: "<Q", 11: "<q", 12: "<d",
}


class _Reader:
    def __init__(self, data: memoryview):
        self.data = data
        self.pos = 0

    def read_fmt(self, fmt: str):
        size = struct.calcsize(fmt)
        (val,) = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return val

    def read_string(self) -> str:
        n = self.read_fmt("<Q")
        s = bytes(self.data[self.pos : self.pos + n]).decode("utf-8", errors="replace")
        self.pos += n
        return s

    def read_value(self, vtype: int):
        if vtype == 8:
            return self.read_string()
        if vtype == 9:
            elem_type = self.read_fmt("<I")
            count = self.read_fmt("<Q")
            return [self.read_value(elem_type) for _ in range(count)]
        return self.read_fmt(_GGUF_VALUE_FMT[vtype])


class GGUFFile:
    def __init__(self, path: str):
        import mmap

        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        mv = memoryview(self._mm)
        if bytes(mv[:4]) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        r = _Reader(mv)
        r.pos = 4
        self.version = r.read_fmt("<I")
        n_tensors = r.read_fmt("<Q")
        n_kv = r.read_fmt("<Q")
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.read_string()
            vtype = r.read_fmt("<I")
            self.metadata[key] = r.read_value(vtype)
        self.entries: Dict[str, dict] = {}
        for _ in range(n_tensors):
            name = r.read_string()
            n_dims = r.read_fmt("<I")
            dims = [r.read_fmt("<Q") for _ in range(n_dims)]
            ttype = r.read_fmt("<I")
            offset = r.read_fmt("<Q")
            self.entries[name] = {"dims": dims, "type": ttype, "offset": offset}
        align = int(self.metadata.get("general.alignment", 32))
        self._data_start = (r.pos + align - 1) // align * align

    def names(self):
        return list(self.entries.keys())

    def tensor(self, name: str) -> np.ndarray:
        """→ float32 array in numpy/torch dim order (GGUF dims are innermost-
        first, so the numpy shape is reversed dims)."""
        e = self.entries[name]
        n_elems = int(np.prod(e["dims"])) if e["dims"] else 1
        block_elems, block_bytes = BLOCK_INFO.get(e["type"], (1, 4))
        nbytes = (n_elems // block_elems) * block_bytes
        start = self._data_start + e["offset"]
        raw = np.frombuffer(self._mm, dtype=np.uint8, count=nbytes, offset=start)
        flat = dequantize(raw, e["type"], n_elems)
        shape = tuple(reversed(e["dims"]))
        return flat.reshape(shape)

    def tensor_blocks(self, name: str) -> Optional[HostQuant]:
        """→ the tensor's own quantization blocks as a HostQuant (no f32
        materialization), or None for non-quantized / unextractable types."""
        e = self.entries[name]
        if e["type"] not in EXTRACT_FNS:
            return None
        n_elems = int(np.prod(e["dims"])) if e["dims"] else 1
        block_elems, block_bytes = BLOCK_INFO[e["type"]]
        if n_elems % block_elems:
            return None
        nbytes = (n_elems // block_elems) * block_bytes
        start = self._data_start + e["offset"]
        raw = np.frombuffer(self._mm, dtype=np.uint8, count=nbytes, offset=start)
        return extract_blocks(raw, e["type"], n_elems, tuple(reversed(e["dims"])))

    def tensor_type(self, name: str) -> str:
        return TYPE_NAMES.get(self.entries[name]["type"], str(self.entries[name]["type"]))

    def close(self):
        self._mm.close()
        self._f.close()


def load_gguf(path: str, keep_quant: bool = False) -> Dict[str, np.ndarray]:
    """keep_quant: quantized 2-D tensors come back as HostQuant (the
    checkpoint's own blocks, ~file-size host RSS) instead of f32 — the
    device path maps them onto GroupQuantTensor/Q4Tensor without a round
    trip."""
    f = GGUFFile(path)

    def read_one(name):
        if keep_quant:
            hq = f.tensor_blocks(name)
            if hq is not None and hq.ndim == 2:
                return name, hq
        return name, f.tensor(name)

    # multi-threaded tensor reading: page-in, dequant and block extraction
    # are numpy/mmap work that releases the GIL
    return dict(_parallel_map(read_one, f.names()))


def _parallel_map(fn, items):
    """Thread-pooled map preserving item order; honors SDTPU_LOAD_THREADS
    (0/1 → serial)."""
    n = os.environ.get("SDTPU_LOAD_THREADS")
    n = int(n) if n else min(16, (os.cpu_count() or 1) * 2)
    if n <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n) as pool:
        return list(pool.map(fn, items))


# ----------------------------------------------------------------- quantizers


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """f32 [..., k] (k % 32 == 0) → q8_0 blocks (ggml quantize_row_q8_0)."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax = np.abs(flat).max(axis=1, keepdims=True)
    d = amax / 127.0
    q = np.where(d > 0, np.round(flat / np.where(d == 0, 1, d)), 0.0)
    q = np.clip(q, -128, 127).astype(np.int8)
    out = np.empty((flat.shape[0], 34), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    """f32 → q4_0 blocks (ggml quantize_row_q4_0: scale by the signed max)."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    idx = np.abs(flat).argmax(axis=1)
    maxv = flat[np.arange(flat.shape[0]), idx]  # signed value of the abs max
    d = maxv / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip((flat * inv[:, None] + 8.5).astype(np.int32), 0, 15).astype(np.uint8)
    out = np.empty((flat.shape[0], 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    vmin = flat.min(axis=1)
    vmax = flat.max(axis=1)
    d = (vmax - vmin) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(((flat - vmin[:, None]) * inv[:, None] + 0.5).astype(np.int32), 0, 15).astype(np.uint8)
    out = np.empty((flat.shape[0], 20), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = vmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


QUANTIZE_FNS = {
    GGML_Q8_0: quantize_q8_0,
    GGML_Q4_0: quantize_q4_0,
    GGML_Q4_1: quantize_q4_1,
}


# --------------------------------------------------------------- GGUF writer


def save_gguf(path: str, tensors: Dict[str, np.ndarray], out_type: str = "f16",
              metadata: Optional[Dict[str, Any]] = None, min_quant_size: int = 1024,
              type_rules: Optional[list] = None):
    """Write a GGUF v3 file.

    out_type: f32/f16/bf16/q8_0/q4_0/q4_1.  2-D tensors whose inner dim is a
    multiple of the block size and with ≥ min_quant_size elements are
    quantized; everything else falls back to f16/f32.

    type_rules: [(regex, type_name), ...] per-tensor overrides — the first
    pattern that regex-searches the tensor name wins (reference
    tensor_type_rules)."""
    import re

    name_to_type = {v: k for k, v in TYPE_NAMES.items()}
    target = name_to_type[out_type]
    rules = [(re.compile(pat), name_to_type[tn])
             for pat, tn in (type_rules or []) if tn in name_to_type]

    entries = []  # (name, type_id, shape, payload bytes)
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        t = target
        for pat, rt in rules:
            if pat.search(name):
                t = rt
                break
        if str(arr.dtype) == "bfloat16":
            arr = arr.astype(np.float32)
        if arr.dtype not in (np.float32, np.float16) or arr.ndim == 0:
            payload = np.ascontiguousarray(arr).tobytes()
            t = {np.dtype(np.int32): GGML_I32, np.dtype(np.int64): GGML_I64,
                 np.dtype(np.int8): GGML_I8}.get(arr.dtype, GGML_F32)
            if t == GGML_F32:
                payload = np.ascontiguousarray(arr, dtype=np.float32).tobytes()
            entries.append((name, t, arr.shape, payload))
            continue
        arr32 = np.ascontiguousarray(arr, dtype=np.float32)
        quantizable = (
            t in QUANTIZE_FNS
            and arr.ndim >= 2
            and arr.shape[-1] % BLOCK_INFO[t][0] == 0
            and arr.size >= min_quant_size
        )
        if quantizable:
            payload = QUANTIZE_FNS[t](arr32).tobytes()
        elif t == GGML_BF16:
            payload = (
                (arr32.view(np.uint32) >> 16).astype(np.uint16).tobytes()
            )
        elif t == GGML_F32:
            payload = arr32.tobytes()
        else:  # f16 fallback (also for non-quantizable tensors)
            t = GGML_F16
            payload = arr32.astype(np.float16).tobytes()
        entries.append((name, t, arr.shape, payload))

    kv = {"general.architecture": "sdtpu", **(metadata or {})}
    buf = _gguf_header(kv, [(name, t, shape, len(payload)) for name, t, shape, payload in entries])
    for _, _, _, payload in entries:
        buf.extend(payload)
        buf.extend(b"\x00" * _pad(len(payload)))
    with open(path, "wb") as f:
        f.write(bytes(buf))


GGUF_ALIGN = 32


def _pad(n: int) -> int:
    return (GGUF_ALIGN - n % GGUF_ALIGN) % GGUF_ALIGN


def _gguf_header(kv: Dict[str, Any], infos) -> bytearray:
    """The GGUF v3 header for metadata ``kv`` and tensor infos
    ``[(name, ggml_type, shape, payload bytes)]``, padded to the alignment
    (each payload starts aligned)."""
    buf = bytearray()
    buf += GGUF_MAGIC
    buf += struct.pack("<IQQ", 3, len(infos), len(kv))

    def w_str(s):
        b = s.encode("utf-8")
        buf.extend(struct.pack("<Q", len(b)))
        buf.extend(b)

    def w_value(v):
        # typed KV values incl. arrays — needed to round-trip
        # tokenizer.ggml.* vocab metadata (llama.cpp-compatible)
        if isinstance(v, bool):
            buf.extend(struct.pack("<I", 7))
            buf.extend(struct.pack("<?", v))
        elif isinstance(v, int):
            buf.extend(struct.pack("<I", 5))  # int32
            buf.extend(struct.pack("<i", v))
        elif isinstance(v, float):
            buf.extend(struct.pack("<I", 6))  # float32
            buf.extend(struct.pack("<f", v))
        elif isinstance(v, (list, tuple)):
            buf.extend(struct.pack("<I", 9))  # array
            elem = v[0] if v else ""
            et = 8 if isinstance(elem, str) else (
                5 if isinstance(elem, int) and not isinstance(elem, bool)
                else 6)
            buf.extend(struct.pack("<IQ", et, len(v)))
            for e in v:
                if et == 8:
                    w_str(str(e))
                elif et == 5:
                    buf.extend(struct.pack("<i", int(e)))
                else:
                    buf.extend(struct.pack("<f", float(e)))
        else:
            buf.extend(struct.pack("<I", 8))  # string
            w_str(str(v))

    for k, v in kv.items():
        w_str(k)
        w_value(v)

    offset = 0
    for name, t, shape, nbytes in infos:
        w_str(name)
        dims = list(reversed(shape))  # gguf dims are innermost-first
        buf.extend(struct.pack("<I", len(dims)))
        for dname in dims:
            buf.extend(struct.pack("<Q", dname))
        buf.extend(struct.pack("<I", t))
        buf.extend(struct.pack("<Q", offset))
        offset += nbytes + _pad(nbytes)
    buf.extend(b"\x00" * _pad(len(buf)))
    return buf


def _payload_bytes(ggml_type: int, shape) -> int:
    """Bytes of one tensor's payload of ``ggml_type`` and numpy ``shape``."""
    block_elems, block_bytes = BLOCK_INFO[ggml_type]
    return int(np.prod(shape, dtype=np.int64)) // block_elems * block_bytes


def write_gguf(path: str, specs, payload: Callable[[str], np.ndarray],
               metadata: Optional[Dict[str, Any]] = None) -> int:
    """Stream a GGUF v3 file tensor by tensor, holding one payload at a time.

    specs: [(name, ggml_type, numpy shape)]; ``payload(name)`` returns that
    tensor's raw bytes (a uint8 array or bytes, in ggml's block layout, of
    the size its type and shape give).  The header is ``save_gguf``'s.  → bytes written."""
    kv = {"general.architecture": "sdtpu", **(metadata or {})}
    infos = [(name, t, tuple(shape), _payload_bytes(t, shape)) for name, t, shape in specs]
    written = 0
    with open(path, "wb") as f:
        written += f.write(bytes(_gguf_header(kv, infos)))
        for name, _, _, nbytes in infos:
            data = memoryview(np.ascontiguousarray(payload(name), dtype=np.uint8)).cast("B")
            if data.nbytes != nbytes:
                raise ValueError(f"{name}: payload of {data.nbytes} bytes, not {nbytes}")
            written += f.write(data)
            written += f.write(b"\x00" * _pad(nbytes))
    return written
