"""Weights for the port: the bridge from JAX-package param dicts, and random
full-width weights drawn on the device.

``from_jax_params`` turns a checkpoint-named ``sdtpu`` param dict (leaves as
numpy/jnp arrays, ``QuantTensor``, ``Q4Tensor`` or ``GroupQuantTensor``) into
this package's, so the tests run both packages on identical weights.  The
JAX ``Q4Tensor`` split-half layout and the transposed ``GroupQuantTensor``
are repacked exactly into this package's layouts (integers and scales are
moved, never recomputed).

``synthesize`` draws random weights with a ``torch.Generator`` on the target
device, in the memory classes of the JAX bench synthesis
(``sdtpu/utils/device_init.py``): large 2-D weights as int8 ``QuantTensor``
(q8_0), group-32 int8 ``GroupQuantTensor`` (q8_0_gguf, a q8_0 GGUF kept in
its blocks) or packed 4-bit ``Q4Tensor`` (q4_0, scale group 64 by default
as in the bench, 32 for a q4_0 GGUF's block grid) with constant scales sized
so dequantized values have std ~0.02; embeddings and tensors under 2**16
elements stay dense.  A dense weight's std is the spec's (0.02, or the
float it names: the Wan VAE's convolutions take 0.05).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sdtpu_torch.ops.quant import (Q4_GROUP, Q4_GROUPS, Q4_K_MULTIPLE, GroupQuantTensor,
                                   Q4Tensor, QuantTensor)

WEIGHT_STD = 0.02
# rms of uniform int8 in [-127, 127) is ~73.3; of centered nibbles ~4.6
Q8_SCALE = WEIGHT_STD / 73.3
Q4_SCALE = WEIGHT_STD / 4.6
MIN_QUANT_ELEMS = 1 << 16
GGUF_GROUP = 32  # ggml q8_0 block size
# name fragments that stay dense (gathered, not matmul'd)
EMBEDDING_HINTS = ("shared.weight", "embed", "wte", "token_embedding", "pos_emb", "position")


def _to_torch(a, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: widen exactly, narrow in torch
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _transposed(a, device, dtype=None) -> torch.Tensor:
    """A JAX [Kp, N] field → this package's contiguous [N, Kp]."""
    return _to_torch(np.ascontiguousarray(np.asarray(a).T), device, dtype)


def repack_q4(packed, scale, k: int, block_k: int, group: int, device="cuda") -> Q4Tensor:
    """JAX ``Q4Tensor`` fields (packed uint8 [Kp/2, N] split-half per
    ``block_k`` tile, scale f32 [Kp/group, N]) → this package's layout."""
    packed = np.asarray(packed)
    scale = np.asarray(scale, dtype=np.float32)
    kp, n = packed.shape[0] * 2, packed.shape[1]
    p = packed.reshape(kp // block_k, block_k // 2, n)
    nib = np.concatenate([p & 0xF, p >> 4], axis=1).reshape(kp, n)  # [Kp, N] in k order
    kq = -(-k // Q4_K_MULTIPLE) * Q4_K_MULTIPLE  # <= the JAX Kp, a multiple of block_k
    nib = np.ascontiguousarray(nib[:kq].T)  # [N, Kq]
    ours = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8)
    return Q4Tensor(
        packed=torch.from_numpy(np.ascontiguousarray(ours)).to(device),
        scale=torch.from_numpy(np.ascontiguousarray(scale[: kq // group].T)).to(device),
        k=int(k), group=int(group))


def from_jax_params(params: dict, device="cuda", dtype: Optional[torch.dtype] = None) -> dict:
    """Checkpoint-named JAX-package params → this package's.  Float leaves
    are cast to ``dtype`` when given; quantized leaves keep their integers
    and float32 scales."""
    out = {}
    for name, v in params.items():
        kind = type(v).__name__
        if kind == "QuantTensor":
            out[name] = QuantTensor(q=_to_torch(v.q, device),
                                    scale=_to_torch(v.scale, device, torch.float32))
        elif kind == "Q4Tensor":
            out[name] = repack_q4(v.packed, v.scale, v.k, v.block_k, v.group, device)
        elif kind == "GroupQuantTensor":
            f32 = torch.float32
            out[name] = GroupQuantTensor(
                q=_transposed(v.q, device), scale=_transposed(v.scale, device, f32),
                zero=None if v.zero is None else _transposed(v.zero, device, f32),
                k=v.k, group=v.group)
        else:
            out[name] = _to_torch(v, device, dtype)
    return out


def _quantizable(name: str, shape, init: str) -> bool:
    return (len(shape) == 2 and init == "normal" and shape[0] * shape[1] >= MIN_QUANT_ELEMS
            and not any(h in name for h in EMBEDDING_HINTS))


def synthesize(specs: Dict[str, tuple], quant: Optional[str] = None, seed: int = 0,
               device="cuda", dtype: torch.dtype = torch.bfloat16,
               group: int = Q4_GROUP) -> dict:
    """name → (shape, init) specs → random tensors drawn on ``device``;
    init is "normal" (std ``WEIGHT_STD``), a float (the std of a normal
    draw), "ones" or "zeros".

    quant: None (all dense), "q8_0" (eligible weights → int8 QuantTensor),
    "q8_0_gguf" (→ group-32 int8 GroupQuantTensor, the footprint of a q8_0
    GGUF kept in its blocks) or "q4_0" (→ packed 4-bit Q4Tensor with scales
    per ``group`` weights along K, the counterpart of ``synthesize_params(...,
    group=...)``).  The packed bytes drawn do not depend on ``group``."""
    if quant not in (None, "q8_0", "q8_0_gguf", "q4_0"):
        raise ValueError(f"unsupported synthesis quant mode {quant!r}")
    if group not in Q4_GROUPS:
        raise ValueError(f"synthesize: group {group} not in {Q4_GROUPS}")
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = {}
    for name, (shape, init) in specs.items():
        if quant is not None and _quantizable(name, shape, init):
            n, k = shape
            if quant == "q8_0":
                q = torch.randint(-127, 127, (n, k), generator=g, device=device, dtype=torch.int8)
                out[name] = QuantTensor(
                    q=q, scale=torch.full((n,), Q8_SCALE, dtype=torch.float32, device=device))
            elif quant == "q8_0_gguf":
                kp = -(-k // GGUF_GROUP) * GGUF_GROUP
                q = torch.randint(-127, 127, (n, kp), generator=g, device=device,
                                  dtype=torch.int8)
                out[name] = GroupQuantTensor(
                    q=q, scale=torch.full((n, kp // GGUF_GROUP), Q8_SCALE, dtype=torch.float32,
                                          device=device),
                    zero=None, k=k, group=GGUF_GROUP)
            else:
                kp = -(-k // Q4_K_MULTIPLE) * Q4_K_MULTIPLE
                packed = torch.randint(0, 256, (n, kp // 2), generator=g, device=device,
                                       dtype=torch.uint8)
                out[name] = Q4Tensor(
                    packed=packed,
                    scale=torch.full((n, kp // group), Q4_SCALE, dtype=torch.float32,
                                     device=device),
                    k=k, group=group)
        elif init == "normal" or isinstance(init, float):
            std = WEIGHT_STD if init == "normal" else init
            out[name] = torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(std)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out


def weight_bytes(params: dict) -> int:
    """Bytes of device memory a param dict holds, scales and zeros included."""
    total = 0
    for v in params.values():
        if isinstance(v, QuantTensor):
            parts = (v.q, v.scale)
        elif isinstance(v, Q4Tensor):
            parts = (v.packed, v.scale)
        elif isinstance(v, GroupQuantTensor):
            parts = (v.q, v.scale) + (() if v.zero is None else (v.zero,))
        else:
            parts = (v,)
        total += sum(t.numel() * t.element_size() for t in parts)
    return total
