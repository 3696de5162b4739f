"""Seed-reproducible noise on the host (this package's copy of ``sdtpu/rng.py``).

webui's Philox4x32-10 stream ("--rng cuda", in numpy), comfyui's stream
("--rng cpu", torch's own CPU generator) and a fast numpy stream, drawn
exactly as the JAX package draws them, so both packages start from the same
latent.  The JAX package's numpy MT19937 form of the torch-CPU stream has
no copy here: torch is always present.  The JAX package's on-device Philox
(``philox_bits_jax``, ``philox_randn_jax``) has no counterpart: the port
draws its noise on the host and uploads it.
"""
from __future__ import annotations

import numpy as np

PHILOX_M0 = np.uint64(0xD2511F53)
PHILOX_M1 = np.uint64(0xCD9E8D57)
PHILOX_W0 = np.uint32(0x9E3779B9)
PHILOX_W1 = np.uint32(0xBB67AE85)
TWO_POW32_INV = np.float32(2.3283064e-10)
TWO_POW32_INV_2PI = np.float32(2.3283064e-10 * 6.2831855)


def _philox4_32(counter: np.ndarray, key: np.ndarray, rounds: int = 10) -> np.ndarray:
    """Philox4x32 block cipher. counter: (4, N) uint32, key: (2, N) uint32."""
    counter = counter.copy()
    key = key.copy()
    for r in range(rounds):
        v1 = counter[0].astype(np.uint64) * PHILOX_M0
        v2 = counter[2].astype(np.uint64) * PHILOX_M1
        hi1 = (v1 >> np.uint64(32)).astype(np.uint32)
        lo1 = v1.astype(np.uint32)
        hi2 = (v2 >> np.uint64(32)).astype(np.uint32)
        lo2 = v2.astype(np.uint32)
        new0 = hi2 ^ counter[1] ^ key[0]
        new2 = hi1 ^ counter[3] ^ key[1]
        counter = np.stack([new0, lo2, new2, lo1])
        if r != rounds - 1:
            key = np.stack([key[0] + PHILOX_W0, key[1] + PHILOX_W1])
    return counter


class PhiloxRNG:
    """webui-compatible gaussian stream (reference src/core/rng_philox.hpp:11)."""

    def __init__(self, seed: int = 0):
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> None:
        self.seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.offset = 0

    def randn(self, n: int) -> np.ndarray:
        counter = np.zeros((4, n), dtype=np.uint32)
        counter[0, :] = self.offset
        counter[2, :] = np.arange(n, dtype=np.uint32)
        self.offset += 1
        key = np.empty((2, n), dtype=np.uint32)
        key[0, :] = self.seed & 0xFFFFFFFF
        key[1, :] = (self.seed >> 32) & 0xFFFFFFFF
        g = _philox4_32(counter, key)
        return _box_muller_sin(g[0], g[1])

    def randn_shape(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        return self.randn(n).reshape(shape)


def _box_muller_sin(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    # webui keeps only the sin branch (one gaussian per 4x32 block).
    u = x.astype(np.float32) * TWO_POW32_INV + TWO_POW32_INV / np.float32(2)
    v = y.astype(np.float32) * TWO_POW32_INV_2PI + TWO_POW32_INV_2PI / np.float32(2)
    s = np.sqrt(np.float32(-2.0) * np.log(u))
    return (s * np.sin(v)).astype(np.float32)


class TorchCPURNG:
    """Bit-exact comfyui-compatible stream via torch's own CPU generator.

    comfyui noise is ``torch.randn`` on a seeded CPU generator; torch's float32
    path uses Sleef-vectorized transcendentals that plain numpy cannot
    reproduce to the ulp, so we delegate to it.
    """

    def __init__(self, seed: int = 0):
        import torch

        self._torch = torch
        self._gen = torch.Generator(device="cpu")
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> None:
        self._gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)

    def randn(self, n: int) -> np.ndarray:
        return self._torch.randn(n, generator=self._gen).numpy()

    def randn_shape(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        return self.randn(n).reshape(shape)


class NumpyRNG:
    """Fast non-compat RNG (reference STDDefaultRNG analog, src/core/rng.hpp:13)."""

    def __init__(self, seed: int = 0):
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> None:
        self._g = np.random.default_rng(seed)

    def randn(self, n: int) -> np.ndarray:
        return self._g.standard_normal(n, dtype=np.float32)

    def randn_shape(self, shape) -> np.ndarray:
        return self._g.standard_normal(shape, dtype=np.float32)


RNG_TYPES = {
    "cuda": PhiloxRNG,  # webui-compatible (reference default)
    "cpu": TorchCPURNG,  # comfyui-compatible (torch is always present here)
    "std_default": NumpyRNG,
}


def create_rng(kind: str, seed: int = 0):
    if kind not in RNG_TYPES:
        raise ValueError(f"unknown rng type {kind!r}; choose from {sorted(RNG_TYPES)}")
    return RNG_TYPES[kind](seed)
