"""Brownian-tree noise for ``dpm++2m_sde_bt`` (counterpart of
``sdtpu/diffusion/brownian.py``: ``_mix64``, ``tree_seed_from_rng``,
``BrownianTreeNoiseSampler``, ``brownian_step_noise``).

A seeded binary bridge over the sigma interval gives deterministic,
step-count-stable Gaussian increments: for a given seed the trajectory's
shape does not depend on the number of steps.  The tree is evaluated on the
host over the host-known schedule, with Python-int 64-bit mixing and numpy
draws, into the per-step noise stack the sampler reads, so the port draws
exactly the JAX package's noise from the same sampler stream.
"""
from __future__ import annotations

import numpy as np

from sdtpu_torch.rng import NumpyRNG

_MASK = (1 << 64) - 1


def _mix64(v: int, salt: int) -> int:
    """splitmix64-style mixer (reference mix64, denoiser.hpp:1903)."""
    z = (v + salt) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) & _MASK


def tree_seed_from_rng(rng) -> int:
    """Derive the tree seed from two sampler-RNG normal draws, reinterpreting
    their bytes as u64 (reference sample_dpmpp_2m_sde_bt, denoiser.hpp:1986)."""
    draw = np.asarray(rng.randn(2), dtype=np.float32)
    return int(np.frombuffer(draw.tobytes(), dtype=np.uint64)[0])


class BrownianTreeNoiseSampler:
    """W(t) evaluated by recursive Brownian bridge with per-node seeds.

    __call__(sigma_a, sigma_b) returns unit-variance noise for the interval,
    i.e. (W(b) − W(a)) / sqrt(|b − a|) — the caller applies the SDE scale.
    """

    _MAX_DEPTH = 24

    def __init__(self, shape, sigma_min: float, sigma_max: float, seed: int):
        self.t_min = float(sigma_min)
        self.t_max = float(sigma_max)
        self.shape = tuple(int(s) for s in shape)
        self.root_seed = _mix64(int(seed) & _MASK, 0x9E3779B97F4A7C15)
        g = NumpyRNG(_mix64(int(seed) & _MASK, 0xBF58476D1CE4E5B9))
        self.w_at_tmax = g.randn_shape(self.shape).astype(np.float32) * np.float32(
            np.sqrt(self.t_max - self.t_min)
        )
        self._cache: dict = {}

    def _clamp(self, t: float) -> float:
        return min(max(t, self.t_min), self.t_max)

    def _w(self, t: float) -> np.ndarray:
        got = self._cache.get(t)
        if got is not None:
            return got
        zero = np.zeros(self.shape, dtype=np.float32)
        out = self._bridge(
            self.t_min, self.t_max, zero, self.w_at_tmax, t, self.root_seed,
            self._MAX_DEPTH,
        )
        self._cache[t] = out
        return out

    def _bridge(self, a, c, w_a, w_c, t, node_seed, depth) -> np.ndarray:
        if depth <= 0 or c - a < 1e-9:
            alpha = np.float32((t - a) / (c - a)) if c > a else np.float32(0.5)
            return (np.float32(1.0) - alpha) * w_a + alpha * w_c
        m = 0.5 * (a + c)
        std_dev = np.sqrt((c - m) * (m - a) / (c - a))
        g = NumpyRNG(node_seed)
        z = g.randn_shape(self.shape).astype(np.float32)
        w_m = np.float32(0.5) * (w_a + w_c) + np.float32(std_dev) * z
        if t == m:
            return w_m
        if t < m:
            return self._bridge(a, m, w_a, w_m, t, _mix64(node_seed, 1), depth - 1)
        return self._bridge(m, c, w_m, w_c, t, _mix64(node_seed, 2), depth - 1)

    def __call__(self, sigma_a: float, sigma_b: float) -> np.ndarray:
        a = self._clamp(min(sigma_a, sigma_b))
        b = self._clamp(max(sigma_a, sigma_b))
        d_w = self._w(b) - self._w(a)
        span = max(abs(sigma_b - sigma_a), 1e-12)
        return d_w * np.float32(1.0 / np.sqrt(span))


def brownian_step_noise(rng, shape, sigmas: np.ndarray) -> np.ndarray:
    """[steps, *shape] noise for the full schedule from one tree (the helper
    pipelines use to stage dpm++2m_sde_bt noise host-side)."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    pos = sigmas[sigmas > 0.0]
    steps = len(sigmas) - 1
    out = np.zeros((steps,) + tuple(shape), dtype=np.float32)
    if pos.size == 0 or float(pos.max()) <= float(pos.min()):
        return out
    bt = BrownianTreeNoiseSampler(
        shape, float(pos.min()), float(pos.max()), tree_seed_from_rng(rng)
    )
    for i in range(steps):
        if sigmas[i + 1] != 0.0:
            out[i] = bt(float(sigmas[i]), float(sigmas[i + 1]))
    return out
