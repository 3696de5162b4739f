"""Sigma schedules FLUX uses (a subset of ``sdtpu/diffusion/schedule.py``).

Host-side numpy, n steps → n + 1 descending sigmas ending in 0.  The port
carries its own copy because importing ``sdtpu.diffusion.schedule`` pulls in
the JAX samplers through ``sdtpu/diffusion/__init__.py``; the tests hold this
copy equal to ``sdtpu.diffusion.schedule.get_sigmas``.
"""
from __future__ import annotations

import math

import numpy as np

TIMESTEPS = 1000


def schedule_discrete(n, sigma_min, sigma_max, t_to_sigma):
    t_max = TIMESTEPS - 1
    if n == 1:
        return np.array([t_to_sigma(float(t_max)), 0.0], dtype=np.float32)
    ts = t_max - (t_max / (n - 1)) * np.arange(n, dtype=np.float32)
    sig = np.asarray(t_to_sigma(ts), dtype=np.float32)
    return np.append(sig, np.float32(0.0))


def flux_time_shift_np(mu, sigma, t):
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)


def schedule_flux(n, sigma_min, sigma_max, t_to_sigma, image_seq_len=0,
                  base_shift=0.5, max_shift=1.15):
    m = (max_shift - base_shift) / (4096.0 - 256.0)
    b = base_shift - m * 256.0
    mu = image_seq_len * m + b
    out = []
    for i in range(n + 1):
        t = 1.0 - i / n
        out.append(0.0 if t <= 0 else flux_time_shift_np(mu, 1.0, t))
    out[n] = 0.0
    return np.asarray(out, dtype=np.float32)


SCHEDULERS = {"discrete": schedule_discrete, "flux": schedule_flux}


def get_sigmas(denoiser, n: int, scheduler: str = "discrete", image_seq_len: int = 0) -> np.ndarray:
    """n sampling steps → n + 1 descending sigmas ending in 0."""
    fn = SCHEDULERS.get(scheduler)
    if fn is None:
        raise ValueError(f"scheduler {scheduler!r} is not ported; choose from {sorted(SCHEDULERS)}")
    extra = {"image_seq_len": image_seq_len} if scheduler == "flux" else {}
    return fn(n, denoiser.sigma_min(), denoiser.sigma_max(), denoiser.t_to_sigma, **extra)
