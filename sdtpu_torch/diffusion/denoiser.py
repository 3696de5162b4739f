"""Flow denoisers FLUX uses (counterpart of ``sdtpu/diffusion/denoiser.py``).

Tables and scalings are host-side numpy, as in the JAX package; the sampling
loop consumes them as f32 values.
"""
from __future__ import annotations

import numpy as np

TIMESTEPS = 1000


def time_snr_shift(alpha: float, t):
    if alpha == 1.0:
        return t
    return alpha * t / (1 + (alpha - 1) * t)


def flux_time_shift(mu: float, sigma: float, t):
    return np.exp(mu) / (np.exp(mu) + (1.0 / t - 1.0) ** sigma)


class DiscreteFlowDenoiser:
    """Rectified flow, sigma in (0, 1], SNR time shift (SD3.x)."""

    prediction = "flow"
    is_flow = True

    def __init__(self, shift: float = 3.0):
        self.shift = shift

    def sigma_min(self) -> float:
        return float(self.t_to_sigma(np.float32(0.0)))

    def sigma_max(self) -> float:
        return float(self.t_to_sigma(np.float32(TIMESTEPS - 1)))

    def sigma_to_t(self, sigma):
        return np.asarray(sigma) * 1000.0

    def t_to_sigma(self, t):
        t = np.asarray(t, dtype=np.float32) + 1.0
        return time_snr_shift(self.shift, t / 1000.0)

    def get_scalings(self, sigma):
        """→ (c_skip, c_out, c_in): denoised = c_skip·x + c_out·model(c_in·x)."""
        sigma = np.asarray(sigma, dtype=np.float32)
        return np.ones_like(sigma), -sigma, np.ones_like(sigma)

    def get_scalings_torch(self, sigma):
        """The same for a 0-dim float32 tensor sigma inside the sampling loop."""
        return 1.0, -sigma, 1.0

    def sigma_to_t_torch(self, sigma):
        return sigma * 1000.0

    def noise_scaling(self, sigma, noise, latent):
        return latent * (1.0 - sigma) + noise * sigma

    def inverse_noise_scaling(self, sigma, latent):
        return latent / (1.0 - sigma)


class FluxFlowDenoiser(DiscreteFlowDenoiser):
    """FLUX flow: exp time shift, t == sigma."""

    def __init__(self, shift: float = 1.15):
        super().__init__(shift)

    def sigma_to_t(self, sigma):
        return np.asarray(sigma)

    def sigma_to_t_torch(self, sigma):
        return sigma

    def t_to_sigma(self, t):
        t = np.asarray(t, dtype=np.float32) + 1.0
        return flux_time_shift(self.shift, 1.0, t / TIMESTEPS)
