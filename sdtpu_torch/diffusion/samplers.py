"""The flow Euler sampler (counterpart of ``sdtpu/diffusion/samplers.py``:
``_euler_step``, ``sample``).

Per-step scalars are precomputed on the host in numpy float32, as in the JAX
package; its ``lax.scan`` becomes a Python loop over the same per-step
arrays.  Each scalar reaches the device as a 0-dim float32 tensor, so the
step arithmetic is float32 throughout.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

PORTED_METHODS = ("euler",)


def per_step_arrays(sigmas: np.ndarray) -> Dict[str, np.ndarray]:
    sigmas = np.asarray(sigmas, dtype=np.float32)
    n = len(sigmas) - 1
    return {
        "i": np.arange(n, dtype=np.int32),
        "sigma": sigmas[:n],
        "sigma_next": sigmas[1:n + 1],
    }


def _euler_step(model_fn: Callable):
    def step(carry, s):
        x = carry["x"]
        den, _ = model_fn(x, s["sigma"], s["i"])
        d = (x - den) / s["sigma"]
        return {"x": x + d * (s["sigma_next"] - s["sigma"])}

    return step


def sample(model_fn: Callable, x: torch.Tensor, sigmas: np.ndarray,
           method: str = "euler") -> torch.Tensor:
    """Run the denoise loop.  model_fn(x, sigma, i) → (denoised,
    uncond_denoised), with sigma a 0-dim float32 tensor on x's device."""
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"sampler {method!r} is not ported yet; ported: {list(PORTED_METHODS)}")
    step = _euler_step(model_fn)
    per = per_step_arrays(sigmas)
    carry = {"x": x}
    for i in range(len(per["i"])):
        s = {
            "i": int(per["i"][i]),
            "sigma": torch.tensor(per["sigma"][i], device=x.device),
            "sigma_next": torch.tensor(per["sigma_next"][i], device=x.device),
        }
        carry = step(carry, s)
    return carry["x"]
