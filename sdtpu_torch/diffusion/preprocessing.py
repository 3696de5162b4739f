"""Control-image preprocessing: Canny edge detection (counterpart of
``sdtpu/diffusion/preprocessing.py``).

Gaussian blur → Sobel → non-maximum suppression → double-threshold
hysteresis, in numpy on the host, as the JAX package runs it: the same
uint8 input gives the same uint8 edge map, bit for bit.
"""
from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int = 5, sigma: float = 1.4) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def _conv2(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, ph), (pw, pw)), mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(padded, (kh, kw))
    return np.einsum("ijkl,kl->ij", windows, k)


def canny(
    image: np.ndarray,
    low_threshold: float = 0.08,
    high_threshold: float = 0.16,
    weak: float = 0.5,
    strong: float = 1.0,
    inverse: bool = False,
) -> np.ndarray:
    """uint8 [H,W,3] (or [H,W]) → uint8 edge map [H,W,3]."""
    img = image.astype(np.float32) / 255.0
    if img.ndim == 3:
        gray = 0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    else:
        gray = img
    blurred = _conv2(gray, _gaussian_kernel())

    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)
    ky = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=np.float32)
    gx = _conv2(blurred, kx)
    gy = _conv2(blurred, ky)
    mag = np.hypot(gx, gy)
    mag = mag / (mag.max() + 1e-8)
    angle = np.rad2deg(np.arctan2(gy, gx)) % 180

    # non-maximum suppression
    h, w = mag.shape
    nms = np.zeros_like(mag)
    padded = np.pad(mag, 1)
    dir_bins = ((angle + 22.5) // 45).astype(np.int32) % 4
    offsets = {0: ((0, 1), (0, -1)), 1: ((-1, 1), (1, -1)), 2: ((-1, 0), (1, 0)), 3: ((-1, -1), (1, 1))}
    for b, ((dy1, dx1), (dy2, dx2)) in offsets.items():
        m = dir_bins == b
        n1 = padded[1 + dy1 : 1 + dy1 + h, 1 + dx1 : 1 + dx1 + w]
        n2 = padded[1 + dy2 : 1 + dy2 + h, 1 + dx2 : 1 + dx2 + w]
        keep = m & (mag >= n1) & (mag >= n2)
        nms[keep] = mag[keep]

    # hysteresis
    strong_mask = nms >= high_threshold
    weak_mask = (nms >= low_threshold) & ~strong_mask
    out = np.where(strong_mask, strong, np.where(weak_mask, weak, 0.0)).astype(np.float32)
    # promote weak pixels adjacent to strong ones (one pass, reference parity)
    sp = np.pad(strong_mask, 1)
    neighbor_strong = np.zeros_like(strong_mask)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neighbor_strong |= sp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    out = np.where(weak_mask & neighbor_strong, strong, np.where(weak_mask, 0.0, out))
    if inverse:
        out = 1.0 - out
    rgb = np.repeat(out[..., None], 3, axis=-1)
    return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
