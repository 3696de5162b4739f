"""Spatial tiling with feathered overlap blending, and the temporal windows
of a video decode (counterpart of ``sdtpu/models/tiling.py``: ``tiled_decode``,
``tiled_encode``, ``tiled_decode_temporal``).

The plane splits into overlapping tiles; each runs through ``fn`` and the
outputs blend with linear feather ramps in the overlap bands.  Images are
[B, H, W, C], videos [B, T, H, W, C] (the spatial axes are the two before
the channels; a video decode may change the frame count).  The canvas lives
on the input's device in f32.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch


def _tile_starts(size: int, tile: int, stride: int) -> List[int]:
    """Tile origins covering [0, size): stride apart, last tile flush with the edge."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def _feather(tile: int, overlap: int) -> np.ndarray:
    """1-D blend weights: linear ramp over the overlap band, never zero."""
    w = np.ones(tile, dtype=np.float32)
    if overlap > 0:
        ramp = np.linspace(1.0 / (overlap + 1), 1.0, overlap, dtype=np.float32)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def tiled_apply(fn: Callable, x: torch.Tensor, tile: int, overlap: int, out_scale: int) -> torch.Tensor:
    """Apply ``fn`` tile-wise over the spatial plane of NHWC ``x``; ``fn``
    scales the spatial dims by ``out_scale``.  Returns f32."""
    H, W = x.shape[-3], x.shape[-2]
    stride = max(tile - overlap, 1)
    ys = _tile_starts(H, tile, stride)
    xs = _tile_starts(W, tile, stride)
    if len(ys) == 1 and len(xs) == 1:
        return fn(x).float()
    th, tw = min(tile, H), min(tile, W)
    s = out_scale
    fy = _feather(th * s, overlap * s)
    fx = _feather(tw * s, overlap * s)
    mask = torch.from_numpy((fy[:, None] * fx[None, :])[..., None]).to(x.device)
    weight = torch.zeros((H * s, W * s, 1), dtype=torch.float32, device=x.device)
    canvas = None
    for y0 in ys:
        for x0 in xs:
            out = fn(x[..., y0:y0 + th, x0:x0 + tw, :]).float()
            if canvas is None:
                canvas = out.new_zeros(out.shape[:-3] + (H * s, W * s, out.shape[-1]))
            oy, ox = y0 * s, x0 * s
            canvas[..., oy:oy + th * s, ox:ox + tw * s, :] += out * mask
            weight[oy:oy + th * s, ox:ox + tw * s] += mask
    return canvas / weight.clamp_min(1e-8)


def tiled_decode(decode_fn: Callable, z: torch.Tensor, tile: int = 64, overlap: int = 8,
                 scale_factor: int = 8) -> torch.Tensor:
    """Latent → pixels, tile and overlap in latent units."""
    return tiled_apply(decode_fn, z, tile, overlap, scale_factor)


def tiled_encode(encode_fn: Callable, x: torch.Tensor, tile: int = 512, overlap: int = 64,
                 scale_factor: int = 8, out_channels: int = 4) -> torch.Tensor:
    """Pixels → latent, tile and overlap in pixel units (multiples of the
    scale factor); the feather ramps run at latent scale.  Float32."""
    H, W = x.shape[-3], x.shape[-2]
    s = scale_factor
    stride = max(tile - overlap, 1)
    ys = _tile_starts(H, tile, stride)
    xs = _tile_starts(W, tile, stride)
    if len(ys) == 1 and len(xs) == 1:
        return encode_fn(x).float()
    th, tw = min(tile, H), min(tile, W)
    fy = _feather(th // s, overlap // s)
    fx = _feather(tw // s, overlap // s)
    mask = torch.from_numpy((fy[:, None] * fx[None, :])[..., None]).to(x.device)
    canvas = torch.zeros(x.shape[:-3] + (H // s, W // s, out_channels), dtype=torch.float32,
                         device=x.device)
    weight = torch.zeros((H // s, W // s, 1), dtype=torch.float32, device=x.device)
    for y0 in ys:
        for x0 in xs:
            out = encode_fn(x[..., y0:y0 + th, x0:x0 + tw, :]).float()
            oy, ox = y0 // s, x0 // s
            canvas[..., oy:oy + th // s, ox:ox + tw // s, :] += out * mask
            weight[oy:oy + th // s, ox:ox + tw // s] += mask
    return canvas / weight.clamp_min(1e-8)


def tiled_decode_temporal(decode_fn: Callable, z: torch.Tensor, frames: int = 16, overlap: int = 4,
                          temporal_scale: int = 4) -> torch.Tensor:
    """A video latent [B, T, h, w, C] decoded in windows of ``frames``
    latent frames, each ``frames - overlap`` after the last; a window after
    the first drops the ``1 + temporal_scale·(overlap - 1)`` output frames
    of its ``overlap`` context frames (a causal VAE decodes a window's frame
    0 to one frame, each later one to ``temporal_scale``).  Float32, on z's
    device."""
    T = z.shape[1]
    frames = max(1, frames)
    overlap = max(0, min(overlap, frames - 1))
    if T <= frames:
        return decode_fn(z).float()
    stride = frames - overlap
    outs = []
    s = 0
    while True:
        e = min(T, s + frames)
        y = decode_fn(z[:, s:e]).float()
        if s > 0 and overlap > 0:
            y = y[:, 1 + temporal_scale * (overlap - 1):]
        outs.append(y)
        if e == T:
            break
        s += stride
    return torch.cat(outs, dim=1)
