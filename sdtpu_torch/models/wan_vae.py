"""Wan 2.1 3-D causal video VAE (counterpart of ``sdtpu/models/wan_vae.py``:
8× spatial, 4× temporal, 16 latent channels; ``wan_vae_decode``,
``wan_vae_encode``, ``init_wan_vae_params``' layout as ``param_specs``).

Params are keyed by the Wan VAE checkpoint names (``conv1`` / ``conv2``,
the quant convolutions; ``{encoder,decoder}.conv1``,
``{encoder,decoder}.middle.{0,1,2}``, ``encoder.downsamples.N`` /
``decoder.upsamples.N`` with ``residual.{0,2,3,6}``, ``shortcut``,
``resample.1``, ``time_conv``; ``{encoder,decoder}.head.{0,2}``); video
tensors are [B, T, H, W, C].  As in the JAX package the whole clip runs as
one forward: every causal temporal convolution is a 3-D convolution with
(kt - 1) zero frames in front, and the temporal up- and downsamples pass
frame 0 through (the downsample's stride-2 convolution over fewer than 3
frames gives none, as at T = 1, an image).  The convolutions are cuDNN's
(``F.conv3d`` / ``F.conv2d`` on channels-last views), as the reference
computes them outside any Pallas kernel; the per-frame mid-block attention
keeps the reference's plain float32 softmax and does not go to flash.
Qwen-Image runs the VAE in image mode: one frame, ``z[:, None]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sdtpu_torch.ops import conv2d, rms_norm, silu


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    input_channels: int = 3
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    temporal_upsample: Tuple[bool, ...] = (True, True, False)


WAN21_VAE_CONFIG = WanVAEConfig()

# per-channel latent statistics of the Wan 2.1 VAE
WAN21_LATENTS_MEAN = np.array(
    [-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
     0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921], dtype=np.float32)
WAN21_LATENTS_STD = np.array(
    [2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
     3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160], dtype=np.float32)


def _stats(z: torch.Tensor):
    """The statistics in z's dtype, on z's device (a bf16 latent stays bf16)."""
    return (torch.from_numpy(WAN21_LATENTS_MEAN).to(z.device, z.dtype),
            torch.from_numpy(WAN21_LATENTS_STD).to(z.device, z.dtype))


def vae_to_diffusion_latents(z: torch.Tensor) -> torch.Tensor:
    """(z - mean) / std, channel-last."""
    mean, std = _stats(z)
    return (z - mean) / std


def diffusion_to_vae_latents(z: torch.Tensor) -> torch.Tensor:
    """z * std + mean, in z's dtype."""
    mean, std = _stats(z)
    return z * std + mean


def causal_conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  stride: Tuple[int, int, int] = (1, 1, 1), spatial_pad: Optional[int] = None,
                  temporal_pad: Optional[int] = None) -> torch.Tensor:
    """x: [B,T,H,W,C]; weight [O, I, kt, kh, kw].  (kt - 1) zero frames go
    in front (causal), ``kh // 2`` on each spatial side unless given."""
    kt, kh = weight.shape[2], weight.shape[3]
    sp = kh // 2 if spatial_pad is None else spatial_pad
    tp = kt - 1 if temporal_pad is None else temporal_pad
    xc = x.permute(0, 4, 1, 2, 3)  # [B, C, T, H, W] over channels-last memory
    if tp:
        xc = F.pad(xc, (0, 0, 0, 0, tp, 0)).contiguous(memory_format=torch.channels_last_3d)
    y = F.conv3d(xc, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=(0, sp, sp))
    return y.permute(0, 2, 3, 4, 1)


def _conv2d_frames(x, weight, bias, stride=1, padding=1):
    """A 2-D convolution on each frame: x [B,T,H,W,C], weight OIHW."""
    b, t, h, w, c = x.shape
    y = conv2d(x.reshape(b * t, h, w, c), weight, bias, stride=stride, padding=padding)
    return y.reshape(b, t, *y.shape[1:])


def _rms(p, name, x):
    """Channel RMS norm; the checkpoint's gamma is [C, 1, 1]."""
    return rms_norm(x, p[f"{name}.gamma"].reshape(-1), eps=1e-12)


def _resblock(p, pre, x):
    h = _rms(p, f"{pre}.residual.0", x)
    h = causal_conv3d(silu(h), p[f"{pre}.residual.2.weight"], p[f"{pre}.residual.2.bias"])
    h = _rms(p, f"{pre}.residual.3", h)
    h = causal_conv3d(silu(h), p[f"{pre}.residual.6.weight"], p[f"{pre}.residual.6.bias"])
    if f"{pre}.shortcut.weight" in p:
        x = causal_conv3d(x, p[f"{pre}.shortcut.weight"], p[f"{pre}.shortcut.bias"])
    return x + h


def _attn_block(p, pre, x):
    """Single-head self-attention within each frame, its softmax in float32."""
    b, t, hh, ww, c = x.shape
    h = _rms(p, f"{pre}.norm", x)
    qkv = _conv2d_frames(h, p[f"{pre}.to_qkv.weight"], p[f"{pre}.to_qkv.bias"], padding=0)
    q, k, v = qkv.reshape(b * t, hh * ww, 3 * c).float().chunk(3, dim=-1)
    att = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / np.sqrt(c), dim=-1)
    o = torch.matmul(att, v).to(x.dtype).reshape(b, t, hh, ww, c)
    o = _conv2d_frames(o, p[f"{pre}.proj.weight"], p[f"{pre}.proj.bias"], padding=0)
    return x + o


def _temporal_upsample(p, pre, x):
    """Frame 0 passes through; frames 1..T go through ``time_conv`` (c → 2c)
    and interleave: T → 1 + 2(T - 1)."""
    head, tail = x[:, :1], x[:, 1:]
    b, tm, hh, ww, c = tail.shape
    if tm == 0:
        return head
    y = causal_conv3d(tail, p[f"{pre}.time_conv.weight"], p[f"{pre}.time_conv.bias"], spatial_pad=0)
    y = y.reshape(b, tm, hh, ww, 2, c).permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * tm, hh, ww, c)
    return torch.cat([head, y], dim=1)


def _spatial_upsample(p, pre, x):
    """Nearest 2× on each frame, then a 3x3 convolution."""
    b, t, hh, ww, c = x.shape
    y = F.interpolate(x.reshape(b * t, hh, ww, c).permute(0, 3, 1, 2), scale_factor=2.0,
                      mode="nearest").permute(0, 2, 3, 1)
    y = conv2d(y, p[f"{pre}.resample.1.weight"], p[f"{pre}.resample.1.bias"])
    return y.reshape(b, t, *y.shape[1:])


def _temporal_downsample(p, pre, x):
    """Frame 0 passes through; a stride-2 convolution (kt 3, no padding)
    over all frames follows it: 1 + 2m → 1 + m frames (a clip of fewer than
    3 frames gives only frame 0)."""
    head = x[:, :1]
    if x.shape[1] < 3:
        return head
    y = causal_conv3d(x, p[f"{pre}.time_conv.weight"], p[f"{pre}.time_conv.bias"], stride=(2, 1, 1),
                      spatial_pad=0, temporal_pad=0)
    return torch.cat([head, y], dim=1)


def _spatial_downsample(p, pre, x):
    """One zero row and column at the bottom and right, then a stride-2 3x3
    convolution on each frame."""
    return _conv2d_frames(x, p[f"{pre}.resample.1.weight"], p[f"{pre}.resample.1.bias"], stride=2,
                          padding=((0, 1), (0, 1)))


def wan_vae_decode(p, z: torch.Tensor, cfg: WanVAEConfig = WAN21_VAE_CONFIG) -> torch.Tensor:
    """z: [B, Tl, h, w, z_dim] raw VAE latent (``diffusion_to_vae_latents``
    first) → video [B, 1 + 4(Tl - 1), 8h, 8w, 3] in [-1, 1]."""
    z = causal_conv3d(z, p["conv2.weight"], p["conv2.bias"])  # 1x1x1 quant conv
    x = causal_conv3d(z, p["decoder.conv1.weight"], p["decoder.conv1.bias"])
    x = _resblock(p, "decoder.middle.0", x)
    x = _attn_block(p, "decoder.middle.1", x)
    x = _resblock(p, "decoder.middle.2", x)
    n_levels = len(cfg.dim_mult)
    idx = 0
    for i in range(n_levels):
        for _ in range(cfg.num_res_blocks + 1):
            x = _resblock(p, f"decoder.upsamples.{idx}", x)
            idx += 1
        if i != n_levels - 1:
            pre = f"decoder.upsamples.{idx}"
            if cfg.temporal_upsample[i]:
                x = _temporal_upsample(p, pre, x)
            x = _spatial_upsample(p, pre, x)
            idx += 1
    x = _rms(p, "decoder.head.0", x)
    return causal_conv3d(silu(x), p["decoder.head.2.weight"], p["decoder.head.2.bias"])


def wan_vae_encode(p, x: torch.Tensor, cfg: WanVAEConfig = WAN21_VAE_CONFIG) -> torch.Tensor:
    """x: [B, T, H, W, 3] video in [-1, 1], T = 1 + 4k → the raw latent's
    posterior mean [B, 1 + k, H/8, W/8, z_dim] (``vae_to_diffusion_latents``
    maps it to the diffusion space)."""
    h = causal_conv3d(x, p["encoder.conv1.weight"], p["encoder.conv1.bias"])
    n_levels = len(cfg.dim_mult)
    idx = 0
    for i in range(n_levels):
        for _ in range(cfg.num_res_blocks):
            h = _resblock(p, f"encoder.downsamples.{idx}", h)
            idx += 1
        if i != n_levels - 1:
            pre = f"encoder.downsamples.{idx}"
            h = _spatial_downsample(p, pre, h)
            if cfg.temporal_downsample[i]:
                h = _temporal_downsample(p, pre, h)
            idx += 1
    h = _resblock(p, "encoder.middle.0", h)
    h = _attn_block(p, "encoder.middle.1", h)
    h = _resblock(p, "encoder.middle.2", h)
    h = _rms(p, "encoder.head.0", h)
    h = causal_conv3d(silu(h), p["encoder.head.2.weight"], p["encoder.head.2.bias"])
    h = causal_conv3d(h, p["conv1.weight"], p["conv1.bias"])  # 1x1x1 quant conv
    return h[..., :cfg.z_dim]  # the mean; the log-variance is dropped


def param_specs(cfg: WanVAEConfig = WAN21_VAE_CONFIG, decode_only: bool = True) -> dict:
    """name → (shape, init) of ``init_wan_vae_params(decode_only=...)``:
    convolutions normal (std 0.05), biases zero, RMS gains one; the encoder
    and ``conv1`` first unless ``decode_only``."""
    specs = {}

    def conv3(name, o, i, kt=3, kh=3, kw=3):
        specs[f"{name}.weight"] = ((o, i, kt, kh, kw), 0.05)
        specs[f"{name}.bias"] = ((o,), "zeros")

    def conv2(name, o, i, k=3):
        specs[f"{name}.weight"] = ((o, i, k, k), 0.05)
        specs[f"{name}.bias"] = ((o,), "zeros")

    def gamma(name, c):
        specs[f"{name}.gamma"] = ((c, 1, 1), "ones")

    def res(pre, ci, co):
        gamma(f"{pre}.residual.0", ci)
        conv3(f"{pre}.residual.2", co, ci)
        gamma(f"{pre}.residual.3", co)
        conv3(f"{pre}.residual.6", co, co)
        if ci != co:
            conv3(f"{pre}.shortcut", co, ci, 1, 1, 1)

    def attn(pre, c):
        gamma(f"{pre}.norm", c)
        conv2(f"{pre}.to_qkv", 3 * c, c, 1)
        conv2(f"{pre}.proj", c, c, 1)

    d = cfg.dim
    n_levels = len(cfg.dim_mult)
    if not decode_only:
        dims_e = [d] + [d * m for m in cfg.dim_mult]
        conv3("encoder.conv1", dims_e[0], cfg.input_channels)
        idx = 0
        for i in range(n_levels):
            ci, co = dims_e[i], dims_e[i + 1]
            for _ in range(cfg.num_res_blocks):
                res(f"encoder.downsamples.{idx}", ci, co)
                ci = co
                idx += 1
            if i != n_levels - 1:
                conv2(f"encoder.downsamples.{idx}.resample.1", co, co)
                if cfg.temporal_downsample[i]:
                    conv3(f"encoder.downsamples.{idx}.time_conv", co, co, 3, 1, 1)
                idx += 1
        top = dims_e[-1]
        res("encoder.middle.0", top, top)
        attn("encoder.middle.1", top)
        res("encoder.middle.2", top, top)
        gamma("encoder.head.0", top)
        conv3("encoder.head.2", cfg.z_dim * 2, top)
        conv3("conv1", cfg.z_dim * 2, cfg.z_dim * 2, 1, 1, 1)
    dims_d = [d * cfg.dim_mult[-1]] + [d * m for m in reversed(cfg.dim_mult)]
    conv3("conv2", cfg.z_dim, cfg.z_dim, 1, 1, 1)
    conv3("decoder.conv1", dims_d[0], cfg.z_dim)
    res("decoder.middle.0", dims_d[0], dims_d[0])
    attn("decoder.middle.1", dims_d[0])
    res("decoder.middle.2", dims_d[0], dims_d[0])
    idx = 0
    for i in range(n_levels):
        ci, co = dims_d[i], dims_d[i + 1]
        if i in (1, 2, 3):
            ci = ci // 2  # the upsample before this level halved the channels
        for _ in range(cfg.num_res_blocks + 1):
            res(f"decoder.upsamples.{idx}", ci, co)
            ci = co
            idx += 1
        if i != n_levels - 1:
            conv2(f"decoder.upsamples.{idx}.resample.1", co // 2, co)
            if cfg.temporal_upsample[i]:
                conv3(f"decoder.upsamples.{idx}.time_conv", co * 2, co, 3, 1, 1)
            idx += 1
    gamma("decoder.head.0", dims_d[-1])
    conv3("decoder.head.2", cfg.input_channels, dims_d[-1])
    return specs


def detect_wan_vae_config(p: dict) -> WanVAEConfig:
    """The VAE's widths from its shapes (the JAX factory's
    ``_detect_wan_vae_config``); the level layout is fixed across published
    Wan 2.1 VAEs."""
    dim = p["decoder.head.2.weight"].shape[1]
    z_dim = p["decoder.conv1.weight"].shape[1]
    n_res = 0
    while f"decoder.upsamples.{n_res}.residual.0.gamma" in p:
        n_res += 1
    return WanVAEConfig(dim=dim, z_dim=z_dim, num_res_blocks=n_res - 1)
