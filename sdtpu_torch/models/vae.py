"""AutoencoderKL encode and decode (counterpart of ``sdtpu/models/vae.py``:
``vae_encode_moments``, ``vae_encode``, ``vae_decode``, the layout of
``init_vae_params``).

Params are keyed by CompVis ``first_stage_model`` names
(``encoder.down.N.block.M.…``, ``decoder.up.N.block.M.…``); activations are
NHWC.  Each half's mid-block attention is single-head over every latent
position (D = 512 at full width, FLUX's, SD1.x's, SDXL's and SD3's alike).
FLUX's and SD3's files ship without ``quant_conv`` / ``post_quant_conv``;
each half skips its 1x1 convolution where the params lack it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from sdtpu_torch.ops import attention, conv2d, group_norm, silu


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    z_channels: int = 4
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    scale_factor: float = 0.18215
    shift_factor: float = 0.0


SD_VAE_CONFIG = VAEConfig()  # SD1.x: 4 latent channels, scale 0.18215, no shift
SDXL_VAE_CONFIG = VAEConfig(scale_factor=0.13025)
# SD3 / SD3.5: 16 latent channels with a shift; its files carry no quant_conv
SD3_VAE_CONFIG = VAEConfig(z_channels=16, scale_factor=1.5305, shift_factor=0.0609)
FLUX_VAE_CONFIG = VAEConfig(z_channels=16, scale_factor=0.3611, shift_factor=0.1159)


def _spec_builders(specs: dict):
    """(conv, norm, res) adding ``init_vae_params``'s entries to ``specs``."""
    def conv(name, out_c, in_c, k=3):
        specs[f"{name}.weight"] = ((out_c, in_c, k, k), "normal")
        specs[f"{name}.bias"] = ((out_c,), "zeros")

    def norm(name, ch):
        specs[f"{name}.weight"] = ((ch,), "ones")
        specs[f"{name}.bias"] = ((ch,), "zeros")

    def res(pre, in_c, out_c):
        norm(f"{pre}.norm1", in_c)
        conv(f"{pre}.conv1", out_c, in_c)
        norm(f"{pre}.norm2", out_c)
        conv(f"{pre}.conv2", out_c, out_c)
        if in_c != out_c:
            conv(f"{pre}.nin_shortcut", out_c, in_c, k=1)

    return conv, norm, res


def vae_encoder_specs(cfg: VAEConfig) -> dict:
    """name → (shape, init) of the encoder half of ``init_vae_params``
    (``quant_conv`` aside: FLUX's and SD3's files have none)."""
    specs = {}
    conv, norm, res = _spec_builders(specs)
    ch = cfg.base_channels
    conv("encoder.conv_in", ch, cfg.in_channels)
    for i, mult in enumerate(cfg.channel_mult):
        out_c = cfg.base_channels * mult
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down.{i}.block.{j}", ch, out_c)
            ch = out_c
        if i != len(cfg.channel_mult) - 1:
            conv(f"encoder.down.{i}.downsample.conv", ch, ch)
    res("encoder.mid.block_1", ch, ch)
    norm("encoder.mid.attn_1.norm", ch)
    for nm in ("q", "k", "v", "proj_out"):
        conv(f"encoder.mid.attn_1.{nm}", ch, ch, k=1)
    res("encoder.mid.block_2", ch, ch)
    norm("encoder.norm_out", ch)
    conv("encoder.conv_out", 2 * cfg.z_channels, ch)
    return specs


def vae_specs(cfg: VAEConfig) -> dict:
    """name → (shape, init) of both halves in ``init_vae_params``'s order:
    the encoder, ``quant_conv``, then the decoder (``param_specs``)."""
    z2 = 2 * cfg.z_channels
    return {**vae_encoder_specs(cfg), "quant_conv.weight": ((z2, z2, 1, 1), "normal"),
            "quant_conv.bias": ((z2,), "zeros"), **param_specs(cfg)}


def param_specs(cfg: VAEConfig) -> dict:
    """name → (shape, init) of the decoder half of ``init_vae_params``."""
    specs = {}
    conv, norm, res = _spec_builders(specs)
    conv("post_quant_conv", cfg.z_channels, cfg.z_channels, k=1)
    ch = cfg.base_channels * cfg.channel_mult[-1]
    conv("decoder.conv_in", ch, cfg.z_channels)
    res("decoder.mid.block_1", ch, ch)
    norm("decoder.mid.attn_1.norm", ch)
    for nm in ("q", "k", "v", "proj_out"):
        conv(f"decoder.mid.attn_1.{nm}", ch, ch, k=1)
    res("decoder.mid.block_2", ch, ch)
    for i in reversed(range(len(cfg.channel_mult))):
        out_c = cfg.base_channels * cfg.channel_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{i}.block.{j}", ch, out_c)
            ch = out_c
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", ch, ch)
    norm("decoder.norm_out", ch)
    conv("decoder.conv_out", cfg.in_channels, ch)
    return specs


def _resnet(p, pre: str, x: torch.Tensor) -> torch.Tensor:
    out_ch = p[f"{pre}.conv1.weight"].shape[0]
    h = silu(group_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"], eps=1e-6))
    h = conv2d(h, p[f"{pre}.conv1.weight"], p[f"{pre}.conv1.bias"])
    h = silu(group_norm(h, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"], eps=1e-6))
    h = conv2d(h, p[f"{pre}.conv2.weight"], p[f"{pre}.conv2.bias"])
    if x.shape[-1] != out_ch:
        x = conv2d(x, p[f"{pre}.nin_shortcut.weight"], p[f"{pre}.nin_shortcut.bias"], padding=0)
    return x + h


def _attn(p, pre: str, x: torch.Tensor) -> torch.Tensor:
    """Single-head spatial self-attention with 1x1-conv projections."""
    b, hh, ww, c = x.shape
    h = group_norm(x, p[f"{pre}.norm.weight"], p[f"{pre}.norm.bias"], eps=1e-6)

    def proj(nm):
        return conv2d(h, p[f"{pre}.{nm}.weight"], p[f"{pre}.{nm}.bias"], padding=0).reshape(
            b, 1, hh * ww, c)

    o = attention(proj("q"), proj("k"), proj("v")).reshape(b, hh, ww, c)
    return x + conv2d(o, p[f"{pre}.proj_out.weight"], p[f"{pre}.proj_out.bias"], padding=0)


def vae_encode_moments(p, x: torch.Tensor, cfg: VAEConfig = SD_VAE_CONFIG) -> torch.Tensor:
    """x: [B,H,W,3] in [-1,1] → moments [B,H/8,W/8,2z] (mean | logvar)."""
    h = conv2d(x, p["encoder.conv_in.weight"], p["encoder.conv_in.bias"])
    n_levels = len(cfg.channel_mult)
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks):
            h = _resnet(p, f"encoder.down.{i}.block.{j}", h)
        if i != n_levels - 1:
            # CompVis downsample: pad H and W by (0, 1), then a stride-2 valid conv
            h = conv2d(h, p[f"encoder.down.{i}.downsample.conv.weight"],
                       p[f"encoder.down.{i}.downsample.conv.bias"], stride=2,
                       padding=((0, 1), (0, 1)))
    h = _resnet(p, "encoder.mid.block_1", h)
    h = _attn(p, "encoder.mid.attn_1", h)
    h = _resnet(p, "encoder.mid.block_2", h)
    h = silu(group_norm(h, p["encoder.norm_out.weight"], p["encoder.norm_out.bias"], eps=1e-6))
    h = conv2d(h, p["encoder.conv_out.weight"], p["encoder.conv_out.bias"])
    if "quant_conv.weight" in p:
        h = conv2d(h, p["quant_conv.weight"], p["quant_conv.bias"], padding=0)
    return h


def vae_encode(p, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
               cfg: VAEConfig = SD_VAE_CONFIG) -> torch.Tensor:
    """x: [B,H,W,3] in [-1,1] → scaled latent [B,H/8,W/8,zc]: the posterior
    mean (``noise=None``) or a sample with the given standard-normal noise."""
    mean, logvar = vae_encode_moments(p, x, cfg).chunk(2, dim=-1)
    if noise is not None:
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        mean = mean + std * noise.to(mean.dtype)
    return (mean - cfg.shift_factor) * cfg.scale_factor


def vae_decode(p, z: torch.Tensor, cfg: VAEConfig = FLUX_VAE_CONFIG) -> torch.Tensor:
    """z: scaled latent [B,h,w,zc] → image [B,8h,8w,3] in [-1,1]."""
    z = z / cfg.scale_factor + cfg.shift_factor
    if "post_quant_conv.weight" in p:
        z = conv2d(z, p["post_quant_conv.weight"], p["post_quant_conv.bias"], padding=0)
    h = conv2d(z, p["decoder.conv_in.weight"], p["decoder.conv_in.bias"])
    h = _resnet(p, "decoder.mid.block_1", h)
    h = _attn(p, "decoder.mid.attn_1", h)
    h = _resnet(p, "decoder.mid.block_2", h)
    for i in reversed(range(len(cfg.channel_mult))):
        for j in range(cfg.num_res_blocks + 1):
            h = _resnet(p, f"decoder.up.{i}.block.{j}", h)
        if i != 0:
            # nearest 2x: repeat along H, then along W
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            h = conv2d(h, p[f"decoder.up.{i}.upsample.conv.weight"],
                       p[f"decoder.up.{i}.upsample.conv.bias"])
    h = silu(group_norm(h, p["decoder.norm_out.weight"], p["decoder.norm_out.bias"], eps=1e-6))
    return conv2d(h, p["decoder.conv_out.weight"], p["decoder.conv_out.bias"])
