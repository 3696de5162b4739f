"""ControlNet (counterpart of ``sdtpu/models/controlnet.py``): a copy of the
UNet's encoder with a zero-conv tap after each input block and after the
middle block, fed the latent plus a hint stem's features.

Param names follow the checkpoint scheme: ``input_blocks…`` (the encoder
copy), ``zero_convs.N.0`` (1×1 taps), ``middle_block…``,
``middle_block_out.0``, ``input_hint_block.{0,2,…,14}`` (the hint stem),
``time_embed…``, and ``label_emb…`` for SDXL ControlNets.  The blocks are
the port's UNet blocks (``models.unet``), so attention runs on the flash
kernel on the card.  Activations are NHWC at this module's functions, as in
the UNet.

Outputs: the per-skip control residuals and the middle residual, consumed
by ``unet_forward(controls=…, control_strength=…)``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from sdtpu_torch.models.unet import (SD1_UNET_CONFIG, UNetConfig, _block_layout, param_specs, resblock,
                                     spatial_transformer)
from sdtpu_torch.ops import conv2d, linear, silu, timestep_embedding

# the hint stem's convolutions: 3→16→16→32→32→96→96→256→model_channels,
# strided (×2 down) at indices 4, 8 and 12: 1/8 of the image, the latent's size
HINT_INDICES = (0, 2, 4, 6, 8, 10, 12, 14)
HINT_STRIDED = (4, 8, 12)
HINT_CHANNELS = ((16, 3), (16, 16), (32, 16), (32, 32), (96, 32), (96, 96), (256, 96))


def controlnet_forward(p, x: torch.Tensor, hint: torch.Tensor, timesteps: torch.Tensor,
                       context: torch.Tensor, y: Optional[torch.Tensor] = None,
                       cfg: UNetConfig = SD1_UNET_CONFIG) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """x: [B,h,w,C] latent; hint: [B,H,W,3] control image in [0,1] at 8×
    the latent's size → (per-input-block controls, middle control)."""
    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = linear(t_emb, p["time_embed.0.weight"], p["time_embed.0.bias"])
    emb = linear(silu(emb), p["time_embed.2.weight"], p["time_embed.2.bias"])
    if cfg.adm_in_channels is not None and y is not None:
        lemb = linear(y.to(x.dtype), p["label_emb.0.0.weight"], p["label_emb.0.0.bias"])
        emb = emb + linear(silu(lemb), p["label_emb.0.2.weight"], p["label_emb.0.2.bias"])
    context = context.to(x.dtype)

    h = hint.to(x.dtype)
    for n, idx in enumerate(HINT_INDICES):
        h = conv2d(h, p[f"input_hint_block.{idx}.weight"], p[f"input_hint_block.{idx}.bias"],
                   stride=2 if idx in HINT_STRIDED else 1)
        if n < len(HINT_INDICES) - 1:
            h = silu(h)
    guided_hint = h

    inputs, _ = _block_layout(cfg)
    controls = []
    hx = x
    for tap, (bi, blk) in enumerate(inputs):
        for j, kind in enumerate(blk):
            pre = f"input_blocks.{bi}.{j}"
            if kind == "conv":
                hx = conv2d(hx, p[f"{pre}.weight"], p[f"{pre}.bias"]) + guided_hint
            elif kind == "res":
                hx = resblock(p, pre, hx, emb)
            elif kind == "down":
                hx = conv2d(hx, p[f"{pre}.op.weight"], p[f"{pre}.op.bias"], stride=2)
            else:
                hx = spatial_transformer(p, pre, hx, context, cfg, kind[1])
        controls.append(conv2d(hx, p[f"zero_convs.{tap}.0.weight"], p[f"zero_convs.{tap}.0.bias"],
                               padding=0))

    hx = resblock(p, "middle_block.0", hx, emb)
    mid_depth = cfg.transformer_depth[-1] if cfg.transformer_depth[-1] > 0 else 1
    hx = spatial_transformer(p, "middle_block.1", hx, context, cfg, mid_depth)
    hx = resblock(p, "middle_block.2", hx, emb)
    middle = conv2d(hx, p["middle_block_out.0.weight"], p["middle_block_out.0.bias"], padding=0)
    return controls, middle


def controlnet_specs(cfg: UNetConfig = SD1_UNET_CONFIG) -> dict:
    """name → (shape, init) for every tensor ``controlnet_forward`` reads,
    as the JAX ``init_controlnet_params`` lays them out: the UNet's encoder
    and middle block, the zero convs and ``middle_block_out`` at zero, the
    hint stem's weights 'normal'.  A tiny UNet has no middle block and no
    ControlNet."""
    if cfg.tiny_unet:
        raise ValueError("ControlNet: a tiny UNet has no middle block to copy")
    specs = {k: v for k, v in param_specs(cfg).items() if not k.startswith(("output_blocks.", "out."))}
    chans = [cfg.model_channels]
    for level, mult in enumerate(cfg.channel_mult):
        chans += [mult * cfg.model_channels] * (cfg.num_res_blocks + (level != len(cfg.channel_mult) - 1))
    for i, c in enumerate(chans):
        specs[f"zero_convs.{i}.0.weight"] = ((c, c, 1, 1), "zeros")
        specs[f"zero_convs.{i}.0.bias"] = ((c,), "zeros")
    top = cfg.channel_mult[-1] * cfg.model_channels
    specs["middle_block_out.0.weight"] = ((top, top, 1, 1), "zeros")
    specs["middle_block_out.0.bias"] = ((top,), "zeros")
    for (o, ic), idx in zip(HINT_CHANNELS + ((cfg.model_channels, 256),), HINT_INDICES):
        specs[f"input_hint_block.{idx}.weight"] = ((o, ic, 3, 3), "normal")
        specs[f"input_hint_block.{idx}.bias"] = ((o,), "zeros")
    return specs
