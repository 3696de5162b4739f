"""SD1.x, SD2.x and SDXL UNets and their tiny distills (counterpart of
``sdtpu/models/unet.py`` but its video variant), with the inpainting (9
input channels: the latent, the mask and the masked image's latent) and
instruct-pix2pix (8: the latent and the edit image's latent) stems.

Params are a flat dict keyed by CompVis checkpoint names
(``input_blocks.N.M.…``, ``middle_block.…``, ``output_blocks.…``,
``time_embed.…``, ``out.…``); activations are NHWC.  Convolutions and dense
linears run as cuDNN / ``torch.matmul`` calls, as the JAX package leaves
them to XLA; attention goes through ``ops.attention`` (the flash kernel on
the card: SD1.x's 8 heads over 320, 640 and 1280 channels, so D 40, 80 and
160; SD2's and SDXL's 64-channel heads, so D 64; SDXS-0.9's one head over
320 channels, so D 320).

Structure (CompVis openaimodel semantics):
  time_embed: Linear→SiLU→Linear on the sinusoidal timestep embedding
  label_emb (SDXL): the same MLP on the pooled + size/crop vector ``y``
  input blocks: conv stem, then per level {ResBlock [+SpatialTransformer]}×n,
    strided-conv Downsample between levels
  middle: ResBlock, SpatialTransformer, ResBlock
  output blocks: mirrored with skip concatenation, nearest-2x Upsample
  out: GroupNorm→SiLU→conv
SD2's and SDXL's transformers project in and out with linears on the tokens
(``use_linear_in_transformer``) and take their head count from 64-channel
heads (``num_head_channels``).  The tiny UNets (SD1 / SD2 tiny, SDXS) run
one resblock a level over three levels with no middle block, and keep the
CompVis block numbering with holes.  ``unet_forward`` adds a ControlNet's
residuals (``controls``) to the skips and the middle.  The video (SVD)
variant is not ported, and the config has none of its fields: the loader
and ``create_pipeline`` refuse that family by name.  IP-Adapter and
AnimateDiff are not ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from sdtpu_torch.ops import attention, conv2d, gelu, group_norm, layer_norm, linear, silu, timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    attention_resolutions: Tuple[int, ...] = (1, 2, 4)  # ds values with attention
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)  # per level
    context_dim: int = 768
    num_heads: Optional[int] = 8
    num_head_channels: Optional[int] = None
    use_linear_in_transformer: bool = False
    adm_in_channels: Optional[int] = None  # SDXL conditioning vector
    # distilled tiny UNets (SD-Turbo tiny / SDXS): one resblock per level, 3
    # levels, no middle block, and the CompVis block numbering kept with
    # holes (input_blocks 1, 4, 7; upsamples at shifted output indices)
    tiny_unet: bool = False
    # SDXS-0.9: the 320-wide attention runs as 1 head x 320 instead of 5 x 64
    sdxs09_wide_head: bool = False


SD1_UNET_CONFIG = UNetConfig()
SD1_INPAINT_UNET_CONFIG = dataclasses.replace(SD1_UNET_CONFIG, in_channels=9)
SD2_UNET_CONFIG = UNetConfig(
    context_dim=1024, num_heads=None, num_head_channels=64, use_linear_in_transformer=True
)
SD2_INPAINT_UNET_CONFIG = dataclasses.replace(SD2_UNET_CONFIG, in_channels=9)
SDXL_UNET_CONFIG = UNetConfig(
    channel_mult=(1, 2, 4),
    attention_resolutions=(2, 4),
    transformer_depth=(0, 2, 10),
    context_dim=2048,
    num_heads=None,
    num_head_channels=64,
    use_linear_in_transformer=True,
    adm_in_channels=2816,
)
SDXL_INPAINT_UNET_CONFIG = dataclasses.replace(SDXL_UNET_CONFIG, in_channels=9)
SD1_TINY_UNET_CONFIG = dataclasses.replace(
    SD1_UNET_CONFIG, num_res_blocks=1, channel_mult=(1, 2, 4), transformer_depth=(1, 1, 1), tiny_unet=True,
)
SDXS_512_UNET_CONFIG = dataclasses.replace(SD1_TINY_UNET_CONFIG, attention_resolutions=(2, 4))
SD2_TINY_UNET_CONFIG = dataclasses.replace(
    SD2_UNET_CONFIG, num_res_blocks=1, channel_mult=(1, 2, 4), transformer_depth=(1, 1, 1), tiny_unet=True,
)
SDXS_09_UNET_CONFIG = dataclasses.replace(SD2_TINY_UNET_CONFIG, sdxs09_wide_head=True)


def _heads_for(cfg: UNetConfig, ch: int) -> int:
    if cfg.num_head_channels is not None:
        n = ch // cfg.num_head_channels
        if cfg.sdxs09_wide_head and n == 5:
            return 1  # SDXS-0.9: 5 x 64 runs as 1 x 320
        return n
    return cfg.num_heads or 8


def resblock(p, pre: str, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """CompVis ResBlock: GN→SiLU→conv, +time-emb, GN→SiLU→conv, skip."""
    out_ch = p[f"{pre}.out_layers.3.weight"].shape[0]
    h = silu(group_norm(x, p[f"{pre}.in_layers.0.weight"], p[f"{pre}.in_layers.0.bias"], eps=1e-5))
    h = conv2d(h, p[f"{pre}.in_layers.2.weight"], p[f"{pre}.in_layers.2.bias"])
    emb_out = linear(silu(emb), p[f"{pre}.emb_layers.1.weight"], p[f"{pre}.emb_layers.1.bias"])
    h = h + emb_out[:, None, None, :].to(h.dtype)
    h = silu(group_norm(h, p[f"{pre}.out_layers.0.weight"], p[f"{pre}.out_layers.0.bias"], eps=1e-5))
    h = conv2d(h, p[f"{pre}.out_layers.3.weight"], p[f"{pre}.out_layers.3.bias"])
    if x.shape[-1] != out_ch:
        x = conv2d(x, p[f"{pre}.skip_connection.weight"], p[f"{pre}.skip_connection.bias"], padding=0)
    return x + h


def cross_attention(p, pre: str, x: torch.Tensor, context: Optional[torch.Tensor],
                    num_heads: int) -> torch.Tensor:
    """attn1 (self, context=None) / attn2 (cross); to_q/k/v have no bias."""
    b, l, c = x.shape
    ctx = x if context is None else context
    d = c // num_heads

    def heads(t, n):
        return t.reshape(b, n, num_heads, d).transpose(1, 2)

    q = heads(linear(x, p[f"{pre}.to_q.weight"]), l)
    k = heads(linear(ctx, p[f"{pre}.to_k.weight"]), ctx.shape[1])
    v = heads(linear(ctx, p[f"{pre}.to_v.weight"]), ctx.shape[1])
    o = attention(q, k, v).transpose(1, 2).reshape(b, l, c)
    return linear(o, p[f"{pre}.to_out.0.weight"], p[f"{pre}.to_out.0.bias"])


def geglu_ff(p, pre: str, x: torch.Tensor) -> torch.Tensor:
    h = linear(x, p[f"{pre}.net.0.proj.weight"], p[f"{pre}.net.0.proj.bias"])
    a, g = h.chunk(2, dim=-1)
    return linear(a * gelu(g), p[f"{pre}.net.2.weight"], p[f"{pre}.net.2.bias"])


def transformer_block(p, pre: str, x: torch.Tensor, context: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    h = layer_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"])
    x = x + cross_attention(p, f"{pre}.attn1", h, None, num_heads)
    h = layer_norm(x, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"])
    x = x + cross_attention(p, f"{pre}.attn2", h, context, num_heads)
    h = layer_norm(x, p[f"{pre}.norm3.weight"], p[f"{pre}.norm3.bias"])
    return x + geglu_ff(p, f"{pre}.ff", h)


def spatial_transformer(p, pre: str, x: torch.Tensor, context: torch.Tensor, cfg: UNetConfig,
                        depth: int) -> torch.Tensor:
    """GroupNorm, ``proj_in`` (a 1x1 conv, or with
    ``use_linear_in_transformer`` a linear on the tokens), ``depth``
    transformer blocks over the H·W tokens, ``proj_out`` likewise, residual."""
    b, hh, ww, c = x.shape
    num_heads = _heads_for(cfg, c)
    h = group_norm(x, p[f"{pre}.norm.weight"], p[f"{pre}.norm.bias"], eps=1e-6)
    if cfg.use_linear_in_transformer:
        h = linear(h.reshape(b, hh * ww, c), p[f"{pre}.proj_in.weight"], p[f"{pre}.proj_in.bias"])
    else:
        h = conv2d(h, p[f"{pre}.proj_in.weight"], p[f"{pre}.proj_in.bias"], padding=0)
        h = h.reshape(b, hh * ww, c)
    for k in range(depth):
        h = transformer_block(p, f"{pre}.transformer_blocks.{k}", h, context, num_heads)
    if cfg.use_linear_in_transformer:
        h = linear(h, p[f"{pre}.proj_out.weight"], p[f"{pre}.proj_out.bias"]).reshape(b, hh, ww, c)
    else:
        h = conv2d(h.reshape(b, hh, ww, c), p[f"{pre}.proj_out.weight"], p[f"{pre}.proj_out.bias"],
                   padding=0)
    return x + h


def upsample(p, pre: str, x: torch.Tensor) -> torch.Tensor:
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return conv2d(x, p[f"{pre}.conv.weight"], p[f"{pre}.conv.bias"])


def _block_layout(cfg: UNetConfig):
    """Static layout of (input_blocks, output_blocks) with CompVis block
    indices, which the tiny UNets keep with holes (the index advances an
    extra step a level and before each upsample, so their checkpoints name
    blocks as their full parents do).  inputs: [(idx, [kinds])]; outputs:
    [(idx, [kinds], up)] where up is None or (up_idx, up_sub) naming the
    UpSample conv position."""
    inputs = [(0, ["conv"])]
    ds = 1
    idx = 0
    for level, _ in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            idx += 1
            blk = ["res"]
            if ds in cfg.attention_resolutions and cfg.transformer_depth[level] > 0:
                blk.append(("attn", cfg.transformer_depth[level]))
            inputs.append((idx, blk))
            if cfg.tiny_unet:
                idx += 1
        if level != len(cfg.channel_mult) - 1:
            idx += 1
            inputs.append((idx, ["down"]))
            ds *= 2
    outputs = []
    obi = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            blk = ["res"]
            up_sub = 1
            if ds in cfg.attention_resolutions and cfg.transformer_depth[level] > 0:
                blk.append(("attn", cfg.transformer_depth[level]))
                up_sub += 1
            entry_idx = obi
            up = None
            if level != 0 and i == cfg.num_res_blocks:
                if cfg.tiny_unet:
                    obi += 1
                    if obi == 2:
                        up_sub = 1
                up = (obi, up_sub)
                ds //= 2
            outputs.append((entry_idx, blk, up))
            obi += 1
    return inputs, outputs


def unet_forward(p, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                 y: Optional[torch.Tensor] = None, cfg: UNetConfig = SD1_UNET_CONFIG,
                 controls=None, control_strength: float = 1.0) -> torch.Tensor:
    """x: [B,H,W,C] latent (NHWC), timesteps: [B], context: [B,L,ctx],
    y: [B, adm_in_channels] (SDXL's vector, added through the label
    embedding) → eps prediction [B,H,W,out].  A ``y`` given to a config
    without ``adm_in_channels`` raises.

    controls: optional (per-input-block residuals, middle residual) from a
    ControlNet (``models.controlnet.controlnet_forward``), added to the
    skips and the middle scaled by ``control_strength``."""
    if y is not None and cfg.adm_in_channels is None:
        raise ValueError("y given to a UNet without a label embedding (adm_in_channels is None)")
    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = linear(t_emb, p["time_embed.0.weight"], p["time_embed.0.bias"])
    emb = linear(silu(emb), p["time_embed.2.weight"], p["time_embed.2.bias"])
    if y is not None:
        lemb = linear(y.to(x.dtype), p["label_emb.0.0.weight"], p["label_emb.0.0.bias"])
        emb = emb + linear(silu(lemb), p["label_emb.0.2.weight"], p["label_emb.0.2.bias"])
    context = context.to(x.dtype)

    inputs, outputs = _block_layout(cfg)
    hs = []
    h = x
    for bi, blk in inputs:
        for j, kind in enumerate(blk):
            pre = f"input_blocks.{bi}.{j}"
            if kind == "conv":
                h = conv2d(h, p[f"{pre}.weight"], p[f"{pre}.bias"])
            elif kind == "res":
                h = resblock(p, pre, h, emb)
            elif kind == "down":
                h = conv2d(h, p[f"{pre}.op.weight"], p[f"{pre}.op.bias"], stride=2)
            else:
                h = spatial_transformer(p, pre, h, context, cfg, kind[1])
        hs.append(h)

    if not cfg.tiny_unet:
        h = resblock(p, "middle_block.0", h, emb)
        mid_depth = cfg.transformer_depth[-1] if cfg.transformer_depth[-1] > 0 else 1
        h = spatial_transformer(p, "middle_block.1", h, context, cfg, mid_depth)
        h = resblock(p, "middle_block.2", h, emb)

    if controls is not None:
        block_controls, middle_control = controls
        h = h + middle_control.to(h.dtype) * control_strength
        hs = [s + c.to(s.dtype) * control_strength for s, c in zip(hs, block_controls)]

    for bi, blk, up in outputs:
        h = torch.cat([h, hs.pop()], dim=-1)
        for j, kind in enumerate(blk):
            pre = f"output_blocks.{bi}.{j}"
            if kind == "res":
                h = resblock(p, pre, h, emb)
            else:
                h = spatial_transformer(p, pre, h, context, cfg, kind[1])
        if up is not None:
            h = upsample(p, f"output_blocks.{up[0]}.{up[1]}", h)

    h = silu(group_norm(h, p["out.0.weight"], p["out.0.bias"], eps=1e-5))
    return conv2d(h, p["out.2.weight"], p["out.2.bias"])


def param_specs(cfg: UNetConfig) -> dict:
    """name → (shape, init) for every tensor ``unet_forward`` reads; init is
    'normal' (std 0.02), 'zeros' (biases) or 'ones' (norm gains), as the JAX
    ``unet_param_shapes`` / ``init_unet_params`` set them."""
    specs = {}

    def w(name, *shape):
        specs[name] = (tuple(shape), "normal")

    def norm(name, ch):
        specs[f"{name}.weight"] = ((ch,), "ones")
        specs[f"{name}.bias"] = ((ch,), "zeros")

    def lin(name, out_c, in_c, bias=True):
        w(f"{name}.weight", out_c, in_c)
        if bias:
            specs[f"{name}.bias"] = ((out_c,), "zeros")

    def conv(name, out_c, in_c, k=3):
        w(f"{name}.weight", out_c, in_c, k, k)
        specs[f"{name}.bias"] = ((out_c,), "zeros")

    def res(pre, in_c, out_c, emb_dim):
        norm(f"{pre}.in_layers.0", in_c)
        conv(f"{pre}.in_layers.2", out_c, in_c)
        lin(f"{pre}.emb_layers.1", out_c, emb_dim)
        norm(f"{pre}.out_layers.0", out_c)
        conv(f"{pre}.out_layers.3", out_c, out_c)
        if in_c != out_c:
            conv(f"{pre}.skip_connection", out_c, in_c, k=1)

    def attn_block(pre, dim, ctx):
        lin(f"{pre}.to_q", dim, dim, bias=False)
        lin(f"{pre}.to_k", dim, ctx, bias=False)
        lin(f"{pre}.to_v", dim, ctx, bias=False)
        lin(f"{pre}.to_out.0", dim, dim)

    def spatial(pre, dim, depth):
        norm(f"{pre}.norm", dim)
        proj = lin if cfg.use_linear_in_transformer else functools.partial(conv, k=1)
        proj(f"{pre}.proj_in", dim, dim)
        proj(f"{pre}.proj_out", dim, dim)
        for k in range(depth):
            tb = f"{pre}.transformer_blocks.{k}"
            norm(f"{tb}.norm1", dim)
            attn_block(f"{tb}.attn1", dim, dim)
            norm(f"{tb}.norm2", dim)
            attn_block(f"{tb}.attn2", dim, cfg.context_dim)
            norm(f"{tb}.norm3", dim)
            lin(f"{tb}.ff.net.0.proj", dim * 8, dim)
            lin(f"{tb}.ff.net.2", dim, dim * 4)

    mc = cfg.model_channels
    emb_dim = 4 * mc
    lin("time_embed.0", emb_dim, mc)
    lin("time_embed.2", emb_dim, emb_dim)
    if cfg.adm_in_channels is not None:
        lin("label_emb.0.0", emb_dim, cfg.adm_in_channels)
        lin("label_emb.0.2", emb_dim, emb_dim)
    conv("input_blocks.0.0", mc, cfg.in_channels)

    layout_in, layout_out = _block_layout(cfg)
    skips = [mc]
    cur = mc
    level = 0
    for bi, blk in layout_in[1:]:
        if blk == ["down"]:
            conv(f"input_blocks.{bi}.0.op", cur, cur)
            level += 1
        else:
            out_c = cfg.channel_mult[level] * mc
            res(f"input_blocks.{bi}.0", cur, out_c, emb_dim)
            cur = out_c
            if len(blk) > 1:
                spatial(f"input_blocks.{bi}.1", out_c, blk[1][1])
        skips.append(cur)

    top = cfg.channel_mult[-1] * mc
    if not cfg.tiny_unet:
        res("middle_block.0", top, top, emb_dim)
        spatial("middle_block.1", top, cfg.transformer_depth[-1] if cfg.transformer_depth[-1] > 0 else 1)
        res("middle_block.2", top, top, emb_dim)

    for oi, (bi, blk, up) in enumerate(layout_out):
        lvl = len(cfg.channel_mult) - 1 - oi // (cfg.num_res_blocks + 1)
        out_c = cfg.channel_mult[lvl] * mc
        res(f"output_blocks.{bi}.0", cur + skips.pop(), out_c, emb_dim)
        cur = out_c
        if len(blk) > 1:
            spatial(f"output_blocks.{bi}.1", out_c, blk[1][1])
        if up is not None:
            conv(f"output_blocks.{up[0]}.{up[1]}.conv", out_c, out_c)

    norm("out.0", mc)
    conv("out.2", cfg.out_channels, mc)
    return specs
