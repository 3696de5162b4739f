"""Wan 2.1 T2V video DiT (counterpart of ``sdtpu/models/wan.py``).

Params are a flat dict keyed by the Wan checkpoint names
(``blocks.N.{self_attn,cross_attn}.{q,k,v,o,norm_q,norm_k}``,
``blocks.N.norm3``, ``blocks.N.ffn.{0,2}``, ``blocks.N.modulation``,
``patch_embedding``, ``text_embedding.{0,2}``, ``time_embedding.{0,2}``,
``time_projection.1``, ``head.{head,modulation}``); latents are
[B, T, H, W, C].  The whole clip is one token sequence over the (t, h, w)
patch grid with a 3-axis RoPE (FLUX's rotation helpers); self-attention
and the T2V cross-attention over the text go through ``ops.attention``
(flash on the card, D 128 at every published width).  The linears are
dense ``F.linear``, as the JAX package computes them with ``jnp.dot``, and
the norms, modulation and gated residuals keep its float32 internals.

I2V (``clip_fea``, ``k_img`` / ``v_img``, ``img_emb``), VACE
(``vace_blocks``, ``vace_context``) and the Wan2.2 TI2V-5B config are not
ported: the config keeps their fields (so it compares equal to the JAX
one) and ``check_supported`` refuses them by name.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.models.flux import apply_rope, rope_freqs
from sdtpu_torch.ops import attention, gelu, gelu_tanh, layer_norm, linear, rms_norm, silu, timestep_embedding


@dataclasses.dataclass(frozen=True)
class WanConfig:
    model_type: str = "t2v"  # "t2v" | "i2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    in_dim: int = 16
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 12
    num_layers: int = 30
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    theta: int = 10000
    axes_dim: Tuple[int, ...] = (44, 42, 42)
    vace_layers: int = 0
    vace_in_dim: int = 96


WAN21_T2V_1_3B_CONFIG = WanConfig()
WAN21_T2V_14B_CONFIG = WanConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)
WAN21_I2V_14B_CONFIG = dataclasses.replace(WAN21_T2V_14B_CONFIG, model_type="i2v", in_dim=36)
WAN22_TI2V_5B_CONFIG = WanConfig(dim=3072, ffn_dim=14336, num_heads=24, num_layers=30, in_dim=48,
                                 out_dim=48)


def check_supported(cfg: WanConfig) -> None:
    """Refuse, by name, what the port does not run: I2V, VACE, Wan2.2 TI2V."""
    if cfg.model_type != "t2v":
        raise NotImplementedError(f"Wan {cfg.model_type} (clip_fea, k_img / v_img, img_emb) is not "
                                  "ported; the port runs Wan2.1 T2V")
    if cfg.vace_layers:
        raise NotImplementedError("Wan VACE (vace_blocks, vace_context) is not ported")
    if cfg.in_dim == 48 or cfg.out_dim == 48:
        raise NotImplementedError("the Wan2.2 TI2V-5B config (48 latent channels) is not ported")


def detect_wan_config(names, shapes) -> WanConfig:
    """The config a checkpoint's names and shapes fingerprint, as the JAX
    package's: depth from ``blocks.N``, I2V from ``img_emb`` or 36 input
    channels, VACE depth from ``vace_blocks.N``, widths from the weights
    (every published Wan has 128-wide heads)."""
    num_layers = 0
    vace_layers = 0
    is_i2v = False
    for n in names:
        if n.startswith("blocks."):
            num_layers = max(num_layers, int(n.split(".")[1]) + 1)
        if n.startswith("vace_blocks."):
            vace_layers = max(vace_layers, int(n.split(".")[1]) + 1)
        if "img_emb" in n:
            is_i2v = True
    in_dim = shapes.get("patch_embedding.weight", (0, 16))[1]
    if num_layers == 40:
        base = WAN21_I2V_14B_CONFIG if (is_i2v or in_dim == 36) else WAN21_T2V_14B_CONFIG
    elif num_layers == 30 and in_dim == 48:
        base = WAN22_TI2V_5B_CONFIG
    else:
        base = WAN21_T2V_1_3B_CONFIG
    base = dataclasses.replace(
        base, in_dim=in_dim or base.in_dim, num_layers=num_layers or base.num_layers,
        model_type="i2v" if is_i2v else base.model_type, vace_layers=vace_layers,
        vace_in_dim=shapes.get("vace_patch_embedding.weight", (0, base.vace_in_dim))[1])
    dim = shapes.get("patch_embedding.weight", (0,))[0]
    ffn = shapes.get("blocks.0.ffn.0.weight", (0,))[0]
    out = shapes.get("head.head.weight", (0,))
    if dim and dim % 128 == 0:
        pt, ph, pw = base.patch_size
        base = dataclasses.replace(
            base, dim=dim, num_heads=dim // 128, ffn_dim=ffn or base.ffn_dim,
            out_dim=(out[0] // (pt * ph * pw)) if out[0] else base.out_dim,
            text_dim=shapes.get("text_embedding.0.weight", (0, base.text_dim))[1])
    return base


def param_specs(cfg: WanConfig) -> dict:
    """name → (shape, init) as ``init_wan_params`` sets them: weights and
    the modulation tables normal (std 0.02), biases zero, norm gains one."""
    check_supported(cfg)
    dim = cfg.dim
    pt, ph, pw = cfg.patch_size
    specs = {"patch_embedding.weight": ((dim, cfg.in_dim, pt, ph, pw), "normal"),
             "patch_embedding.bias": ((dim,), "zeros")}

    def lin(name, o, i):
        specs[f"{name}.weight"] = ((o, i), "normal")
        specs[f"{name}.bias"] = ((o,), "zeros")

    def norm(name, n, bias=False):
        specs[f"{name}.weight"] = ((n,), "ones")
        if bias:
            specs[f"{name}.bias"] = ((n,), "zeros")

    lin("text_embedding.0", dim, cfg.text_dim)
    lin("text_embedding.2", dim, dim)
    lin("time_embedding.0", dim, cfg.freq_dim)
    lin("time_embedding.2", dim, dim)
    lin("time_projection.1", dim * 6, dim)
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            for ln in ("q", "k", "v", "o"):
                lin(f"{pre}.{attn}.{ln}", dim, dim)
            norm(f"{pre}.{attn}.norm_q", dim)
            norm(f"{pre}.{attn}.norm_k", dim)
        if cfg.cross_attn_norm:
            norm(f"{pre}.norm3", dim, bias=True)
        lin(f"{pre}.ffn.0", cfg.ffn_dim, dim)
        lin(f"{pre}.ffn.2", dim, cfg.ffn_dim)
        specs[f"{pre}.modulation"] = ((1, 6, dim), "normal")
    lin("head.head", cfg.out_dim * pt * ph * pw, dim)
    specs["head.modulation"] = ((1, 2, dim), "normal")
    return specs


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, c = t.shape
    return t.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def _wan_attention(p, pre: str, x, rot, num_heads: int, eps: float):
    """Self-attention: q and k RMS-normed over the full width, 3-axis RoPE."""
    b, l, dim = x.shape
    q = rms_norm(linear(x, p[f"{pre}.q.weight"], p[f"{pre}.q.bias"]), p[f"{pre}.norm_q.weight"], eps=eps)
    k = rms_norm(linear(x, p[f"{pre}.k.weight"], p[f"{pre}.k.bias"]), p[f"{pre}.norm_k.weight"], eps=eps)
    v = linear(x, p[f"{pre}.v.weight"], p[f"{pre}.v.bias"])
    q = apply_rope(_heads(q, num_heads), rot)
    k = apply_rope(_heads(k, num_heads), rot)
    o = attention(q, k, _heads(v, num_heads)).transpose(1, 2).reshape(b, l, dim)
    return linear(o, p[f"{pre}.o.weight"], p[f"{pre}.o.bias"])


def _wan_cross_attention(p, pre: str, x, context, num_heads: int, eps: float):
    """T2V cross-attention on the text tokens (q and k RMS-normed)."""
    b, l, dim = x.shape
    q = rms_norm(linear(x, p[f"{pre}.q.weight"], p[f"{pre}.q.bias"]), p[f"{pre}.norm_q.weight"], eps=eps)
    k = rms_norm(linear(context, p[f"{pre}.k.weight"], p[f"{pre}.k.bias"]),
                 p[f"{pre}.norm_k.weight"], eps=eps)
    v = linear(context, p[f"{pre}.v.weight"], p[f"{pre}.v.bias"])
    o = attention(_heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads))
    return linear(o.transpose(1, 2).reshape(b, l, dim), p[f"{pre}.o.weight"], p[f"{pre}.o.bias"])


def wan_block_params(p, pre: str) -> dict:
    """Local (prefix-stripped) view of one transformer block's params."""
    plen = len(pre) + 1
    return {k[plen:]: v for k, v in p.items() if k.startswith(pre + ".")}


def wan_block_forward(bp, h, e0, ctx, rot, cfg: WanConfig):
    """One Wan transformer block on local params."""
    es = (e0 + bp["modulation"].reshape(1, 6, cfg.dim)).to(h.dtype)
    shift_sa, scale_sa, gate_sa = es[:, 0, None], es[:, 1, None], es[:, 2, None]
    shift_ff, scale_ff, gate_ff = es[:, 3, None], es[:, 4, None], es[:, 5, None]

    y = layer_norm(h, eps=cfg.eps) * (1 + scale_sa) + shift_sa
    y = _wan_attention(bp, "self_attn", y, rot, cfg.num_heads, cfg.eps)
    h = h + y * gate_sa

    hn = layer_norm(h, bp["norm3.weight"], bp["norm3.bias"], eps=cfg.eps) if cfg.cross_attn_norm else h
    h = h + _wan_cross_attention(bp, "cross_attn", hn, ctx, cfg.num_heads, cfg.eps)

    y = layer_norm(h, eps=cfg.eps) * (1 + scale_ff) + shift_ff
    y = linear(y, bp["ffn.0.weight"], bp["ffn.0.bias"])
    y = linear(gelu_tanh(y), bp["ffn.2.weight"], bp["ffn.2.bias"])
    return h + y * gate_ff


@functools.lru_cache(maxsize=8)
def _rope_table(tl: int, hl: int, wl: int, axes_dim, theta: int, device: str) -> torch.Tensor:
    """RoPE rotations over the (t, h, w) patch grid, moved to the device once
    per shape."""
    ids = np.zeros((tl * hl * wl, 3), dtype=np.int64)
    ti, hi, wi = np.meshgrid(np.arange(tl), np.arange(hl), np.arange(wl), indexing="ij")
    ids[:, 0], ids[:, 1], ids[:, 2] = ti.reshape(-1), hi.reshape(-1), wi.reshape(-1)
    return torch.from_numpy(rope_freqs(ids, axes_dim, theta)).to(device)


def wan_prologue(p, x, timesteps, context, cfg: WanConfig):
    """Patchify + embeddings + RoPE → (img, e, e0, ctx, rot, dims); dims are
    the input's and the patch grid's sizes for the head."""
    b, t, hh, ww, c = x.shape
    pt, ph, pw = cfg.patch_size
    pad_t, pad_h, pad_w = (-t) % pt, (-hh) % ph, (-ww) % pw
    if pad_t or pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_t))
    tl, hl, wl = (t + pad_t) // pt, (hh + pad_h) // ph, (ww + pad_w) // pw

    # tokens ordered (t, h, w); each patch vector ordered (C, pt, ph, pw), as
    # the Conv3d weight [dim, C, pt, ph, pw] lays it out
    img = (x.reshape(b, tl, pt, hl, ph, wl, pw, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
           .reshape(b, tl * hl * wl, c * pt * ph * pw))
    img = linear(img, p["patch_embedding.weight"].reshape(cfg.dim, -1), p["patch_embedding.bias"])

    t_emb = timestep_embedding(timesteps, cfg.freq_dim).to(x.dtype)
    e = linear(t_emb, p["time_embedding.0.weight"], p["time_embedding.0.bias"])
    e = linear(silu(e), p["time_embedding.2.weight"], p["time_embedding.2.bias"])
    e0 = linear(silu(e), p["time_projection.1.weight"], p["time_projection.1.bias"]).reshape(b, 6, cfg.dim)

    ctx = linear(context.to(x.dtype), p["text_embedding.0.weight"], p["text_embedding.0.bias"])
    ctx = linear(gelu(ctx), p["text_embedding.2.weight"], p["text_embedding.2.bias"])
    rot = _rope_table(tl, hl, wl, tuple(cfg.axes_dim), cfg.theta, str(x.device))
    return img, e, e0, ctx, rot, (b, t, hh, ww, tl, hl, wl)


def wan_head(p, h, e, cfg: WanConfig, dims):
    """Final modulated norm + head + unpatchify."""
    b, t, hh, ww, tl, hl, wl = dims
    pt, ph, pw = cfg.patch_size
    e2 = (e[:, None, :] + p["head.modulation"].reshape(1, 2, cfg.dim)).to(h.dtype)
    h = layer_norm(h, eps=cfg.eps) * (1 + e2[:, 1, None]) + e2[:, 0, None]
    h = linear(h, p["head.head.weight"], p["head.head.bias"])
    out = (h.reshape(b, tl, hl, wl, cfg.out_dim, pt, ph, pw).permute(0, 1, 5, 2, 6, 3, 7, 4)
           .reshape(b, tl * pt, hl * ph, wl * pw, cfg.out_dim))
    return out[:, :t, :hh, :ww, :]


def wan_forward(p, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                clip_fea: Optional[torch.Tensor] = None, cfg: WanConfig = WAN21_T2V_1_3B_CONFIG,
                vace_context: Optional[torch.Tensor] = None,
                skip_layers: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: [B, T, H, W, C] video latent; timesteps: [B] in [0, 1000];
    context: [B, L, text_dim] UMT5 states → the velocity [B, T, H, W,
    out_dim].  ``skip_layers``: blocks to skip (the Skip-Layer Guidance
    pass).  ``clip_fea`` (I2V) and ``vace_context`` raise."""
    check_supported(cfg)
    if clip_fea is not None:
        raise NotImplementedError("Wan I2V (clip_fea) is not ported")
    if vace_context is not None:
        raise NotImplementedError("Wan VACE (vace_context) is not ported")
    img, e, e0, ctx, rot, dims = wan_prologue(p, x, timesteps, context, cfg)
    h = img
    for i in range(cfg.num_layers):
        if i not in skip_layers:
            pre = f"blocks.{i}"
            h = wan_block_forward(wan_block_params(p, pre), h, e0, ctx, rot, cfg)
    return wan_head(p, h, e, cfg, dims)
