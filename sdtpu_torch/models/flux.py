"""FLUX.1 — double/single-stream rectified-flow DiT (counterpart of
``sdtpu/models/flux.py``, standard FLUX.1 dev/schnell path).

Params are a flat dict keyed by checkpoint names (``double_blocks.N.…``,
``single_blocks.N.…``, ``img_in``, ``txt_in``, ``time_in``, ``vector_in``,
``guidance_in``, ``final_layer``).  Latents are NHWC and packed 2×2 into
tokens; RoPE runs over (id, y, x) axes.  The Chroma, SeFi, Radiance,
Kontext-reference, PuLID and FLUX.2-style variants are not ported yet: the
config keeps their fields (so it compares equal to the JAX one) and
``flux_forward`` refuses them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.ops import attention, gelu_tanh, layer_norm, linear, rms_norm, silu, timestep_embedding


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64  # packed 16ch × 2×2
    out_channels: Optional[int] = None
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    context_in_dim: int = 4096
    vec_in_dim: int = 768
    guidance_embed: bool = True  # dev; schnell = False
    is_chroma: bool = False
    chroma_use_dit_mask: bool = True
    share_modulation: bool = False
    disable_bias: bool = False
    mlp_silu: bool = False
    qkv_bias: bool = True
    txt_arange_axes: Tuple[int, ...] = ()
    patch_size: int = 2
    yak_mlp: bool = False
    semantic_txt_norm: bool = False
    longcat_rope: bool = False
    is_sefi: bool = False
    sefi_sem_channels: int = 16
    is_radiance: bool = False
    nerf_hidden: int = 64
    nerf_mlp_ratio: int = 4
    nerf_depth: int = 4
    nerf_max_freqs: int = 8
    radiance_x0: bool = False
    fake_patch_x2: bool = False
    ref_index_increase: bool = False
    ref_index_scale: float = 1.0


FLUX_DEV_CONFIG = FluxConfig()
FLUX_SCHNELL_CONFIG = FluxConfig(guidance_embed=False)

_UNPORTED_VARIANTS = ("is_chroma", "share_modulation", "mlp_silu", "yak_mlp",
                      "semantic_txt_norm", "longcat_rope", "is_sefi", "is_radiance",
                      "txt_arange_axes")


def check_supported(cfg: FluxConfig) -> None:
    bad = [f for f in _UNPORTED_VARIANTS if getattr(cfg, f)]
    if bad:
        raise NotImplementedError(f"FLUX variants not ported yet: {bad}")


def param_specs(cfg: FluxConfig) -> dict:
    """name → (shape, init) for every tensor ``flux_forward`` reads; init is
    'normal' (std 0.02), 'zeros' (biases) or 'ones' (norm scales), as the JAX
    init (``init_flux_params``) sets them."""
    check_supported(cfg)
    hid = cfg.hidden_size
    mlp_h = int(hid * cfg.mlp_ratio)
    d_head = hid // cfg.num_heads
    use_bias = not cfg.disable_bias
    specs = {}

    def lin(name, o, i, bias=use_bias):
        specs[f"{name}.weight"] = ((o, i), "normal")
        if bias:
            specs[f"{name}.bias"] = ((o,), "zeros")

    def scale(name):
        specs[name] = ((d_head,), "ones")

    lin("img_in", hid, cfg.in_channels)
    lin("txt_in", hid, cfg.context_in_dim)
    lin("time_in.in_layer", hid, 256)
    lin("time_in.out_layer", hid, hid)
    if cfg.vec_in_dim > 0:
        lin("vector_in.in_layer", hid, cfg.vec_in_dim)
        lin("vector_in.out_layer", hid, hid)
    if cfg.guidance_embed:
        lin("guidance_in.in_layer", hid, 256)
        lin("guidance_in.out_layer", hid, hid)
    for i in range(cfg.depth):
        for s in ("img", "txt"):
            pre = f"double_blocks.{i}.{s}"
            lin(f"{pre}_mod.lin", 6 * hid, hid)
            lin(f"{pre}_attn.qkv", 3 * hid, hid, bias=cfg.qkv_bias and use_bias)
            scale(f"{pre}_attn.norm.query_norm.scale")
            scale(f"{pre}_attn.norm.key_norm.scale")
            lin(f"{pre}_attn.proj", hid, hid)
            lin(f"{pre}_mlp.0", mlp_h, hid)
            lin(f"{pre}_mlp.2", hid, mlp_h)
    for i in range(cfg.depth_single):
        pre = f"single_blocks.{i}"
        lin(f"{pre}.modulation.lin", 3 * hid, hid)
        lin(f"{pre}.linear1", 3 * hid + mlp_h, hid)
        lin(f"{pre}.linear2", hid, hid + mlp_h)
        scale(f"{pre}.norm.query_norm.scale")
        scale(f"{pre}.norm.key_norm.scale")
    lin("final_layer.adaLN_modulation.1", 2 * hid, hid)
    lin("final_layer.linear", cfg.out_channels or cfg.in_channels, hid)
    return specs


def rope_freqs(ids: np.ndarray, axes_dim, theta: int) -> np.ndarray:
    """ids: [L, n_axes] int → [L, sum(dim)/2, 2, 2] rotations (host, f64 → f32)."""
    outs = []
    for a, dim in enumerate(axes_dim):
        pos = ids[:, a].astype(np.float64)
        omega = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        out = pos[:, None] * omega[None, :]
        cos, sin = np.cos(out), np.sin(out)
        rot = np.stack([np.stack([cos, -sin], axis=-1), np.stack([sin, cos], axis=-1)], axis=-2)
        outs.append(rot)
    return np.concatenate(outs, axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _rope_table(l_txt: int, hp: int, wp: int, axes_dim, theta: int, device: str) -> torch.Tensor:
    """RoPE rotations for txt tokens (ids 0) then the hp×wp image grid, moved
    to the device once per shape."""
    ids = np.zeros((l_txt + hp * wp, len(axes_dim)), dtype=np.int64)
    ii, jj = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
    ids[l_txt:, 1] = ii.reshape(-1)
    ids[l_txt:, 2] = jj.reshape(-1)
    return torch.from_numpy(rope_freqs(ids, axes_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """x: [B, H, L, D], rot: [L, D/2, 2, 2] f32."""
    b, h, l, d = x.shape
    xf = x.float().reshape(b, h, l, d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    o0 = rot[..., 0, 0] * x0 + rot[..., 0, 1] * x1
    o1 = rot[..., 1, 0] * x0 + rot[..., 1, 1] * x1
    return torch.stack([o0, o1], dim=-1).reshape(b, h, l, d).to(x.dtype)


def _mlp_embed(p, pre, x):
    h = linear(x, p[f"{pre}.in_layer.weight"], p.get(f"{pre}.in_layer.bias"))
    return linear(silu(h), p[f"{pre}.out_layer.weight"], p.get(f"{pre}.out_layer.bias"))


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, c = t.shape
    return t.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def _qkv_norm(p, pre, x, num_heads):
    qkv = linear(x, p[f"{pre}.qkv.weight"], p.get(f"{pre}.qkv.bias"))
    q, k, v = (_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    q = rms_norm(q, p[f"{pre}.norm.query_norm.scale"], eps=1e-6)
    k = rms_norm(k, p[f"{pre}.norm.key_norm.scale"], eps=1e-6)
    return q, k, v


def _modulation(p, pre, vec, n: int):
    m = linear(silu(vec), p[f"{pre}.lin.weight"], p.get(f"{pre}.lin.bias"))
    return m.chunk(n, dim=-1)


def _modulate(x, shift, scale):
    return layer_norm(x, eps=1e-6) * (1 + scale[:, None]) + shift[:, None]


def _double_mlp(p, pre, h):
    h = linear(h, p[f"{pre}.0.weight"], p.get(f"{pre}.0.bias"))
    return linear(gelu_tanh(h), p[f"{pre}.2.weight"], p.get(f"{pre}.2.bias"))


def flux_double_block(p, pre, img, txt, vec, rot, cfg: FluxConfig):
    """One MMDiT double-stream block (joint attention over [txt, img])."""
    b = img.shape[0]
    l_txt = txt.shape[1]
    im = _modulation(p, f"{pre}.img_mod", vec, 6)
    tm = _modulation(p, f"{pre}.txt_mod", vec, 6)
    iq, ik, iv = _qkv_norm(p, f"{pre}.img_attn", _modulate(img, im[0], im[1]), cfg.num_heads)
    tq, tk, tv = _qkv_norm(p, f"{pre}.txt_attn", _modulate(txt, tm[0], tm[1]), cfg.num_heads)
    q = apply_rope(torch.cat([tq, iq], dim=2), rot)
    k = apply_rope(torch.cat([tk, ik], dim=2), rot)
    v = torch.cat([tv, iv], dim=2)
    att = attention(q, k, v).transpose(1, 2).reshape(b, -1, cfg.hidden_size)
    txt_att, img_att = att[:, :l_txt], att[:, l_txt:]
    img = img + im[2][:, None] * linear(img_att, p[f"{pre}.img_attn.proj.weight"],
                                        p.get(f"{pre}.img_attn.proj.bias"))
    img = img + im[5][:, None] * _double_mlp(p, f"{pre}.img_mlp", _modulate(img, im[3], im[4]))
    txt = txt + tm[2][:, None] * linear(txt_att, p[f"{pre}.txt_attn.proj.weight"],
                                        p.get(f"{pre}.txt_attn.proj.bias"))
    txt = txt + tm[5][:, None] * _double_mlp(p, f"{pre}.txt_mlp", _modulate(txt, tm[3], tm[4]))
    return img, txt


def flux_single_block(p, pre, xx, vec, rot, cfg: FluxConfig):
    """One single-stream block: fused qkv + MLP-in, joint attention, fused out."""
    b, seq = xx.shape[:2]
    hidden = cfg.hidden_size
    mods = _modulation(p, f"{pre}.modulation", vec, 3)
    h1 = linear(_modulate(xx, mods[0], mods[1]), p[f"{pre}.linear1.weight"],
                p.get(f"{pre}.linear1.bias"))
    qkv, mlp = h1[..., : 3 * hidden], h1[..., 3 * hidden:]
    q, k, v = (_heads(t, cfg.num_heads) for t in qkv.chunk(3, dim=-1))
    q = apply_rope(rms_norm(q, p[f"{pre}.norm.query_norm.scale"], eps=1e-6), rot)
    k = apply_rope(rms_norm(k, p[f"{pre}.norm.key_norm.scale"], eps=1e-6), rot)
    att = attention(q, k, v).transpose(1, 2).reshape(b, seq, hidden)
    out = linear(torch.cat([att, gelu_tanh(mlp)], dim=-1), p[f"{pre}.linear2.weight"],
                 p.get(f"{pre}.linear2.bias"))
    return xx + mods[2][:, None] * out


def flux_prologue(p, x, timesteps, context, y, guidance, cfg: FluxConfig):
    """Patchify + embeddings → (img tokens, txt tokens, vec, rope table)."""
    b, h, w, c = x.shape
    ps = cfg.patch_size
    hp, wp = h // ps, w // ps
    img = (x.reshape(b, hp, ps, wp, ps, c).permute(0, 1, 3, 2, 4, 5)
           .reshape(b, hp * wp, ps * ps * c))
    img = linear(img, p["img_in.weight"], p.get("img_in.bias"))
    txt = linear(context.to(x.dtype), p["txt_in.weight"], p.get("txt_in.bias"))
    vec = _mlp_embed(p, "time_in", timestep_embedding(timesteps * 1000.0, 256).to(x.dtype))
    if cfg.guidance_embed and guidance is not None:
        g_emb = timestep_embedding(guidance * 1000.0, 256).to(x.dtype)
        vec = vec + _mlp_embed(p, "guidance_in", g_emb)
    if cfg.vec_in_dim > 0 and y is not None:
        vec = vec + _mlp_embed(p, "vector_in", y.to(x.dtype))
    rot = _rope_table(txt.shape[1], hp, wp, tuple(cfg.axes_dim), cfg.theta, str(x.device))
    return img, txt, vec, rot


def flux_head(p, img, vec, dims, cfg: FluxConfig):
    """Final adaLN + unpatchify; dims is the (b, h, w, c) of the model input."""
    b, h, w, c = dims
    ps = cfg.patch_size
    hp, wp = h // ps, w // ps
    oc = (cfg.out_channels // (ps * ps)) if cfg.out_channels else c
    mf = linear(silu(vec), p["final_layer.adaLN_modulation.1.weight"],
                p.get("final_layer.adaLN_modulation.1.bias"))
    shift, scale = mf.chunk(2, dim=-1)
    img = linear(_modulate(img, shift, scale), p["final_layer.linear.weight"],
                 p.get("final_layer.linear.bias"))
    return (img.reshape(b, hp, wp, ps, ps, oc).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h, w, oc))


def flux_forward(p, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                 y: Optional[torch.Tensor], guidance: Optional[torch.Tensor] = None,
                 cfg: FluxConfig = FLUX_DEV_CONFIG,
                 skip_layers: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: [B,H,W,C] latent NHWC; timesteps: [B] (sigma in [0,1]); context:
    [B,L,context_in_dim] T5; y: [B,vec_in_dim] CLIP pooled; guidance: [B]
    distilled guidance; ``skip_layers``: the single blocks to skip (the
    Skip-Layer Guidance forward), block i indexed depth + i as in the JAX
    package.  Returns the velocity [B,H,W,C]."""
    check_supported(cfg)
    img, txt, vec, rot = flux_prologue(p, x, timesteps, context, y, guidance, cfg)
    for i in range(cfg.depth):
        img, txt = flux_double_block(p, f"double_blocks.{i}", img, txt, vec, rot, cfg)
    l_txt = txt.shape[1]
    xx = torch.cat([txt, img], dim=1)
    for i in range(cfg.depth_single):
        if i + cfg.depth not in skip_layers:
            xx = flux_single_block(p, f"single_blocks.{i}", xx, vec, rot, cfg)
    return flux_head(p, xx[:, l_txt:], vec, tuple(x.shape), cfg)
