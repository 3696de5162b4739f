"""Z-Image single-stream DiT (counterpart of ``sdtpu/models/z_image.py``:
``ZImageConfig``, ``detect_z_image_config``, ``_attn``, ``_ffn``,
``_block``, ``z_image_rope``, ``z_image_forward``, ``init_z_image_params``'
layout as ``param_specs``).

A Lumina-2-style joint stream: the text tokens (``cap_embedder``) run
through the unmodulated context refiner, the image patches
(``x_embedder``) through the modulated noise refiner, then both, text
first, through the main layers.  Each block has GQA attention with per-head
q/k RMS norms and a 3-axis RoPE (FLUX's rotation helpers), a SwiGLU FFN,
RMS sandwich norms and, where modulated, a scale-only adaLN with tanh
gates from the 256-wide timestep embedding.  The learned ``cap_pad_token``
and ``x_pad_token`` round each stream up to a multiple of 32 tokens; text
positions are 1..L, the image grid sits at L + 1 on axis 0, image pad
tokens get all-zero ids.  Latents are NHWC, patch features ordered
(py, px, c), c fastest.  The model predicts the negated velocity, so the
forward returns its output negated; the caller passes ``1000 - t``.

Checkpoint names: ``x_embedder``, ``t_embedder.mlp.{0,2}``,
``cap_embedder.{0,1}``, ``{noise_refiner,context_refiner,layers}.N.
{attention.{qkv,out,q_norm,k_norm}, feed_forward.{w1,w2,w3},
attention_norm{1,2}, ffn_norm{1,2}, adaLN_modulation.0}``,
``final_layer.{linear,adaLN_modulation.1}``, ``cap_pad_token``,
``x_pad_token``.  Z-Image-Omni's reference latents (``ref_latents``) are
not ported and raise by name.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sdtpu_torch.models.flux import apply_rope, rope_freqs
from sdtpu_torch.ops import attention, layer_norm, linear, rms_norm, silu, timestep_embedding

ADALN_EMBED_DIM = 256
SEQ_MULTI_OF = 32


@dataclasses.dataclass(frozen=True)
class ZImageConfig:
    patch_size: int = 2
    hidden_size: int = 3840
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 30
    num_refiner_layers: int = 2
    head_dim: int = 128
    num_heads: int = 30
    num_kv_heads: int = 30
    multiple_of: int = 256
    ffn_dim_multiplier: float = 8.0 / 3.0
    norm_eps: float = 1e-5
    cap_feat_dim: int = 2560
    theta: int = 256
    axes_dim: Tuple[int, ...] = (32, 48, 48)


Z_IMAGE_CONFIG = ZImageConfig()


def detect_z_image_config(names, shapes) -> ZImageConfig:
    """The config a checkpoint's names and shapes give, as the JAX
    package's: widths from ``x_embedder``, ``cap_embedder.1`` and
    ``final_layer.linear``, the head width from the q norm and the KV heads
    from the fused qkv, the depths from the block indices."""
    names = set(names)
    kw = {}
    xe = shapes.get("x_embedder.weight")
    if xe:
        kw["hidden_size"] = xe[0]
        kw["in_channels"] = xe[1] // 4
    ce = shapes.get("cap_embedder.1.weight")
    if ce:
        kw["cap_feat_dim"] = ce[1]
        kw["hidden_size"] = ce[0]
    fl = shapes.get("final_layer.linear.weight")
    if fl:
        kw["out_channels"] = fl[0] // 4
    qn = shapes.get("layers.0.attention.q_norm.weight")
    qkv = shapes.get("layers.0.attention.qkv.weight")
    if qn:
        hd = qn[0]
        kw["head_dim"] = hd
        nh = kw.get("hidden_size", 3840) // hd
        kw["num_heads"] = nh
        if qkv:
            kw["num_kv_heads"] = max(1, (qkv[0] // hd - nh) // 2)
    layers = refiners = 0
    for n in names:
        if n.startswith("layers."):
            layers = max(layers, int(n.split(".")[1]) + 1)
        elif n.startswith(("noise_refiner.", "context_refiner.")):
            refiners = max(refiners, int(n.split(".")[1]) + 1)
    if layers:
        kw["num_layers"] = layers
    if refiners:
        kw["num_refiner_layers"] = refiners
    return dataclasses.replace(Z_IMAGE_CONFIG, **kw)


def _bound_mod(n: int, m: int) -> int:
    return (m - n % m) % m


def _ffn_hidden(cfg: ZImageConfig) -> int:
    h = int(cfg.ffn_dim_multiplier * cfg.hidden_size)
    return cfg.multiple_of * ((h + cfg.multiple_of - 1) // cfg.multiple_of)


def param_specs(cfg: ZImageConfig) -> dict:
    """name → (shape, init) as ``init_z_image_params`` sets them: weights
    and the pad tokens normal (std 0.02), biases zero, norm gains one."""
    hid, ffh = cfg.hidden_size, _ffn_hidden(cfg)
    ada = min(hid, ADALN_EMBED_DIM)
    specs = {"cap_pad_token": ((hid,), "normal"), "x_pad_token": ((hid,), "normal"),
             "cap_embedder.0.weight": ((cfg.cap_feat_dim,), "ones")}

    def lin(pre, din, dout, bias=True):
        specs[f"{pre}.weight"] = ((dout, din), "normal")
        if bias:
            specs[f"{pre}.bias"] = ((dout,), "zeros")

    lin("x_embedder", cfg.patch_size ** 2 * cfg.in_channels, hid)
    te_hid = min(hid, 1024)
    lin("t_embedder.mlp.0", 256, te_hid)
    lin("t_embedder.mlp.2", te_hid, ada)
    lin("cap_embedder.1", cfg.cap_feat_dim, hid)

    def blk(pre, modulated):
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        lin(f"{pre}.attention.qkv", hid, (nh + 2 * nkv) * hd, bias=False)
        lin(f"{pre}.attention.out", nh * hd, hid, bias=False)
        specs[f"{pre}.attention.q_norm.weight"] = ((hd,), "ones")
        specs[f"{pre}.attention.k_norm.weight"] = ((hd,), "ones")
        lin(f"{pre}.feed_forward.w1", hid, ffh, bias=False)
        lin(f"{pre}.feed_forward.w2", ffh, hid, bias=False)
        lin(f"{pre}.feed_forward.w3", hid, ffh, bias=False)
        for nm in ("attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2"):
            specs[f"{pre}.{nm}.weight"] = ((hid,), "ones")
        if modulated:
            lin(f"{pre}.adaLN_modulation.0", ada, 4 * hid)

    for i in range(cfg.num_refiner_layers):
        blk(f"noise_refiner.{i}", True)
        blk(f"context_refiner.{i}", False)
    for i in range(cfg.num_layers):
        blk(f"layers.{i}", True)
    lin("final_layer.linear", hid, cfg.patch_size ** 2 * cfg.out_channels)
    lin("final_layer.adaLN_modulation.1", ada, hid)
    return specs


def _attn(p, pre, x, rot, cfg: ZImageConfig):
    """Fused GQA qkv, per-head q/k RMS norms (eps 1e-6), the rotation, one
    attention over the whole stream."""
    b, l, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = linear(x, p[f"{pre}.qkv.weight"], p.get(f"{pre}.qkv.bias")).reshape(b, l, nh + 2 * nkv, hd)
    q, k, v = qkv[:, :, :nh], qkv[:, :, nh:nh + nkv], qkv[:, :, nh + nkv:]
    if f"{pre}.q_norm.weight" in p:
        q = rms_norm(q, p[f"{pre}.q_norm.weight"])
        k = rms_norm(k, p[f"{pre}.k_norm.weight"])
    q = apply_rope(q.transpose(1, 2), rot)
    k = apply_rope(k.transpose(1, 2), rot)
    v = v.transpose(1, 2)
    if nkv != nh:  # each kv head serves nh / nkv consecutive q heads
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
    o = attention(q, k, v).transpose(1, 2).reshape(b, l, nh * hd)
    return linear(o, p[f"{pre}.out.weight"], p.get(f"{pre}.out.bias"))


def _ffn(p, pre, x):
    x1 = linear(x, p[f"{pre}.w1.weight"])
    x3 = linear(x, p[f"{pre}.w3.weight"])
    return linear(silu(x1) * x3, p[f"{pre}.w2.weight"])


def _block(p, pre, x, rot, t_emb, cfg: ZImageConfig):
    """One joint block: RMS sandwich norms (eps ``norm_eps``); where
    modulated, the input norms scaled by 1 + s and the outputs gated by
    tanh(g)."""
    eps = cfg.norm_eps
    if f"{pre}.adaLN_modulation.0.weight" in p:
        mods = linear(t_emb, p[f"{pre}.adaLN_modulation.0.weight"],
                      p.get(f"{pre}.adaLN_modulation.0.bias"))
        s_msa, g_msa, s_mlp, g_mlp = mods[:, None].chunk(4, dim=-1)
    else:
        s_msa = g_msa = s_mlp = g_mlp = None

    h = rms_norm(x, p[f"{pre}.attention_norm1.weight"], eps=eps)
    if s_msa is not None:
        h = h * (1.0 + s_msa)
    h = rms_norm(_attn(p, f"{pre}.attention", h, rot, cfg), p[f"{pre}.attention_norm2.weight"],
                 eps=eps)
    x = x + (h if g_msa is None else h * torch.tanh(g_msa))
    h = rms_norm(x, p[f"{pre}.ffn_norm1.weight"], eps=eps)
    if s_mlp is not None:
        h = h * (1.0 + s_mlp)
    h = rms_norm(_ffn(p, f"{pre}.feed_forward", h), p[f"{pre}.ffn_norm2.weight"], eps=eps)
    return x + (h if g_mlp is None else h * torch.tanh(g_mlp))


def z_image_ids(hp: int, wp: int, n_txt_padded: int) -> np.ndarray:
    """RoPE ids [n_txt_padded + image tokens rounded up to 32, 3]: text at
    1..n_txt_padded on axis 0, the hp × wp grid at n_txt_padded + 1 with
    (row, column) on axes 1 and 2, image pad tokens all zero."""
    n_img = hp * wp
    ids = np.zeros((n_txt_padded + n_img + _bound_mod(n_img, SEQ_MULTI_OF), 3), dtype=np.int64)
    ids[:n_txt_padded, 0] = np.arange(1, n_txt_padded + 1)
    ii, jj = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
    ids[n_txt_padded:n_txt_padded + n_img, 0] = n_txt_padded + 1
    ids[n_txt_padded:n_txt_padded + n_img, 1] = ii.reshape(-1)
    ids[n_txt_padded:n_txt_padded + n_img, 2] = jj.reshape(-1)
    return ids


@functools.lru_cache(maxsize=8)
def z_image_rope(hp: int, wp: int, n_txt_padded: int, axes_dim, theta: int,
                 device: str) -> torch.Tensor:
    """The stream's rotations [L, D/2, 2, 2] (``z_image_ids``), moved to the
    device once per shape."""
    return torch.from_numpy(rope_freqs(z_image_ids(hp, wp, n_txt_padded), axes_dim, theta)).to(device)


def z_image_forward(p, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                    cfg: ZImageConfig = Z_IMAGE_CONFIG, ref_latents=None) -> torch.Tensor:
    """x: [B, H, W, C] latent; timesteps: [B], already 1000 - t; context:
    [B, L, cap_feat_dim] → the velocity [B, H, W, out_channels] (the model's
    output negated).  ``ref_latents`` (Z-Image-Omni) raises."""
    if ref_latents:
        raise NotImplementedError("Z-Image-Omni reference latents (ref_latents) are not ported")
    b, h, w, c = x.shape
    ps = cfg.patch_size
    pad_h, pad_w = (-h) % ps, (-w) % ps
    if pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = (h + pad_h) // ps, (w + pad_w) // ps

    img = x.reshape(b, hp, ps, wp, ps, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp * wp, ps * ps * c)
    img = linear(img, p["x_embedder.weight"], p.get("x_embedder.bias"))

    t_freq = timestep_embedding(timesteps, 256).to(img.dtype)
    t_emb = linear(t_freq, p["t_embedder.mlp.0.weight"], p["t_embedder.mlp.0.bias"])
    t_emb = linear(silu(t_emb), p["t_embedder.mlp.2.weight"], p["t_embedder.mlp.2.bias"])

    txt = rms_norm(context.to(img.dtype), p["cap_embedder.0.weight"], eps=cfg.norm_eps)
    txt = linear(txt, p["cap_embedder.1.weight"], p.get("cap_embedder.1.bias"))

    n_txt, n_img = txt.shape[1], img.shape[1]
    n_txt_pad = _bound_mod(n_txt, SEQ_MULTI_OF)
    if n_txt_pad:
        pad = p["cap_pad_token"].to(txt.dtype).expand(b, n_txt_pad, cfg.hidden_size)
        txt = torch.cat([txt, pad], dim=1)
    n_img_pad = _bound_mod(n_img, SEQ_MULTI_OF)
    if n_img_pad:
        pad = p["x_pad_token"].to(img.dtype).expand(b, n_img_pad, cfg.hidden_size)
        img = torch.cat([img, pad], dim=1)

    lt = txt.shape[1]
    rot = z_image_rope(hp, wp, lt, tuple(cfg.axes_dim), cfg.theta, str(x.device))
    txt_rot, img_rot = rot[:lt], rot[lt:]
    for i in range(cfg.num_refiner_layers):
        txt = _block(p, f"context_refiner.{i}", txt, txt_rot, None, cfg)
    for i in range(cfg.num_refiner_layers):
        img = _block(p, f"noise_refiner.{i}", img, img_rot, t_emb, cfg)

    hseq = torch.cat([txt, img], dim=1)
    for i in range(cfg.num_layers):
        hseq = _block(p, f"layers.{i}", hseq, rot, t_emb, cfg)

    scale = linear(silu(t_emb), p["final_layer.adaLN_modulation.1.weight"],
                   p.get("final_layer.adaLN_modulation.1.bias"))
    out = layer_norm(hseq, eps=1e-6) * (1.0 + scale[:, None])
    out = linear(out, p["final_layer.linear.weight"], p.get("final_layer.linear.bias"))

    out = out[:, lt:lt + hp * wp].reshape(b, hp, wp, ps, ps, cfg.out_channels)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp * ps, wp * ps, cfg.out_channels)
    return -out[:, :h, :w]
