"""Qwen-Image joint-stream DiT (counterpart of ``sdtpu/models/qwen_image.py``:
``QwenImageConfig``, ``QWEN_IMAGE_CONFIG``, ``detect_qwen_image_config``,
``_heads``, ``_joint_attention``, ``_ff``, ``qwen_image_forward``,
``init_qwen_image_params``' layout as ``param_specs``).

A rectified-flow DiT conditioned on Qwen2.5-VL hidden states: the image
patches (``img_in``) and the RMS-normed text states (``txt_norm``,
``txt_in``) keep separate weights in every block (``img_mod`` /
``txt_mod`` modulation, ``img_mlp`` / ``txt_mlp``), and meet in one joint
attention over [text; image] with per-head q/k RMS norms and a 3-axis RoPE
(FLUX's rotation helpers).  The norms are affine-free LayerNorms (eps
1e-6), the FFN GELU-tanh, the final ``norm_out`` an AdaLayerNormContinuous
whose chunks come in (scale, shift) order.  Text positions run from
max(hp, wp) // 2 on every axis; the image grid is centred on 0.  The
timesteps are multiplied by 1000 once more before the sinusoidal embedding,
as the JAX package does (its factory passes sigma · 1000, so the embedding
sees sigma · 1e6).  Latents are NHWC, patch features ordered (py, px, c).

Checkpoint names: ``transformer_blocks.N.{attn.{to_q,to_k,to_v,to_out.0,
add_{q,k,v}_proj,to_add_out,norm_q,norm_k,norm_added_q,norm_added_k},
img_mod.1, txt_mod.1, img_mlp.net.{0.proj,2}, txt_mlp.net.{0.proj,2}}``,
``img_in``, ``txt_in``, ``txt_norm``,
``time_text_embed.timestep_embedder.linear_{1,2}``, ``norm_out.linear``,
``proj_out``.  ``check_supported`` refuses, by name, the layered variant,
Qwen-Image-Edit 2509's ``zero_cond_t`` and Mage-Flow; ``ref_latents`` (the
edit path) raises.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sdtpu_torch.models.flux import apply_rope, rope_freqs
from sdtpu_torch.ops import attention, gelu_tanh, layer_norm, linear, rms_norm, silu, timestep_embedding


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    patch_size: int = 2
    in_channels: int = 64  # packed 16 channels x 2 x 2
    out_channels: int = 16
    num_layers: int = 60
    head_dim: int = 128
    num_heads: int = 24
    joint_attention_dim: int = 3584
    theta: int = 10000
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    rope_scheme: str = "qwen"
    bf16_timestep: bool = False
    use_additional_t_cond: bool = False
    zero_cond_t: bool = False


QWEN_IMAGE_CONFIG = QwenImageConfig()


def check_supported(cfg: QwenImageConfig) -> None:
    """Refuse, by name, the Qwen-Image variants the port does not run."""
    refused = [what for what, on in (
        ("the layered variant (use_additional_t_cond)", cfg.use_additional_t_cond),
        ("Qwen-Image-Edit 2509's zero_cond_t", cfg.zero_cond_t),
        ("Mage-Flow (rope_scheme 'mage', bf16_timestep)",
         cfg.rope_scheme != "qwen" or cfg.bf16_timestep),
    ) if on]
    if refused:
        raise NotImplementedError(f"Qwen-Image: {', '.join(refused)} not ported; the port runs "
                                  "Qwen-Image txt2img and img2img")


def detect_qwen_image_config(names) -> QwenImageConfig:
    """The config a checkpoint's names give, as the JAX package's: the depth
    from the block indices, the layered and zero_cond_t variants by their
    marker tensors."""
    names = list(names)
    num_layers = 0
    for n in names:
        if "transformer_blocks." in n:
            num_layers = max(num_layers, int(n.split("transformer_blocks.")[1].split(".")[0]) + 1)
    return dataclasses.replace(
        QWEN_IMAGE_CONFIG, num_layers=num_layers or 60,
        use_additional_t_cond=any("addition_t_embedding" in n for n in names),
        zero_cond_t=any("__index_timestep_zero__" in n for n in names))


def param_specs(cfg: QwenImageConfig) -> dict:
    """name → (shape, init) as ``init_qwen_image_params`` sets them: weights
    normal (std 0.02), biases zero, norm gains one."""
    check_supported(cfg)
    inner = cfg.num_heads * cfg.head_dim
    specs = {}

    def lin(name, o, i):
        specs[f"{name}.weight"] = ((o, i), "normal")
        specs[f"{name}.bias"] = ((o,), "zeros")

    lin("img_in", inner, cfg.in_channels)
    lin("txt_in", inner, cfg.joint_attention_dim)
    specs["txt_norm.weight"] = ((cfg.joint_attention_dim,), "ones")
    lin("time_text_embed.timestep_embedder.linear_1", inner, 256)
    lin("time_text_embed.timestep_embedder.linear_2", inner, inner)
    for i in range(cfg.num_layers):
        blk = f"transformer_blocks.{i}"
        lin(f"{blk}.img_mod.1", 6 * inner, inner)
        lin(f"{blk}.txt_mod.1", 6 * inner, inner)
        for ln in ("to_q", "to_k", "to_v", "to_out.0", "add_q_proj", "add_k_proj", "add_v_proj",
                   "to_add_out"):
            lin(f"{blk}.attn.{ln}", inner, inner)
        for nn in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            specs[f"{blk}.attn.{nn}.weight"] = ((cfg.head_dim,), "ones")
        for s in ("img_mlp", "txt_mlp"):
            lin(f"{blk}.{s}.net.0.proj", 4 * inner, inner)
            lin(f"{blk}.{s}.net.2", inner, 4 * inner)
    lin("norm_out.linear", 2 * inner, inner)
    lin("proj_out", cfg.patch_size * cfg.patch_size * cfg.out_channels, inner)
    return specs


def _heads(x: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.reshape(b, l, nh, hd).transpose(1, 2)


def _joint_attention(p, pre, img, txt, rot, cfg: QwenImageConfig):
    """Separate image and text projections, per-head q/k RMS norms (eps
    1e-6), one attention over [text; image]; the padded text tokens of a
    CFG batch are not masked, as in the JAX package."""
    b, li, inner = img.shape
    lt = txt.shape[1]
    nh, hd = cfg.num_heads, cfg.head_dim

    def proj(x, name, norm=None):
        h = _heads(linear(x, p[f"{pre}.{name}.weight"], p[f"{pre}.{name}.bias"]), nh, hd)
        return h if norm is None else rms_norm(h, p[f"{pre}.{norm}.weight"], eps=1e-6)

    q = apply_rope(torch.cat([proj(txt, "add_q_proj", "norm_added_q"), proj(img, "to_q", "norm_q")],
                             dim=2), rot)
    k = apply_rope(torch.cat([proj(txt, "add_k_proj", "norm_added_k"), proj(img, "to_k", "norm_k")],
                             dim=2), rot)
    v = torch.cat([proj(txt, "add_v_proj"), proj(img, "to_v")], dim=2)
    att = attention(q, k, v).transpose(1, 2).reshape(b, lt + li, inner)
    txt_out = linear(att[:, :lt], p[f"{pre}.to_add_out.weight"], p[f"{pre}.to_add_out.bias"])
    img_out = linear(att[:, lt:], p[f"{pre}.to_out.0.weight"], p[f"{pre}.to_out.0.bias"])
    return img_out, txt_out


def _ff(p, pre, x):
    """GELU(tanh) FeedForward: net.0.proj → gelu → net.2."""
    h = linear(x, p[f"{pre}.net.0.proj.weight"], p[f"{pre}.net.0.proj.bias"])
    return linear(gelu_tanh(h), p[f"{pre}.net.2.weight"], p[f"{pre}.net.2.bias"])


def qwen_image_ids(lt: int, hp: int, wp: int) -> np.ndarray:
    """RoPE ids [lt + hp·wp, 3] in float64: the text tokens' scalar run from
    max(hp, wp) // 2 on every axis, then the image grid (axis 0 zero, rows
    and columns centred: -(n // 2) ..)."""
    ids = np.zeros((lt + hp * wp, 3), dtype=np.float64)
    ids[:lt] = (max(hp, wp) // 2 + np.arange(lt))[:, None]
    hi, wi = np.meshgrid(np.arange(hp) - hp // 2, np.arange(wp) - wp // 2, indexing="ij")
    ids[lt:, 1] = hi.reshape(-1)
    ids[lt:, 2] = wi.reshape(-1)
    return ids


@functools.lru_cache(maxsize=8)
def qwen_image_rope(lt: int, hp: int, wp: int, axes_dim, theta: int, device: str) -> torch.Tensor:
    """The joint stream's rotations [lt + hp·wp, D/2, 2, 2]
    (``qwen_image_ids``), moved to the device once per shape."""
    return torch.from_numpy(rope_freqs(qwen_image_ids(lt, hp, wp), axes_dim, theta)).to(device)


def qwen_image_forward(p, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                       cfg: QwenImageConfig = QWEN_IMAGE_CONFIG, ref_latents=None) -> torch.Tensor:
    """x: [B, H, W, out_channels] latent; timesteps: [B] (multiplied by 1000
    before the embedding); context: [B, L, joint_attention_dim] Qwen2.5-VL
    hidden states → the velocity [B, H, W, out_channels].  ``ref_latents``
    (Qwen-Image-Edit) raises."""
    check_supported(cfg)
    if ref_latents:
        raise NotImplementedError("Qwen-Image-Edit reference latents (ref_latents) are not ported")
    b, h, w, c = x.shape
    ps = cfg.patch_size
    hp, wp = h // ps, w // ps
    img = x.reshape(b, hp, ps, wp, ps, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp * wp, ps * ps * c)
    img = linear(img, p["img_in.weight"], p["img_in.bias"])
    txt = rms_norm(context.to(x.dtype), p["txt_norm.weight"], eps=1e-6)
    txt = linear(txt, p["txt_in.weight"], p["txt_in.bias"])
    lt = txt.shape[1]

    pre = "time_text_embed.timestep_embedder"
    temb = timestep_embedding(timesteps * 1000.0, 256).to(x.dtype)
    temb = linear(temb, p[f"{pre}.linear_1.weight"], p[f"{pre}.linear_1.bias"])
    temb = linear(silu(temb), p[f"{pre}.linear_2.weight"], p[f"{pre}.linear_2.bias"])
    act = silu(temb)
    rot = qwen_image_rope(lt, hp, wp, tuple(cfg.axes_dim), cfg.theta, str(x.device))

    for i in range(cfg.num_layers):
        blk = f"transformer_blocks.{i}"
        im = linear(act, p[f"{blk}.img_mod.1.weight"], p[f"{blk}.img_mod.1.bias"])[:, None].chunk(6, -1)
        tm = linear(act, p[f"{blk}.txt_mod.1.weight"], p[f"{blk}.txt_mod.1.bias"])[:, None].chunk(6, -1)

        img_n = layer_norm(img, eps=1e-6) * (1 + im[1]) + im[0]
        txt_n = layer_norm(txt, eps=1e-6) * (1 + tm[1]) + tm[0]
        img_att, txt_att = _joint_attention(p, f"{blk}.attn", img_n, txt_n, rot, cfg)
        img = img + img_att * im[2]
        txt = txt + txt_att * tm[2]

        img_n = layer_norm(img, eps=1e-6) * (1 + im[4]) + im[3]
        txt_n = layer_norm(txt, eps=1e-6) * (1 + tm[4]) + tm[3]
        img = img + _ff(p, f"{blk}.img_mlp", img_n) * im[5]
        txt = txt + _ff(p, f"{blk}.txt_mlp", txt_n) * tm[5]

    sc, sh = linear(act, p["norm_out.linear.weight"], p["norm_out.linear.bias"]).chunk(2, -1)
    img = layer_norm(img, eps=1e-6) * (1 + sc[:, None]) + sh[:, None]
    img = linear(img, p["proj_out.weight"], p["proj_out.bias"])
    out = img.reshape(b, hp, wp, ps, ps, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, h, w, cfg.out_channels)
