"""Decoder LLM used as a text encoder (counterpart of ``sdtpu/models/llm.py``:
``LLMConfig``, the Qwen2.5-VL and Qwen3 configs, ``detect_llm_config``,
``_neox_rope``, ``_llm_rms``, ``llm_forward``, ``init_llm_params``' layout
as ``param_specs``).

HF checkpoint names: ``model.embed_tokens.weight``, ``model.norm.weight``,
``model.layers.N.{input_layernorm, post_attention_layernorm,
self_attn.{q,k,v,o}_proj, self_attn.{q,k}_norm, mlp.{gate,up,down}_proj}``.
The port runs the text towers of Qwen2.5-VL and Qwen3: GQA attention with
optional q/k/v biases and per-head q/k RMS norms, NEOX RoPE, a SwiGLU MLP,
a causal mask plus an optional padding mask, and the hidden state after a
chosen layer (``output_layer``, or several concatenated:
``output_layers``), by default the state after the final norm.  The
``qwen_image`` chat template (``CHAT_TEMPLATES``) and its 34-id drop are
Qwen-Image's; the JAX package's other templates are not ported.  The
attention is causal and takes the plain path
(``flash=False``), as the JAX package runs it; the linears may be
``Q4Tensor``s (a q4_0 text encoder).

The config keeps every field of the JAX one (so the two compare equal);
``check_supported`` refuses, by name, what the port does not run: the
Gemma norms and input scaling, sliding-window attention, several RoPE
thetas or scales, YaRN, interleaved M-RoPE (``imrope``) and GPT-style
adjacent-pair RoPE, GELU-tanh MLPs, attention sinks, an attention output
bias and mixture-of-experts MLPs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.ops import attention, linear, rms_norm, silu


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    arch: str = "qwen2.5vl"
    num_layers: int = 28
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    qkv_bias: bool = True
    attention_out_bias: bool = False
    qk_norm: bool = False
    vocab_size: int = 152064
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    mlp_activation: str = "silu"
    norm_add: bool = False
    normalize_input: bool = False
    gemma_norms: bool = False
    sliding_attention: Tuple[int, ...] = ()
    rope_thetas: Tuple[float, ...] = ()
    rope_scales: Tuple[float, ...] = ()
    rope_style: str = "neox"
    rope_yarn: bool = False
    rope_orig_ctx: int = 4096
    attention_sinks: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    mrope_sections: Tuple[int, ...] = ()


QWEN25_VL_7B_CONFIG = LLMConfig()
QWEN3_8B_CONFIG = LLMConfig(
    arch="qwen3", num_layers=36, hidden_size=4096, intermediate_size=12288,
    num_heads=32, num_kv_heads=8, qkv_bias=False, qk_norm=True,
    vocab_size=151936,
)
# Qwen3-4B: Z-Image's (and FLUX.2-klein's) text tower
QWEN3_4B_CONFIG = LLMConfig(
    arch="qwen3", num_layers=36, hidden_size=2560, intermediate_size=9728,
    num_heads=32, num_kv_heads=8, head_dim=128, qkv_bias=False, qk_norm=True,
    vocab_size=151936,
)


def check_supported(cfg: LLMConfig) -> None:
    """Refuse, by name, the LLM features the port does not run."""
    refused = [what for what, on in (
        ("Gemma norms (norm_add, normalize_input, gemma_norms)",
         cfg.norm_add or cfg.normalize_input or cfg.gemma_norms or cfg.arch.startswith("gemma")),
        ("GELU-tanh MLPs (mlp_activation)", cfg.mlp_activation != "silu"),
        ("sliding-window attention (sliding_attention)", bool(cfg.sliding_attention)),
        ("several RoPE thetas or scales (rope_thetas, rope_scales)",
         bool(cfg.rope_thetas or cfg.rope_scales)),
        ("YaRN RoPE (rope_yarn)", cfg.rope_yarn),
        ("interleaved M-RoPE (imrope)", cfg.rope_style == "imrope"),
        ("adjacent-pair RoPE (rope_style 'normal')", cfg.rope_style == "normal"),
        ("attention sinks (attention_sinks)", cfg.attention_sinks),
        ("an attention output bias (attention_out_bias)", cfg.attention_out_bias),
        ("mixture-of-experts MLPs (num_experts)", cfg.num_experts > 0),
    ) if on]
    if refused:
        raise NotImplementedError(f"LLM {cfg.arch}: {', '.join(refused)} not ported; the port runs "
                                  "the Qwen2.5-VL and Qwen3 text towers")


def detect_llm_config(names, shapes, arch: str = "qwen2.5vl") -> LLMConfig:
    """Config from checkpoint shapes, as the JAX package's: the arch's base
    config with depth, vocab, width, head counts and MLP width read from the
    weights."""
    base = {"qwen2.5vl": QWEN25_VL_7B_CONFIG, "qwen3": QWEN3_8B_CONFIG}.get(arch)
    if base is None:
        raise NotImplementedError(f"LLM arch {arch!r} is not ported; the port runs 'qwen2.5vl' "
                                  "and 'qwen3'")
    num_layers = 0
    for n in names:
        if n.startswith("model.layers."):
            num_layers = max(num_layers, int(n.split(".")[2]) + 1)
    emb = shapes.get("model.embed_tokens.weight")
    q = shapes.get("model.layers.0.self_attn.q_proj.weight")
    kv = shapes.get("model.layers.0.self_attn.k_proj.weight")
    gate = shapes.get("model.layers.0.mlp.gate_proj.weight")
    kw = {}
    if num_layers:
        kw["num_layers"] = num_layers
    if emb:
        kw["vocab_size"], kw["hidden_size"] = emb
    if q and emb and q[0] >= base.head_dim:
        kw["num_heads"] = q[0] // base.head_dim
    if kv and emb and kv[0] >= base.head_dim:
        kw["num_kv_heads"] = kv[0] // base.head_dim
    if gate:
        kw["intermediate_size"] = gate[0]
    return dataclasses.replace(base, **kw)


def param_specs(cfg: LLMConfig) -> dict:
    """name → (shape, init) as ``init_llm_params`` sets them: weights normal
    (std 0.02; the token embedding stays dense when synthesized quantized),
    biases zero, norm gains one."""
    check_supported(cfg)
    hid, nh, nkv, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {"model.embed_tokens.weight": ((cfg.vocab_size, hid), "normal"),
             "model.norm.weight": ((hid,), "ones")}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        specs[f"{pre}.self_attn.q_proj.weight"] = ((nh * hd, hid), "normal")
        specs[f"{pre}.self_attn.k_proj.weight"] = ((nkv * hd, hid), "normal")
        specs[f"{pre}.self_attn.v_proj.weight"] = ((nkv * hd, hid), "normal")
        specs[f"{pre}.self_attn.o_proj.weight"] = ((hid, nh * hd), "normal")
        if cfg.qkv_bias:
            specs[f"{pre}.self_attn.q_proj.bias"] = ((nh * hd,), "zeros")
            specs[f"{pre}.self_attn.k_proj.bias"] = ((nkv * hd,), "zeros")
            specs[f"{pre}.self_attn.v_proj.bias"] = ((nkv * hd,), "zeros")
        if cfg.qk_norm:
            specs[f"{pre}.self_attn.q_norm.weight"] = ((hd,), "ones")
            specs[f"{pre}.self_attn.k_norm.weight"] = ((hd,), "ones")
        specs[f"{pre}.input_layernorm.weight"] = ((hid,), "ones")
        specs[f"{pre}.post_attention_layernorm.weight"] = ((hid,), "ones")
        specs[f"{pre}.mlp.gate_proj.weight"] = ((cfg.intermediate_size, hid), "normal")
        specs[f"{pre}.mlp.up_proj.weight"] = ((cfg.intermediate_size, hid), "normal")
        specs[f"{pre}.mlp.down_proj.weight"] = ((hid, cfg.intermediate_size), "normal")
    return specs


def _neox_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """NEOX RoPE: x [B, H, L, D] rotated in (i, i + D/2) pairs by the angles
    of positions ``pos`` [L] (frequencies in float64 on the host, angles in
    float32)."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2 / d))
    freq = torch.from_numpy(freq.astype(np.float32)).to(x.device)
    ang = pos.float()[:, None] * freq[None, :]  # [L, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _llm_rms(p, name: str, x: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    return rms_norm(x, p[name], eps=cfg.rms_norm_eps)


def llm_forward(p, input_ids: torch.Tensor, cfg: LLMConfig = QWEN25_VL_7B_CONFIG,
                attention_mask: Optional[torch.Tensor] = None, output_layer: int = -1,
                output_layers=()) -> torch.Tensor:
    """input_ids [B, L] → hidden states [B, L, hidden] after ``output_layer``
    decoder layers (-1: every layer and the final norm), or the states after
    each layer in ``output_layers`` (1-indexed; ``num_layers + 1`` names the
    final-norm output) concatenated on the feature axis.

    attention_mask: a [B, L] 0/1 padding mask (added to the causal mask),
    or an additive [L, L] / [B, L, L] bias that replaces it."""
    check_supported(cfg)
    b, l = input_ids.shape
    h = p["model.embed_tokens.weight"][input_ids]
    dev = h.device
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev))
    mask = torch.where(causal, 0.0, -1e9)[None, None]
    if attention_mask is not None:
        if attention_mask.dim() == 1:
            attention_mask = attention_mask[None]
        if attention_mask.dim() == 2 and attention_mask.shape[-1] == l and attention_mask.shape[0] != l:
            mask = mask + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
        else:  # a pre-built additive bias replaces the mask
            mask = attention_mask.float()
            while mask.dim() < 4:
                mask = mask[None]

    pos = torch.arange(l, device=dev)
    picks = tuple(output_layers)
    n_layers = cfg.num_layers if (output_layer == -1 or picks) else output_layer
    picked = []
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        hn = _llm_rms(p, f"{pre}.input_layernorm.weight", h, cfg)
        q = linear(hn, p[f"{pre}.self_attn.q_proj.weight"], p.get(f"{pre}.self_attn.q_proj.bias"))
        k = linear(hn, p[f"{pre}.self_attn.k_proj.weight"], p.get(f"{pre}.self_attn.k_proj.bias"))
        v = linear(hn, p[f"{pre}.self_attn.v_proj.weight"], p.get(f"{pre}.self_attn.v_proj.bias"))
        q = q.reshape(b, l, nh, hd).transpose(1, 2)
        k = k.reshape(b, l, nkv, hd).transpose(1, 2)
        v = v.reshape(b, l, nkv, hd).transpose(1, 2)
        if cfg.qk_norm:
            q = rms_norm(q, p[f"{pre}.self_attn.q_norm.weight"], eps=cfg.rms_norm_eps)
            k = rms_norm(k, p[f"{pre}.self_attn.k_norm.weight"], eps=cfg.rms_norm_eps)
        q = _neox_rope(q, pos, cfg.rope_theta)
        k = _neox_rope(k, pos, cfg.rope_theta)
        if nkv != nh:  # GQA: each kv head serves nh / nkv consecutive q heads
            k = k.repeat_interleave(nh // nkv, dim=1)
            v = v.repeat_interleave(nh // nkv, dim=1)
        o = attention(q, k, v, mask=mask, flash=False)
        o = o.transpose(1, 2).reshape(b, l, nh * hd)
        h = h + linear(o, p[f"{pre}.self_attn.o_proj.weight"])

        hn = _llm_rms(p, f"{pre}.post_attention_layernorm.weight", h, cfg)
        gate = linear(hn, p[f"{pre}.mlp.gate_proj.weight"])
        up = linear(hn, p[f"{pre}.mlp.up_proj.weight"])
        h = h + linear(silu(gate) * up, p[f"{pre}.mlp.down_proj.weight"])
        if (i + 1) in picks:
            picked.append(h)

    if output_layer == -1 or (cfg.num_layers + 1) in picks:
        h = _llm_rms(p, "model.norm.weight", h, cfg)
    if picks:
        if (cfg.num_layers + 1) in picks:
            picked.append(h)
        return torch.cat(picked, dim=-1)
    return h


# chat templates (the JAX package's ``CHAT_TEMPLATES``, Qwen-Image's alone):
# name → (template, ids of its system prefix dropped from the states)
CHAT_TEMPLATES = {
    "qwen_image": (
        "<|im_start|>system\nDescribe the image by detailing the color, shape, "
        "size, texture, quantity, text, spatial relationships of the objects and "
        "background:<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n"
        "<|im_start|>assistant\n",
        34,
    ),
}
