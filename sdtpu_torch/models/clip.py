"""CLIP text encoders (counterpart of ``sdtpu/models/clip.py``, text towers):
OpenAI CLIP-L, OpenCLIP-G (SDXL's second encoder, with its pooled
projection) and OpenCLIP-H (SD2.x's text tower: 23 of the checkpoint's 24
layers, as the JAX config holds them).

Params are keyed by HF ``CLIPTextModel`` names (``text_model.…``,
``text_projection.weight``), linear weights [out, in].  The causal mask
goes to the flash kernel as an additive bias on CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from sdtpu_torch.ops import attention, gelu, layer_norm, linear, quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # OpenAI-L; OpenCLIP-G uses "gelu"
    projection_dim: Optional[int] = None
    eos_token_id: int = 49407


CLIP_L_CONFIG = CLIPTextConfig()
CLIP_G_CONFIG = CLIPTextConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_layers=32,
    num_heads=20,
    hidden_act="gelu",
    projection_dim=1280,
)
# SD2.x's OpenCLIP ViT-H text tower
CLIP_H_CONFIG = CLIPTextConfig(
    hidden_size=1024,
    intermediate_size=4096,
    num_layers=23,
    num_heads=16,
    hidden_act="gelu",
)


def param_specs(cfg: CLIPTextConfig) -> dict:
    """name → (shape, init) as ``init_clip_params`` sets them."""
    c, ff = cfg.hidden_size, cfg.intermediate_size
    specs = {
        "text_model.embeddings.token_embedding.weight": ((cfg.vocab_size, c), "normal"),
        "text_model.embeddings.position_embedding.weight": ((cfg.max_position_embeddings, c), "normal"),
        "text_model.final_layer_norm.weight": ((c,), "ones"),
        "text_model.final_layer_norm.bias": ((c,), "zeros"),
    }
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            specs[f"{pre}.self_attn.{nm}.weight"] = ((c, c), "normal")
            specs[f"{pre}.self_attn.{nm}.bias"] = ((c,), "zeros")
        for ln in ("layer_norm1", "layer_norm2"):
            specs[f"{pre}.{ln}.weight"] = ((c,), "ones")
            specs[f"{pre}.{ln}.bias"] = ((c,), "zeros")
        specs[f"{pre}.mlp.fc1.weight"] = ((ff, c), "normal")
        specs[f"{pre}.mlp.fc1.bias"] = ((ff,), "zeros")
        specs[f"{pre}.mlp.fc2.weight"] = ((c, ff), "normal")
        specs[f"{pre}.mlp.fc2.bias"] = ((c,), "zeros")
    if cfg.projection_dim is not None:
        specs["text_projection.weight"] = ((cfg.projection_dim, c), "normal")
    return specs


def clip_attention(p, prefix: str, x, mask, num_heads: int):
    b, l, c = x.shape

    def proj(name):
        t = linear(x, p[f"{prefix}.{name}.weight"], p[f"{prefix}.{name}.bias"])
        return t.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)

    o = attention(proj("q_proj"), proj("k_proj"), proj("v_proj"), mask=mask)
    o = o.transpose(1, 2).reshape(b, l, c)
    return linear(o, p[f"{prefix}.out_proj.weight"], p[f"{prefix}.out_proj.bias"])


def clip_layer(p, prefix: str, x, mask, cfg: CLIPTextConfig):
    act = quick_gelu if cfg.hidden_act == "quick_gelu" else gelu
    h = layer_norm(x, p[f"{prefix}.layer_norm1.weight"], p[f"{prefix}.layer_norm1.bias"])
    x = x + clip_attention(p, f"{prefix}.self_attn", h, mask, cfg.num_heads)
    h = layer_norm(x, p[f"{prefix}.layer_norm2.weight"], p[f"{prefix}.layer_norm2.bias"])
    h = act(linear(h, p[f"{prefix}.mlp.fc1.weight"], p[f"{prefix}.mlp.fc1.bias"]))
    return x + linear(h, p[f"{prefix}.mlp.fc2.weight"], p[f"{prefix}.mlp.fc2.bias"])


def clip_text_forward(p, input_ids: torch.Tensor, cfg: CLIPTextConfig, clip_skip: int = -1,
                      return_pooled: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """input_ids: [B, L] → (hidden [B, L, C], pooled [B, P] or None).

    clip_skip: 1 (or -1) = final layer after the final LN, 2 = penultimate
    layer (pre-LN), etc.  The pooled output always comes from the top."""
    b, l = input_ids.shape
    x = p["text_model.embeddings.token_embedding.weight"][input_ids]
    pos = p["text_model.embeddings.position_embedding.weight"][:l]
    x = x + pos[None].to(x.dtype)
    causal = torch.full((l, l), -1e30, dtype=torch.float32, device=x.device).triu(1)

    n_layers = cfg.num_layers
    stop_at = n_layers if clip_skip <= 1 else n_layers - (clip_skip - 1)
    hidden = x
    for i in range(stop_at):
        hidden = clip_layer(p, f"text_model.encoder.layers.{i}", hidden, causal, cfg)
    final_w = p["text_model.final_layer_norm.weight"]
    final_b = p["text_model.final_layer_norm.bias"]
    out = layer_norm(hidden, final_w, final_b) if clip_skip <= 1 else hidden

    pooled = None
    if return_pooled:
        full = hidden
        for i in range(stop_at, n_layers):
            full = clip_layer(p, f"text_model.encoder.layers.{i}", full, causal, cfg)
        full = layer_norm(full, final_w, final_b)
        eos_pos = torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32), dim=1)
        pooled = full[torch.arange(b, device=full.device), eos_pos]
        if cfg.projection_dim is not None and "text_projection.weight" in p:
            pooled = linear(pooled, p["text_projection.weight"])
    return out, pooled
