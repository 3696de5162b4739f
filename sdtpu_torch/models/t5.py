"""T5 encoder (counterpart of ``sdtpu/models/t5.py``).

HF naming (``encoder.block.N.layer.{0,1}…``, ``shared.weight``): RMS norms,
a relative position bias from block 0 shared by every layer, gated-GELU
feed-forward, unscaled attention; UMT5 (Wan's text encoder, ``is_umt5``)
has a relative bias in every layer.  Attention takes the plain path
(``flash=False``), as on the TPU; its linears are ``Q4Tensor``s in the
FLUX.1 memory class.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sdtpu_torch.ops import attention, gelu_tanh, linear, rms_norm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    is_umt5: bool = False  # UMT5: per-layer relative attention bias


T5_XXL_CONFIG = T5Config()
UMT5_XXL_CONFIG = dataclasses.replace(T5_XXL_CONFIG, vocab_size=256384, is_umt5=True)  # Wan's


def param_specs(cfg: T5Config) -> dict:
    """name → (shape, init) as ``init_t5_params`` sets them."""
    inner = cfg.num_heads * cfg.d_kv
    specs = {
        "shared.weight": ((cfg.vocab_size, cfg.d_model), "normal"),
        "encoder.final_layer_norm.weight": ((cfg.d_model,), "ones"),
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}"
        if i == 0 or cfg.is_umt5:
            specs[f"{pre}.layer.0.SelfAttention.relative_attention_bias.weight"] = (
                (cfg.relative_attention_num_buckets, cfg.num_heads), "normal")
        for nm in ("q", "k", "v"):
            specs[f"{pre}.layer.0.SelfAttention.{nm}.weight"] = ((inner, cfg.d_model), "normal")
        specs[f"{pre}.layer.0.SelfAttention.o.weight"] = ((cfg.d_model, inner), "normal")
        specs[f"{pre}.layer.0.layer_norm.weight"] = ((cfg.d_model,), "ones")
        specs[f"{pre}.layer.1.DenseReluDense.wi_0.weight"] = ((cfg.d_ff, cfg.d_model), "normal")
        specs[f"{pre}.layer.1.DenseReluDense.wi_1.weight"] = ((cfg.d_ff, cfg.d_model), "normal")
        specs[f"{pre}.layer.1.DenseReluDense.wo.weight"] = ((cfg.d_model, cfg.d_ff), "normal")
        specs[f"{pre}.layer.1.layer_norm.weight"] = ((cfg.d_model,), "ones")
    return specs


def _relative_position_bucket(rel_pos: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucket function (host-side, static per length)."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


def t5_position_bias(p, length: int, cfg: T5Config, layer: int = 0) -> torch.Tensor:
    """[1, heads, L, L] additive bias from the relative embedding table."""
    ctx = np.arange(length)
    buckets = _relative_position_bucket(
        ctx[None, :] - ctx[:, None], cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    src = layer if cfg.is_umt5 else 0
    table = p[f"encoder.block.{src}.layer.0.SelfAttention.relative_attention_bias.weight"]
    bias = table[torch.from_numpy(buckets).to(table.device)]  # [L, L, heads]
    return bias.permute(2, 0, 1)[None]


def t5_encoder_forward(p, input_ids: torch.Tensor, cfg: T5Config = T5_XXL_CONFIG,
                       attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """input_ids: [B, L] → hidden [B, L, d_model]."""
    b, l = input_ids.shape
    h = p["shared.weight"][input_ids]
    mask = None
    if attention_mask is not None:
        mask = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
    shared_bias = None if cfg.is_umt5 else t5_position_bias(p, l, cfg).float()

    def heads(t):
        return t.reshape(b, l, cfg.num_heads, cfg.d_kv).transpose(1, 2)

    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}"
        pos_bias = shared_bias if shared_bias is not None else t5_position_bias(p, l, cfg, i).float()
        if mask is not None:
            pos_bias = pos_bias + mask
        hn = rms_norm(h, p[f"{pre}.layer.0.layer_norm.weight"], eps=cfg.layer_norm_eps)
        q = heads(linear(hn, p[f"{pre}.layer.0.SelfAttention.q.weight"]))
        k = heads(linear(hn, p[f"{pre}.layer.0.SelfAttention.k.weight"]))
        v = heads(linear(hn, p[f"{pre}.layer.0.SelfAttention.v.weight"]))
        o = attention(q, k, v, mask=pos_bias, scale=1.0, flash=False)
        o = o.transpose(1, 2).reshape(b, l, cfg.num_heads * cfg.d_kv)
        h = h + linear(o, p[f"{pre}.layer.0.SelfAttention.o.weight"])
        hn = rms_norm(h, p[f"{pre}.layer.1.layer_norm.weight"], eps=cfg.layer_norm_eps)
        g = gelu_tanh(linear(hn, p[f"{pre}.layer.1.DenseReluDense.wi_0.weight"]))
        u = linear(hn, p[f"{pre}.layer.1.DenseReluDense.wi_1.weight"])
        h = h + linear(g * u, p[f"{pre}.layer.1.DenseReluDense.wo.weight"])
    return rms_norm(h, p["encoder.final_layer_norm.weight"], eps=cfg.layer_norm_eps)
