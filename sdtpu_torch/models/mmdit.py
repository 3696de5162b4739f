"""MMDiT — the SD3 / SD3.5 joint-attention diffusion transformer (counterpart
of ``sdtpu/models/mmdit.py``).

Params are a flat dict keyed by the SD3 checkpoint names
(``joint_blocks.N.{context_block,x_block}.…``, ``x_embedder.proj``,
``t_embedder.mlp.{0,2}``, ``y_embedder.mlp.{0,2}``, ``context_embedder``,
``pos_embed``, ``final_layer.…``); latents are NHWC.  SD3.5's per-head qk
RMS norm and SD3.5-Medium's MMDiT-X second self-attention
(``x_block.attn2``) are in.  Attention goes through ``ops.attention``
(flash on the card, D 64 at every published width); the linears are dense
``F.linear``, as the JAX package computes them with ``jnp.dot``, and the
norms, modulation and gated residuals keep its float32 internals.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from sdtpu_torch.ops import attention, gelu_tanh, layer_norm, linear, rms_norm, silu, timestep_embedding


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    patch_size: int = 2
    in_channels: int = 16
    depth: int = 24  # SD3-medium; 3.5-large = 38
    mlp_ratio: float = 4.0
    context_size: int = 4096
    adm_in_channels: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = None  # "rms" for SD3.5
    num_x_self_attn_layers: int = 0  # MMDiT-X (SD3.5-medium): x_block.attn2 depth

    @property
    def hidden_size(self) -> int:
        return 64 * self.depth

    @property
    def num_heads(self) -> int:
        return self.depth

    @property
    def out_channels(self) -> int:
        return self.in_channels


SD3_MEDIUM_CONFIG = MMDiTConfig(depth=24)
SD35_MEDIUM_CONFIG = MMDiTConfig(depth=24, qk_norm="rms", num_x_self_attn_layers=13,
                                 pos_embed_max_size=384)
SD35_LARGE_CONFIG = MMDiTConfig(depth=38, qk_norm="rms")


def detect_mmdit_config(names, shapes) -> MMDiTConfig:
    """The config a checkpoint's names and shapes fingerprint: depth from the
    joint blocks, SD3.5 from the attention's qk norms, MMDiT-X from the
    ``x_block.attn2`` keys, the pos-embed grid from ``pos_embed``'s rows."""
    depth = 0
    num_x = 0
    qk = None
    for n in names:
        if n.startswith("joint_blocks."):
            i = int(n.split(".")[1])
            depth = max(depth, i + 1)
            if ".x_block.attn2." in n:
                num_x = max(num_x, i + 1)
            if ".attn.ln_q" in n:
                qk = "rms"
    pos = shapes.get("pos_embed")
    pos_max = int(round(pos[1] ** 0.5)) if pos is not None else 192
    in_ch = shapes.get("x_embedder.proj.weight", (0, 16))[1]
    ctx = shapes.get("context_embedder.weight", (0, 4096))[1]
    base = (SD35_LARGE_CONFIG if depth >= 38
            else SD35_MEDIUM_CONFIG if (depth == 24 and qk == "rms")
            else SD3_MEDIUM_CONFIG)
    return dataclasses.replace(base, depth=depth or base.depth, qk_norm=qk,
                               num_x_self_attn_layers=num_x, pos_embed_max_size=pos_max,
                               in_channels=in_ch, context_size=ctx)


def param_specs(cfg: MMDiTConfig) -> dict:
    """name → (shape, init) as ``init_mmdit_params`` sets them: weights
    normal (std 0.02), ``pos_embed`` std 0.01, biases zero, qk-norm gains
    one."""
    hid = cfg.hidden_size
    ps, c = cfg.patch_size, cfg.in_channels
    mlp = int(hid * cfg.mlp_ratio)
    d_head = hid // cfg.num_heads
    specs = {"pos_embed": ((1, cfg.pos_embed_max_size ** 2, hid), 0.01),
             "x_embedder.proj.weight": ((hid, c, ps, ps), "normal"),
             "x_embedder.proj.bias": ((hid,), "zeros")}

    def lin(name, o, i):
        specs[f"{name}.weight"] = ((o, i), "normal")
        specs[f"{name}.bias"] = ((o,), "zeros")

    def qk_norm(pre):
        if cfg.qk_norm == "rms":
            specs[f"{pre}.ln_q.weight"] = ((d_head,), "ones")
            specs[f"{pre}.ln_k.weight"] = ((d_head,), "ones")

    lin("t_embedder.mlp.0", hid, 256)
    lin("t_embedder.mlp.2", hid, hid)
    if cfg.adm_in_channels > 0:
        lin("y_embedder.mlp.0", hid, cfg.adm_in_channels)
        lin("y_embedder.mlp.2", hid, hid)
    lin("context_embedder", hid, cfg.context_size)
    for i in range(cfg.depth):
        pre_only = i == cfg.depth - 1
        self_attn_x = i < cfg.num_x_self_attn_layers
        for which, po in (("context_block", pre_only), ("x_block", False)):
            pre = f"joint_blocks.{i}.{which}"
            lin(f"{pre}.attn.qkv", 3 * hid, hid)
            qk_norm(f"{pre}.attn")
            if not po:
                lin(f"{pre}.attn.proj", hid, hid)
                lin(f"{pre}.mlp.fc1", mlp, hid)
                lin(f"{pre}.mlp.fc2", hid, mlp)
            n_mods = 2 if po else (9 if (which == "x_block" and self_attn_x) else 6)
            lin(f"{pre}.adaLN_modulation.1", n_mods * hid, hid)
            if which == "x_block" and self_attn_x:
                lin(f"{pre}.attn2.qkv", 3 * hid, hid)
                lin(f"{pre}.attn2.proj", hid, hid)
                qk_norm(f"{pre}.attn2")
    lin("final_layer.adaLN_modulation.1", 2 * hid, hid)
    lin("final_layer.linear", ps * ps * cfg.out_channels, hid)
    return specs


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _qkv(p, pre: str, x, num_heads: int, qk_norm: Optional[str]):
    """→ q, k, v [B, L, H, D], q and k normed per head (in float32)."""
    b, l, c = x.shape
    d = c // num_heads
    qkv = linear(x, p[f"{pre}.qkv.weight"], p.get(f"{pre}.qkv.bias"))
    q, k, v = (t.reshape(b, l, num_heads, d) for t in qkv.chunk(3, dim=-1))
    if qk_norm == "rms":
        q = rms_norm(q, p[f"{pre}.ln_q.weight"], eps=1e-6)
        k = rms_norm(k, p[f"{pre}.ln_k.weight"], eps=1e-6)
    elif qk_norm == "ln":
        q = layer_norm(q, p[f"{pre}.ln_q.weight"], p.get(f"{pre}.ln_q.bias"), eps=1e-6)
        k = layer_norm(k, p[f"{pre}.ln_k.weight"], p.get(f"{pre}.ln_k.bias"), eps=1e-6)
    return q, k, v


def _mlp(p, pre: str, x):
    h = gelu_tanh(linear(x, p[f"{pre}.fc1.weight"], p[f"{pre}.fc1.bias"]))
    return linear(h, p[f"{pre}.fc2.weight"], p[f"{pre}.fc2.bias"])


def cropped_pos_embed(p, h_patches: int, w_patches: int, cfg: MMDiTConfig) -> torch.Tensor:
    """The centre ``h_patches`` × ``w_patches`` of the pos-embed grid,
    cropped in the table's own dtype (the caller casts the crop)."""
    pe = p["pos_embed"]  # [1, P*P, hidden]
    P = cfg.pos_embed_max_size
    pe = pe.reshape(P, P, cfg.hidden_size)
    top = (P - h_patches) // 2
    left = (P - w_patches) // 2
    return pe[top:top + h_patches, left:left + w_patches].reshape(
        1, h_patches * w_patches, cfg.hidden_size)


def mmdit_forward(p, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                  y: Optional[torch.Tensor] = None, cfg: MMDiTConfig = SD3_MEDIUM_CONFIG,
                  skip_layers: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: [B,H,W,C] latent (NHWC), timesteps: [B], context: [B,L,ctx],
    y: [B, adm] pooled → the velocity [B,H,W,C].  ``skip_layers``: joint
    blocks to skip (the Skip-Layer Guidance pass)."""
    b, h, w, c = x.shape
    ps = cfg.patch_size
    hp, wp = h // ps, w // ps
    hidden = cfg.hidden_size

    # patchify as a matmul (NHWC → tokens)
    xw = p["x_embedder.proj.weight"]  # [hidden, C, ps, ps]
    patches = x.reshape(b, hp, ps, wp, ps, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, hp * wp, ps * ps * c)
    wmat = xw.permute(0, 2, 3, 1).reshape(hidden, ps * ps * c)
    tokens = linear(patches, wmat, p["x_embedder.proj.bias"])
    tokens = tokens + cropped_pos_embed(p, hp, wp, cfg).to(tokens.dtype)

    t_emb = timestep_embedding(timesteps, 256).to(x.dtype)
    cvec = linear(t_emb, p["t_embedder.mlp.0.weight"], p["t_embedder.mlp.0.bias"])
    cvec = linear(silu(cvec), p["t_embedder.mlp.2.weight"], p["t_embedder.mlp.2.bias"])
    if y is not None and "y_embedder.mlp.0.weight" in p:
        yv = linear(y.to(x.dtype), p["y_embedder.mlp.0.weight"], p["y_embedder.mlp.0.bias"])
        yv = linear(silu(yv), p["y_embedder.mlp.2.weight"], p["y_embedder.mlp.2.bias"])
        cvec = cvec + yv
    act = silu(cvec)

    ctx = linear(context.to(x.dtype), p["context_embedder.weight"], p["context_embedder.bias"])
    n_ctx = ctx.shape[1]
    heads = cfg.num_heads
    for i in range(cfg.depth):
        if i in skip_layers:
            continue
        pre_only = i == cfg.depth - 1
        self_attn_x = i < cfg.num_x_self_attn_layers
        cb = f"joint_blocks.{i}.context_block"
        xb = f"joint_blocks.{i}.x_block"

        # context modulation (6 mods, or 2 when pre_only)
        mc = linear(act, p[f"{cb}.adaLN_modulation.1.weight"], p[f"{cb}.adaLN_modulation.1.bias"])
        mods_c = mc.chunk(2 if pre_only else 6, dim=-1)
        ctx_in = _modulate(layer_norm(ctx, eps=1e-6), mods_c[0], mods_c[1])
        cq, ck, cv = _qkv(p, f"{cb}.attn", ctx_in, heads, cfg.qk_norm)

        mx = linear(act, p[f"{xb}.adaLN_modulation.1.weight"], p[f"{xb}.adaLN_modulation.1.bias"])
        mods_x = mx.chunk(9 if self_attn_x else 6, dim=-1)
        x_norm = layer_norm(tokens, eps=1e-6)
        x_in = _modulate(x_norm, mods_x[0], mods_x[1])
        xq, xk, xv = _qkv(p, f"{xb}.attn", x_in, heads, cfg.qk_norm)

        # [B, L, H, D] → [B, H, L, D] over the context tokens, then the image's
        att = attention(*(torch.cat(pair, dim=1).transpose(1, 2)
                          for pair in ((cq, xq), (ck, xk), (cv, xv))))
        att = att.transpose(1, 2).reshape(b, att.shape[2], hidden)
        ctx_attn, x_attn = att[:, :n_ctx], att[:, n_ctx:]

        if not pre_only:
            ctx_attn = linear(ctx_attn, p[f"{cb}.attn.proj.weight"], p[f"{cb}.attn.proj.bias"])
            ctx = ctx + ctx_attn * mods_c[2][:, None, :]
            ctx_m = _modulate(layer_norm(ctx, eps=1e-6), mods_c[3], mods_c[4])
            ctx = ctx + _mlp(p, f"{cb}.mlp", ctx_m) * mods_c[5][:, None, :]

        x_attn = linear(x_attn, p[f"{xb}.attn.proj.weight"], p[f"{xb}.attn.proj.bias"])
        tokens = tokens + x_attn * mods_x[2][:, None, :]
        if self_attn_x:
            # MMDiT-X: a second (pure self) attention over the image tokens
            x_in2 = _modulate(x_norm, mods_x[6], mods_x[7])
            q2, k2, v2 = _qkv(p, f"{xb}.attn2", x_in2, heads, cfg.qk_norm)
            att2 = attention(q2.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2))
            att2 = att2.transpose(1, 2).reshape(b, hp * wp, hidden)
            att2 = linear(att2, p[f"{xb}.attn2.proj.weight"], p[f"{xb}.attn2.proj.bias"])
            tokens = tokens + att2 * mods_x[8][:, None, :]
        x_m = _modulate(layer_norm(tokens, eps=1e-6), mods_x[3], mods_x[4])
        tokens = tokens + _mlp(p, f"{xb}.mlp", x_m) * mods_x[5][:, None, :]

    mf = linear(act, p["final_layer.adaLN_modulation.1.weight"],
                p["final_layer.adaLN_modulation.1.bias"])
    shift, scale = mf.chunk(2, dim=-1)
    out = _modulate(layer_norm(tokens, eps=1e-6), shift, scale)
    out = linear(out, p["final_layer.linear.weight"], p["final_layer.linear.bias"])

    # unpatchify
    out = out.reshape(b, hp, wp, ps, ps, cfg.out_channels)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, cfg.out_channels)
