"""LoRA, LoCon, LoHa and LoKr adapters on a pipeline's weights (counterpart of
``sdtpu/models/lora.py``).

Key styles: kohya (``lora_unet_*`` / ``lora_te_*`` / ``lora_te1_*`` /
``lora_te2_*`` with ``lora_down`` / ``lora_up`` and ``alpha``), PEFT
(``lora_A`` / ``lora_B`` under ``unet.`` / ``text_encoder.``) and the
diffusers attention-processor form (``unet.<path>.processor.to_q_lora``).
A group resolves to a weight by the module's canonical names with dots
flattened to underscores, one rule for every family.

The apply modes (``--lora-apply-mode``):

* ``auto``: a per-row int8 base (``QuantTensor``) gets runtime factors
  (``QuantLoraTensor``: the int8 base is left as it is), a dense base is
  merged.
* ``immediately``: every base is merged; a per-row int8 base is
  dequantized, merged (with any runtime ranks it carries) and requantized
  per row.
* ``at_runtime``: a dense 2-D base gets runtime factors too
  (``LoraTensor``); a group with no low-rank form (LoCon conv, LoHa, LoKr)
  merges into it.

A packed 4-bit base (``Q4Tensor``) is merged and requantized at the default
group of 64 and a GGUF-block base (``GroupQuantTensor``) symmetric at its own
group, in every mode.  Deltas are computed in float32 on the weight's own
device; a merged dense weight keeps its dtype.  Nothing is changed in
place: a patched entry is replaced by a new object, so the entry it
replaced stays the pristine base.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.ops.quant import (GroupQuantTensor, LoraTensor, Q4Tensor, QuantLoraTensor,
                                   QuantTensor, dequantize, dequantize_group, dequantize_q4,
                                   quantize_group, quantize_per_channel, quantize_q4)

_KEY_RE = re.compile(
    r"(.*)\.(lora_down|lora_up|lora_A|lora_B|alpha|lora_mid|dora_scale"
    r"|hada_w1_a|hada_w1_b|hada_t1|hada_w2_a|hada_w2_b|hada_t2"
    r"|lokr_w1_a|lokr_w1_b|lokr_w1|lokr_w2_a|lokr_w2_b|lokr_w2"
    r")\.?(weight)?$")

_KOHYA_PREFIXES = (
    ("lora_unet_", "diffusion"),
    ("lora_te1_", "clip_l"),
    ("lora_te2_", "clip_g"),
    ("lora_te_", "clip_l"),
    ("unet.", "diffusion"),
    ("text_encoder.", "clip_l"),
)

MODES = ("auto", "immediately", "at_runtime")


def _flatten_key(name: str) -> str:
    return name.replace(".", "_")


def _scalar(a) -> float:
    return float(np.asarray(a).reshape(-1)[0])


def group_lora_tensors(tensors: Dict[str, np.ndarray]) -> Dict[str, dict]:
    """Raw LoRA file tensors → {module key: {down, up, alpha, mid, hada_*,
    lokr_*}}."""
    groups: Dict[str, dict] = {}
    for name, arr in tensors.items():
        m = _KEY_RE.match(name)
        if not m:
            m2 = re.match(r"(.*)\.alpha$", name)
            if m2:
                groups.setdefault(m2.group(1), {})["alpha"] = _scalar(arr)
            continue
        key, kind = m.group(1), m.group(2)
        g = groups.setdefault(key, {})
        if kind in ("lora_down", "lora_A"):
            g["down"] = arr
        elif kind in ("lora_up", "lora_B"):
            g["up"] = arr
        elif kind == "lora_mid":
            g["mid"] = arr
        elif kind == "alpha":
            g["alpha"] = _scalar(arr)
        else:  # LoHa / LoKr factors keep their own names
            g[kind] = arr
    return groups


def resolve_target(lora_key: str, lookup: Dict[str, Dict[str, str]]) -> Optional[Tuple[str, str]]:
    """A LoRA module key → (module, canonical name of its ``.weight``), or
    None."""
    for prefix, module in _KOHYA_PREFIXES:
        if not lora_key.startswith(prefix):
            continue
        flat = lora_key[len(prefix):]
        names = lookup.get(module)
        if names and flat in names:
            return module, names[flat]
    # the diffusers processor form: unet.<path>.processor.to_q_lora etc.
    m = re.match(r"unet\.(.*)\.processor\.(to_[qkv]|to_out)_lora", lora_key)
    if m:
        path = m.group(1) + "." + m.group(2) + (".0" if m.group(2) == "to_out" else "")
        flat = _flatten_key(path)
        names = lookup.get("diffusion", {})
        if flat in names:
            return "diffusion", names[flat]
    return None


def build_lookup(param_names_by_module: Dict[str, list]) -> Dict[str, Dict[str, str]]:
    """module → {flattened name without ``.weight``: canonical name}."""
    out: Dict[str, Dict[str, str]] = {}
    for module, names in param_names_by_module.items():
        out[module] = {_flatten_key(n[:-len(".weight")]): n for n in names
                       if n.endswith(".weight")}
    return out


def _f32(a, device) -> torch.Tensor:
    """A file tensor (numpy or torch) → float32 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    a = np.ascontiguousarray(a, dtype=np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _low_rank(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [o, r(, 1, 1)] · b [r, ...] → [o, ...]."""
    if b.ndim > 2:
        r = b.shape[0]
        return (a.reshape(-1, r) @ b.reshape(r, -1)).reshape((a.shape[0],) + tuple(b.shape[1:]))
    return a @ b


def _loha_delta(g: dict, mult: float, device) -> Optional[torch.Tensor]:
    """LoHa: (w1_a · w1_b) ⊙ (w2_a · w2_b) · alpha / rank (Tucker t1 / t2
    forms too)."""
    parts = []
    for k in ("1", "2"):
        a, b = g.get(f"hada_w{k}_a"), g.get(f"hada_w{k}_b")
        if a is None or b is None:
            return None
        t = g.get(f"hada_t{k}")
        a, b = _f32(a, device), _f32(b, device)
        if t is not None:  # Tucker: t [r, r, kh, kw]; a / b [r, dim]
            parts.append(torch.einsum("rsxy,ro,si->oixy", _f32(t, device), a, b))
        else:
            parts.append(_low_rank(a, b))
    if parts[0].shape != parts[1].shape:
        return None
    rank = g["hada_w1_b"].shape[0]
    alpha = g.get("alpha", float(rank))
    return parts[0] * parts[1] * (mult * alpha / rank)


def _lokr_delta(g: dict, mult: float, device) -> Optional[torch.Tensor]:
    """LoKr: kron(w1, w2) · alpha / rank; either factor may itself be
    low-rank (a · b)."""
    rank = 1

    def factor(k):
        nonlocal rank
        w = g.get(f"lokr_w{k}")
        if w is not None:
            return _f32(w, device)
        a, b = g.get(f"lokr_w{k}_a"), g.get(f"lokr_w{k}_b")
        if a is None or b is None:
            return None
        rank = b.shape[0]
        return _low_rank(_f32(a, device), _f32(b, device))

    w1, w2 = factor(1), factor(2)
    if w1 is None or w2 is None:
        return None
    alpha = g.get("alpha", float(rank))
    scale = 1.0 if rank == 1 else alpha / rank
    if w2.ndim > 2:  # conv kron: w1 [o1, i1], w2 [o2, i2, kh, kw]
        out = torch.einsum("ab,cdxy->acbdxy", w1, w2).reshape(
            w1.shape[0] * w2.shape[0], w1.shape[1] * w2.shape[1], *w2.shape[2:])
    else:
        out = torch.kron(w1, w2)
    return out * (mult * scale)


def lora_delta(g: dict, mult: float, device="cpu") -> Optional[torch.Tensor]:
    """ΔW of one group in float32 on ``device``: mult · (alpha / rank) · up ·
    (mid ·) down; a group without down / up is LoHa or LoKr by its keys."""
    down, up = g.get("down"), g.get("up")
    if down is None or up is None:
        if "hada_w1_a" in g:
            return _loha_delta(g, mult, device)
        if any(k.startswith("lokr_") for k in g):
            return _lokr_delta(g, mult, device)
        return None
    rank = down.shape[0]
    scale = mult * g.get("alpha", float(rank)) / rank
    dn, u = _f32(down, device), _f32(up, device)
    if dn.ndim == 2:
        return (u @ dn) * scale
    # LoCon: down [r, in, kh, kw], up [out, r, 1, 1]
    r, in_c, kh, kw = dn.shape
    u = u.reshape(-1, r)
    mid = g.get("mid")
    if mid is not None:  # Tucker: mid [r, r, kh, kw] composed with down [r, in, 1, 1]
        mid_down = torch.einsum("rsxy,si->rixy", _f32(mid, device), dn.reshape(r, in_c))
        return torch.einsum("or,rixy->oixy", u, mid_down) * scale
    return (u @ dn.reshape(r, -1)).reshape(u.shape[0], in_c, kh, kw) * scale


def _lowrank_factors(g: dict, mult: float, w_shape, device):
    """(down [r, in], up · scale [out, r]) in float32 for runtime attachment,
    or None where the group has no plain low-rank form (LoHa, LoKr, a
    k×k conv)."""
    if "down" not in g or "up" not in g:
        return None
    if g["down"].ndim != 2 and tuple(g["down"].shape[2:]) != (1, 1):
        return None
    down = _f32(g["down"], device).reshape(g["down"].shape[0], -1)
    up = _f32(g["up"], device).reshape(g["up"].shape[0], -1)
    rank = down.shape[0]
    up = up * (mult * (g.get("alpha", rank) / rank))
    if down.shape[1] != w_shape[1] or up.shape[0] != w_shape[0]:
        return None
    return down, up


def _device(w) -> torch.device:
    for t in (w.q if isinstance(w, (QuantTensor, QuantLoraTensor, GroupQuantTensor)) else None,
              w.packed if isinstance(w, Q4Tensor) else None,
              w.w if isinstance(w, LoraTensor) else None):
        if t is not None:
            return t.device
    return w.device


def _stack(old: torch.Tensor, new: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat([old.float(), new], dim=dim)


def _attach(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def apply_lora(params_by_module: Dict[str, dict], lora_tensors: Dict[str, np.ndarray],
               multiplier: float = 1.0, mode: str = "auto",
               factor_dtype: Optional[torch.dtype] = None) -> Tuple[int, int]:
    """Apply one LoRA file's tensors to the module param dicts (``diffusion``,
    ``clip_l``, ``clip_g``), replacing each patched entry → (groups applied,
    groups in the file).  A group that resolves to no weight, or whose ΔW
    does not fit it, is skipped but counted.  ``factor_dtype``: the dtype
    runtime factors are attached in (the pipeline's compute dtype; None
    keeps float32, as the JAX package stores them).  The float32 products
    run with TF32 off, so a requantized weight moves off the numpy grid
    only where cuBLAS's summation order rounds across a step."""
    if mode not in MODES:
        raise ValueError(f"lora apply mode {mode!r}: one of {MODES}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _apply(params_by_module, lora_tensors, multiplier, mode, factor_dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _apply(params_by_module, lora_tensors, multiplier, mode, factor_dtype) -> Tuple[int, int]:
    groups = group_lora_tensors(lora_tensors)
    lookup = build_lookup({m: list(p) for m, p in params_by_module.items() if p})
    applied = 0
    for key, g in groups.items():
        target = resolve_target(key, lookup)
        if target is None:
            continue
        module, pname = target
        params = params_by_module[module]
        w = params[pname]
        dev = _device(w)
        if isinstance(w, (Q4Tensor, GroupQuantTensor)):
            # no runtime path on a block grid: dequantize, merge, requantize
            # (4-bit at the default group, GGUF blocks symmetric at their own)
            delta = lora_delta(g, multiplier, dev)
            if delta is None or tuple(delta.shape) != tuple(w.shape):
                continue
            if isinstance(w, Q4Tensor):
                params[pname] = quantize_q4(dequantize_q4(w, torch.float32) + delta)
            else:
                params[pname] = quantize_group(dequantize_group(w, torch.float32) + delta,
                                               group=w.group)
            applied += 1
            continue
        if isinstance(w, (QuantTensor, QuantLoraTensor)):
            if mode == "immediately":
                # fold everything, attached ranks too, into a fresh per-row base
                delta = lora_delta(g, multiplier, dev)
                if delta is None or tuple(delta.shape) != tuple(w.shape):
                    continue
                dense = dequantize(QuantTensor(w.q, w.scale), torch.float32)
                if isinstance(w, QuantLoraTensor):
                    dense = dense + w.lora_up.float() @ w.lora_down.float()
                params[pname] = quantize_per_channel(dense + delta)
                applied += 1
                continue
            fac = _lowrank_factors(g, multiplier, w.shape, dev)
            if fac is None:
                continue
            down, up = fac
            if isinstance(w, QuantLoraTensor):  # stack the ranks
                down, up = _stack(w.lora_down, down, 0), _stack(w.lora_up, up, 1)
            params[pname] = QuantLoraTensor(q=w.q, scale=w.scale,
                                            lora_down=_attach(down, factor_dtype),
                                            lora_up=_attach(up, factor_dtype))
            applied += 1
            continue
        if isinstance(w, LoraTensor) or (mode == "at_runtime" and w.ndim == 2):
            base = w.w if isinstance(w, LoraTensor) else w
            fac = _lowrank_factors(g, multiplier, base.shape, dev)
            if fac is None:  # no low-rank form: merge into the base
                delta = lora_delta(g, multiplier, dev)
                if delta is None or tuple(delta.shape) != tuple(base.shape):
                    continue
                merged = (base.float() + delta).to(base.dtype)
                params[pname] = (LoraTensor(merged, w.lora_down, w.lora_up)
                                 if isinstance(w, LoraTensor) else merged)
                applied += 1
                continue
            down, up = fac
            if isinstance(w, LoraTensor):
                down, up = _stack(w.lora_down, down, 0), _stack(w.lora_up, up, 1)
            params[pname] = LoraTensor(w=base, lora_down=_attach(down, factor_dtype),
                                       lora_up=_attach(up, factor_dtype))
            applied += 1
            continue
        delta = lora_delta(g, multiplier, dev)
        if delta is None:
            continue
        if tuple(delta.shape) != tuple(w.shape):
            if delta.ndim == 2 and w.ndim == 4 and tuple(delta.shape) == tuple(w.shape[:2]):
                delta = delta.reshape(tuple(delta.shape) + (1, 1))
            else:
                continue
        params[pname] = (w.float() + delta).to(w.dtype)
        applied += 1
    return applied, len(groups)


def lora_modules(pipe) -> Dict[str, dict]:
    """A pipeline's live param dicts a LoRA can patch: the diffusion model's,
    and CLIP-L's / CLIP-G's where its conditioner has them (SD1.x and SD2.x
    hold their one text tower as CLIP-L; the T5 and LLM encoders take no
    LoRA, as in the JAX package)."""
    from sdtpu_torch.conditioning.conditioner import (FluxConditioner, SD1Conditioner,
                                                      SD3Conditioner, SDXLConditioner)

    cond = pipe.conditioner
    out = {"diffusion": pipe.diffusion_params}
    if isinstance(cond, SD1Conditioner):
        out["clip_l"] = cond.params
    elif isinstance(cond, (FluxConditioner, SDXLConditioner, SD3Conditioner)):
        out["clip_l"] = cond.pl
    if isinstance(cond, (SDXLConditioner, SD3Conditioner)):
        out["clip_g"] = cond.pg
    return {k: v for k, v in out.items() if v is not None}
