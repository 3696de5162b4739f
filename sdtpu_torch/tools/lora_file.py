"""Synthetic LoRA files from seeded values, for the port's tests and its
on-card proof (no published LoRA is in the repo or fetched).

``lora_tensors`` draws the groups from ``numpy.random.default_rng(seed)``
in name order: down [r, in] and up [out, r] with standard deviation
``std`` and ``alpha`` = r, so ΔW has a standard deviation of about
√r · std² (4e-3 at r 16, std 0.03, a fifth of the std-0.02 random
weights).  ``kind`` picks the adapter: ``lora`` (2-D weights), ``locon`` /
``locon_tucker`` (4-D convolutions: a k×k down, or a 1×1 down with a k×k
``lora_mid``), ``loha`` (2-D; ``loha_tucker``: 4-D with ``hada_t1`` /
``hada_t2``) and ``lokr`` (2-D weights whose sides split by 2 or 4: a dense
``lokr_w1`` and a low-rank ``lokr_w2_a`` · ``lokr_w2_b``).  ``style``
names the keys: ``kohya`` (``lora_unet_<flat name>.lora_down.weight``),
``peft`` (``unet.<flat name>.lora_A.weight``) or ``diffusers`` (the
attention processor form, ``unet.<path>.processor.to_q_lora.lora_down.weight``,
for the ``to_q`` / ``to_k`` / ``to_v`` / ``to_out.0`` weights only).
"""
from __future__ import annotations

import json
import re
import struct
from typing import Dict, Optional

import numpy as np

KINDS = ("lora", "locon", "locon_tucker", "loha", "loha_tucker", "lokr")
STYLES = ("kohya", "peft", "diffusers")
# lookup tables, not linears: no adapter is drawn over them
TABLES = ("token_embedding", "position_embedding", "embed_tokens", "shared.weight")


def te_prefixes(modules) -> Dict[str, str]:
    """module → its kohya prefix: CLIP-L is ``lora_te_`` alone and
    ``lora_te1_`` beside a CLIP-G (``lora_te2_``)."""
    two = "clip_g" in modules
    return {"diffusion": "lora_unet_", "clip_l": "lora_te1_" if two else "lora_te_",
            "clip_g": "lora_te2_"}


def _fits(kind: str, shape) -> bool:
    if kind in ("lora", "loha"):
        return len(shape) == 2
    if kind == "lokr":
        return len(shape) == 2 and shape[0] % 2 == 0 and shape[1] % 4 == 0
    return len(shape) == 4  # the LoCon and Tucker LoHa forms


def _group(rng, kind: str, shape, rank: int, std: float) -> Dict[str, np.ndarray]:
    def draw(*s):
        return (rng.standard_normal(s) * std).astype(np.float32)

    out, r = shape[0], rank
    alpha = {"alpha": np.asarray(float(r), np.float32)}
    if kind == "lora":
        return {"lora_down.weight": draw(r, shape[1]), "lora_up.weight": draw(out, r), **alpha}
    if kind == "locon":
        return {"lora_down.weight": draw(r, *shape[1:]), "lora_up.weight": draw(out, r, 1, 1),
                **alpha}
    if kind == "locon_tucker":
        return {"lora_down.weight": draw(r, shape[1], 1, 1),
                "lora_mid.weight": draw(r, r, *shape[2:]), "lora_up.weight": draw(out, r, 1, 1),
                **alpha}
    if kind == "loha":
        return {"hada_w1_a": draw(out, r), "hada_w1_b": draw(r, shape[1]),
                "hada_w2_a": draw(out, r), "hada_w2_b": draw(r, shape[1]), **alpha}
    if kind == "loha_tucker":
        return {"hada_w1_a": draw(r, out), "hada_w1_b": draw(r, shape[1]),
                "hada_t1": draw(r, r, *shape[2:]), "hada_w2_a": draw(r, out),
                "hada_w2_b": draw(r, shape[1]), "hada_t2": draw(r, r, *shape[2:]), **alpha}
    # lokr: kron(w1 [2, 4], w2_a · w2_b [out / 2, in / 4])
    return {"lokr_w1": draw(2, 4), "lokr_w2_a": draw(out // 2, r),
            "lokr_w2_b": draw(r, shape[1] // 4), **alpha}


def _key(style: str, prefix: str, name: str) -> Optional[str]:
    stem = name[:-len(".weight")]
    if style == "kohya":
        return prefix + stem.replace(".", "_")
    if style == "peft":
        return ("unet." if prefix == "lora_unet_" else "text_encoder.") + stem.replace(".", "_")
    m = re.fullmatch(r"(.*)\.(to_[qkv]|to_out)(\.0)?", stem)
    if prefix != "lora_unet_" or not m or bool(m.group(3)) != (m.group(2) == "to_out"):
        return None
    return f"unet.{m.group(1)}.processor.{m.group(2)}_lora"


def lora_tensors(shapes_by_module: Dict[str, dict], rank: int = 4, seed: int = 0,
                 std: float = 0.03, kind: str = "lora", style: str = "kohya"
                 ) -> Dict[str, np.ndarray]:
    """{module: {name: weight or shape}} (``diffusion``, ``clip_l``,
    ``clip_g``) → one LoRA file's tensors: a ``kind`` group on every
    ``.weight`` it fits but the lookup tables (``TABLES``), keys in
    ``style``."""
    if kind not in KINDS or style not in STYLES:
        raise ValueError(f"kind {kind!r} / style {style!r}: one of {KINDS} / {STYLES}")
    if style != "kohya" and kind != "lora":
        raise ValueError(f"the {style} style names lora_A / lora_down groups only")
    rng = np.random.default_rng(seed)
    prefixes = te_prefixes(shapes_by_module)
    out: Dict[str, np.ndarray] = {}
    for module in sorted(shapes_by_module):
        for name in sorted(shapes_by_module[module]):
            v = shapes_by_module[module][name]
            shape = tuple(v if isinstance(v, (tuple, list)) else v.shape)
            if (not name.endswith(".weight") or not _fits(kind, shape)
                    or any(t in name for t in TABLES)):
                continue
            key = _key(style, prefixes[module], name)
            if key is None:
                continue
            for part, arr in _group(rng, kind, shape, rank, std).items():
                if style == "peft":
                    part = part.replace("lora_down", "lora_A").replace("lora_up", "lora_B")
                out[f"{key}.{part}"] = arr
    return out


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> int:
    """float32 / float16 numpy tensors → a safetensors file → bytes written."""
    codes = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16"}
    header, offset = {}, 0
    for n, a in tensors.items():
        header[n] = {"dtype": codes[a.dtype], "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as f:
        written = f.write(struct.pack("<Q", len(hjson))) + f.write(hjson)
        for a in tensors.values():
            written += f.write(np.ascontiguousarray(a).tobytes())
    return written


def write_ckpt(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """numpy tensors → a torch ZIP checkpoint under ``state_dict``, as
    training scripts save them."""
    import torch

    sd = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in tensors.items()}
    torch.save({"state_dict": sd}, path)

