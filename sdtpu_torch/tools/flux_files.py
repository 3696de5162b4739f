"""A synthetic FLUX.1-dev checkpoint set on disk, at full width, from seeded
raw blocks (the files a user passes to ``python -m sdtpu_torch.cli``).

    python -m sdtpu_torch.tools.flux_files OUT_DIR

Writes four files, each tensor by tensor (no float source is ever held;
values are drawn on the GPU from fixed seeds):
  flux1-dev-q8_0.gguf   the DiT under its internal names, every 2-D weight of
                        at least 2**16 elements as q8_0 blocks (random int8
                        in [-127, 127], fp16 block scales around
                        ``Q8_SCALE``, so values have std ~0.02), the rest
                        float32 at its init;
  t5xxl-q8_0.gguf       the T5-XXL encoder under llama.cpp names, q8_0 the
                        same way (the token embedding too; norms and the
                        relative-attention bias float32), with a synthetic
                        unigram vocab of T5's 32128 pieces as
                        ``tokenizer.ggml.*``;
  clip_l.safetensors    CLIP-L in bf16;
  ae.safetensors        the FLUX VAE, encoder included, float32, under its
                        original names (no post_quant_conv, as FLUX's).
``write_flux_files`` may cut the depth of the DiT and draw on another
device; its width and every other module stay full.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import struct
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from sdtpu_torch.io import gguf
from sdtpu_torch.models import clip as clip_mod
from sdtpu_torch.models import flux as flux_mod
from sdtpu_torch.models import t5 as t5_mod
from sdtpu_torch.models import vae as vae_mod
from sdtpu_torch.weights import MIN_QUANT_ELEMS, Q4_SCALE, Q8_SCALE, WEIGHT_STD

# HF T5 names → llama.cpp GGUF names (the inverse of convert_gguf_t5_name)
GGUF_T5_NAMES = (("encoder.block.", "enc.blk."), ("encoder.final_layer_norm.", "enc.output_norm."),
                 ("layer.0.SelfAttention.relative_attention_bias.", "attn_rel_b."),
                 ("layer.0.SelfAttention.q.", "attn_q."), ("layer.0.SelfAttention.k.", "attn_k."),
                 ("layer.0.SelfAttention.v.", "attn_v."), ("layer.0.SelfAttention.o.", "attn_o."),
                 ("layer.0.layer_norm.", "attn_norm."), ("layer.1.layer_norm.", "ffn_norm."),
                 ("layer.1.DenseReluDense.wi_0.", "ffn_gate."),
                 ("layer.1.DenseReluDense.wi_1.", "ffn_up."),
                 ("layer.1.DenseReluDense.wo.", "ffn_down."), ("shared.", "token_embd."))
_WORDS = ("a", "the", "of", "on", "in", "at", "and", "with", "photograph", "astronaut", "riding",
          "horse", "red", "fox", "fresh", "snow", "golden", "hour", "lighthouse", "cliff", "above",
          "stormy", "sea", "paper", "boat", "puddle", "after", "rain", "lantern", "wooden", "table",
          "portrait", "studio", "lighting", "city", "night", "cat", "dog", "forest", "mountain")


def gguf_t5_name(name: str) -> str:
    for src, dst in GGUF_T5_NAMES:
        name = name.replace(src, dst)
    return name


def synthetic_t5_vocab(n: int, seed: int = 0) -> dict:
    """A unigram vocab of ``n`` pieces as llama.cpp ``tokenizer.ggml.*``
    metadata: the specials, "▁", single characters with and without "▁",
    English words, then seeded random letter strings; longer pieces score
    higher, so words come out whole."""
    rng = np.random.default_rng(seed)
    chars = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,:;!?()'\"-")
    pieces = ["<pad>", "</s>", "<unk>", "▁"] + chars + ["▁" + c for c in chars]
    pieces += ["▁" + w for w in _WORDS] + list(_WORDS)
    seen = set(pieces)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(pieces) < n:
        p = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        p = ("▁" + p) if rng.random() < 0.5 else p
        if p not in seen:
            seen.add(p)
            pieces.append(p)
    scores = [0.0, 0.0, 0.0] + [float(-12.0 + len(p) + rng.uniform(0, 0.5)) for p in pieces[3:]]
    return {"tokenizer.ggml.model": "t5", "tokenizer.ggml.tokens": pieces,
            "tokenizer.ggml.scores": scores, "tokenizer.ggml.token_type": [3, 3, 2] + [1] * (n - 3),
            "tokenizer.ggml.eos_token_id": 1, "tokenizer.ggml.padding_token_id": 0,
            "tokenizer.ggml.unknown_token_id": 2}


def _quantized(shape, init: str, min_elems: int = MIN_QUANT_ELEMS) -> bool:
    return (len(shape) == 2 and init == "normal" and shape[0] * shape[1] >= min_elems
            and shape[1] % 32 == 0)


class _Draw:
    """Seeded values drawn on a device, handed to the host tensor by tensor."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(seed)

    def q8_0(self, shape) -> np.ndarray:
        """Raw q8_0 blocks (fp16 scale, 32 int8) of a tensor of ``shape``."""
        nb = shape[0] * shape[1] // 32
        q = torch.randint(-127, 128, (nb, 32), generator=self.g, device=self.device,
                          dtype=torch.int8)
        d = (torch.rand((nb, 1), generator=self.g, device=self.device) * 0.5 + 0.75) * Q8_SCALE
        blocks = torch.cat([d.half().view(torch.uint8), q.view(torch.uint8)], dim=1)
        return blocks.cpu().numpy().reshape(-1)

    def q4_0(self, shape) -> np.ndarray:
        """Raw q4_0 blocks (fp16 scale, 16 bytes of nibbles) of a tensor of
        ``shape``."""
        nb = shape[0] * shape[1] // 32
        nib = torch.randint(0, 256, (nb, 16), generator=self.g, device=self.device, dtype=torch.uint8)
        d = (torch.rand((nb, 1), generator=self.g, device=self.device) * 0.5 + 0.75) * Q4_SCALE
        return torch.cat([d.half().view(torch.uint8), nib], dim=1).cpu().numpy().reshape(-1)

    def dense(self, shape, init: str, dtype=torch.float32) -> torch.Tensor:
        if init == "normal" or isinstance(init, float):
            std = WEIGHT_STD if init == "normal" else init
            t = torch.randn(shape, generator=self.g, device=self.device).mul_(std)
        else:
            t = (torch.ones if init == "ones" else torch.zeros)(shape, device=self.device)
        return t.to(dtype)


def _gguf_from_specs(path: Path, specs: dict, draw: _Draw, min_elems: int, metadata=None,
                     rename=lambda n: n, qtype: int = gguf.GGML_Q8_0) -> int:
    """A GGUF file of ``specs``: the tensors ``_quantized`` picks as
    ``qtype`` blocks (q8_0 or q4_0), the rest float32 → bytes written."""
    blocks = {gguf.GGML_Q8_0: draw.q8_0, gguf.GGML_Q4_0: draw.q4_0}[qtype]
    types = {rename(n): (qtype if _quantized(s, i, min_elems) else gguf.GGML_F32, s, i)
             for n, (s, i) in specs.items()}

    def payload(name):
        t, shape, init = types[name]
        if t == qtype:
            return blocks(shape)
        return draw.dense(shape, init).cpu().numpy().view(np.uint8).reshape(-1)

    return gguf.write_gguf(str(path), [(n, t, s) for n, (t, s, _) in types.items()], payload,
                           metadata=metadata)


def write_safetensors(path: Path, specs: dict, draw: _Draw, dtype=torch.float32,
                      names: Optional[Dict[str, list]] = None) -> int:
    """A safetensors file of ``specs`` drawn by ``draw`` in ``dtype``, tensor
    by tensor → bytes written.  ``names`` (name → the names it is written
    under) renames each tensor, cut in as many equal parts along dim 0 as it
    has names (a fused q / k / v written apart): the values drawn do not
    depend on it."""
    name = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}[dtype]
    size = torch.tensor([], dtype=dtype).element_size()
    names = names or {n: [n] for n in specs}
    header, offset = {}, 0
    for n, (shape, _) in specs.items():
        parts = names[n]
        part_shape = [shape[0] // len(parts), *shape[1:]]
        for pn in parts:
            nbytes = int(np.prod(part_shape)) * size
            header[pn] = {"dtype": name, "shape": part_shape, "data_offsets": [offset, offset + nbytes]}
            offset += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as f:
        written = f.write(struct.pack("<Q", len(hjson))) + f.write(hjson)
        for n, (shape, init) in specs.items():
            t = draw.dense(shape, init, dtype).contiguous().view(torch.uint8)
            written += f.write(memoryview(t.cpu().numpy()).cast("B"))
    return written


def file_specs(double: int = 19, single: int = 38) -> Dict[str, dict]:
    """file → {name: (shape, init)} of the set at full width."""
    dit = dataclasses.replace(flux_mod.FLUX_DEV_CONFIG, depth=double, depth_single=single)
    vae = {k: v for k, v in vae_mod.param_specs(vae_mod.FLUX_VAE_CONFIG).items()
           if not k.startswith("post_quant_conv.")}
    return {"diffusion_model": flux_mod.param_specs(dit),
            "t5xxl": t5_mod.param_specs(t5_mod.T5_XXL_CONFIG),
            "clip_l": clip_mod.param_specs(clip_mod.CLIP_L_CONFIG),
            "vae": {**vae_mod.vae_encoder_specs(vae_mod.FLUX_VAE_CONFIG), **vae}}


FILE_NAMES = {"diffusion_model": "flux1-dev-q8_0.gguf", "t5xxl": "t5xxl-q8_0.gguf",
              "clip_l": "clip_l.safetensors", "vae": "ae.safetensors"}


def expected_bytes(specs: Dict[str, dict], min_elems: int = MIN_QUANT_ELEMS,
                   qtypes: Optional[Dict[str, int]] = None) -> int:
    """About the bytes the set takes on disk (payloads; headers aside).
    ``qtypes``: file → the GGUF block type of its quantized tensors (by
    default FLUX's: the DiT and T5-XXL q8_0); CLIP-L is bf16, the rest
    float32."""
    qtypes = qtypes or {"diffusion_model": gguf.GGML_Q8_0, "t5xxl": gguf.GGML_Q8_0}
    total = 0
    for flag, mod in specs.items():
        for shape, init in mod.values():
            n = int(np.prod(shape))
            if flag in qtypes and _quantized(shape, init, min_elems):
                elems, nbytes = gguf.BLOCK_INFO[qtypes[flag]]
                total += n // elems * nbytes
            else:
                total += n * (2 if flag == "clip_l" else 4)
    return total


def write_flux_files(out_dir, double: int = 19, single: int = 38, device="cuda",
                     min_quant_elems: int = MIN_QUANT_ELEMS) -> dict:
    """Write the set into ``out_dir`` → {"paths": {CLI flag: path}, "bytes": {...},
    "write_s": {...}}; 2-D weights of at least ``min_quant_elems`` go q8_0.
    Raises before writing where the disk has too little free space."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = file_specs(double, single)
    need = expected_bytes(specs, min_quant_elems) + (1 << 30)
    free = shutil.disk_usage(out_dir).free
    if free < need:
        raise RuntimeError(f"{out_dir}: {free / 2**30:.1f} GiB free, the FLUX file set needs "
                           f"{need / 2**30:.1f} GiB")
    out = {"paths": {}, "bytes": {}, "write_s": {}}
    for i, (flag, mod) in enumerate(specs.items()):
        path = out_dir / FILE_NAMES[flag]
        draw = _Draw(i, device)
        t0 = time.time()
        if flag == "diffusion_model":
            n = _gguf_from_specs(path, mod, draw, min_quant_elems)
        elif flag == "t5xxl":
            vocab = synthetic_t5_vocab(t5_mod.T5_XXL_CONFIG.vocab_size)
            n = _gguf_from_specs(path, mod, draw, min_quant_elems, metadata=vocab,
                                 rename=gguf_t5_name)
        else:
            n = write_safetensors(path, mod, draw, torch.bfloat16 if flag == "clip_l" else torch.float32)
        out["write_s"][flag] = time.time() - t0
        out["paths"][flag] = str(path)
        out["bytes"][flag] = n
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print(json.dumps(write_flux_files(sys.argv[1]), indent=1))
