"""A synthetic Z-Image-Turbo file set on disk, at full width, from seeded
values (the files a user passes to ``python -m sdtpu_torch.cli
--diffusion-model ... --llm ... --vae ...``).

    python -m sdtpu_torch.tools.z_image_file OUT_DIR

Three files, written tensor by tensor (no whole float source is ever held;
values are drawn on the device from fixed seeds: std 0.02 weights and pad
tokens, unit norm gains, zero biases):
  z_image_turbo-q8_0.gguf (about 6.5 GB): the DiT under its original names
      (``Z_IMAGE_CONFIG``: 30 layers and 2 + 2 refiner layers, hidden 3840,
      30 heads of 128, FFN 10240, ``cap_feat_dim`` 2560), every 2-D weight
      of at least 2**16 elements as q8_0 blocks, as ``tools/flux_files.py``
      writes FLUX's;
  Qwen3-4B-q4_0.gguf (about 2.3 GB): Qwen3-4B under llama.cpp names, every
      2-D weight of at least 2**16 elements (the token embedding too) as
      q4_0 blocks (random nibbles, fp16 block scales around ``Q4_SCALE``),
      with a "gpt2" vocab of Qwen's 151936 ids as ``tokenizer.ggml.*``: the
      256 byte units at 0..255 and the special tokens at their fixed ids
      (``Qwen2Tokenizer.byte_fallback``'s vocabulary), the rest unused;
  ae.safetensors: the FLUX VAE, encoder included, float32
      (``tools/flux_files.py``'s).
Both packages' loaders fingerprint the first as Z-Image; the LLM's config
reads as ``QWEN3_4B_CONFIG``.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import torch

from sdtpu_torch.io import gguf
from sdtpu_torch.io.name_conversion import _GGUF_LLM_MAP, _replace_name_map
from sdtpu_torch.models import llm as llm_mod
from sdtpu_torch.models import z_image as zi_mod
from sdtpu_torch.tokenizers.bpe import bytes_to_unicode
from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer
from sdtpu_torch.tools.flux_files import _Draw, _gguf_from_specs, expected_bytes, write_safetensors
from sdtpu_torch.tools.flux_files import file_specs as flux_file_specs
from sdtpu_torch.weights import MIN_QUANT_ELEMS

SEED = 0
FILE_NAMES = {"diffusion_model": "z_image_turbo-q8_0.gguf", "llm": "Qwen3-4B-q4_0.gguf",
              "vae": "ae.safetensors"}
QTYPES = {"diffusion_model": gguf.GGML_Q8_0, "llm": gguf.GGML_Q4_0}
# llama.cpp token types: normal, control, unused
_TT_NORMAL, _TT_CONTROL, _TT_UNUSED = 1, 3, 5


def gguf_llm_name(name: str) -> str:
    """HF LLM names → llama.cpp GGUF names: the loader's map, inverted."""
    return _replace_name_map(name, [(hf, src) for src, hf in _GGUF_LLM_MAP])


def qwen_byte_vocab(n: int) -> dict:
    """``Qwen2Tokenizer.byte_fallback``'s vocabulary as llama.cpp
    ``tokenizer.ggml.*`` metadata of ``n`` ids: the 256 byte units, the
    special tokens at their fixed ids, "[PAD<id>]" for every other id; no
    merges."""
    tokens = [f"[PAD{i}]" for i in range(n)]
    types = [_TT_UNUSED] * n
    for i, ch in enumerate(bytes_to_unicode().values()):
        tokens[i], types[i] = ch, _TT_NORMAL
    for tok, i in Qwen2Tokenizer.CANONICAL_SPECIAL.items():
        tokens[i], types[i] = tok, _TT_CONTROL
    special = Qwen2Tokenizer.CANONICAL_SPECIAL
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "qwen2",
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.eos_token_id": special["<|im_end|>"],
            "tokenizer.ggml.padding_token_id": special["<|endoftext|>"]}


def file_specs() -> dict:
    """file → {name: (shape, init)} of the set at full width."""
    return {"diffusion_model": zi_mod.param_specs(zi_mod.Z_IMAGE_CONFIG),
            "llm": llm_mod.param_specs(llm_mod.QWEN3_4B_CONFIG),
            "vae": flux_file_specs(double=1, single=1)["vae"]}


def write_z_image_files(out_dir, device="cuda", min_quant_elems: int = MIN_QUANT_ELEMS) -> dict:
    """Write the set into ``out_dir`` → {"paths": {key: path}, "bytes",
    "write_s", "tensors"}.  Raises before writing where the disk has too
    little free space."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = file_specs()
    need = expected_bytes(specs, min_quant_elems, QTYPES) + (1 << 28)
    free = shutil.disk_usage(out_dir).free
    if free < need:
        raise RuntimeError(f"{out_dir}: {free / 2**30:.1f} GiB free, the Z-Image files need "
                           f"{need / 2**30:.1f} GiB")
    out = {"paths": {}, "bytes": {}, "write_s": {}, "tensors": {}}
    for i, (key, sp) in enumerate(specs.items()):
        path = out_dir / FILE_NAMES[key]
        draw = _Draw(SEED + i, device)
        t0 = time.time()
        if key == "diffusion_model":
            n = _gguf_from_specs(path, sp, draw, min_quant_elems)
        elif key == "llm":
            n = _gguf_from_specs(path, sp, draw, min_quant_elems,
                                 metadata=qwen_byte_vocab(llm_mod.QWEN3_4B_CONFIG.vocab_size),
                                 rename=gguf_llm_name, qtype=gguf.GGML_Q4_0)
        else:
            n = write_safetensors(path, sp, draw, torch.float32)
        out["write_s"][key] = time.time() - t0
        out["paths"][key] = str(path)
        out["bytes"][key] = n
        out["tensors"][key] = len(sp)
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print(json.dumps(write_z_image_files(sys.argv[1]), indent=1))
