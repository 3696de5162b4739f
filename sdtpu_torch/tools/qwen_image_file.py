"""A synthetic Qwen-Image file set on disk, at full width, from seeded
values (the files a user passes to ``python -m sdtpu_torch.cli
--diffusion-model ... --llm ... --vae ...``).

    python -m sdtpu_torch.tools.qwen_image_file OUT_DIR

Three files, written tensor by tensor (no whole float source is ever held;
values are drawn on the device from fixed seeds: std 0.02 weights, unit
norm gains, zero biases, the VAE's convolutions std 0.05):
  qwen-image-q4_0.gguf (about 11.5 GB): the DiT under its original names
      (``QWEN_IMAGE_CONFIG``: 60 blocks, 24 heads of 128, context 3584),
      every 2-D weight of at least 2**16 elements as q4_0 blocks (random
      nibbles, fp16 block scales around ``Q4_SCALE``); q8_0 would be 21.7 GB;
  Qwen2.5-VL-7B-q4_0.gguf (about 4 GB): the Qwen2.5-VL-7B text tower under
      llama.cpp names, its q / k / v biases float32, every 2-D weight of at
      least 2**16 elements (the token embedding too) as q4_0 blocks, with a
      "gpt2" vocab of 152064 ids (``Qwen2Tokenizer.byte_fallback``'s
      vocabulary, ``tools/z_image_file.py``'s ``qwen_byte_vocab``);
  wan_2.1_vae.safetensors: the Wan 2.1 VAE, encoder included, float32.
Both packages' loaders fingerprint the first as Qwen-Image; the LLM's
config reads as ``QWEN25_VL_7B_CONFIG``.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import torch

from sdtpu_torch.io import gguf
from sdtpu_torch.models import llm as llm_mod
from sdtpu_torch.models import qwen_image as qi_mod
from sdtpu_torch.models import wan_vae as wan_vae_mod
from sdtpu_torch.tools.flux_files import _Draw, _gguf_from_specs, expected_bytes, write_safetensors
from sdtpu_torch.tools.z_image_file import gguf_llm_name, qwen_byte_vocab
from sdtpu_torch.weights import MIN_QUANT_ELEMS

SEED = 0
FILE_NAMES = {"diffusion_model": "qwen-image-q4_0.gguf", "llm": "Qwen2.5-VL-7B-q4_0.gguf",
              "vae": "wan_2.1_vae.safetensors"}
QTYPES = {"diffusion_model": gguf.GGML_Q4_0, "llm": gguf.GGML_Q4_0}


def file_specs() -> dict:
    """file → {name: (shape, init)} of the set at full width."""
    return {"diffusion_model": qi_mod.param_specs(qi_mod.QWEN_IMAGE_CONFIG),
            "llm": llm_mod.param_specs(llm_mod.QWEN25_VL_7B_CONFIG),
            "vae": wan_vae_mod.param_specs(wan_vae_mod.WAN21_VAE_CONFIG, decode_only=False)}


def write_qwen_image_files(out_dir, device="cuda", min_quant_elems: int = MIN_QUANT_ELEMS) -> dict:
    """Write the set into ``out_dir`` → {"paths": {key: path}, "bytes",
    "write_s", "tensors"}.  Raises before writing where the disk has too
    little free space."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = file_specs()
    need = expected_bytes(specs, min_quant_elems, QTYPES) + (1 << 28)
    free = shutil.disk_usage(out_dir).free
    if free < need:
        raise RuntimeError(f"{out_dir}: {free / 2**30:.1f} GiB free, the Qwen-Image files need "
                           f"{need / 2**30:.1f} GiB")
    out = {"paths": {}, "bytes": {}, "write_s": {}, "tensors": {}}
    for i, (key, sp) in enumerate(specs.items()):
        path = out_dir / FILE_NAMES[key]
        draw = _Draw(SEED + i, device)
        t0 = time.time()
        if key == "diffusion_model":
            n = _gguf_from_specs(path, sp, draw, min_quant_elems, qtype=gguf.GGML_Q4_0)
        elif key == "llm":
            n = _gguf_from_specs(path, sp, draw, min_quant_elems,
                                 metadata=qwen_byte_vocab(llm_mod.QWEN25_VL_7B_CONFIG.vocab_size),
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
    print(json.dumps(write_qwen_image_files(sys.argv[1]), indent=1))
