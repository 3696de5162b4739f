"""A synthetic Wan2.1-T2V-1.3B file set on disk, at full width, from seeded
values (the files a user passes to ``python -m sdtpu_torch.cli -M vid_gen
--diffusion-model ... --vae ... --t5xxl ...``).

    python -m sdtpu_torch.tools.wan_file OUT_DIR

Three files, written tensor by tensor (no whole float source is ever held;
values are drawn on the device from fixed seeds: std 0.02 DiT weights and
modulation tables, std 0.05 VAE convolutions, unit norm gains, zero
biases):
  wan2.1_t2v_1.3B_fp16.safetensors (about 2.8 GB, float16): the DiT under
      its original names (``WAN21_T2V_1_3B_CONFIG``: 30 blocks, dim 1536,
      12 heads of 128, ffn 8960);
  wan_2.1_vae.safetensors (float16): the Wan 2.1 VAE's decoder half
      (``conv2``, ``decoder.*``; T2V decodes only);
  umt5-xxl-enc-q8_0.gguf: UMT5-XXL under llama.cpp names (a relative bias in
      every block), its 2-D weights q8_0 as ``tools/flux_files.py`` writes
      T5-XXL, with a synthetic unigram vocab of UMT5's 256384 pieces.
Both packages' loaders fingerprint the first as Wan2 and its config as
Wan2.1-T2V-1.3B's.

``write_vae_files(out_dir)`` writes the whole Wan 2.1 VAE (encoder
included) under its original names and under ``AutoencoderKLWan``'s, drawn
from one seed, and a DiT cut to ``dit_blocks`` blocks beside them, so the
loader has a Wan model to fingerprint.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sdtpu_torch.models import t5 as t5_mod
from sdtpu_torch.models import wan as wan_mod
from sdtpu_torch.models import wan_vae as wan_vae_mod
from sdtpu_torch.tools.flux_files import (_Draw, _gguf_from_specs, expected_bytes, gguf_t5_name,
                                          synthetic_t5_vocab, write_safetensors)
from sdtpu_torch.weights import MIN_QUANT_ELEMS

DTYPE = torch.float16
SEED = 0
FILE_NAMES = {"diffusion_model": "wan2.1_t2v_1.3B_fp16.safetensors", "vae": "wan_2.1_vae.safetensors",
              "t5xxl": "umt5-xxl-enc-q8_0.gguf"}


def file_specs() -> dict:
    """file → {name: (shape, init)} of the set at full width."""
    return {"diffusion_model": wan_mod.param_specs(wan_mod.WAN21_T2V_1_3B_CONFIG),
            "vae": wan_vae_mod.param_specs(wan_vae_mod.WAN21_VAE_CONFIG),
            "t5xxl": t5_mod.param_specs(t5_mod.UMT5_XXL_CONFIG)}


def write_wan_files(out_dir, device="cuda", min_quant_elems: int = MIN_QUANT_ELEMS) -> dict:
    """Write the set into ``out_dir`` → {"paths": {CLI flag: path}, "bytes",
    "write_s", "tensors"}; UMT5's 2-D weights of at least ``min_quant_elems``
    go q8_0.  Raises before writing where the disk has too little free
    space."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = file_specs()
    size = torch.tensor([], dtype=DTYPE).element_size()
    need = (expected_bytes({"t5xxl": specs["t5xxl"]}, min_quant_elems) + (1 << 28)
            + sum(int(np.prod(s)) * size for k, sp in specs.items() if k != "t5xxl"
                  for s, _ in sp.values()))
    free = shutil.disk_usage(out_dir).free
    if free < need:
        raise RuntimeError(f"{out_dir}: {free / 2**30:.1f} GiB free, the Wan files need "
                           f"{need / 2**30:.1f} GiB")
    out = {"paths": {}, "bytes": {}, "write_s": {}, "tensors": {}}
    for i, (key, sp) in enumerate(specs.items()):
        path = out_dir / FILE_NAMES[key]
        draw = _Draw(SEED + i, device)
        t0 = time.time()
        if key == "t5xxl":
            vocab = synthetic_t5_vocab(t5_mod.UMT5_XXL_CONFIG.vocab_size)
            n = _gguf_from_specs(path, sp, draw, min_quant_elems, metadata=vocab,
                                 rename=gguf_t5_name)
        else:
            n = write_safetensors(path, sp, draw, DTYPE)
        out["write_s"][key] = time.time() - t0
        out["paths"][key] = str(path)
        out["bytes"][key] = n
        out["tensors"][key] = len(sp)
    return out


def write_vae_files(out_dir, device="cuda", cfg=None, dit_cfg=None, dit_blocks: int = 2,
                    stem: str = "wan_2.1_vae") -> dict:
    """The Wan VAE (``cfg``, by default ``WAN21_VAE_CONFIG``, encoder
    included) under its original and its diffusers names, and the DiT
    (``dit_cfg``, by default Wan2.1-T2V-1.3B's) cut to ``dit_blocks``
    blocks as ``paths["dit"]``."""
    import dataclasses

    from sdtpu_torch.io.name_conversion import convert_diffusers_wan_vae_name
    from sdtpu_torch.tools.diffusers_names import wan_vae_name, write_pair

    specs = wan_vae_mod.param_specs(cfg or wan_vae_mod.WAN21_VAE_CONFIG, decode_only=False)
    out = write_pair(out_dir, stem, specs, wan_vae_name, convert_diffusers_wan_vae_name, device,
                     dtype=DTYPE, seed=SEED)
    dit = dataclasses.replace(dit_cfg or wan_mod.WAN21_T2V_1_3B_CONFIG, num_layers=dit_blocks)
    path = Path(out_dir) / "wan_dit_cut.safetensors"
    out["bytes"]["dit"] = write_safetensors(path, wan_mod.param_specs(dit), _Draw(SEED, device), DTYPE)
    out["paths"]["dit"] = str(path)
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print(json.dumps(write_wan_files(sys.argv[1]), indent=1))
