"""A synthetic SD3.5-Medium file set on disk, at full width, from seeded values
(the files a user passes to ``python -m sdtpu_torch.cli -m ... --clip_l ...
--clip_g ... --t5xxl ...``).

    python -m sdtpu_torch.tools.sd3_file OUT_DIR

Four files, in the published SD3.5-Medium layout, written tensor by tensor
(no whole float source is ever held; values are drawn on the device from
fixed seeds: std 0.02 weights, ``pos_embed`` std 0.01, unit norm gains,
zero biases):
  sd3.5_medium.safetensors (about 5.1 GB, float16):
    model.diffusion_model.*   the MMDiT-X (``SD35_MEDIUM_CONFIG``: 24 joint
                              blocks, qk RMS norms, ``x_block.attn2`` in the
                              first 13, a 384² pos-embed grid);
    first_stage_model.*       the SD3 VAE, encoder included, no quant_conv;
  clip_l.safetensors, clip_g.safetensors (float16): the text towers with
    their projections under HF ``CLIPTextModelWithProjection`` names
    (``text_model.*``, ``text_projection.weight`` [proj, width]);
  t5xxl-q8_0.gguf: T5-XXL as ``tools/flux_files.py`` writes it (q8_0 blocks
    under llama.cpp names, its synthetic 32128-piece vocab embedded).
Both packages' loaders fingerprint the first as SD3 (``joint_blocks``) and
the MMDiT config as SD3.5-Medium's.

``write_mmdit_files(out_dir, depth)`` writes the MMDiT alone (a
``--diffusion-model`` file), cut to ``depth`` joint blocks, under its
original names and under ``SD3Transformer2DModel``'s (q, k and v apart),
drawn from one seed.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sdtpu_torch.models import clip as clip_mod
from sdtpu_torch.models import mmdit as mmdit_mod
from sdtpu_torch.models import t5 as t5_mod
from sdtpu_torch.models import vae as vae_mod
from sdtpu_torch.tools.flux_files import (_Draw, _gguf_from_specs, expected_bytes, gguf_t5_name,
                                          synthetic_t5_vocab, write_safetensors)
from sdtpu_torch.weights import MIN_QUANT_ELEMS

DTYPE = torch.float16  # as SD3.5 files ship
SEED = 0
FILE_NAMES = {"model": "sd3.5_medium.safetensors", "clip_l": "clip_l.safetensors",
              "clip_g": "clip_g.safetensors", "t5xxl": "t5xxl-q8_0.gguf"}


def file_specs() -> dict:
    """file → {name: (shape, init)} of the set at full width."""
    vae_cfg = vae_mod.SD3_VAE_CONFIG
    vae = {k: v for k, v in vae_mod.param_specs(vae_cfg).items()
           if not k.startswith("post_quant_conv.")}
    model = {"model.diffusion_model." + k: v
             for k, v in mmdit_mod.param_specs(mmdit_mod.SD35_MEDIUM_CONFIG).items()}
    model.update({"first_stage_model." + k: v
                  for k, v in {**vae_mod.vae_encoder_specs(vae_cfg), **vae}.items()})
    return {"model": model,
            "clip_l": clip_mod.param_specs(dataclasses.replace(clip_mod.CLIP_L_CONFIG,
                                                               projection_dim=768)),
            "clip_g": clip_mod.param_specs(clip_mod.CLIP_G_CONFIG),
            "t5xxl": t5_mod.param_specs(t5_mod.T5_XXL_CONFIG)}


def write_sd3_files(out_dir, device="cuda", min_quant_elems: int = MIN_QUANT_ELEMS) -> dict:
    """Write the set into ``out_dir`` → {"paths": {key: path}, "bytes",
    "write_s", "tensors"}; T5's 2-D weights of at least ``min_quant_elems``
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
        raise RuntimeError(f"{out_dir}: {free / 2**30:.1f} GiB free, the SD3.5 files need "
                           f"{need / 2**30:.1f} GiB")
    out = {"paths": {}, "bytes": {}, "write_s": {}, "tensors": {}}
    for i, (key, sp) in enumerate(specs.items()):
        path = out_dir / FILE_NAMES[key]
        draw = _Draw(SEED + i, device)
        t0 = time.time()
        if key == "t5xxl":
            vocab = synthetic_t5_vocab(t5_mod.T5_XXL_CONFIG.vocab_size)
            n = _gguf_from_specs(path, sp, draw, min_quant_elems, metadata=vocab,
                                 rename=gguf_t5_name)
        else:
            n = write_safetensors(path, sp, draw, DTYPE)
        out["write_s"][key] = time.time() - t0
        out["paths"][key] = str(path)
        out["bytes"][key] = n
        out["tensors"][key] = len(sp)
    return out


def write_mmdit_files(out_dir, device="cuda", depth: int = 2, cfg=None,
                      stem: str = "sd3.5_medium_mmdit") -> dict:
    """The MMDiT (``cfg``, by default SD3.5-Medium's, cut to ``depth`` joint
    blocks) under its original and its diffusers names."""
    from sdtpu_torch.io.name_conversion import convert_diffusers_sd3_name
    from sdtpu_torch.tools.diffusers_names import sd3_name, write_pair

    cfg = dataclasses.replace(cfg or mmdit_mod.SD35_MEDIUM_CONFIG, depth=depth)
    return write_pair(out_dir, stem, mmdit_mod.param_specs(cfg), sd3_name,
                      convert_diffusers_sd3_name, device, dtype=DTYPE, seed=SEED)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print(json.dumps(write_sd3_files(sys.argv[1]), indent=1))
