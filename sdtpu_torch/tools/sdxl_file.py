"""A synthetic SDXL single-file checkpoint and a TAESD-XL decoder file on disk,
at full width, from seeded values (the files a user passes to ``python -m
sdtpu_torch.cli -m ... --taesd ...``).

    python -m sdtpu_torch.tools.sdxl_file OUT_DIR

Two safetensors files in float16, written tensor by tensor (no whole float
source is ever held; values are drawn on the device from fixed seeds, std
0.02 weights (TAESD's 0.05), unit norm gains, zero biases):
  sdxl.safetensors (about 6.9 GB), under the SGM names:
    model.diffusion_model.*              the SDXL UNet (``SDXL_UNET_CONFIG``);
    conditioner.embedders.0.transformer.*  CLIP-L's text tower (HF names);
    conditioner.embedders.1.model.*      OpenCLIP-G's text tower under its
                                         own names: ``transformer.resblocks.N``
                                         with the fused ``attn.in_proj_*``,
                                         ``positional_embedding``, ``ln_final``,
                                         ``text_projection`` as [width, proj];
    first_stage_model.*                  the SDXL VAE, encoder included;
  taesdxl.safetensors: the TAESD-XL decoder under the raw ``taesd`` names
    (``decoder.N.…``, the Clamp at index 0, so each index one above the
    port's own).
Both packages' loaders fingerprint the first as SDXL (a label embedding, a
second text encoder, a 10-deep middle block).

``write_unet_files(out_dir)`` writes the SDXL UNet alone under CompVis
and under diffusers names, drawn from one seed (the same values).
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sdtpu_torch.models import clip as clip_mod
from sdtpu_torch.models import tae as tae_mod
from sdtpu_torch.models import unet as unet_mod
from sdtpu_torch.models import vae as vae_mod
from sdtpu_torch.tools.flux_files import _Draw, write_safetensors

PREFIXES = {"diffusion": "model.diffusion_model.", "clip_l": "conditioner.embedders.0.transformer.",
            "clip_g": "conditioner.embedders.1.model.", "vae": "first_stage_model."}
DTYPE = torch.float16  # as SDXL files ship
SEED = 0
TAE_SEED = 1
FILE_NAMES = {"model": "sdxl.safetensors", "taesd": "taesdxl.safetensors"}


def open_clip_specs(cfg: clip_mod.CLIPTextConfig) -> dict:
    """name → (shape, init) of an OpenCLIP text tower (``convert_open_clip_name``'s
    source names; q, k and v fused in ``in_proj``)."""
    c, ff = cfg.hidden_size, cfg.intermediate_size
    specs = {"token_embedding.weight": ((cfg.vocab_size, c), "normal"),
             "positional_embedding": ((cfg.max_position_embeddings, c), "normal"),
             "ln_final.weight": ((c,), "ones"), "ln_final.bias": ((c,), "zeros"),
             "text_projection": ((c, cfg.projection_dim), "normal")}
    for i in range(cfg.num_layers):
        pre = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            specs[f"{pre}.{ln}.weight"] = ((c,), "ones")
            specs[f"{pre}.{ln}.bias"] = ((c,), "zeros")
        specs[f"{pre}.attn.in_proj_weight"] = ((3 * c, c), "normal")
        specs[f"{pre}.attn.in_proj_bias"] = ((3 * c,), "zeros")
        specs[f"{pre}.attn.out_proj.weight"] = ((c, c), "normal")
        specs[f"{pre}.attn.out_proj.bias"] = ((c,), "zeros")
        specs[f"{pre}.mlp.c_fc.weight"] = ((ff, c), "normal")
        specs[f"{pre}.mlp.c_fc.bias"] = ((ff,), "zeros")
        specs[f"{pre}.mlp.c_proj.weight"] = ((c, ff), "normal")
        specs[f"{pre}.mlp.c_proj.bias"] = ((c,), "zeros")
    return specs


def file_specs() -> dict:
    """name → (shape, init) of every tensor of the checkpoint, SGM-prefixed."""
    vae_cfg = vae_mod.SDXL_VAE_CONFIG
    vae = vae_mod.vae_specs(vae_cfg)
    mods = {"diffusion": unet_mod.param_specs(unet_mod.SDXL_UNET_CONFIG),
            "clip_l": clip_mod.param_specs(clip_mod.CLIP_L_CONFIG),
            "clip_g": open_clip_specs(clip_mod.CLIP_G_CONFIG), "vae": vae}
    return {PREFIXES[m] + n: v for m, specs in mods.items() for n, v in specs.items()}


def tae_file_specs() -> dict:
    """name → (shape, init) of the TAESD-XL decoder under the raw names."""
    out = {}
    for name, spec in tae_mod.param_specs(tae_mod.TAESD_XL_CONFIG).items():
        _, _, idx, rest = name.split(".", 3)  # decoder.layers.N.rest
        out[f"decoder.{int(idx) + 1}.{rest}"] = spec
    return out


def write_sdxl_files(out_dir, device="cuda") -> dict:
    """Write both files into ``out_dir`` → {"paths", "bytes", "write_s",
    "tensors"}.  Raises before writing where the disk has too little free
    space."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = {"model": (file_specs(), SEED), "taesd": (tae_file_specs(), TAE_SEED)}
    size = torch.tensor([], dtype=DTYPE).element_size()
    elems = sum(int(np.prod(s)) for sp, _ in files.values() for s, _ in sp.values())
    need = elems * size + (1 << 28)
    free = shutil.disk_usage(out_dir).free
    if free < need:
        raise RuntimeError(f"{out_dir}: {free / 2**30:.1f} GiB free, the SDXL files need "
                           f"{need / 2**30:.1f} GiB")
    t0 = time.time()
    paths, nbytes = {}, {}
    for key, (sp, seed) in files.items():
        paths[key] = str(out_dir / FILE_NAMES[key])
        nbytes[key] = write_safetensors(Path(paths[key]), sp, _Draw(seed, device), DTYPE)
    return {"paths": paths, "bytes": nbytes, "write_s": time.time() - t0,
            "tensors": {k: len(sp) for k, (sp, _) in files.items()}}


def write_unet_files(out_dir, device="cuda", cfg=None, stem: str = "sdxl_unet") -> dict:
    """The SDXL UNet (``cfg``, by default ``SDXL_UNET_CONFIG``) under CompVis
    and under diffusers names (``diffusers_names.write_pair``)."""
    from sdtpu_torch.io.name_conversion import convert_diffusers_unet_name
    from sdtpu_torch.tools.diffusers_names import unet_name, write_pair

    specs = unet_mod.param_specs(cfg or unet_mod.SDXL_UNET_CONFIG)
    return write_pair(out_dir, stem, specs, unet_name, convert_diffusers_unet_name, device,
                      dtype=DTYPE, seed=SEED)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print(json.dumps(write_sdxl_files(sys.argv[1]), indent=1))
