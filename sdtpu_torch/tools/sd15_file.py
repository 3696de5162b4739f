"""A synthetic SD1.5 single-file checkpoint on disk, at full width, from
seeded values (the file a user passes to ``python -m sdtpu_torch.cli -m``).

    python -m sdtpu_torch.tools.sd15_file OUT.safetensors [IN_CHANNELS]

One safetensors file in float16 (about 2.1 GB), under the original LDM
names, written tensor by tensor (no whole float source is ever held; values
are drawn on the device from fixed seeds, std 0.02 weights, unit norm gains,
zero biases):
  model.diffusion_model.*          the SD1.x UNet (``SD1_UNET_CONFIG``; with
                                   ``in_channels`` 9 the inpainting stem of
                                   SD1.5-inpainting, with 8 instruct-pix2pix's);
  cond_stage_model.transformer.*   CLIP-L's text tower (``CLIP_L_CONFIG``);
  first_stage_model.*              the SD VAE (``SD_VAE_CONFIG``), encoder,
                                   ``quant_conv`` and ``post_quant_conv``
                                   included.
Both packages' loaders fingerprint it as SD1 (a 4-channel UNet stem, a
768-wide cross-attention context, a middle block, no label embedding), as
SD1_INPAINT with 9 input channels and as SD1_PIX2PIX with 8.

``write_unet_files(out_dir)`` writes the UNet alone twice (a
``--diffusion-model`` file): under its CompVis names and under a diffusers
folder's ``UNet2DConditionModel`` names, both drawn from ``SEED`` first, so
they hold the single file's UNet, value for value.
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
from sdtpu_torch.models import unet as unet_mod
from sdtpu_torch.models import vae as vae_mod
from sdtpu_torch.io.name_conversion import convert_diffusers_unet_name
from sdtpu_torch.tools.diffusers_names import unet_name, write_pair
from sdtpu_torch.tools.flux_files import _Draw, write_safetensors

PREFIXES = {"diffusion": "model.diffusion_model.", "clip_l": "cond_stage_model.transformer.",
            "vae": "first_stage_model."}
DTYPE = torch.float16  # as SD1.5 files ship
SEED = 0


def file_specs(in_channels: int = 4) -> dict:
    """name → (shape, init) of every tensor of the file, LDM-prefixed."""
    vae_cfg = vae_mod.SD_VAE_CONFIG
    vae = vae_mod.vae_specs(vae_cfg)
    unet_cfg = dataclasses.replace(unet_mod.SD1_UNET_CONFIG, in_channels=in_channels)
    mods = {"diffusion": unet_mod.param_specs(unet_cfg),
            "clip_l": clip_mod.param_specs(clip_mod.CLIP_L_CONFIG), "vae": vae}
    return {PREFIXES[m] + n: v for m, specs in mods.items() for n, v in specs.items()}


def write_single_file(path, specs: dict, device, what: str) -> dict:
    """Write ``specs`` as one float16 safetensors file drawn from ``SEED`` →
    {"path", "bytes", "write_s", "tensors"}.  Raises before writing where
    the disk has too little free space for ``what``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    size = torch.tensor([], dtype=DTYPE).element_size()
    need = sum(int(np.prod(s)) for s, _ in specs.values()) * size + (1 << 28)
    free = shutil.disk_usage(path.parent).free
    if free < need:
        raise RuntimeError(f"{path.parent}: {free / 2**30:.1f} GiB free, the {what} needs "
                           f"{need / 2**30:.1f} GiB")
    t0 = time.time()
    n = write_safetensors(path, specs, _Draw(SEED, device), DTYPE)
    return {"path": str(path), "bytes": n, "write_s": time.time() - t0, "tensors": len(specs)}


def write_sd15_file(path, device="cuda", in_channels: int = 4) -> dict:
    """Write the file (the UNet's stem taking ``in_channels``) → {"path",
    "bytes", "write_s", "tensors"}.  Raises before writing where the disk
    has too little free space."""
    return write_single_file(path, file_specs(in_channels), device, "SD1.5 file")


def write_unet_files(out_dir, device="cuda", cfg=None, stem: str = "sd15_unet") -> dict:
    """The SD1.x UNet (``cfg``, by default ``SD1_UNET_CONFIG``) under CompVis
    and under diffusers names (``diffusers_names.write_pair``) → its
    paths, bytes and tensor counts."""
    specs = unet_mod.param_specs(cfg or unet_mod.SD1_UNET_CONFIG)
    return write_pair(out_dir, stem, specs, unet_name, convert_diffusers_unet_name, device,
                      dtype=DTYPE, seed=SEED)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    print(json.dumps(write_sd15_file(sys.argv[1], in_channels=int((sys.argv[2:] or [4])[0])),
                     indent=1))
