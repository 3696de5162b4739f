"""A synthetic SD2.1 single-file checkpoint on disk, at full width, from
seeded values (the file a user passes to ``python -m sdtpu_torch.cli -m``,
with ``--prediction v`` for the 768-v model).

    python -m sdtpu_torch.tools.sd2_file OUT.safetensors [IN_CHANNELS]

One safetensors file in float16 (about 2.6 GB), under the original LDM
names, written as ``tools/sd15_file.py`` writes its file (tensor by tensor,
drawn on the device from fixed seeds):
  model.diffusion_model.*   the SD2.x UNet (``SD2_UNET_CONFIG``; with
                            ``in_channels`` 9 SD2-inpainting's stem);
  cond_stage_model.model.*  OpenCLIP-H's text tower under its own names, as
                            SD2.x files ship it: 24 ``transformer.resblocks``
                            with the fused ``attn.in_proj_*``,
                            ``positional_embedding``, ``ln_final`` and the
                            square ``text_projection`` (the loaders keep all
                            24 layers; the 23-layer config reads 23);
  first_stage_model.*       the SD VAE (``SD_VAE_CONFIG``), encoder included.
Both packages' loaders fingerprint it as SD2 (a 1024-wide cross-attention
context, a middle block), or SD2_INPAINT with 9 input channels.
"""
from __future__ import annotations

import dataclasses
import json
import sys

from sdtpu_torch.models import clip as clip_mod
from sdtpu_torch.models import unet as unet_mod
from sdtpu_torch.models import vae as vae_mod
from sdtpu_torch.tools.sd15_file import write_single_file
from sdtpu_torch.tools.sdxl_file import open_clip_specs

PREFIXES = {"diffusion": "model.diffusion_model.", "clip_h": "cond_stage_model.model.",
            "vae": "first_stage_model."}
# the text tower as the checkpoint holds it: 24 layers, a square projection
OPEN_CLIP_H = dataclasses.replace(clip_mod.CLIP_H_CONFIG, num_layers=24, projection_dim=1024)


def file_specs(in_channels: int = 4) -> dict:
    """name → (shape, init) of every tensor of the file, LDM-prefixed."""
    unet_cfg = dataclasses.replace(unet_mod.SD2_UNET_CONFIG, in_channels=in_channels)
    mods = {"diffusion": unet_mod.param_specs(unet_cfg), "clip_h": open_clip_specs(OPEN_CLIP_H),
            "vae": vae_mod.vae_specs(vae_mod.SD_VAE_CONFIG)}
    return {PREFIXES[m] + n: v for m, specs in mods.items() for n, v in specs.items()}


def write_sd2_file(path, device="cuda", in_channels: int = 4) -> dict:
    """Write the file → {"path", "bytes", "write_s", "tensors"}.  Raises
    before writing where the disk has too little free space."""
    return write_single_file(path, file_specs(in_channels), device, "SD2.1 file")


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    print(json.dumps(write_sd2_file(sys.argv[1], in_channels=int((sys.argv[2:] or [4])[0])),
                     indent=1))
