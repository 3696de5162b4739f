"""A synthetic ControlNet on disk, at full width, from seeded values (the file
a user passes to ``python -m sdtpu_torch.cli --control-net``).

    python -m sdtpu_torch.tools.controlnet_file OUT_DIR [sd15|sdxl]

Two float16 safetensors files holding the same values, drawn tensor by
tensor on the device from one seed (std 0.02 weights, unit norm gains, zero
biases; the zero convs and ``middle_block_out`` drawn like any weight, as a
trained ControlNet's are no longer zero):
  control_<family>.safetensors            under the CompVis names
                                          (``control_model.input_blocks.…``,
                                          ``zero_convs.N.0``,
                                          ``input_hint_block.{0,2,…,14}``);
  control_<family>_diffusers.safetensors  under ``ControlNetModel``'s
                                          (``down_blocks.…``,
                                          ``controlnet_down_blocks.N``,
                                          ``controlnet_cond_embedding.…``).
The ControlNet copies the UNet of the family: SD1.5's (``SD1_UNET_CONFIG``,
about 361 M values) or SDXL's with its label embedding.  ``load_controlnet``
reads both files to the same dict.
"""
from __future__ import annotations

import json
import sys

import torch

from sdtpu_torch.io.name_conversion import convert_diffusers_controlnet_name
from sdtpu_torch.models import controlnet as controlnet_mod
from sdtpu_torch.models import unet as unet_mod
from sdtpu_torch.tools.diffusers_names import controlnet_name, write_pair

DTYPE = torch.float16
SEED = 7
CONFIGS = {"sd15": unet_mod.SD1_UNET_CONFIG, "sdxl": unet_mod.SDXL_UNET_CONFIG}


def file_specs(cfg=unet_mod.SD1_UNET_CONFIG) -> dict:
    """name → (shape, init) of a ControlNet for the UNet at ``cfg``, its
    taps drawn ('normal') instead of zero."""
    taps = ("zero_convs.", "middle_block_out.")
    return {n: (s, "normal" if n.startswith(taps) and n.endswith(".weight") else init)
            for n, (s, init) in controlnet_mod.controlnet_specs(cfg).items()}


def write_controlnet_files(out_dir, device="cuda", family: str = "sd15", cfg=None) -> dict:
    """Both files of ``family``'s ControlNet (``cfg`` overrides its UNet
    config) → {"paths": {"original", "diffusers"}, "bytes", "write_s",
    "tensors"}."""
    return write_pair(out_dir, f"control_{family}", file_specs(cfg or CONFIGS[family]), controlnet_name,
                      convert_diffusers_controlnet_name, device, prefix="control_model.", dtype=DTYPE,
                      seed=SEED)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    print(json.dumps(write_controlnet_files(sys.argv[1], family=(sys.argv[2:] or ["sd15"])[0]),
                     indent=1))
