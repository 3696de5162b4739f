"""TAESD tiny autoencoder, decoder half (counterpart of ``sdtpu/models/tae.py``:
``TAEConfig``, the TAESD configs, ``tae_decode``, ``convert_taesd_name``,
``tae_config_for`` and the decoder names of ``init_tae_params``).

Params are keyed ``decoder.layers.N.(conv.{0,2,4}|skip).{weight,bias}``:
index 1 is a parameter-free ReLU and each upsampling stage's first index a
parameter-free nearest 2x upsample, so those indices hold no tensor.  Raw
``taesd.pth`` / ``taesdxl`` files put a Clamp at decoder index 0; their
names shift down by one (``convert_taesd_name``).  The variants differ only
in latent scaling.  Activations are NHWC; every layer is a convolution,
ReLU or tanh (cuDNN on the card).  The encoder (img2img) is not ported.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from sdtpu_torch.ops import conv2d


@dataclasses.dataclass(frozen=True)
class TAEConfig:
    z_channels: int = 4
    channels: int = 64
    out_channels: int = 3
    num_blocks: int = 3
    # TAESD consumes unscaled latents: decode divides by the VAE's scale
    vae_scale_factor: float = 0.18215


TAESD_CONFIG = TAEConfig()
TAESD_XL_CONFIG = TAEConfig(vae_scale_factor=0.13025)
TAESD_SD3_CONFIG = TAEConfig(z_channels=16, vae_scale_factor=1.5305)
TAESD_FLUX_CONFIG = TAEConfig(z_channels=16, vae_scale_factor=0.3611)


def _block(p, pre: str, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(conv2d(x, p[f"{pre}.conv.0.weight"], p[f"{pre}.conv.0.bias"]))
    h = torch.relu(conv2d(h, p[f"{pre}.conv.2.weight"], p[f"{pre}.conv.2.bias"]))
    h = conv2d(h, p[f"{pre}.conv.4.weight"], p[f"{pre}.conv.4.bias"])
    if f"{pre}.skip.weight" in p:
        x = conv2d(x, p[f"{pre}.skip.weight"], None, padding=0)
    return torch.relu(h + x)


def _decoder_layout(cfg: TAEConfig):
    """[(index, kind)] of the decoder's parametered layers: "conv_in",
    "block", "up_conv" (bias-free, after a 2x upsample), "conv_out"."""
    nb = cfg.num_blocks
    out = [(0, "conv_in")]
    i = 2  # index 1: ReLU
    for _ in range(nb):
        out.append((i, "block"))
        i += 1
    for stage in range(3):
        i += 1  # the upsample
        out.append((i, "up_conv"))
        i += 1
        for _ in range(1 if stage == 2 else nb):
            out.append((i, "block"))
            i += 1
    out.append((i, "conv_out"))
    return out


def tae_decode(p, z: torch.Tensor, cfg: TAEConfig = TAESD_CONFIG) -> torch.Tensor:
    """z: scaled diffusion latent [B,h,w,zc] → image [B,8h,8w,3] in [-1,1]
    (TAESD's [0,1] mapped for the pipeline)."""
    h = z / cfg.vae_scale_factor
    h = 3.0 * torch.tanh(h / 3.0)  # the Clamp stage
    for i, kind in _decoder_layout(cfg):
        pre = f"decoder.layers.{i}"
        if kind == "block":
            h = _block(p, pre, h)
            continue
        if kind == "up_conv":
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        h = conv2d(h, p[f"{pre}.weight"], p.get(f"{pre}.bias"))
        if kind == "conv_in":
            h = torch.relu(h)  # index 1
    return h * 2.0 - 1.0


# ``init_tae_params``' weight std: without a normalization layer, TAESD's
# signal fades through weights of the other modules' 0.02
WEIGHT_STD = 0.05


def param_specs(cfg: TAEConfig = TAESD_CONFIG) -> dict:
    """name → (shape, init) of the decoder half of ``init_tae_params``
    (weights drawn at ``WEIGHT_STD``, zero biases)."""
    ch = cfg.channels
    specs = {}

    def conv(name, out_c, in_c, k=3, bias=True):
        specs[f"{name}.weight"] = ((out_c, in_c, k, k), WEIGHT_STD)
        if bias:
            specs[f"{name}.bias"] = ((out_c,), "zeros")

    for i, kind in _decoder_layout(cfg):
        pre = f"decoder.layers.{i}"
        if kind == "block":
            for j in (0, 2, 4):
                conv(f"{pre}.conv.{j}", ch, ch)
        elif kind == "conv_in":
            conv(pre, ch, cfg.z_channels)
        elif kind == "up_conv":
            conv(pre, ch, ch, bias=False)
        else:
            conv(pre, cfg.out_channels, ch)
    return specs


def convert_taesd_name(name: str) -> Optional[str]:
    """Raw taesd.pth names (a leading Clamp in the decoder Sequential) →
    ``{encoder,decoder}.layers.N`` names; names already in that form pass,
    anything else → None."""
    m = re.match(r"(encoder|decoder)\.(\d+)\.(.*)", name)
    if not m:
        if name.startswith(("encoder.layers.", "decoder.layers.")):
            return name
        return None
    which, idx, rest = m.group(1), int(m.group(2)), m.group(3)
    if which == "decoder":
        idx -= 1  # drop the Clamp stage
    return f"{which}.layers.{idx}.{rest}"


def tae_config_for(version_name: str, z_channels: int) -> TAEConfig:
    """The TAE variant for a pipeline version (taesd / taesdxl / taesd3 /
    taef1 differ only in latent scaling)."""
    v = version_name.lower()
    if z_channels == 4:
        return TAESD_XL_CONFIG if "sdxl" in v else TAESD_CONFIG
    if z_channels == 16:
        return TAESD_SD3_CONFIG if "sd3" in v else TAESD_FLUX_CONFIG
    return TAEConfig(z_channels=z_channels)
