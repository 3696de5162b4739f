"""Model-version taxonomy and per-request parameters (this package's copy of
``sdtpu/config.py``: ``SDVersion``, ``GenerationParams`` and the version
predicates ``sd_version_is_sd2`` / ``_sdxl`` / ``_inpaint`` / ``_unet_edit``,
with the same names, values, fields and defaults).

The port compares only its own ``SDVersion``: an enum member of the JAX
package's class never equals one of this class.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class SDVersion(enum.Enum):
    SD1 = "sd1"
    SD1_INPAINT = "sd1_inpaint"
    SD1_PIX2PIX = "sd1_pix2pix"
    SD1_TINY_UNET = "sd1_tiny_unet"
    SD2 = "sd2"
    SD2_INPAINT = "sd2_inpaint"
    SD2_TINY_UNET = "sd2_tiny_unet"
    SDXS_512_DS = "sdxs_512_ds"
    SDXS_09 = "sdxs_09"
    SDXL = "sdxl"
    SDXL_INPAINT = "sdxl_inpaint"
    SDXL_PIX2PIX = "sdxl_pix2pix"
    SDXL_SSD1B = "sdxl_ssd1b"
    SDXL_VEGA = "sdxl_vega"
    SVD = "svd"
    SD3 = "sd3"
    FLUX = "flux"
    FLUX_FILL = "flux_fill"
    FLUX_CONTROLS = "flux_controls"
    FLEX_2 = "flex_2"
    FLUX2 = "flux2"
    FLUX2_KLEIN = "flux2_klein"
    CHROMA = "chroma"
    CHROMA_RADIANCE = "chroma_radiance"
    WAN2 = "wan2"
    WAN2_2_I2V = "wan2_2_i2v"
    WAN2_2_TI2V = "wan2_2_ti2v"
    QWEN_IMAGE = "qwen_image"
    QWEN_IMAGE_LAYERED = "qwen_layered"
    HUNYUAN_VIDEO = "hunyuan_video"
    LTXAV = "ltxav"
    Z_IMAGE = "z_image"
    ANIMA = "anima"
    HIDREAM_O1 = "hidream_o1"
    PID = "pid"
    IDEOGRAM4 = "ideogram4"
    KREA2 = "krea2"
    LENS = "lens"
    BOOGU_IMAGE = "boogu_image"
    ERNIE_IMAGE = "ernie_image"
    MINIT2I = "minit2i"
    MAGE_FLOW = "mage_flow"
    LINGBOT_VIDEO = "lingbot_video"
    OVIS = "ovis"
    LONGCAT = "longcat"
    SEFI = "sefi"
    UNKNOWN = "unknown"


_SD2_FAMILY = {SDVersion.SD2, SDVersion.SD2_INPAINT, SDVersion.SD2_TINY_UNET, SDVersion.SDXS_09}
_SDXL_FAMILY = {SDVersion.SDXL, SDVersion.SDXL_INPAINT, SDVersion.SDXL_PIX2PIX,
                SDVersion.SDXL_SSD1B, SDVersion.SDXL_VEGA}


def sd_version_is_sd2(v: SDVersion) -> bool:
    return v in _SD2_FAMILY


def sd_version_is_sdxl(v: SDVersion) -> bool:
    return v in _SDXL_FAMILY


def sd_version_is_inpaint(v: SDVersion) -> bool:
    return v in {SDVersion.SD1_INPAINT, SDVersion.SD2_INPAINT, SDVersion.SDXL_INPAINT,
                 SDVersion.FLUX_FILL, SDVersion.FLEX_2}


def sd_version_is_unet_edit(v: SDVersion) -> bool:
    """instruct-pix2pix-style UNets: the edit image's latent concatenated to
    the model input."""
    return v in {SDVersion.SD1_PIX2PIX, SDVersion.SDXL_PIX2PIX}


@dataclasses.dataclass
class GenerationParams:
    """Per-request options (reference sd_img_gen_params_t)."""

    prompt: str = ""
    negative_prompt: str = ""
    clip_skip: int = -1
    width: int = 512
    height: int = 512
    sample_method: str = "euler_a"
    schedule: str = "discrete"
    sample_steps: int = 20
    cfg_scale: float = 7.0
    img_cfg_scale: Optional[float] = None
    guidance: float = 3.5  # distilled guidance (flux)
    eta: float = 0.0
    shifted_timestep: int = 0
    seed: int = 42
    batch_count: int = 1
    strength: float = 0.75  # img2img
    # SLG
    slg_scale: float = 0.0
    skip_layers: Tuple[int, ...] = (7, 8, 9)
    slg_start: float = 0.01
    slg_end: float = 0.2
    # APG
    apg_eta: float = 1.0
    apg_momentum: float = 0.0
    apg_norm_threshold: float = 0.0
    apg_norm_smoothing: float = 0.0
    # key=value,... escape hatch (reference extra_sample_args,
    # stable-diffusion.cpp:2429-2504): guidance_schedule=7.5x10+5x10,
    # gamma=, alpha=, delta_t=, noise_scale_start/end=, noise_clip_std=
    extra_sample_args: str = ""
    # comma-separated custom sigma schedule (reference --sigmas); overrides
    # schedule + sample_steps when set
    custom_sigmas: str = ""
    # key=value,... reference-image routing overrides (reference
    # ref_image_args, stable-diffusion.cpp:3030-3128): pass_to_vlm=,
    # pass_to_dit=, vlm_max_pixels=, vlm_min_pixels= (family presets are the
    # per-pipeline defaults)
    ref_image_args: str = ""
