"""Pipeline construction (counterpart of ``sdtpu/factory.py``:
``create_pipeline`` with ``v_prediction``, ``unet_config_for`` and its
UNet branch for SD1.x, SD2.x and SDXL with their inpainting and
instruct-pix2pix stems, the tiny UNets and SDXS, and its ``controlnet_fn``,
``_create_sd3_pipeline``, the WAN2 branch of
``_create_wan_pipeline``, ``_create_z_image_pipeline``,
``_create_flux_pipeline`` and ``_detect_t5_config``).

FLUX, the UNet families and SD3 are built from given params (this package's
tensors, e.g. bridged with ``sdtpu_torch.weights.from_jax_params``) or from
random weights drawn on the target device; each gets the VAE's encoder
(``vae_encode_fn``) beside its decoder, and a VAE it draws has both halves
in ``init_vae_params``'s layout (``vae_specs``).  Full-width random FLUX weights
come in the memory classes of the JAX FLUX bench: the DiT as per-row int8
``QuantTensor``s (q8_0), T5-XXL as packed 4-bit ``Q4Tensor``s (q4_0), CLIP-L
and the VAE dense.  A given DiT runs at the depth its params hold (a
checkpoint cut to fewer blocks).  SD1.x, SD2.x and SDXL are dense
throughout, as the JAX SD1.5 and SDXL benches (``bench_sd15``,
``bench_sdxl_lcm_taesd``) draw them; SD3 as ``bench_sd35_medium`` draws
it: the MMDiT, CLIP-L, CLIP-G and the VAE dense, T5-XXL 4-bit.  A given
MMDiT's config is fingerprinted from its names and shapes
(``detect_mmdit_config``: SD3-Medium, SD3.5-Medium's MMDiT-X, SD3.5-Large),
a given T5's from its shapes.  Wan2.1 T2V
(``_create_wan_pipeline``, ``_detect_wan_vae_config``) as
``bench_wan21_t2v`` draws it: the DiT and the VAE dense, UMT5-XXL 4-bit; a
given DiT's config comes from ``detect_wan_config``, a given VAE's from its
shapes.  Z-Image (``_create_z_image_pipeline``): the DiT and the FLUX VAE
dense, its Qwen3-4B text encoder 4-bit, the class users run it in; a given
DiT's config comes from ``detect_z_image_config``, a given LLM's from
``detect_llm_config(arch="qwen3")``.  Qwen-Image
(``_create_qwen_image_pipeline``): the joint-stream DiT dense in the
pipeline's dtype, its Qwen2.5-VL-7B text tower 4-bit, the Wan 2.1 VAE
(encoder and decoder) dense, run in image mode; given weights are
fingerprinted (``detect_qwen_image_config``, ``detect_llm_config``,
``detect_wan_vae_config``).  Every other version raises by name.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from sdtpu_torch.conditioning.conditioner import (FluxConditioner, QwenImageConditioner,
                                                  SD1Conditioner, SD3Conditioner, SDXLConditioner,
                                                  WanConditioner, ZImageConditioner)
from sdtpu_torch.config import (SDVersion, sd_version_is_inpaint, sd_version_is_sd2,
                                sd_version_is_sdxl, sd_version_is_unet_edit)
from sdtpu_torch.diffusion.denoiser import (CompVisDenoiser, CompVisVDenoiser, DiscreteFlowDenoiser,
                                            FluxFlowDenoiser)
from sdtpu_torch.io.model_loader import PORTED_VERSIONS, UNET_VERSIONS
from sdtpu_torch.models import clip as clip_mod
from sdtpu_torch.models import controlnet as controlnet_mod
from sdtpu_torch.models import flux as flux_mod
from sdtpu_torch.models import llm as llm_mod
from sdtpu_torch.models import mmdit as mmdit_mod
from sdtpu_torch.models import qwen_image as qi_mod
from sdtpu_torch.models import t5 as t5_mod
from sdtpu_torch.models import unet as unet_mod
from sdtpu_torch.models import vae as vae_mod
from sdtpu_torch.models import wan as wan_mod
from sdtpu_torch.models import wan_vae as wan_vae_mod
from sdtpu_torch.models import z_image as zi_mod
from sdtpu_torch.pipeline import DiffusionPipeline
from sdtpu_torch.tokenizers.clip import CLIPTokenizer
from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer
from sdtpu_torch.weights import synthesize

# synthesis memory class and seed offset per module at full width
FULL_QUANT = {"diffusion": "q8_0", "t5": "q4_0", "clip_l": None, "vae": None}
SEED_OFFSET = {"diffusion": 1, "t5": 2, "clip_l": 3, "vae": 4, "clip_g": 5, "llm": 6}


def flux_configs(small: bool):
    """→ (dit, clip_l, t5, vae) configs and the T5 sequence length; the small
    set is the JAX factory's small FLUX config."""
    if small:
        dit_cfg = flux_mod.FluxConfig(
            in_channels=16, hidden_size=64, num_heads=2, depth=2, depth_single=2,
            axes_dim=(8, 12, 12), context_in_dim=96, vec_in_dim=48, guidance_embed=True)
        clip_l_cfg = dataclasses.replace(clip_mod.CLIP_L_CONFIG, hidden_size=48,
                                         intermediate_size=96, num_layers=2, num_heads=4)
        t5_cfg = t5_mod.T5Config(vocab_size=256, d_model=96, d_kv=16, d_ff=128, num_layers=2,
                                 num_heads=4)
        vae_cfg = vae_mod.VAEConfig(base_channels=32, channel_mult=(1, 2, 2, 2), num_res_blocks=1,
                                    z_channels=4, scale_factor=0.3611, shift_factor=0.1159)
        return dit_cfg, clip_l_cfg, t5_cfg, vae_cfg, 32
    return (flux_mod.FLUX_DEV_CONFIG, clip_mod.CLIP_L_CONFIG, t5_mod.T5_XXL_CONFIG,
            vae_mod.FLUX_VAE_CONFIG, 256)


def unet_config_for(version: SDVersion, small: bool = False) -> unet_mod.UNetConfig:
    """The JAX factory's ``unet_config_for`` for the ported UNet versions:
    SD1.x, SD2.x and SDXL, their inpainting stems (9 input channels), the
    instruct-pix2pix ones (8), and the tiny distills (SD1 / SD2 tiny,
    SDXS-512-DS, SDXS-0.9 with its one 320-wide head).  The small config is the small SD1 UNet
    (SDXL's with a 96-wide context and a 48 + 6·256 vector) with the
    version's stem."""
    if small:
        cfg = unet_mod.UNetConfig(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
                                  attention_resolutions=(1, 2), transformer_depth=(1, 1),
                                  context_dim=64, num_heads=2)
        if sd_version_is_sdxl(version):
            cfg = dataclasses.replace(cfg, context_dim=96, adm_in_channels=48 + 1536)
        if sd_version_is_inpaint(version):
            cfg = dataclasses.replace(cfg, in_channels=9)
        if sd_version_is_unet_edit(version):
            cfg = dataclasses.replace(cfg, in_channels=8)
        return cfg
    if sd_version_is_sdxl(version):
        if sd_version_is_unet_edit(version):
            return dataclasses.replace(unet_mod.SDXL_UNET_CONFIG, in_channels=8)
        return (unet_mod.SDXL_INPAINT_UNET_CONFIG if sd_version_is_inpaint(version)
                else unet_mod.SDXL_UNET_CONFIG)
    if version == SDVersion.SD2_TINY_UNET:
        return unet_mod.SD2_TINY_UNET_CONFIG
    if version == SDVersion.SDXS_09:
        return unet_mod.SDXS_09_UNET_CONFIG
    if sd_version_is_sd2(version):
        return (unet_mod.SD2_INPAINT_UNET_CONFIG if sd_version_is_inpaint(version)
                else unet_mod.SD2_UNET_CONFIG)
    if version == SDVersion.SD1_TINY_UNET:
        return unet_mod.SD1_TINY_UNET_CONFIG
    if version == SDVersion.SDXS_512_DS:
        return unet_mod.SDXS_512_UNET_CONFIG
    if sd_version_is_unet_edit(version):
        return dataclasses.replace(unet_mod.SD1_UNET_CONFIG, in_channels=8)
    return (unet_mod.SD1_INPAINT_UNET_CONFIG if sd_version_is_inpaint(version)
            else unet_mod.SD1_UNET_CONFIG)


def sd1_configs(small: bool, version: SDVersion = SDVersion.SD1):
    """→ (unet, text encoder, vae) configs of an SD1.x or SD2.x version; the
    small set is the JAX factory's small SD1 config (``unet_config_for``,
    its CLIP-L 64 wide, which SD2 also takes, and its VAE).  At full width
    SD2 conditions on OpenCLIP-H."""
    unet_cfg = unet_config_for(version, small)
    if small:
        clip_cfg = dataclasses.replace(clip_mod.CLIP_L_CONFIG, hidden_size=64,
                                       intermediate_size=128, num_layers=2, num_heads=4)
        vae_cfg = vae_mod.VAEConfig(base_channels=32, channel_mult=(1, 2, 2, 2), num_res_blocks=1)
        return unet_cfg, clip_cfg, vae_cfg
    clip_cfg = clip_mod.CLIP_H_CONFIG if sd_version_is_sd2(version) else clip_mod.CLIP_L_CONFIG
    return unet_cfg, clip_cfg, vae_mod.SD_VAE_CONFIG


def sdxl_configs(small: bool, version: SDVersion = SDVersion.SDXL):
    """→ (unet, clip_l, clip_g, vae) configs of an SDXL version; the small
    set is the JAX factory's small SDXL config (``unet_config_for``: the
    small SD1 UNet with a 96-wide context and a 48 + 6·256 vector; CLIP-L
    and CLIP-G 48 wide, CLIP-G's projection 48)."""
    unet_cfg = unet_config_for(version, small)
    if small:
        _, clip_l_cfg, vae_cfg = sd1_configs(small=True)
        clip_l_cfg = dataclasses.replace(clip_l_cfg, hidden_size=48, intermediate_size=96)
        clip_g_cfg = dataclasses.replace(clip_mod.CLIP_G_CONFIG, hidden_size=48,
                                         intermediate_size=96, num_layers=2, num_heads=4,
                                         projection_dim=48)
        return unet_cfg, clip_l_cfg, clip_g_cfg, vae_cfg
    return unet_cfg, clip_mod.CLIP_L_CONFIG, clip_mod.CLIP_G_CONFIG, vae_mod.SDXL_VAE_CONFIG


def sd3_configs(small: bool):
    """→ (mmdit, clip_l, clip_g, t5, vae) configs; the small set is the JAX
    factory's small SD3 config (a 2-deep MMDiT 128 wide over 4 latent
    channels, CLIP-L and a CLIP-G of CLIP-L's shape 48 wide with 48-wide
    projections, the small T5, a 4-channel VAE with SD3's scale and shift).
    At full width the MMDiT is ``SD3_MEDIUM_CONFIG`` (the factory
    fingerprints a given one instead), CLIP-L projects to 768."""
    if small:
        dit_cfg = mmdit_mod.MMDiTConfig(patch_size=2, in_channels=4, depth=2, context_size=96,
                                        adm_in_channels=96, pos_embed_max_size=16)
        clip_l_cfg = dataclasses.replace(clip_mod.CLIP_L_CONFIG, hidden_size=48,
                                         intermediate_size=96, num_layers=2, num_heads=4,
                                         projection_dim=48)
        clip_g_cfg = dataclasses.replace(clip_l_cfg, projection_dim=48)
        t5_cfg = t5_mod.T5Config(vocab_size=256, d_model=96, d_kv=16, d_ff=128, num_layers=2,
                                 num_heads=4)
        vae_cfg = vae_mod.VAEConfig(base_channels=32, channel_mult=(1, 2, 2, 2), num_res_blocks=1,
                                    z_channels=4, scale_factor=1.5305, shift_factor=0.0609)
        return dit_cfg, clip_l_cfg, clip_g_cfg, t5_cfg, vae_cfg
    return (mmdit_mod.SD3_MEDIUM_CONFIG,
            dataclasses.replace(clip_mod.CLIP_L_CONFIG, projection_dim=768),
            clip_mod.CLIP_G_CONFIG, t5_mod.T5_XXL_CONFIG, vae_mod.SD3_VAE_CONFIG)


def wan_configs(small: bool):
    """→ (dit, umt5, vae) configs and the UMT5 sequence length; the small set
    is the JAX factory's small Wan2.1 T2V config (2 blocks 64 wide, axes
    (8, 12, 12), the small UMT5, a VAE 8 wide over 4 latent channels, 32
    tokens).  At full width: Wan2.1-T2V-1.3B, UMT5-XXL, the Wan 2.1 VAE, 512
    tokens (the factory fingerprints given weights instead)."""
    if small:
        dit_cfg = wan_mod.WanConfig(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=96,
                                    out_dim=4, num_heads=2, num_layers=2, axes_dim=(8, 12, 12))
        t5_cfg = t5_mod.T5Config(vocab_size=256, d_model=96, d_kv=16, d_ff=128, num_layers=2,
                                 num_heads=4, is_umt5=True)
        return dit_cfg, t5_cfg, wan_vae_mod.WanVAEConfig(dim=8, z_dim=4, num_res_blocks=1), 32
    return wan_mod.WAN21_T2V_1_3B_CONFIG, t5_mod.UMT5_XXL_CONFIG, wan_vae_mod.WAN21_VAE_CONFIG, 512


def _create_wan_pipeline(params: dict, rng_type: str, dtype: torch.dtype, small: bool, seed: int,
                         t5_tokenizer, flow_shift: Optional[float], device) -> DiffusionPipeline:
    """Wan2.1 T2V: the Wan DiT, UMT5-XXL (``WanConditioner``), the 3-D causal
    Wan VAE (the latent statistics applied only to its 16-channel latent),
    the discrete flow denoiser (shift 5 unless ``flow_shift``), 4 frames a
    latent frame.  Random weights come in ``bench_wan21_t2v``'s classes: the
    DiT and the VAE dense, UMT5-XXL 4-bit at full width."""
    dit_cfg, t5_cfg, vae_cfg, t5_seq = wan_configs(small)
    if not small:
        if params.get("diffusion"):
            d = params["diffusion"]
            dit_cfg = wan_mod.detect_wan_config(d.keys(), {k: tuple(v.shape) for k, v in d.items()})
        if params.get("t5"):
            t5_cfg = detect_t5_config(params["t5"])
        if params.get("vae"):
            vae_cfg = wan_vae_mod.detect_wan_vae_config(params["vae"])
    wan_mod.check_supported(dit_cfg)
    specs = {"diffusion": wan_mod.param_specs(dit_cfg), "t5": t5_mod.param_specs(t5_cfg),
             "vae": wan_vae_mod.param_specs(vae_cfg)}
    mods = {name: params.get(name) or synthesize(
                spec, quant="q4_0" if name == "t5" and not small else None,
                seed=seed + SEED_OFFSET[name], device=device, dtype=dtype)
            for name, spec in specs.items()}
    conditioner = WanConditioner(t5_tokenizer, mods["t5"], t5_cfg, seq_len=t5_seq, device=device)

    def diffusion_fn(p, x, t, ctx, y, guidance=None, skip_layers=()):
        return wan_mod.wan_forward(p, x, t, ctx, clip_fea=y, cfg=dit_cfg, skip_layers=skip_layers)

    use_stats = vae_cfg.z_dim == 16  # the statistics are the real VAE's

    def vae_decode_fn(p, z):
        if use_stats:
            z = wan_vae_mod.diffusion_to_vae_latents(z)
        return wan_vae_mod.wan_vae_decode(p, z, vae_cfg)

    return DiffusionPipeline(
        version=SDVersion.WAN2, diffusion_params=mods["diffusion"], diffusion_fn=diffusion_fn,
        conditioner=conditioner, vae_params=mods["vae"], vae_decode_fn=vae_decode_fn,
        denoiser=DiscreteFlowDenoiser(shift=5.0 if flow_shift is None else flow_shift),
        rng_type=rng_type, latent_channels=vae_cfg.z_dim, compute_dtype=dtype, device=device,
        temporal_scale=4)


def z_image_configs(small: bool):
    """→ (dit, llm, vae) configs; the small set is the JAX factory's small
    Z-Image config (a 48-wide DiT of 2 + 1 + 1 blocks with 4 heads of 12 over
    2 KV heads, a 2-layer Qwen3 32 wide with a 256-piece vocab, the small
    FLUX-scaled VAE over 4 latent channels).  At full width: Z-Image-Turbo's
    DiT, Qwen3-4B (hidden 2560, Z-Image's ``cap_feat_dim``), the FLUX VAE
    (the factory fingerprints given weights instead)."""
    if small:
        dit_cfg = zi_mod.ZImageConfig(
            hidden_size=48, in_channels=4, out_channels=4, num_layers=2, num_refiner_layers=1,
            head_dim=12, num_heads=4, num_kv_heads=2, multiple_of=16, cap_feat_dim=32,
            axes_dim=(4, 4, 4))
        llm_cfg = dataclasses.replace(llm_mod.QWEN3_8B_CONFIG, num_layers=2, hidden_size=32,
                                      intermediate_size=64, num_heads=4, num_kv_heads=2, head_dim=8,
                                      vocab_size=256)
        vae_cfg = vae_mod.VAEConfig(base_channels=32, channel_mult=(1, 2, 2, 2), num_res_blocks=1,
                                    z_channels=4, scale_factor=0.3611, shift_factor=0.1159)
        return dit_cfg, llm_cfg, vae_cfg
    return zi_mod.Z_IMAGE_CONFIG, llm_mod.QWEN3_4B_CONFIG, vae_mod.FLUX_VAE_CONFIG


def _create_z_image_pipeline(params: dict, rng_type: str, dtype: torch.dtype, small: bool,
                             seed: int, qwen_tokenizer, flow_shift: Optional[float],
                             device) -> DiffusionPipeline:
    """Z-Image: the single-stream DiT, the Qwen3 LLM (``ZImageConditioner``),
    the FLUX VAE, the discrete flow denoiser (shift 3 unless
    ``flow_shift``); the DiT takes 1000 - t.  At full width a missing
    tokenizer is the Qwen2 byte-level one, with a warning; the small
    configs keep None (the ids 0..23, as the golden was made)."""
    dit_cfg, llm_cfg, vae_cfg = z_image_configs(small)
    if not small:
        if params.get("diffusion"):
            d = params["diffusion"]
            dit_cfg = zi_mod.detect_z_image_config(d.keys(), {k: tuple(v.shape) for k, v in d.items()})
        if params.get("llm"):
            m = params["llm"]
            llm_cfg = llm_mod.detect_llm_config(m.keys(), {k: tuple(v.shape) for k, v in m.items()},
                                                arch="qwen3")
    if llm_cfg.hidden_size != dit_cfg.cap_feat_dim:
        raise ValueError(f"the LLM's hidden size {llm_cfg.hidden_size} is not the DiT's "
                         f"cap_feat_dim {dit_cfg.cap_feat_dim}")
    specs = {"diffusion": zi_mod.param_specs(dit_cfg), "llm": llm_mod.param_specs(llm_cfg),
             "vae": vae_mod.vae_specs(vae_cfg)}
    mods = {name: params.get(name) or synthesize(
                spec, quant="q4_0" if name == "llm" and not small else None,
                seed=seed + SEED_OFFSET[name], device=device, dtype=dtype)
            for name, spec in specs.items()}
    if qwen_tokenizer is None and not small:
        warnings.warn("no qwen_tokenizer: using the Qwen2 byte-level vocabulary (valid ids, no "
                      "multi-byte merges; pass Qwen2Tokenizer.from_tokenizer_json(...) for exact "
                      "encoding)", stacklevel=3)
        qwen_tokenizer = Qwen2Tokenizer.byte_fallback()
    conditioner = ZImageConditioner(qwen_tokenizer, mods["llm"], llm_cfg, device=device)

    def diffusion_fn(p, x, t, ctx, y, guidance=None):
        return zi_mod.z_image_forward(p, x, 1000.0 - t, ctx, cfg=dit_cfg)

    vae_decode_fn, vae_encode_fn = _vae_fns(vae_cfg)
    return DiffusionPipeline(
        version=SDVersion.Z_IMAGE, diffusion_params=mods["diffusion"], diffusion_fn=diffusion_fn,
        conditioner=conditioner, vae_params=mods["vae"], vae_decode_fn=vae_decode_fn,
        vae_encode_fn=vae_encode_fn,
        denoiser=DiscreteFlowDenoiser(shift=3.0 if flow_shift is None else flow_shift),
        rng_type=rng_type, latent_channels=dit_cfg.in_channels, compute_dtype=dtype, device=device)


def qwen_image_configs(small: bool):
    """→ (dit, llm, vae) configs; the small set is the JAX factory's small
    Qwen-Image config (a 2-block DiT of 4 heads of 16 over 4 latent
    channels, context 48 wide; a 2-layer Qwen2.5-VL 48 wide with a 256-piece
    vocab; the Wan VAE 8 wide over 4 latent channels).  At full width:
    Qwen-Image's DiT (60 blocks, 20.4e9 parameters), Qwen2.5-VL-7B (hidden
    3584 = ``joint_attention_dim``), the Wan 2.1 VAE (the factory
    fingerprints given weights instead)."""
    if small:
        dit_cfg = qi_mod.QwenImageConfig(in_channels=16, out_channels=4, num_layers=2, head_dim=16,
                                         num_heads=4, joint_attention_dim=48, axes_dim=(4, 6, 6))
        llm_cfg = llm_mod.LLMConfig(num_layers=2, hidden_size=48, intermediate_size=96,
                                    num_heads=4, num_kv_heads=2, head_dim=12, vocab_size=256)
        return dit_cfg, llm_cfg, wan_vae_mod.WanVAEConfig(dim=8, z_dim=4, num_res_blocks=1)
    return qi_mod.QWEN_IMAGE_CONFIG, llm_mod.QWEN25_VL_7B_CONFIG, wan_vae_mod.WAN21_VAE_CONFIG


def _check_fits(specs: dict, dtype: torch.dtype, device, what: str) -> None:
    """Raise, before drawing, where dense ``specs`` in ``dtype`` exceed the
    card's free memory (a float32 full-width Qwen-Image DiT is 81.7e9 bytes)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    need = sum(int(torch.Size(s).numel()) for s, _ in specs.values()) * dtype.itemsize
    free = torch.cuda.mem_get_info(device)[0]
    if need > free:
        raise MemoryError(f"{what} in {dtype} is {need / 1e9:.1f} GB; the card has "
                          f"{free / 1e9:.1f} GB free (pass dtype=torch.bfloat16, or weights cut "
                          "to fewer blocks)")


def _create_qwen_image_pipeline(params: dict, rng_type: str, dtype: torch.dtype, small: bool,
                                seed: int, qwen_tokenizer, flow_shift: Optional[float],
                                device) -> DiffusionPipeline:
    """Qwen-Image: the joint-stream DiT, Qwen2.5-VL (``QwenImageConditioner``),
    the Wan 2.1 VAE in image mode (a one-frame video: ``z[:, None]`` in,
    frame 0 out; the latent statistics applied to its 16-channel latent
    only), the discrete flow denoiser (shift 3 unless ``flow_shift``).  An
    LLM's ``visual.*`` tensors (the vision tower, Qwen-Image-Edit's, which
    nothing in the port runs) are dropped.  At full width
    a missing tokenizer is the Qwen2 byte-level one, with a warning; the
    small configs keep None (the ids 0..47, as the golden was made)."""
    dit_cfg, llm_cfg, vae_cfg = qwen_image_configs(small)
    llm = params.get("llm")
    if llm:
        llm = {k: v for k, v in llm.items() if not k.startswith("visual.")}
    if not small:
        if params.get("diffusion"):
            dit_cfg = qi_mod.detect_qwen_image_config(params["diffusion"].keys())
        if llm:
            llm_cfg = llm_mod.detect_llm_config(llm.keys(), {k: tuple(v.shape) for k, v in llm.items()})
        if params.get("vae"):
            vae_cfg = wan_vae_mod.detect_wan_vae_config(params["vae"])
    qi_mod.check_supported(dit_cfg)
    if llm_cfg.hidden_size != dit_cfg.joint_attention_dim:
        raise ValueError(f"the LLM's hidden size {llm_cfg.hidden_size} is not the DiT's "
                         f"joint_attention_dim {dit_cfg.joint_attention_dim}")
    specs = {"diffusion": qi_mod.param_specs(dit_cfg), "llm": llm_mod.param_specs(llm_cfg),
             "vae": wan_vae_mod.param_specs(vae_cfg, decode_only=False)}
    if not params.get("diffusion"):
        _check_fits(specs["diffusion"], dtype, device, "the Qwen-Image DiT")
    given = {**params, "llm": llm}
    mods = {name: given.get(name) or synthesize(
                spec, quant="q4_0" if name == "llm" and not small else None,
                seed=seed + SEED_OFFSET[name], device=device, dtype=dtype)
            for name, spec in specs.items()}
    if qwen_tokenizer is None and not small:
        warnings.warn("no qwen_tokenizer: using the Qwen2 byte-level vocabulary (valid ids, no "
                      "multi-byte merges; pass Qwen2Tokenizer.from_tokenizer_json(...) for exact "
                      "encoding)", stacklevel=3)
        qwen_tokenizer = Qwen2Tokenizer.byte_fallback()
    conditioner = QwenImageConditioner(qwen_tokenizer, mods["llm"], llm_cfg, device=device)

    def diffusion_fn(p, x, t, ctx, y, guidance=None):
        return qi_mod.qwen_image_forward(p, x, t, ctx, cfg=dit_cfg)

    use_stats = vae_cfg.z_dim == 16  # the statistics are the real VAE's

    def vae_decode_fn(p, z):
        zv = z[:, None]
        if use_stats:
            zv = wan_vae_mod.diffusion_to_vae_latents(zv)
        return wan_vae_mod.wan_vae_decode(p, zv, vae_cfg)[:, 0]

    def vae_encode_fn(p, x, noise=None):
        zv = wan_vae_mod.wan_vae_encode(p, x[:, None], vae_cfg)
        if use_stats:
            zv = wan_vae_mod.vae_to_diffusion_latents(zv)
        return zv[:, 0]

    return DiffusionPipeline(
        version=SDVersion.QWEN_IMAGE, diffusion_params=mods["diffusion"], diffusion_fn=diffusion_fn,
        conditioner=conditioner, vae_params=mods["vae"], vae_decode_fn=vae_decode_fn,
        vae_encode_fn=vae_encode_fn,
        denoiser=DiscreteFlowDenoiser(shift=3.0 if flow_shift is None else flow_shift),
        rng_type=rng_type, latent_channels=dit_cfg.out_channels, compute_dtype=dtype, device=device)


def detect_t5_config(p: dict) -> t5_mod.T5Config:
    """A T5 / UMT5 encoder's config from its params' shapes (the JAX
    factory's ``_detect_t5_config``)."""
    vocab, d_model = p["shared.weight"].shape
    num_layers = 1 + max(int(k.split(".")[2]) for k in p if k.startswith("encoder.block."))
    num_heads = p["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"].shape[1]
    inner = p["encoder.block.0.layer.0.SelfAttention.q.weight"].shape[0]
    d_ff = p["encoder.block.0.layer.1.DenseReluDense.wi_0.weight"].shape[0]
    is_umt5 = "encoder.block.1.layer.0.SelfAttention.relative_attention_bias.weight" in p
    return t5_mod.T5Config(vocab_size=vocab, d_model=d_model, d_kv=inner // num_heads, d_ff=d_ff,
                           num_layers=num_layers, num_heads=num_heads, is_umt5=is_umt5)


def _create_sd3_pipeline(params: dict, rng_type: str, dtype: torch.dtype, small: bool, seed: int,
                         t5_tokenizer, flow_shift: Optional[float], device) -> DiffusionPipeline:
    """SD3 / SD3.5: the MMDiT, CLIP-L + CLIP-G + T5-XXL, the SD3 VAE, the
    discrete flow denoiser (shift 3 unless ``flow_shift``)."""
    dit_cfg, clip_l_cfg, clip_g_cfg, t5_cfg, vae_cfg = sd3_configs(small)
    if not small:
        if params.get("diffusion"):
            d = params["diffusion"]
            dit_cfg = mmdit_mod.detect_mmdit_config(d.keys(), {k: tuple(v.shape) for k, v in d.items()})
        if params.get("t5"):
            t5_cfg = detect_t5_config(params["t5"])
    specs = {"diffusion": mmdit_mod.param_specs(dit_cfg), "clip_l": clip_mod.param_specs(clip_l_cfg),
             "clip_g": clip_mod.param_specs(clip_g_cfg), "t5": t5_mod.param_specs(t5_cfg),
             "vae": vae_mod.vae_specs(vae_cfg)}
    mods = {name: params.get(name) or synthesize(
                spec, quant="q4_0" if name == "t5" and not small else None,
                seed=seed + SEED_OFFSET[name], device=device, dtype=dtype)
            for name, spec in specs.items()}
    conditioner = SD3Conditioner(CLIPTokenizer(), t5_tokenizer, mods["clip_l"], clip_l_cfg,
                                 mods["clip_g"], clip_g_cfg, mods["t5"], t5_cfg, device=device)

    def diffusion_fn(p, x, t, ctx, y, guidance=None, skip_layers=()):
        return mmdit_mod.mmdit_forward(p, x, t, ctx, y, cfg=dit_cfg, skip_layers=skip_layers)

    vae_decode_fn, vae_encode_fn = _vae_fns(vae_cfg)
    return DiffusionPipeline(
        version=SDVersion.SD3, diffusion_params=mods["diffusion"], diffusion_fn=diffusion_fn,
        conditioner=conditioner, vae_params=mods["vae"], vae_decode_fn=vae_decode_fn,
        vae_encode_fn=vae_encode_fn,
        denoiser=DiscreteFlowDenoiser(shift=3.0 if flow_shift is None else flow_shift),
        rng_type=rng_type, latent_channels=dit_cfg.in_channels, compute_dtype=dtype, device=device)


def _create_unet_pipeline(version: SDVersion, params: dict, rng_type: str, dtype: torch.dtype,
                          small: bool, seed: int, v_prediction: bool, device) -> DiffusionPipeline:
    """SD1.x and SD2.x (one text encoder: CLIP-L, or OpenCLIP-H at full width
    on SD2) or SDXL (CLIP-L and CLIP-G, the vector ``y``), with the
    version's stem and layout (``unet_config_for``); the CompVis denoiser,
    in its v-prediction form with ``v_prediction``.  ``controlnet_fn`` runs
    a ControlNet of the UNet's config (``set_controlnet``; params'
    'controlnet' attaches one at once, as the JAX factory does); the tiny
    versions have no middle block to copy, and none."""
    if sd_version_is_sdxl(version):
        unet_cfg, clip_l_cfg, clip_g_cfg, vae_cfg = sdxl_configs(small, version)
    else:
        (unet_cfg, clip_l_cfg, vae_cfg), clip_g_cfg = sd1_configs(small, version), None
    specs = {"diffusion": unet_mod.param_specs(unet_cfg), "clip_l": clip_mod.param_specs(clip_l_cfg),
             "vae": vae_mod.vae_specs(vae_cfg)}
    if clip_g_cfg is not None:
        specs["clip_g"] = clip_mod.param_specs(clip_g_cfg)
    mods = {name: params.get(name) or synthesize(spec, seed=seed + SEED_OFFSET[name], device=device,
                                                 dtype=dtype)
            for name, spec in specs.items()}
    if clip_g_cfg is not None:
        conditioner = SDXLConditioner(CLIPTokenizer(), mods["clip_l"], clip_l_cfg, mods["clip_g"],
                                      clip_g_cfg, device=device)
    else:
        conditioner = SD1Conditioner(CLIPTokenizer(), mods["clip_l"], clip_l_cfg,
                                     is_sd2=sd_version_is_sd2(version), device=device)

    def diffusion_fn(p, x, t, ctx, y, guidance=None, controls=None, control_strength=1.0):
        return unet_mod.unet_forward(p, x, t, ctx, y=y, cfg=unet_cfg, controls=controls,
                                     control_strength=control_strength)

    def controlnet_fn(p, x, hint, t, ctx, y):
        return controlnet_mod.controlnet_forward(p, x, hint, t, ctx, y=y, cfg=unet_cfg)

    vae_decode_fn, vae_encode_fn = _vae_fns(vae_cfg)
    pipe = DiffusionPipeline(
        version=version, diffusion_params=mods["diffusion"], diffusion_fn=diffusion_fn,
        conditioner=conditioner, vae_params=mods["vae"], vae_decode_fn=vae_decode_fn,
        vae_encode_fn=vae_encode_fn,
        denoiser=CompVisVDenoiser() if v_prediction else CompVisDenoiser(), rng_type=rng_type,
        latent_channels=vae_cfg.z_channels, compute_dtype=dtype, device=device,
        controlnet_fn=None if unet_config_for(version).tiny_unet else controlnet_fn)
    if params.get("controlnet") is not None:
        pipe.set_controlnet(params["controlnet"])
    return pipe


def _vae_fns(vae_cfg: vae_mod.VAEConfig):
    """(decode, encode) of the 2-D VAE at ``vae_cfg``, as the JAX factory's
    ``vae_decode_fn`` / ``vae_encode_fn``."""
    def vae_decode_fn(p, z):
        return vae_mod.vae_decode(p, z, vae_cfg)

    def vae_encode_fn(p, x, noise=None):
        return vae_mod.vae_encode(p, x, noise=noise, cfg=vae_cfg)

    return vae_decode_fn, vae_encode_fn


def _blocks(p: dict, prefix: str) -> int:
    return len({name.split(".")[1] for name in p if name.startswith(prefix + ".")})


def create_pipeline(version: SDVersion = SDVersion.FLUX, params: Optional[dict] = None,
                    rng_type: str = "cuda", dtype: torch.dtype = torch.float32,
                    small: bool = False, seed: int = 0, v_prediction: bool = False,
                    t5_tokenizer=None, flow_shift: Optional[float] = None,
                    device="cuda", qwen_tokenizer=None) -> DiffusionPipeline:
    """params: dict with keys 'diffusion', 'clip_l' (SD2's OpenCLIP-H too),
    't5' (FLUX, SD3 and Wan's UMT5), 'clip_g' (SDXL and SD3), 'llm'
    (Z-Image's Qwen3, Qwen-Image's Qwen2.5-VL), 'vae'; a missing module gets
    random weights drawn on ``device`` (dense for the small configs and for
    the UNet families at full width, the bench's memory classes for FLUX,
    SD3 and Wan at full width, Z-Image's and Qwen-Image's LLM 4-bit; a
    Qwen-Image DiT that would not fit the card's free memory raises
    ``MemoryError`` before it is drawn).  v_prediction: the UNet families'
    v-prediction denoiser (SD2.x-v); flow_shift: SD3's, Wan's, Z-Image's and
    Qwen-Image's flow shift (None: 3.0, 5.0, 3.0 and 3.0); the other ported
    families take neither, and ignore them, as the JAX factory does.
    qwen_tokenizer: Z-Image's and Qwen-Image's (None:
    ``Qwen2Tokenizer.byte_fallback()`` with a warning at full width, with
    ``small`` the ids 0..23 (Z-Image) or 0..47 (Qwen-Image) whatever the
    prompt)."""
    if version not in PORTED_VERSIONS:
        raise NotImplementedError(f"{version} is not ported yet; the port runs "
                                  f"{[v.name for v in PORTED_VERSIONS]}")
    params = params or {}
    if version == SDVersion.QWEN_IMAGE:
        return _create_qwen_image_pipeline(params, rng_type, dtype, small, seed, qwen_tokenizer,
                                           flow_shift, device)
    if version == SDVersion.Z_IMAGE:
        return _create_z_image_pipeline(params, rng_type, dtype, small, seed, qwen_tokenizer,
                                        flow_shift, device)
    if version == SDVersion.WAN2:
        return _create_wan_pipeline(params, rng_type, dtype, small, seed, t5_tokenizer, flow_shift,
                                    device)
    if version == SDVersion.SD3:
        return _create_sd3_pipeline(params, rng_type, dtype, small, seed, t5_tokenizer, flow_shift,
                                    device)
    if version in UNET_VERSIONS:
        return _create_unet_pipeline(version, params, rng_type, dtype, small, seed, v_prediction,
                                     device)
    dit_cfg, clip_l_cfg, t5_cfg, vae_cfg, t5_seq = flux_configs(small)
    specs = {"diffusion": flux_mod.param_specs(dit_cfg), "t5": t5_mod.param_specs(t5_cfg),
             "clip_l": clip_mod.param_specs(clip_l_cfg), "vae": vae_mod.vae_specs(vae_cfg)}
    mods = {}
    for name, spec in specs.items():
        mods[name] = params.get(name) or synthesize(
            spec, quant=None if small else FULL_QUANT[name], seed=seed + SEED_OFFSET[name],
            device=device, dtype=dtype)
    if params.get("diffusion"):
        dit_cfg = dataclasses.replace(dit_cfg, depth=_blocks(params["diffusion"], "double_blocks"),
                                      depth_single=_blocks(params["diffusion"], "single_blocks"))

    conditioner = FluxConditioner(CLIPTokenizer(), t5_tokenizer, mods["clip_l"], clip_l_cfg,
                                  mods["t5"], t5_cfg, t5_seq_len=t5_seq, device=device)

    def diffusion_fn(p, x, t, ctx, y, guidance=None, skip_layers=()):
        return flux_mod.flux_forward(p, x, t, ctx, y, guidance=guidance, cfg=dit_cfg,
                                     skip_layers=skip_layers)

    vae_decode_fn, vae_encode_fn = _vae_fns(vae_cfg)
    return DiffusionPipeline(
        version=SDVersion.FLUX, diffusion_params=mods["diffusion"], diffusion_fn=diffusion_fn,
        conditioner=conditioner, vae_params=mods["vae"], vae_decode_fn=vae_decode_fn,
        vae_encode_fn=vae_encode_fn,
        denoiser=FluxFlowDenoiser(), rng_type=rng_type, latent_channels=vae_cfg.z_channels,
        compute_dtype=dtype, uses_distilled_guidance=dit_cfg.guidance_embed, device=device)
