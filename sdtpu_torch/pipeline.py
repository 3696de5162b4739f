"""txt2img, img2img, masked img2img and the latent hires fix for FLUX, SD1.x,
SD2.x, SDXL, SD3, Z-Image and Qwen-Image (the UNets' inpainting and
instruct-pix2pix variants too), and txt2vid for Wan2.1 T2V (counterpart of ``sdtpu/pipeline.py``:
``DiffusionPipeline.generate`` with its init image, init latent, mask,
the inpainting and pix2pix UNets' concat latents, their image guidance and
the pix2pix edit image (``ref_images``),
``img2img``, ``encode_image``, ``txt2img_hires``, ``generate_video``,
``VideoResult``, ``txt2img``, ``set_vae_tiling`` with its temporal windows,
``set_tae``, the tiled decode and encode, the prompt → conditions cache,
``free_conditioner_params``, ``_match_context``, ``_parse_custom_sigmas``
and ``_to_pm1``).

img2img: the init image is encoded to the posterior mean (tiled under
``set_vae_tiling``; refused while a TAESD decoder is attached, whose params
hold no encoder), ``strength`` keeps the last ``int(steps · strength)`` steps
of the schedule (one fewer at 1.0) and the noise is scaled around the init
latent.  A mask (1 regenerate, 0 keep; uint8 or [0, 1]) is rounded,
nearest-downsampled to the latent and blends each denoised estimate toward
the init latent where it is 0.  ``txt2img_hires`` runs the base request,
resizes its latents bilinearly (half-pixel centres, antialiased when
shrinking, as ``jax.image.resize``) and runs an img2img pass at the target
size; an ESRGAN upscaler is not ported.  An inpainting UNet (9 input
channels) takes [mask, masked image's latent] beside the latent instead of
the blend; an instruct-pix2pix UNet (8) the edit image's latent
(``ref_images[0]``, else the init image); with CFG on and
``img_cfg_scale`` set apart from ``cfg_scale``, a third forward on the
uncond context with those channels zeroed (the mask kept) gives the
image-guidance estimate (``cfg_combine``).  ``generate_video(init_image=...)``
is not ported.
Repeated prompts come from a cache of ``COND_CACHE_SIZE`` (16) entries,
the oldest dropped first, keyed on (prompt, negative prompt, clip skip, width, height,
CFG); ``free_params_immediately`` (or ``free_conditioner_params()``)
releases the text encoders' tensors after conditioning, after which only
cached prompts can be answered.

Samplers: ``sdtpu_torch.diffusion.samplers.PORTED_METHODS`` (all of the JAX
package's but SeFi's ``sefi_euler``), schedules: all 17 of
``diffusion.schedule.SCHEDULERS`` (``get_sigmas`` gets the pipeline's
version and the image's token count).  A noisy method's per-step noise (at
``eta > 0``, ``lcm``'s at any ``eta``; ``dpm++2m_sde_bt``'s from a
Brownian tree seeded by two draws) follows the initial noise in each batch
item's ``rng`` stream, or comes from a fresh stream of
``sampler_rng_type``, as the JAX pipeline draws it.  The latent's channels and the schedule come from the
model (FLUX's 16-channel flow latent, SD1's, SD2's and SDXL's 4-channel
eps or v latent on the DDPM table, SD3's 16-channel latent on the discrete
flow schedule); SD1 has no pooled vector (``y``), SDXL's is the pooled CLIP-G output with
the size embeddings of the request's width and height, SD3's the pooled
CLIP-L and CLIP-G outputs; only FLUX has distilled guidance.  Under CFG:
Skip-Layer Guidance (``slg_scale``, ``skip_layers``, ``slg_start`` /
``slg_end``) on the models whose forward takes ``skip_layers`` (FLUX, SD3,
Wan; elsewhere it warns and is dropped, as in the JAX pipeline), APG
(``apg_*``, its momentum buffer carried across steps and cache skips) in
place of the CFG combine, and ``extra_sample_args``'s ``guidance_schedule``
as a per-step CFG scale.
``set_tae`` swaps the final decode for a TAESD decoder.  Of
``extra_sample_args`` the samplers take the JAX pipeline's keys
(``SAMPLER_KEYS``: ``gamma`` for ``euler_ge``, ``lcm``'s
``noise_scale_start`` / ``noise_scale_end``, ``noise_clip_std``, which no
method reads) beside ``guidance_schedule``; any other key is dropped.
``set_loras`` sets the LoRA adapters of the diffusion weights (an epoch:
re-derived from the pristine weights on every call), ``load_embedding`` a
textual-inversion embedding on SD1.x / SD2.x.  ``generate(step_cache=...)`` runs a step
cache (``diffusion/stepcache.py``).  ``generate`` takes the JAX pipeline's
``progress_callback(step, steps, x)`` and ``cancel_check()`` (a server
job's progress and cancellation): both run after each step, and a cancelled
request decodes the latents it reached.

Takes this package's ``sdtpu_torch.config.GenerationParams`` (the fields
and defaults of the JAX package's).  The initial noise comes from
``sdtpu_torch.rng`` (Philox in numpy, or torch's CPU generator), drawn per batch item
exactly as the JAX pipeline draws it, so both packages start from the same
latent.  Phase wall-clock times of the last call land in
``last_timings`` (``cond``, ``sample``, ``decode``, ``total``, ``steps``;
``encode`` where an init image was encoded; ``frames`` for a video); each
phase ends in a device synchronize.  A video's
latent is [B, Tl, h, w, C], Tl = 1 + (frames - 1) / ``temporal_scale``.  ``last_t5_ids`` holds the padded
ids T5 was fed for the last prompt (all zero without a T5 tokenizer).
"""
from __future__ import annotations

import dataclasses
import inspect
import sys
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sdtpu_torch.config import (GenerationParams, SDVersion, sd_version_is_inpaint,
                                sd_version_is_unet_edit)
from sdtpu_torch.diffusion.brownian import brownian_step_noise
from sdtpu_torch.diffusion.guidance import (APGParams, apg_combine, cfg_combine,
                                            parse_guidance_schedule, slg_active_steps)
from sdtpu_torch.diffusion.samplers import method_needs_noise, sample
from sdtpu_torch.diffusion.schedule import get_sigmas
from sdtpu_torch.diffusion.stepcache import make_step_cache
from sdtpu_torch.models.tiling import tiled_decode, tiled_decode_temporal, tiled_encode
from sdtpu_torch.rng import create_rng


@dataclasses.dataclass
class GenerationResult:
    images: np.ndarray  # [B, H, W, 3] uint8
    latents: np.ndarray  # [B, h, w, zc] float32 (pre-decode)
    seeds: list


@dataclasses.dataclass
class VideoResult:
    frames: np.ndarray  # [B, T, H, W, 3] uint8
    latents: np.ndarray  # [B, Tl, h, w, zc] float32 (pre-decode)
    seeds: list


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tile(x: Optional[torch.Tensor], bc: int) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return x.repeat((bc,) + (1,) * (x.dim() - 1))


def _pad_tokens_by_repeat(x: torch.Tensor, target: int) -> torch.Tensor:
    """Repeat the last 77-token chunk up to ``target`` tokens (CLIP
    chunking); a context not in 77-token chunks is zero-padded."""
    if x.shape[1] == target:
        return x
    if (target - x.shape[1]) % 77 == 0 and x.shape[1] >= 77:
        reps = (target - x.shape[1]) // 77
        return torch.cat([x] + [x[:, -77:, :]] * reps, dim=1)
    pad = x.new_zeros((x.shape[0], target - x.shape[1], x.shape[2]))
    return torch.cat([x, pad], dim=1)


# the keys of ``extra_sample_args`` the samplers take (the JAX pipeline's
# ``_SAMPLER_KEYS``): ``gamma`` (euler_ge), ``noise_scale_start`` / ``_end``
# (lcm) and SeFi's ``alpha`` / ``delta_t`` / ``sem_channels`` are read by
# their methods, ``noise_clip_std`` by none
SAMPLER_KEYS = ("gamma", "alpha", "delta_t", "noise_scale_start", "noise_scale_end",
                "noise_clip_std", "sem_channels")


def _sampler_extra_args(spec: str):
    """``extra_sample_args`` ("key=value,...") → (the ``SAMPLER_KEYS`` among
    them as floats, the ``guidance_schedule`` spec or ""), as the JAX
    pipeline parses them: any other key is dropped."""
    out, schedule = {}, ""
    for part in (spec or "").split(","):
        if "=" not in part:
            continue
        k, v = (t.strip() for t in part.split("=", 1))
        if k == "guidance_schedule":
            schedule = v
        elif k in SAMPLER_KEYS:
            out[k] = float(v)
    return out, schedule


def _parse_custom_sigmas(spec: str) -> np.ndarray:
    """'14.61,7.8,...' → float32 sigmas, 0 appended where the list does not
    end in it."""
    vals = [float(v) for v in spec.replace(" ", "").split(",") if v]
    if not vals:
        raise ValueError("empty custom sigma list")
    if vals[-1] != 0.0:
        vals.append(0.0)
    return np.asarray(vals, dtype=np.float32)


def _to_pm1(image) -> np.ndarray:
    """uint8 [0, 255] or float [0, 1] image → float32 in [-1, 1] (uint8 where
    its maximum exceeds 1.5)."""
    img = np.asarray(image, dtype=np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return img * 2.0 - 1.0


def resize_latents(latents: torch.Tensor, lh: int, lw: int) -> torch.Tensor:
    """[B, h, w, C] → [B, lh, lw, C] float32 on the latents' device: bilinear
    with half-pixel centres, antialiased along a shrinking axis, as
    ``jax.image.resize(..., "bilinear")``."""
    x = latents.float().permute(0, 3, 1, 2)
    shrink = lh < x.shape[2] or lw < x.shape[3]
    y = F.interpolate(x, size=(lh, lw), mode="bilinear", align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1).contiguous()


def _tensors(value) -> list:
    """The torch tensors inside a conditioner attribute (dicts, sequences and
    the quantized weights' dataclasses)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _tensors(v)]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return [t for f in dataclasses.fields(value) for t in _tensors(getattr(value, f.name))]
    return []


def _on(weight, device: torch.device) -> bool:
    return all(t.device.type == device.type for t in _tensors(weight))


def _moved(weight, device: torch.device):
    """A weight (a tensor, or a quantized or LoRA weight's dataclass or
    named tuple) on ``device``: itself where it is there already.  The copy
    is asynchronous (to the host: into pinned memory), so synchronize
    before the host reads it."""
    if _on(weight, device):
        return weight

    def to(t):
        return t.to(device, non_blocking=True)

    if isinstance(weight, torch.Tensor):
        return to(weight)
    if dataclasses.is_dataclass(weight):
        return dataclasses.replace(weight, **{
            f.name: to(getattr(weight, f.name)) for f in dataclasses.fields(weight)
            if isinstance(getattr(weight, f.name), torch.Tensor)})
    return type(weight)(*(to(t) if isinstance(t, torch.Tensor) else t for t in weight))


COND_CACHE_SIZE = 16  # prompt → conditions entries kept, the oldest dropped first
FREED_ERROR = ("text-encoder params were freed (free_params_immediately) and this prompt is not "
               "in the cond cache; rebuild the pipeline to encode new prompts")


def _match_context(c: torch.Tensor, u: Optional[torch.Tensor], bc: int):
    """Pad the cond and uncond contexts to one token length (their chunk
    counts may differ), then tile both to the batch."""
    if u is not None and c.shape[1] != u.shape[1]:
        target = max(c.shape[1], u.shape[1])
        c, u = _pad_tokens_by_repeat(c, target), _pad_tokens_by_repeat(u, target)
    return _tile(c, bc), _tile(u, bc)


class DiffusionPipeline:
    """Conditioner + diffusion backbone + VAE on one device.

    diffusion_fn(params, x, t, context, y, guidance=None) → model output in
    x's layout (NHWC latents)."""

    def __init__(self, version: SDVersion, diffusion_params, diffusion_fn: Callable, conditioner,
                 vae_params, vae_decode_fn: Callable, denoiser, rng_type: str = "cuda",
                 latent_channels: int = 4, compute_dtype: torch.dtype = torch.float32,
                 uses_distilled_guidance: bool = False, device="cuda", temporal_scale: int = 1,
                 vae_encode_fn: Optional[Callable] = None):
        self.version = version
        self.diffusion_params = diffusion_params
        self.diffusion_fn = diffusion_fn
        self.conditioner = conditioner
        self.vae_params = vae_params
        self.vae_decode_fn = vae_decode_fn
        self.vae_encode_fn = vae_encode_fn  # (params, x, noise=None) → scaled latent
        self.denoiser = denoiser
        self.rng_type = rng_type
        self.latent_channels = latent_channels
        self.scale_factor = 8  # VAE pixels per latent
        self.temporal_scale = temporal_scale  # video frames per latent frame (after the first)
        self.compute_dtype = compute_dtype
        self.uses_distilled_guidance = uses_distilled_guidance
        self.device = torch.device(device)
        self._vae_tiling = False
        self._vae_tile = 64
        self._vae_overlap = 8
        self._vae_temporal = False
        self._vae_temporal_frames = 16
        self._vae_temporal_overlap = 4
        self.last_timings: Dict[str, float] = {}
        self.last_t5_ids: Optional[list] = None
        self._tae: Optional[dict] = None
        self._cond_cache: Dict[tuple, tuple] = {}  # prompt key → (cond, uncond)
        self.free_params_immediately = False
        self._conditioner_freed = False
        self._lora_base: dict = {}  # the pristine diffusion entries a LoRA epoch replaced
        # the sampler noise's RNG kind (the CLI's --sampler-rng); None: the
        # latent noise's stream goes on
        self.sampler_rng_type: Optional[str] = None

    def free_conditioner_params(self) -> int:
        """Release the text encoders' tensors (``free_params_immediately``):
        cached prompts keep working, an uncached one raises.  → the bytes
        released."""
        cond = self.conditioner
        if cond is None or self._conditioner_freed:
            return 0
        freed = 0
        for attr, val in list(vars(cond).items()):
            tensors = {id(t): t for t in _tensors(val)}
            if not tensors:
                continue
            freed += sum(t.numel() * t.element_size() for t in tensors.values())
            setattr(cond, attr, None)
        self._conditioner_freed = True
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return freed

    def set_loras(self, loras, mode: str = "auto") -> None:
        """Set the active LoRA set (``sdtpu.pipeline.DiffusionPipeline.
        set_loras``'s epochs): every call applies ``loras``, a list of
        (LoRA file tensors, multiplier), to the pristine diffusion weights,
        so a set does not accumulate over calls and ``[]`` restores the
        weights bit for bit.  ``mode``: ``--lora-apply-mode`` (``auto``,
        ``immediately``, ``at_runtime``; ``models.lora.apply_lora``).

        Every weight class takes it: a dense weight is merged in float32 and
        kept in its dtype, a per-row int8 one gets runtime factors in the
        compute dtype (or is requantized under ``immediately``), a 4-bit or
        GGUF-block one is requantized on its grid.  Only the entries an
        epoch replaced are kept as the pristine copy (a patched entry is a
        new object, nothing is changed in place): where runtime factors
        ride on the base, the base itself, which adds no bytes; where a
        merge replaced it, a copy in host memory, as the JAX pipeline keeps
        its snapshot, so a merged DiT does not hold two copies on the card
        (it is uploaded again for the next epoch)."""
        from sdtpu_torch.models.lora import apply_lora

        params, host = self.diffusion_params, torch.device("cpu")
        pristine = {**params, **{k: _moved(v, self.device) for k, v in self._lora_base.items()}}
        work = dict(pristine)
        patched = 0
        for tensors, mult in loras:
            applied, _ = apply_lora({"diffusion": work}, tensors, mult, mode=mode,
                                    factor_dtype=self.compute_dtype)
            patched += applied
        base = {}
        for k, v in work.items():
            if v is pristine[k]:
                continue
            shared = {id(t) for t in _tensors(v)}
            if all(id(t) in shared for t in _tensors(pristine[k])):  # factors on the base
                base[k] = pristine[k]
            elif k in self._lora_base and _on(self._lora_base[k], host):
                base[k] = self._lora_base[k]
            else:
                base[k] = _moved(pristine[k], host)
        _sync(self.device)  # the host copies are whole before their device entries go
        self._lora_base = base
        params.update(work)
        print(f"LoRA epoch: {len(loras)} adapter(s), {patched} tensors patched", file=sys.stderr)

    def load_embedding(self, name: str, vectors) -> None:
        """Add a textual-inversion embedding to the conditioner (SD1.x and
        SD2.x: ``SD1Conditioner.load_embedding``) and empty the prompt cache:
        the new rows change how prompts tokenize."""
        if not hasattr(self.conditioner, "load_embedding"):
            raise NotImplementedError(f"{self.version.value}: textual-inversion embeddings run on "
                                      "SD1.x and SD2.x, as in the JAX package")
        self.conditioner.load_embedding(name, vectors)
        self._cond_cache.clear()

    def set_vae_tiling(self, enabled: bool = True, tile_size: int = 64, overlap: int = 8,
                       temporal: bool = False, extra_tiling_args: str = "") -> None:
        """Spatial VAE tiling: decode runs tile-wise with feathered blending;
        tile and overlap in latent units.  ``temporal``: a video decode also
        runs in windows of latent frames; ``extra_tiling_args``
        "temporal_tile_frames=N,temporal_tile_overlap=M" sizes them (16 and
        4 by default)."""
        self._vae_tiling = enabled
        self._vae_tile = tile_size
        self._vae_overlap = overlap
        self._vae_temporal = temporal
        kv = dict(part.split("=", 1) for part in extra_tiling_args.split(",") if "=" in part)
        kv = {k.strip(): v.strip() for k, v in kv.items()}
        self._vae_temporal_frames = max(1, int(kv.get("temporal_tile_frames", 16)))
        self._vae_temporal_overlap = max(0, int(kv.get("temporal_tile_overlap", 4)))

    def set_tae(self, tae_params, tae_cfg=None, preview_only: bool = False) -> None:
        """Attach a TAESD decoder (the CLI's ``--taesd``): final decodes run
        the tiny decoder.  ``tae_params=None`` restores the full VAE;
        re-attaching over a TAE keeps the original VAE pair.  The port has no
        latent preview, so ``preview_only`` (``--taesd-preview-only``) is
        refused."""
        if preview_only:
            raise NotImplementedError("set_tae(preview_only=True): the port has no latent "
                                      "preview to serve (--taesd-preview-only is not ported)")
        if tae_params is None:
            if self._tae is not None:
                self.vae_decode_fn, self.vae_params = self._tae["orig"]
            self._tae = None
            return
        from sdtpu_torch.models.tae import TAESD_CONFIG, tae_decode

        tae_cfg = tae_cfg or TAESD_CONFIG

        def tae_decode_fn(p, z):
            return tae_decode(p, z, tae_cfg)

        orig = self._tae["orig"] if self._tae else (self.vae_decode_fn, self.vae_params)
        self._tae = {"cfg": tae_cfg, "orig": orig}
        self.vae_decode_fn, self.vae_params = tae_decode_fn, tae_params

    def _vae_dtype(self, params: Optional[dict] = None) -> torch.dtype:
        for v in (params or self.vae_params).values():
            if v.is_floating_point():
                return v.dtype
        return self.compute_dtype

    def _encode(self, image) -> torch.Tensor:
        """[H,W,3] image → scaled latent [1,h,w,zc], float32 on the device
        (the posterior mean; tiled under ``set_vae_tiling``, tile and
        overlap in pixels = the latent units times the scale factor)."""
        if self.vae_encode_fn is None:
            from sdtpu_torch.io.model_loader import image_families

            raise NotImplementedError(f"{self.version.value}: the port has no VAE encoder for this "
                                      f"model (img2img is ported for {image_families()})")
        if self._tae is not None:
            raise NotImplementedError("encode_image with a TAESD decoder attached: the TAE params "
                                      "hold no encoder (set_tae(None) restores the full VAE)")
        x = torch.from_numpy(_to_pm1(image)[None]).to(self.device, self._vae_dtype())

        def run(t):
            return self.vae_encode_fn(self.vae_params, t)

        if self._vae_tiling:
            sf = self.scale_factor
            return tiled_encode(run, x, tile=self._vae_tile * sf, overlap=self._vae_overlap * sf,
                                scale_factor=sf, out_channels=self.latent_channels)
        return run(x).float()

    @torch.inference_mode()
    def encode_image(self, image) -> np.ndarray:
        """[H,W,3] (uint8, or float in [0, 1]) → scaled latent [1,h,w,zc]
        float32 (deterministic: the posterior mean)."""
        return self._encode(image).cpu().numpy()

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B,h,w,zc] → image [B,8h,8w,3] in [-1,1], float32;
        a video's [B,Tl,h,w,zc] → [B,T,8h,8w,3], in temporal windows where
        ``set_vae_tiling(temporal=True)`` asked for them."""
        vae_dtype = self._vae_dtype()

        def run(z):
            return self.vae_decode_fn(self.vae_params, z.to(vae_dtype))

        def spatial(z):
            if self._vae_tiling:
                return tiled_decode(run, z, tile=self._vae_tile, overlap=self._vae_overlap,
                                    scale_factor=self.scale_factor)
            return run(z).float()

        if self._vae_temporal and latents.dim() == 5:
            return tiled_decode_temporal(spatial, latents, frames=self._vae_temporal_frames,
                                         overlap=self._vae_temporal_overlap,
                                         temporal_scale=self.temporal_scale)
        return spatial(latents)

    def txt2img(self, gp: GenerationParams) -> GenerationResult:
        return self.generate(gp)

    def _slg_supported(self) -> bool:
        """Skip-Layer Guidance needs a diffusion function with a
        ``skip_layers`` parameter (FLUX, SD3's MMDiT, Wan), as in the JAX
        pipeline; the others warn and drop it."""
        return "skip_layers" in inspect.signature(self.diffusion_fn).parameters

    def _model_fn(self, ctx_c, ctx_u, y_c, y_u, cfg_scale, guidance, b: int,
                  denoise_mask: Optional[torch.Tensor] = None,
                  masked_target: Optional[torch.Tensor] = None,
                  c_concat: Optional[torch.Tensor] = None,
                  img_uncond_concat: Optional[torch.Tensor] = None,
                  img_cfg_scale: Optional[float] = None, apg: Optional[APGParams] = None,
                  slg: Optional[tuple] = None):
        """→ model_fn(x, sigma, i) → (denoised, uncond denoised); with a
        mask, the denoised estimate keeps ``masked_target`` where it is 0.  ``cfg_scale``: a float, or a
        per-step list (the guidance schedule; the last entry holds past its
        end).  ``c_concat`` ([1, h, w, C]): channels that follow the scaled
        latent into the model (the inpainting and pix2pix UNets' input);
        with ``img_cfg_scale`` a third forward (the uncond context, the latent
        beside ``img_uncond_concat``) gives the image guidance's estimate.
        ``apg`` replaces the CFG combine by Adaptive Projected Guidance, its
        momentum buffer held here from forward to forward (a forward a step
        cache skips leaves it as it is);
        ``slg`` = (scale, skip layers, i0, i1): at steps i0 <= i < i1 one
        more cond-only forward with those layers skipped adds scale · (cond −
        skipped) to the guided estimate."""
        denoiser = self.denoiser
        has_uncond = ctx_u is not None
        dev = self.device
        momentum = {"buf": None}

        def with_concat(x_core, concat):
            if concat is None:
                return x_core
            return torch.cat([x_core, concat.to(x_core.dtype).expand(b, -1, -1, -1)], dim=-1)

        def model_fn(xt, sigma, i):
            cfg_s = (cfg_scale[min(i, len(cfg_scale) - 1)] if isinstance(cfg_scale, list)
                     else cfg_scale)
            c_skip, c_out, c_in = denoiser.get_scalings_torch(sigma)
            t = denoiser.sigma_to_t_torch(sigma)
            x_core = (xt * c_in).to(self.compute_dtype)  # only the latent is scaled
            x_in = with_concat(x_core, c_concat)
            tt = t.reshape(1).expand(b).to(torch.float32)
            if has_uncond:
                x_both = torch.cat([x_in, x_in], dim=0)
                ctx = torch.cat([ctx_c, ctx_u], dim=0)
                y = torch.cat([y_c, y_u], dim=0) if y_c is not None else None
                g = torch.cat([guidance, guidance], dim=0) if guidance is not None else None
                out = self.diffusion_fn(self.diffusion_params, x_both, tt.repeat(2), ctx, y,
                                        guidance=g).float()
                den_both = c_skip * torch.cat([xt, xt], dim=0) + c_out * out
                den_cond, den_uncond = den_both[:b], den_both[b:]
                den_img_u, img_scale = None, 1.0
                if img_cfg_scale is not None:
                    out_iu = self.diffusion_fn(self.diffusion_params,
                                               with_concat(x_core, img_uncond_concat), tt, ctx_u,
                                               y_u, guidance=guidance).float()
                    den_img_u, img_scale = c_skip * xt + c_out * out_iu, img_cfg_scale
                if apg is not None:
                    pred, momentum["buf"] = apg_combine(
                        den_cond, den_uncond, den_img_u, float(cfg_s), apg,
                        momentum_buffer=momentum["buf"], image_guidance_scale=img_scale)
                else:
                    pred = cfg_combine(den_cond, den_uncond, den_img_u,
                                       torch.tensor(cfg_s, dtype=torch.float32, device=dev),
                                       img_scale)
                if slg is not None and slg[2] <= i < slg[3]:
                    out_s = self.diffusion_fn(self.diffusion_params, x_in, tt, ctx_c, y_c,
                                              guidance=guidance, skip_layers=slg[1]).float()
                    pred = pred + slg[0] * (den_cond - (c_skip * xt + c_out * out_s))
            else:
                out = self.diffusion_fn(self.diffusion_params, x_in, tt, ctx_c, y_c,
                                        guidance=guidance).float()
                pred = c_skip * xt + c_out * out
                den_uncond = pred
            if denoise_mask is not None:
                pred = pred * denoise_mask + masked_target * (1.0 - denoise_mask)
            return pred, den_uncond

        return model_fn

    def _conditions(self, gp: GenerationParams, has_uncond: bool):
        """(cond, uncond) of the request's prompts, from the cache where
        they are in it."""
        w, h = gp.width, gp.height
        key = (gp.prompt, gp.negative_prompt, gp.clip_skip, w, h, has_uncond)
        cached = self._cond_cache.get(key)
        if cached is not None:
            return cached
        if self._conditioner_freed:
            raise RuntimeError(FREED_ERROR)
        encode = self.conditioner.get_learned_condition
        cond = encode(gp.prompt, clip_skip=gp.clip_skip, width=w, height=h)
        uncond = (encode(gp.negative_prompt, clip_skip=gp.clip_skip, width=w, height=h)
                  if has_uncond else None)
        if len(self._cond_cache) >= COND_CACHE_SIZE:
            self._cond_cache.pop(next(iter(self._cond_cache)))
        self._cond_cache[key] = (cond, uncond)
        return cond, uncond

    def _denoise(self, gp: GenerationParams, shape: tuple, image_seq_len: int,
                 progress_callback: Optional[Callable], cancel_check: Optional[Callable],
                 init_latent: Optional[torch.Tensor] = None, mask_image=None,
                 concat: tuple = (None, None), video: bool = False,
                 step_cache: Optional[str] = None, cache_options: Optional[dict] = None):
        """Conditioning, then sampling from the initial noise of ``shape``
        (one batch item's latent), scaled around ``init_latent`` where given
        (img2img: the schedule cut by ``gp.strength``; ``mask_image`` keeps
        the init latent where it is 0); ``concat``: the model's extra input
        channels and their image-guidance form (``_concat_latents``).  As in
        the JAX pipeline a ``video`` request runs SLG but neither APG, the
        guidance schedule nor the sampler keys of ``extra_sample_args``.
        ``step_cache`` (with ``cache_options``) wraps the model function in
        that cache (``stepcache.make_step_cache``) → (latents on the device,
        float32; seeds; cond seconds; sample seconds; steps; the cache's
        skipped forwards, or None)."""
        dev = self.device
        bc = gp.batch_count
        has_uncond = gp.cfg_scale != 1.0

        extra_args, schedule = _sampler_extra_args(gp.extra_sample_args)
        if video:
            extra_args, schedule = {}, ""
        tc0 = time.time()
        cond, uncond = self._conditions(gp, has_uncond)
        self.last_t5_ids = cond.t5_ids
        _sync(dev)
        t_cond = time.time() - tc0
        ctx_c, ctx_u = _match_context(cond.c_crossattn,
                                      uncond.c_crossattn if uncond is not None else None, bc)
        y_c = _tile(cond.c_vector, bc)
        y_u = _tile(uncond.c_vector, bc) if uncond is not None else None

        sigmas = get_sigmas(self.denoiser, gp.sample_steps, scheduler=gp.schedule,
                            version=self.version.value, image_seq_len=image_seq_len)
        if gp.custom_sigmas:
            sigmas = _parse_custom_sigmas(gp.custom_sigmas)
        x0 = np.zeros((bc,) + shape, dtype=np.float32)
        if init_latent is not None:
            if tuple(init_latent.shape[1:]) != shape:
                raise ValueError(f"init latent {tuple(init_latent.shape[1:])} does not match the "
                                 f"request's {shape} (an init image of {gp.width}x{gp.height} "
                                 "pixels)")
            if gp.strength < 1.0:
                n_total = len(sigmas) - 1  # not sample_steps under custom sigmas
                t_enc = int(n_total * gp.strength)
                if t_enc == n_total:
                    t_enc -= 1
                sigmas = sigmas[n_total - t_enc - 1:]
            x0 = np.broadcast_to(init_latent.cpu().numpy(), x0.shape).astype(np.float32)
        denoise_mask = masked_target = None
        if mask_image is not None and init_latent is not None:
            m = np.round(np.asarray(mask_image, dtype=np.float32))
            if m.max() > 1.0:
                m = m / 255.0
            sf = self.scale_factor  # nearest-downsampled to the latent
            m = m[::sf, ::sf][None, :shape[0], :shape[1], None].astype(np.float32)
            denoise_mask = torch.from_numpy(np.broadcast_to(m, (bc,) + m.shape[1:]).copy()).to(dev)
            masked_target = torch.from_numpy(x0.copy()).to(dev)
        steps = len(sigmas) - 1

        # per-batch streams: latent noise, then the sampler's per-step noise
        # (its own stream where ``sampler_rng_type`` names another kind)
        seeds = [gp.seed + i for i in range(bc)]
        init_noise = np.empty((bc,) + shape, dtype=np.float32)
        need_noise = method_needs_noise(gp.sample_method, gp.eta)
        step_noise = np.empty((steps, bc) + shape, dtype=np.float32) if need_noise else None
        for bi, s in enumerate(seeds):
            rng = create_rng(self.rng_type, s)
            init_noise[bi] = rng.randn_shape(shape)
            srng = rng
            if self.sampler_rng_type and self.sampler_rng_type != self.rng_type:
                srng = create_rng(self.sampler_rng_type, s)
            if need_noise and gp.sample_method == "dpm++2m_sde_bt":
                step_noise[:, bi] = brownian_step_noise(srng, shape, sigmas)
            elif need_noise:
                for si in range(steps):
                    step_noise[si, bi] = srng.randn_shape(shape)
        x = np.asarray(self.denoiser.noise_scaling(np.float32(sigmas[0]), init_noise, x0),
                       dtype=np.float32)

        guidance = None
        if self.uses_distilled_guidance:
            guidance = torch.full((bc,), gp.guidance, dtype=torch.float32, device=dev)
        if self.free_params_immediately:
            self.free_conditioner_params()

        # the guidance extensions: the SLG step window, APG, the schedule
        slg = apg = None
        if gp.slg_scale != 0.0 and has_uncond:
            if self._slg_supported():
                i0, i1 = slg_active_steps(steps, gp.slg_start, gp.slg_end)
                slg = (float(gp.slg_scale), tuple(gp.skip_layers), i0, i1)
            else:
                warnings.warn(f"SLG: {self.version.value} has no skip_layers support; ignoring "
                              "slg_scale")
        apg_params = APGParams(eta=gp.apg_eta, momentum=gp.apg_momentum,
                               norm_threshold=gp.apg_norm_threshold,
                               norm_threshold_smoothing=gp.apg_norm_smoothing)
        if apg_params.enabled and has_uncond and not video:
            apg = apg_params
        cfg = gp.cfg_scale
        sched = parse_guidance_schedule(schedule)
        if sched:
            cfg = [sched[min(i, len(sched) - 1)] for i in range(steps)]

        c_concat, img_uncond_concat = concat
        # separate image guidance: under CFG, where the model takes concat
        # channels and img_cfg_scale differs from cfg_scale
        img_cfg = (gp.img_cfg_scale if has_uncond and img_uncond_concat is not None
                   and gp.img_cfg_scale is not None
                   and float(gp.img_cfg_scale) != float(gp.cfg_scale) else None)
        ts0 = time.time()
        model_fn = self._model_fn(ctx_c, ctx_u, y_c, y_u, cfg, guidance, bc,
                                  denoise_mask, masked_target, c_concat, img_uncond_concat,
                                  None if img_cfg is None else float(img_cfg), apg=apg, slg=slg)
        cached = None
        if step_cache is not None:
            model_fn = cached = make_step_cache(step_cache, model_fn, self.denoiser, steps,
                                                **(cache_options or {}))

        def step_callback(i, xi):
            if cancel_check is not None and cancel_check():
                return False
            if progress_callback is not None and progress_callback(i + 1, steps, xi) is False:
                return False
            return True

        latents = sample(model_fn, torch.from_numpy(x).to(dev), sigmas, method=gp.sample_method,
                         noises=step_noise, eta=gp.eta, is_flow=self.denoiser.is_flow,
                         step_callback=step_callback, extra_args=extra_args)
        latents = self.denoiser.inverse_noise_scaling(
            torch.tensor(sigmas[-1], device=dev), latents).float()
        _sync(dev)
        return (latents, seeds, t_cond, time.time() - ts0, steps,
                None if cached is None else cached.steps_skipped)

    def _concat_latents(self, gp: GenerationParams, init_image, mask_image, ref_images):
        """The inpainting and instruct-pix2pix UNets' extra input channels, as
        the JAX pipeline builds them → (c_concat, img_uncond_concat), each
        [1, h, w, C] float32 on the device, or (None, None) for any other
        model.  Inpainting: [mask, masked image's latent], the mask rounded,
        scaled to [0, 1] and nearest-downsampled (ones without a mask), the
        masked image (1 - mask)·(image - 0.5) + 0.5 in [0, 1] (zeros without
        an init image); its image-guidance form zeroes the latent.
        pix2pix: the latent of ``ref_images[0]`` (else of the init image,
        else zeros), resized bilinearly to the request's latent; zeros for
        image guidance."""
        lh, lw = gp.height // self.scale_factor, gp.width // self.scale_factor
        zeros = torch.zeros((1, lh, lw, self.latent_channels), device=self.device)
        if sd_version_is_inpaint(self.version):
            if mask_image is not None:
                mask_full = np.round(np.asarray(mask_image, dtype=np.float32))
                if mask_full.max() > 1.0:
                    mask_full = mask_full / 255.0
                sf = self.scale_factor
                lm = mask_full[::sf, ::sf][None, :lh, :lw, None]
            else:
                mask_full = np.ones((gp.height, gp.width), dtype=np.float32)
                lm = np.ones((1, lh, lw, 1), dtype=np.float32)
            lm = torch.from_numpy(np.ascontiguousarray(lm, dtype=np.float32)).to(self.device)
            masked_latent = zeros
            if init_image is not None:
                im01 = (_to_pm1(init_image) + 1.0) / 2.0
                masked = (1.0 - mask_full[..., None]) * (im01 - 0.5) + 0.5
                # as the JAX pipeline: the [-1, 1] image goes through the
                # encoder's [0, 1] → [-1, 1] mapping once more
                masked_latent = self._encode(masked * 2.0 - 1.0)
            return torch.cat([lm, masked_latent], dim=-1), torch.cat([lm, zeros], dim=-1)
        if sd_version_is_unet_edit(self.version):
            src = ref_images[0] if ref_images else init_image
            edit = zeros
            if src is not None:
                edit = self._encode(src)
                if tuple(edit.shape[1:3]) != (lh, lw):
                    edit = resize_latents(edit, lh, lw)
            return edit, zeros
        return None, None

    @torch.inference_mode()
    def generate(self, gp: GenerationParams, init_image=None, mask_image=None, init_latent=None,
                 ref_images=None, progress_callback: Optional[Callable] = None,
                 cancel_check: Optional[Callable] = None, step_cache: Optional[str] = None,
                 cache_options: Optional[dict] = None) -> GenerationResult:
        """txt2img, or img2img from ``init_image`` ([H,W,3] uint8 or float in
        [0, 1]) or ``init_latent`` ([1 or B, h, w, zc], scaled) with
        ``gp.strength``, masked by ``mask_image`` ([H,W]: 1 regenerate, 0
        keep; on an inpainting UNet it goes into the model's input instead):
        conditioning → sampling (CFG when cfg_scale != 1; image guidance at
        ``gp.img_cfg_scale`` on the inpainting and pix2pix UNets) → (tiled)
        VAE decode.  ``ref_images``: the pix2pix UNets' edit image (the
        first; any other model raises).  progress_callback(step, steps, x)
        after each step (False stops); cancel_check() before it (True
        stops).  ``step_cache`` (``easycache``, ``ucache``, ``taylorseer``,
        ``spectrum``, ``dbcache`` / ``cache_dit``) with ``cache_options``
        (its config's fields) skips forwards; ``last_timings`` then adds
        ``cache_skipped``."""
        if ref_images is not None and not sd_version_is_unet_edit(self.version):
            raise NotImplementedError(
                f"generate(ref_images=...) on {self.version.name}: the port takes reference "
                "images on the instruct-pix2pix UNets (SD1_PIX2PIX, SDXL_PIX2PIX) only")
        t0 = time.time()
        lh, lw = gp.height // self.scale_factor, gp.width // self.scale_factor
        timings = {}
        encoded = init_image is not None and init_latent is None
        if encoded:
            init_latent = self._encode(init_image)
        elif init_latent is not None:
            init_latent = torch.as_tensor(np.asarray(init_latent, dtype=np.float32))
        concat = self._concat_latents(gp, init_image, mask_image, ref_images)
        if sd_version_is_inpaint(self.version):
            mask_image = None  # the inpainting UNet takes the mask in its input: no blend
        if encoded or (concat[0] is not None and (init_image is not None or ref_images)):
            _sync(self.device)
            timings["encode"] = time.time() - t0
        latents, seeds, t_cond, t_sample, steps, skipped = self._denoise(
            gp, (lh, lw, self.latent_channels), (lh // 2) * (lw // 2), progress_callback,
            cancel_check, init_latent=init_latent, mask_image=mask_image, concat=concat,
            step_cache=step_cache, cache_options=cache_options)
        if skipped is not None:
            timings["cache_skipped"] = skipped
        t1 = time.time()
        imgs = self.decode(latents).cpu().numpy()
        lat_np = latents.cpu().numpy()
        images = np.clip((imgs + 1.0) * 127.5, 0, 255).round().astype(np.uint8)
        t2 = time.time()
        self.last_timings = {
            "cond": t_cond, "sample": t_sample, "decode": t2 - t1,
            "total": t2 - t0, "steps": steps, **timings,
        }
        return GenerationResult(images=images, latents=lat_np, seeds=seeds)

    def img2img(self, gp: GenerationParams, init_image, mask_image=None) -> GenerationResult:
        """init_image: [H,W,3] uint8 or float in [0, 1]; mask: [H,W] (1 =
        regenerate, 0 = keep)."""
        return self.generate(gp, init_image=init_image, mask_image=mask_image)

    def txt2img_hires(self, gp: GenerationParams, hires_scale: float = 2.0,
                      hires_steps: Optional[int] = None, hires_strength: float = 0.7,
                      upscaler: str = "latent", hires_width: int = 0, hires_height: int = 0,
                      hires_sigmas: str = "") -> GenerationResult:
        """Hires fix: the base request → its latents resized to the target
        (``hires_width`` / ``hires_height``, else ``hires_scale`` times the
        base size, rounded down to the scale factor) → an img2img pass there
        at ``hires_strength`` with ``hires_steps`` (the base's when None) and
        ``hires_sigmas``.  Only the latent upscaler is ported: an ESRGAN
        upscaler raises by name."""
        if upscaler != "latent":
            raise NotImplementedError(f"txt2img_hires(upscaler={upscaler!r}): ESRGAN is not "
                                      "ported; the port runs the latent upscaler")
        base = self.generate(gp)
        sf = self.scale_factor
        tw = (hires_width or int(gp.width * hires_scale)) // sf * sf
        th = (hires_height or int(gp.height * hires_scale)) // sf * sf
        gp2 = dataclasses.replace(gp, width=tw, height=th,
                                  sample_steps=hires_steps or gp.sample_steps,
                                  strength=hires_strength, custom_sigmas=hires_sigmas)
        return self.generate(gp2, init_latent=resize_latents(torch.from_numpy(base.latents), th // sf,
                                                             tw // sf))

    @torch.inference_mode()
    def generate_video(self, gp: GenerationParams, frames: int = 81, init_image=None,
                       high_noise_params=None, control_frames=None, preview_callback=None,
                       progress_callback: Optional[Callable] = None, **unported) -> VideoResult:
        """txt2vid for one GenerationParams: ``frames`` rounded down to
        1 + ``temporal_scale``·k (the causal VAE's), the noise drawn per batch
        item at [Tl, h, w, C], sampling as ``generate`` (CFG batched;
        ``progress_callback`` as there), then the (spatially and temporally
        tiled) video decode.  ``last_timings``
        adds ``frames``.  I2V (``init_image``), the Wan2.2 MoE
        (``high_noise_params`` and the ``high_noise_*`` / ``moe_boundary``
        options), VACE (``control_frames``) and ``preview_callback`` are not
        ported and raise by name."""
        for name, value in (("init_image", init_image), ("high_noise_params", high_noise_params),
                            ("control_frames", control_frames),
                            ("preview_callback", preview_callback), *unported.items()):
            if value is not None:
                raise NotImplementedError(f"generate_video({name}=...) is not ported; the port "
                                          "runs txt2vid")
        t0 = time.time()
        lh, lw = gp.height // self.scale_factor, gp.width // self.scale_factor
        ts = self.temporal_scale
        frames = max(1, ((frames - 1) // ts) * ts + 1)
        tl = (frames - 1) // ts + 1
        latents, seeds, t_cond, t_sample, steps, _ = self._denoise(
            gp, (tl, lh, lw, self.latent_channels), tl * (lh // 2) * (lw // 2), progress_callback,
            None, video=True)
        t1 = time.time()
        vid = self.decode(latents).cpu().numpy()
        lat_np = latents.cpu().numpy()
        frames_u8 = np.clip((vid + 1.0) * 127.5, 0, 255).round().astype(np.uint8)
        t2 = time.time()
        self.last_timings = {
            "cond": t_cond, "sample": t_sample, "decode": t2 - t1,
            "total": t2 - t0, "steps": steps, "frames": frames,
        }
        return VideoResult(frames=frames_u8, latents=lat_np, seeds=seeds)
