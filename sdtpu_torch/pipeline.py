"""txt2img pipeline for FLUX, SD1.x, SDXL and SD3, and txt2vid for Wan2.1
T2V (counterpart of the txt2img and T2V parts of ``sdtpu/pipeline.py``:
``DiffusionPipeline.generate``, ``generate_video``, ``VideoResult``,
``txt2img``, ``set_vae_tiling`` with its temporal windows, ``set_tae``, the
tiled decode and ``_match_context``).

Samplers: ``sdtpu_torch.diffusion.samplers.PORTED_METHODS``; at ``eta > 0``
an ancestral sampler's per-step noise (and ``lcm``'s at any ``eta``)
follows the initial noise in each batch item's ``rng`` stream, as the JAX
pipeline draws it.  The latent's channels and the schedule come from the
model (FLUX's 16-channel flow latent, SD1's and SDXL's 4-channel eps latent
on the DDPM table, SD3's 16-channel latent on the discrete flow schedule);
SD1 has no pooled vector (``y``), SDXL's is the pooled CLIP-G output with
the size embeddings of the request's width and height, SD3's the pooled
CLIP-L and CLIP-G outputs; only FLUX has distilled guidance.  Skip-Layer
Guidance (``slg_scale`` under CFG) is not ported and raises by name on
every family; without CFG it is ignored, as the JAX pipeline ignores it.
``set_tae`` swaps the final decode for a TAESD decoder.  Of
``extra_sample_args`` the port runs ``lcm``'s
``noise_scale_start`` / ``noise_scale_end``; any other key raises by
name.  ``generate`` takes the JAX pipeline's
``progress_callback(step, steps, x)`` and ``cancel_check()`` (a server
job's progress and cancellation): both run after each step, and a cancelled
request decodes the latents it reached.

Takes this package's ``sdtpu_torch.config.GenerationParams`` (the fields
and defaults of the JAX package's).  The initial noise comes from
``sdtpu_torch.rng`` (Philox in numpy, or torch's CPU generator), drawn per batch item
exactly as the JAX pipeline draws it, so both packages start from the same
latent.  Phase wall-clock times of the last call land in
``last_timings`` (``cond``, ``sample``, ``decode``, ``total``, ``steps``;
``frames`` for a video); each phase ends in a device synchronize.  A video's
latent is [B, Tl, h, w, C], Tl = 1 + (frames - 1) / ``temporal_scale``.  ``last_t5_ids`` holds the padded
ids T5 was fed for the last prompt (all zero without a T5 tokenizer).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.diffusion.guidance import cfg_combine
from sdtpu_torch.diffusion.samplers import method_needs_noise, sample
from sdtpu_torch.diffusion.schedule import get_sigmas
from sdtpu_torch.models.tiling import tiled_decode, tiled_decode_temporal
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


# the keys of ``extra_sample_args`` the port's samplers read
SAMPLER_KEYS = ("noise_scale_start", "noise_scale_end")


def _sampler_extra_args(spec: str) -> Dict[str, float]:
    """``extra_sample_args`` ("key=value,...") → the sampler keys as floats,
    as the JAX pipeline parses them; a key the port does not run raises."""
    out = {}
    for part in (spec or "").split(","):
        if "=" not in part:
            continue
        k, v = (t.strip() for t in part.split("=", 1))
        if k not in SAMPLER_KEYS:
            raise NotImplementedError(f"extra_sample_args key {k!r} is not ported; "
                                      f"ported: {list(SAMPLER_KEYS)}")
        out[k] = float(v)
    return out


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
                 uses_distilled_guidance: bool = False, device="cuda", temporal_scale: int = 1):
        self.version = version
        self.diffusion_params = diffusion_params
        self.diffusion_fn = diffusion_fn
        self.conditioner = conditioner
        self.vae_params = vae_params
        self.vae_decode_fn = vae_decode_fn
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

    def _vae_dtype(self) -> torch.dtype:
        for v in self.vae_params.values():
            if v.is_floating_point():
                return v.dtype
        return self.compute_dtype

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

    def _model_fn(self, ctx_c, ctx_u, y_c, y_u, cfg_scale: float, guidance, b: int):
        denoiser = self.denoiser
        has_uncond = ctx_u is not None
        dev = self.device

        def model_fn(xt, sigma, i):
            c_skip, c_out, c_in = denoiser.get_scalings_torch(sigma)
            t = denoiser.sigma_to_t_torch(sigma)
            x_in = (xt * c_in).to(self.compute_dtype)
            if has_uncond:
                x_both = torch.cat([x_in, x_in], dim=0)
                ctx = torch.cat([ctx_c, ctx_u], dim=0)
                y = torch.cat([y_c, y_u], dim=0) if y_c is not None else None
                g = torch.cat([guidance, guidance], dim=0) if guidance is not None else None
                tt = t.reshape(1).expand(2 * b).to(torch.float32)
                out = self.diffusion_fn(self.diffusion_params, x_both, tt, ctx, y,
                                        guidance=g).float()
                den_both = c_skip * torch.cat([xt, xt], dim=0) + c_out * out
                den_cond, den_uncond = den_both[:b], den_both[b:]
                pred = cfg_combine(den_cond, den_uncond, None,
                                   torch.tensor(cfg_scale, dtype=torch.float32, device=dev))
            else:
                tt = t.reshape(1).expand(b).to(torch.float32)
                out = self.diffusion_fn(self.diffusion_params, x_in, tt, ctx_c, y_c,
                                        guidance=guidance).float()
                pred = c_skip * xt + c_out * out
                den_uncond = pred
            return pred, den_uncond

        return model_fn

    def _denoise(self, gp: GenerationParams, shape: tuple, image_seq_len: int,
                  progress_callback: Optional[Callable], cancel_check: Optional[Callable]):
        """Conditioning, then sampling from the initial noise of ``shape``
        (one batch item's latent) → (latents on the device, float32; seeds;
        cond seconds; sample seconds; steps)."""
        if gp.custom_sigmas:
            raise NotImplementedError("custom sigmas are not ported yet")
        dev = self.device
        w, h = gp.width, gp.height
        bc = gp.batch_count
        has_uncond = gp.cfg_scale != 1.0

        extra_args = _sampler_extra_args(gp.extra_sample_args)
        if gp.slg_scale != 0.0 and has_uncond:
            raise NotImplementedError("skip-layer guidance (slg_scale) is not ported")
        tc0 = time.time()
        cond = self.conditioner.get_learned_condition(gp.prompt, clip_skip=gp.clip_skip, width=w,
                                                      height=h)
        self.last_t5_ids = cond.t5_ids
        uncond = (self.conditioner.get_learned_condition(gp.negative_prompt, clip_skip=gp.clip_skip,
                                                         width=w, height=h)
                  if has_uncond else None)
        _sync(dev)
        t_cond = time.time() - tc0
        ctx_c, ctx_u = _match_context(cond.c_crossattn,
                                      uncond.c_crossattn if uncond is not None else None, bc)
        y_c = _tile(cond.c_vector, bc)
        y_u = _tile(uncond.c_vector, bc) if uncond is not None else None

        sigmas = get_sigmas(self.denoiser, gp.sample_steps, scheduler=gp.schedule,
                            image_seq_len=image_seq_len)
        steps = len(sigmas) - 1

        # per-batch streams: latent noise, then the sampler's per-step noise
        seeds = [gp.seed + i for i in range(bc)]
        init_noise = np.empty((bc,) + shape, dtype=np.float32)
        need_noise = method_needs_noise(gp.sample_method, gp.eta)
        step_noise = np.empty((steps, bc) + shape, dtype=np.float32) if need_noise else None
        for bi, s in enumerate(seeds):
            rng = create_rng(self.rng_type, s)
            init_noise[bi] = rng.randn_shape(shape)
            if need_noise:
                for si in range(steps):
                    step_noise[si, bi] = rng.randn_shape(shape)
        x0 = np.zeros((bc,) + shape, dtype=np.float32)
        x = np.asarray(self.denoiser.noise_scaling(np.float32(sigmas[0]), init_noise, x0),
                       dtype=np.float32)

        guidance = None
        if self.uses_distilled_guidance:
            guidance = torch.full((bc,), gp.guidance, dtype=torch.float32, device=dev)

        ts0 = time.time()
        model_fn = self._model_fn(ctx_c, ctx_u, y_c, y_u, gp.cfg_scale, guidance, bc)

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
        return latents, seeds, t_cond, time.time() - ts0, steps

    @torch.inference_mode()
    def generate(self, gp: GenerationParams, progress_callback: Optional[Callable] = None,
                 cancel_check: Optional[Callable] = None) -> GenerationResult:
        """txt2img for one GenerationParams: conditioning → sampling (CFG
        when cfg_scale != 1) → (tiled) VAE decode.  progress_callback(step, steps, x) after each step (False
        stops); cancel_check() before it (True stops)."""
        t0 = time.time()
        lh, lw = gp.height // self.scale_factor, gp.width // self.scale_factor
        latents, seeds, t_cond, t_sample, steps = self._denoise(
            gp, (lh, lw, self.latent_channels), (lh // 2) * (lw // 2), progress_callback,
            cancel_check)
        t1 = time.time()
        imgs = self.decode(latents).cpu().numpy()
        lat_np = latents.cpu().numpy()
        images = np.clip((imgs + 1.0) * 127.5, 0, 255).round().astype(np.uint8)
        t2 = time.time()
        self.last_timings = {
            "cond": t_cond, "sample": t_sample, "decode": t2 - t1,
            "total": t2 - t0, "steps": steps,
        }
        return GenerationResult(images=images, latents=lat_np, seeds=seeds)

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
        latents, seeds, t_cond, t_sample, steps = self._denoise(
            gp, (tl, lh, lw, self.latent_channels), tl * (lh // 2) * (lw // 2), progress_callback,
            None)
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
