"""sd-cli for the PyTorch/CUDA port: FLUX.1, SD1.x, SD2.x, SDXL, SD3,
Z-Image and Qwen-Image txt2img, img2img, masked img2img and the latent
hires fix, the
inpainting and instruct-pix2pix UNets, and Wan2.1 T2V txt2vid from
checkpoint files (this package's copy of ``sdtpu/cli.py``: ``build_parser``,
``main``, the FLUX, SD1, SD2, SDXL, SD3, Wan, Z-Image and Qwen-Image parts of
``_load_pipeline`` with its ``--prediction`` override and the LLM
tokenizer's choice (``sidecar_free_llm_tokenizer``), ``_img_gen`` with ``-i`` / ``--mask`` /
``--hires`` / ``-r`` / ``--img-cfg-scale``, the T2V part of ``_vid_gen``,
``--taesd``, ``--flow-shift``, the metadata mode,
``discover_gguf_tokenizer``).

    python -m sdtpu_torch.cli --diffusion-model flux1-dev-q8_0.gguf \
        --clip_l clip_l.safetensors --t5xxl t5xxl-q8_0.gguf --vae ae.safetensors \
        -p "a lantern on a wooden table" -W 1024 -H 1024 --steps 20 -o out.png
    python -m sdtpu_torch.cli -m sd15.safetensors -p "an astronaut riding a horse" \
        -W 512 -H 512 --steps 20 -o out.png
    python -m sdtpu_torch.cli -m sdxl.safetensors --taesd taesdxl.safetensors \
        -p "an astronaut riding a horse" -W 1024 -H 1024 --steps 4 --cfg-scale 1 \
        --sampling-method lcm -o out.png
    python -m sdtpu_torch.cli -m sd3.5_medium.safetensors --clip_l clip_l.safetensors \
        --clip_g clip_g.safetensors --t5xxl t5xxl-q8_0.gguf -p "an astronaut riding a horse" \
        -n blurry -W 1024 -H 1024 --steps 28 --cfg-scale 4.5 --sampling-method dpm++2m -o out.png
    python -m sdtpu_torch.cli -M vid_gen --diffusion-model wan2.1_t2v_1.3B_fp16.safetensors \
        --vae wan_2.1_vae.safetensors --t5xxl umt5-xxl-enc-q8_0.gguf -p "a corgi running on a beach" \
        -n static -W 832 -H 480 --video-frames 33 --steps 8 --cfg-scale 6 --sampling-method euler \
        --vae-tiling --vae-tile-size 32 --vae-temporal-tiling \
        --extra-tiling-args temporal_tile_frames=5,temporal_tile_overlap=1 -o clip.png
    python -m sdtpu_torch.cli --diffusion-model z_image_turbo-q8_0.gguf \
        --llm Qwen3-4B-q4_0.gguf --vae ae.safetensors -p "a red fox in fresh snow" \
        -W 1024 -H 1024 --steps 8 --cfg-scale 1 --sampling-method euler -o out.png
    python -m sdtpu_torch.cli --diffusion-model qwen-image-q4_0.gguf \
        --llm Qwen2.5-VL-7B-q4_0.gguf --vae wan_2.1_vae.safetensors -p "a red fox in fresh snow" \
        -n blurry -W 1024 -H 1024 --steps 20 --cfg-scale 2.5 --sampling-method euler -o out.png
    python -m sdtpu_torch.cli -m sd15.safetensors -p "a watercolour harbour" -i init.png \
        --mask mask.png --strength 0.6 -W 512 -H 512 --steps 20 -o out.png
    python -m sdtpu_torch.cli -m sd15.safetensors -p "a watercolour harbour" -W 512 -H 512 \
        --steps 20 --hires --hires-scale 2 --hires-denoising-strength 0.7 -o out.png
    python -m sdtpu_torch.cli -m v2-1_768-ema-pruned.safetensors --prediction v \
        -p "a lighthouse at dusk" -n blurry -W 768 -H 768 --steps 20 --sampling-method heun \
        -o out.png
    python -m sdtpu_torch.cli -m sd-v1-5-inpainting.safetensors -p "a red sofa" -i room.png \
        --mask mask.png --strength 1.0 -o out.png
    python -m sdtpu_torch.cli -m instruct-pix2pix.safetensors -p "make it snow" -r photo.png \
        --cfg-scale 7.5 --img-cfg-scale 1.5 -o out.png
    python -m sdtpu_torch.cli metadata --image out.png

The model family is fingerprinted from the files' tensor names, as the JAX
CLI does; FLUX.1, SD1.x, SD2.x, SDXL (with their inpainting and
instruct-pix2pix UNets), SD3, Wan2.1 T2V, Z-Image and Qwen-Image load, any
other family (Mage-Flow and the layered Qwen-Image among them) exits naming
it; so do ``--qwen-image-layers`` and the ``qwen_image_zero_cond_t`` model
arg.  Z-Image's Qwen3 and Qwen-Image's Qwen2.5-VL text encoders (``--llm``)
tokenize with
``--llm-tokenizer``'s ``tokenizer.json``, else the vocab embedded in the
``--llm`` (or ``-m``) GGUF, else the Qwen byte-level ids without merges
(``Qwen2Tokenizer.byte_fallback``, with a warning).  ``--prediction`` swaps the denoiser as the JAX CLI does
(``eps``, ``v`` for an SD2.x-v checkpoint, ``edm_v``, ``flow``,
``flux_flow``; the SeFi / MiniT2I flows exit 2).  On an inpainting UNet
``-i`` / ``--mask`` go into the model's input; on a pix2pix UNet ``-r``
names the edit image (else ``-i``'s) and ``--img-cfg-scale`` its guidance;
``-r`` on any other model exits 2.  The parser is the JAX CLI's (the
same flags, defaults and help).
The port runs three modes, ``img_gen`` (txt2img; img2img with ``-i``,
``--strength`` and ``--mask``, the mask being channel 0 of its PNG; the
hires fix with ``--hires`` and the ``Latent`` upscaler; custom sigmas with
``--sigmas`` / ``--hires-sigmas``; init images and masks are PNGs),
``vid_gen`` (txt2vid on
Wan2.1: one PNG a frame, ``name_0000.png``... for ``-o name.png``; the AVI,
WebP, GIF and WebM containers, the default ``output.avi`` among them, need
Pillow's JPEG / WebP encoders and exit 2) and ``metadata``, and the flags in
``RUN_FLAGS``; any other mode or flag set away from its default (e.g.
``--control-net``), a sampler outside ``samplers.PORTED_METHODS`` (SeFi's
``sefi_euler``) or a schedule outside ``schedule.SCHEDULERS`` exits with
code 2 before anything loads, naming it.  ``<lora:name:mult>`` prompt tags
run as in the JAX CLI: ``name`` + ``.safetensors``, ``.ckpt`` or ``.pt``
from ``--lora-model-dir``, applied by ``--lora-apply-mode`` to the
pipeline's live diffusion and CLIP weights (``lora NAME: applied a/t
tensors xM``; a name with no file warns); ``vid_gen`` drops the tags.
``--embd-dir`` loads every embedding file of the directory under its stem
as the trigger word (SD1.x and SD2.x).  A model or LoRA file may be a torch
``.ckpt`` / ``.pt`` (``io.torch_ckpt``'s restricted unpickler).  The sampling flags run as in the
JAX CLI: every schedule, ``--skip-layers`` / ``--slg-*`` (on FLUX, SD3 and
Wan; a warning elsewhere), ``--apg-*``, ``--extra-sample-args``
(``guidance_schedule`` and the JAX pipeline's sampler keys; any other key
is dropped),
``--sampler-rng``, and ``--cache`` / ``--cache-mode`` with
``--cache-option``, ``--scm-mask`` and ``--scm-policy`` on ``img_gen``
without ``--hires``; as in the JAX CLI, ``vid_gen`` passes none of the
guidance flags, ``--extra-sample-args`` or ``--cache`` on.

Device: ``--backend`` as the JAX CLI spells it, one device for every module:
``cpu`` or ``cuda0``..``cudaN`` (a per-module split exits 2).  With no
``--backend`` the port runs on the GPU, and raises where there is none.
The dtype is bf16 on the GPU and float32 on the CPU unless ``--dtype`` says
otherwise.  q8_0 blocks of a GGUF diffusion model are re-quantized per row
onto the W8A8 kernels unless ``--no-promote-q8`` (or ``--type q4_0``);
other quantized diffusion blocks are kept (``--no-keep-quant`` dequantizes
them); a quantized text encoder is dequantized on the host, one tensor at a
time.  ``--type q8_0|q4_0`` quantizes the dense diffusion weights at load
as the JAX CLI does (``ops.quant.quantize_params``: per-row int8 on the
W8A8 kernels, or packed 4-bit), and ``--type q8_0`` promotes a q8_0 GGUF's
blocks per row even under ``--no-promote-q8``.  Images are
PNGs with the webui ``parameters`` text.  ``--taesd`` attaches a TAESD
decoder (raw ``taesd`` names, its variant by the model's version) for the
final decode; ``--taesd-preview-only`` is not ported (the port has no
preview).  ``--flow-shift`` sets SD3's, Wan's and Z-Image's flow shift (3.0, 5.0 and
3.0 by default) and, as in the JAX CLI, changes nothing for the other families.
``--vae-temporal-tiling`` (or ``--temporal-tiling``) windows a video decode
over latent frames, sized by ``--extra-tiling-args
temporal_tile_frames=N,temporal_tile_overlap=M``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Optional

from sdtpu_torch.utils.image import VIDEO_CONTAINERS

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sdtpu_torch",
                                 description="stable diffusion on an NVIDIA GPU (PyTorch/CUDA)")
    from sdtpu_torch import __version__

    ap.add_argument("--version", action="version",
                    version=f"sdtpu_torch {__version__}")
    ap.add_argument("mode", nargs="?", default="img_gen",
                    choices=["img_gen", "vid_gen", "adetailer", "convert",
                             "upscale", "metadata"])
    ap.add_argument("-M", "--mode", dest="mode_flag", default=None,
                    choices=["img_gen", "vid_gen", "adetailer", "convert",
                             "upscale", "metadata"],
                    help="run mode (reference -M/--mode; same as the "
                    "positional)")
    # model files (reference sd_ctx_params)
    ap.add_argument("-m", "--model", help="full checkpoint (safetensors/gguf/ckpt)")
    ap.add_argument("--diffusion-model", help="standalone diffusion model file")
    ap.add_argument("--clip_l", help="clip-l text encoder file")
    ap.add_argument("--clip_g", help="clip-g text encoder file")
    ap.add_argument("--t5xxl", help="t5xxl text encoder file")
    ap.add_argument("--t5-tokenizer", help="t5 tokenizer.json path")
    ap.add_argument("--llm", "--qwen2vl", dest="llm",
                    help="decoder-LLM text encoder file (qwen/gemma); --qwen2vl is the reference's deprecated alias")
    ap.add_argument("--llm-tokenizer", help="LLM tokenizer.json path")
    ap.add_argument("--audio-vae", help="LTX audio VAE + vocoder file")
    ap.add_argument("--vae", help="vae file")
    ap.add_argument("--taesd", "--tae", dest="taesd", help="taesd file (fast decode)")
    ap.add_argument("--vae-tiling", action="store_true",
                    help="tile VAE encode/decode (low-memory hires)")
    ap.add_argument("--vae-tile-size", type=int, default=64, help="latent units")
    ap.add_argument("--vae-tile-overlap", type=int, default=8)
    ap.add_argument("--vae-temporal-tiling", action="store_true",
                    help="window the video VAE decode over latent frames "
                    "(reference sd_tiling_params_t.temporal_tiling)")
    ap.add_argument("--extra-tiling-args", default="",
                    help="key=value,... tiling escape hatch (reference "
                    "extra_tiling_args): temporal_tile_frames=, "
                    "temporal_tile_overlap=")
    ap.add_argument("--stream-weights", "--stream-layers", dest="stream_weights",
                    nargs="?", const="host", default=False,
                    choices=["host", "disk"],
                    help="stream diffusion block weights per layer (>HBM "
                    "models; reference --stream-layers): 'host' keeps them "
                    "in host RAM, 'disk' reads them from the checkpoint "
                    "mmap per use (ResidencyMode::Disk — neither HBM nor "
                    "host RSS holds the full model). Wan/FLUX/Hunyuan/LTX.")
    ap.add_argument("--stream-cache-gib", type=float, default=0.0,
                    help="host-RAM LRU budget (GiB) for decoded blocks in "
                    "disk streaming mode (0 = re-read per use)")
    ap.add_argument("--motion-module",
                    help="AnimateDiff motion module for SD1.5 (reference "
                    "--motion-module); enables vid_gen on UNet checkpoints")
    ap.add_argument("--lora-model-dir", default="", help="dir for <lora:name:mult>")
    ap.add_argument("--embd-dir", default="", help="textual-inversion embeddings dir")
    # generation
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-n", "--negative-prompt", default="")
    ap.add_argument("-H", "--height", type=int, default=512)
    ap.add_argument("-W", "--width", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cfg-scale", type=float, default=7.0)
    ap.add_argument("--img-cfg-scale", type=float, default=None,
                    help="separate image guidance scale (pix2pix / ref-image models)")
    ap.add_argument("--guidance", type=float, default=3.5)
    ap.add_argument("--sampling-method", default="euler_a")
    ap.add_argument("--schedule", "--scheduler", dest="schedule", default="discrete")
    ap.add_argument("-s", "--seed", type=int, default=42)
    ap.add_argument("-b", "--batch-count", type=int, default=1)
    ap.add_argument("--qwen-image-layers", type=int, default=3,
                    help="layer count for QWEN_IMAGE_LAYERED checkpoints "
                    "(reference --qwen-image-layers)")
    ap.add_argument("--clip-skip", type=int, default=-1)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--strength", type=float, default=0.75)
    ap.add_argument("-i", "--init-img", help="img2img init image")
    ap.add_argument("--mask", help="inpaint mask image")
    ap.add_argument("--rng", default="cuda", choices=["cuda", "cpu", "std_default"])
    ap.add_argument("--sampler-rng", default=None,
                    choices=["cuda", "cpu", "std_default"],
                    help="separate sampler-noise RNG (reference "
                    "--sampler-rng); default: same stream as --rng")
    ap.add_argument("--control-net", help="controlnet checkpoint file")
    ap.add_argument("--control-image", help="control hint image")
    ap.add_argument("--control-strength", type=float, default=0.9)
    ap.add_argument("--canny", action="store_true",
                    help="apply canny preprocessing to the control image")
    ap.add_argument("--ip-adapter", help="ip-adapter checkpoint file")
    ap.add_argument("--ip-image", "--ip-adapter-image", dest="ip_image", help="ip-adapter reference image")
    ap.add_argument("-r", "--ref-image", action="append", default=[],
                    help="reference image (PiD low-quality input; repeatable)")
    ap.add_argument("--ip-scale", "--ip-adapter-strength", dest="ip_scale",
                    type=float, default=1.0)
    ap.add_argument("--clip-vision", help="CLIP vision encoder checkpoint (ip-adapter)")
    ap.add_argument("--photo-maker", help="PhotoMaker checkpoint (v1/v2)")
    ap.add_argument("--pm-id-images-dir", help="PhotoMaker input ID images dir")
    ap.add_argument("--pm-id-embed-path", help="PhotoMaker v2 insightface id embed file")
    ap.add_argument("--pm-style-strength", type=float, default=20.0)
    ap.add_argument("--pulid-weights", help="PuLID pulid_ca weights file")
    ap.add_argument("--pulid-id-embedding", help="PuLID id embedding file")
    ap.add_argument("--pulid-id-weight", type=float, default=1.0)
    ap.add_argument("--cache", "--cache-mode", dest="cache", default=None,
                    choices=["easycache", "ucache", "taylorseer", "spectrum",
                             "dbcache", "cache_dit"],
                    help="step cache: skip diffusion forwards (reference docs/caching.md)")
    ap.add_argument("--extra-sample-args", default="",
                    help="key=value,... sampler/guidance escape hatch "
                    "(reference --extra-sample-args): guidance_schedule="
                    "7.5x10+5x10, gamma=, alpha=, delta_t=, "
                    "noise_scale_start/end=, noise_clip_std=")
    ap.add_argument("--cache-option", default="",
                    help="key=value,... options for the step cache")
    ap.add_argument("--model-args", default="",
                    help="key=value,... model escape hatch (reference "
                    "--model-args): chroma_use_dit_mask=, chroma_use_t5_mask=,"
                    " chroma_t5_mask_pad=, qwen_image_zero_cond_t=")
    # adetailer mode
    ap.add_argument("--detector", help="yolov8 detector checkpoint (adetailer)")
    ap.add_argument("--ad-prompt", default=None, help="adetailer inpaint prompt")
    ap.add_argument("--ad-confidence", type=float, default=0.3)
    ap.add_argument("--ad-strength", type=float, default=0.4)
    ap.add_argument("--ad-option", "--extra-ad-args", dest="ad_option", default="",
                    help="extra adetailer args key=value,... (reference "
                    "extra_ad_args): sort_by/mask_k_largest/dilate_erode/"
                    "merge_masks/invert_mask/mask_blur/...")
    ap.add_argument("--slg-scale", type=float, default=0.0)
    ap.add_argument("--skip-layers", default="7,8,9")
    ap.add_argument("--slg-start", "--skip-layer-start", dest="slg_start",
                    type=float, default=0.01)
    ap.add_argument("--slg-end", "--skip-layer-end", dest="slg_end",
                    type=float, default=0.2)
    ap.add_argument("--apg-eta", type=float, default=1.0)
    ap.add_argument("--apg-momentum", type=float, default=0.0)
    ap.add_argument("--apg-nt", type=float, default=0.0, help="APG norm threshold")
    # video (vid_gen mode)
    ap.add_argument("--video-frames", type=int, default=81, help="frame count (1+4k)")
    ap.add_argument("--fps", type=int, default=16)
    ap.add_argument("--end-img", help="last-frame conditioning image (LTX FLF2V)")
    ap.add_argument("--no-audio", action="store_true",
                    help="skip audio generation for audio-video models (LTX-2)")
    ap.add_argument("--control-video", action="append", default=[],
                    help="VACE control frame image (repeatable, in order)")
    ap.add_argument("--vace-strength", type=float, default=1.0)
    ap.add_argument("--upscale-model",
                    help="upscaler checkpoint: ESRGAN for img_gen/upscale "
                    "modes (reference --upscale-model), LTX latent spatial "
                    "upsampler for vid_gen")
    # standalone upscale mode + post-generation ESRGAN pass
    # (reference cli/main.cpp:926-962, common.h:248-249)
    ap.add_argument("--upscale-repeats", type=int, default=1,
                    help="run the ESRGAN upscaler N times (reference "
                    "--upscale-repeats)")
    ap.add_argument("--upscale-tile-size", type=int, default=128,
                    help="ESRGAN tile size in pixels")
    # highres fix (reference common.h:255-264)
    ap.add_argument("--hires", action="store_true", help="enable highres fix")
    ap.add_argument("--hires-upscaler", default="Latent",
                    help="'Latent' or 'ESRGAN' (uses --upscale-model)")
    ap.add_argument("--hires-scale", type=float, default=2.0)
    ap.add_argument("--hires-width", type=int, default=0,
                    help="hires target width, 0 to use --hires-scale")
    ap.add_argument("--hires-height", type=int, default=0)
    ap.add_argument("--hires-steps", type=int, default=0,
                    help="hires pass steps, 0 = same as --steps")
    ap.add_argument("--hires-denoising-strength", type=float, default=0.7)
    ap.add_argument("--hires-sigmas", default="",
                    help="custom sigma schedule for the hires pass "
                    "(reference --hires-sigmas)")
    ap.add_argument("--flow-shift", type=float, default=None)
    ap.add_argument("--prediction", default=None,
                    choices=["eps", "v", "edm_v", "flow", "flux_flow",
                             "sefi_flow", "minit2i_flow"],
                    help="override the prediction type / denoiser "
                    "(reference --prediction)")
    ap.add_argument("--ref-image-args", default="",
                    help="key=value,... reference-image routing overrides "
                    "(reference --ref-image-args): pass_to_vlm=, pass_to_dit=,"
                    " vlm_max_pixels=, vlm_min_pixels=")
    ap.add_argument("--disable-auto-resize-ref-image", action="store_true",
                    help="deprecated alias for --ref-image-args "
                    "resize_before_vae=off (reference common.cpp:2484-2487)")
    ap.add_argument("--sigmas", default="",
                    help="custom comma-separated sigma schedule (reference "
                    "--sigmas); overrides --schedule/--steps")
    ap.add_argument("--prompt-file", default=None,
                    help="read the prompt from a file (reference --prompt-file)")
    ap.add_argument("--negative-prompt-file", default=None)
    ap.add_argument("--clip-on-cpu", action="store_true",
                    help="keep the text encoder on the host CPU (reference "
                    "--clip-on-cpu; per-module placement)")
    ap.add_argument("--vae-on-cpu", action="store_true",
                    help="keep the VAE on the host CPU (reference --vae-on-cpu)")
    ap.add_argument("--circular", action="store_true",
                    help="seamless tiling on both axes (reference --circular)")
    ap.add_argument("--circularx", action="store_true",
                    help="seamless tiling on the x axis only")
    ap.add_argument("--circulary", action="store_true",
                    help="seamless tiling on the y axis only")
    ap.add_argument("--list-devices", action="store_true",
                    help="print available devices and exit (reference "
                    "--list-devices)")
    ap.add_argument("--type", dest="wtype", default=None,
                    choices=["q8_0", "q4_0"],
                    help="quantize large diffusion weights at load "
                    "(int8 W8A8 / packed 4-bit; reference --type). On an "
                    "already-quantized GGUF, q8_0 re-quantizes int8-class "
                    "blocks per-row onto the faster W8A8 MXU path")
    ap.add_argument("--auto-fit", type=float, default=None, metavar="GIB",
                    help="derive a memory plan for the given HBM budget and "
                    "apply it (quantize / VAE-tile / stream weights; "
                    "reference --auto-fit, backend_fit.h:12)")
    ap.add_argument("--max-vram", default=None, metavar="SPEC",
                    help="HBM budget for compute segmentation (reference "
                    "--max-vram graph-cut, common.cpp:504): GiB float, "
                    "'dev=GiB,...' spec, 0 disables, negative = auto-detect "
                    "free HBM minus |value| GiB headroom; bounds activations "
                    "by running cond/uncond forwards sequentially and "
                    "shrinking VAE decode tiles to fit")
    ap.add_argument("--no-keep-quant", action="store_true",
                    help="dequantize quantized GGUF weights to the compute "
                    "dtype instead of computing on the checkpoint's own "
                    "quant blocks (default keeps blocks, matching the "
                    "reference's end-to-end ggml types)")
    ap.add_argument("--no-promote-q8", action="store_true",
                    help="keep q8_0 GGUF blocks on the group-dequant matmul "
                    "path instead of the default per-row W8A8 re-quantization "
                    "(exact checkpoint numerics)")
    # Wan2.2 MoE (reference --high-noise-* family + --moe-boundary)
    ap.add_argument("--high-noise-diffusion-model",
                    help="Wan2.2 MoE high-noise expert checkpoint")
    ap.add_argument("--moe-boundary", type=float, default=0.875,
                    help="sigma boundary between high/low-noise experts")
    ap.add_argument("--high-noise-cfg-scale", type=float, default=None)
    ap.add_argument("--high-noise-sampling-method", default=None)
    ap.add_argument("--high-noise-eta", type=float, default=None)
    ap.add_argument("--high-noise-steps", type=int, default=None,
                    help="explicit phase split step (overrides --moe-boundary)")
    ap.add_argument("--high-noise-img-cfg-scale", type=float, default=None,
                    help="(high noise) image guidance scale (reference "
                    "--high-noise-img-cfg-scale, common.cpp:1133)")
    ap.add_argument("--high-noise-slg-scale", type=float, default=None,
                    help="(high noise) skip-layer guidance scale (reference "
                    "--high-noise-slg-scale)")
    ap.add_argument("--high-noise-skip-layers", default=None,
                    help="(high noise) comma-separated layers for SLG "
                    "(reference --high-noise-skip-layers; default: base "
                    "--skip-layers)")
    ap.add_argument("--high-noise-slg-start", "--high-noise-skip-layer-start",
                    dest="high_noise_slg_start", type=float, default=None)
    ap.add_argument("--high-noise-slg-end", "--high-noise-skip-layer-end",
                    dest="high_noise_slg_end", type=float, default=None)
    # output
    ap.add_argument("-o", "--output", default="output.png")
    ap.add_argument("--output-begin-idx", type=int, default=None,
                    help="starting index for output image sequences "
                    "(reference --output-begin-idx; works with printf-style "
                    "%%d patterns in -o)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--dtype", default=None, choices=["f32", "f16", "bf16"],
                    help="compute dtype (default: bf16 on the GPU, f32 on the CPU)")
    ap.add_argument("--preview", default="none", choices=["none", "proj", "tae", "vae"],
                    help="per-step latent preview mode (reference --preview)")
    ap.add_argument("--preview-interval", type=int, default=1)
    ap.add_argument("--preview-path", default="preview.png")
    ap.add_argument("--preview-noisy", action="store_true",
                    help="preview the noisy model inputs instead of the "
                    "denoised estimates (reference --preview-noisy)")
    ap.add_argument("--taesd-preview-only", action="store_true",
                    help="use --taesd only for previews, not the final "
                    "decode (reference --taesd-preview-only)")
    ap.add_argument("--no-progress", action="store_true",
                    help="disable the per-step progress bar (fastest path: "
                    "the whole sigma schedule runs as one on-device scan)")
    # convert mode
    ap.add_argument("--output-type", default="f16", help="convert: f32/f16/bf16/q8_0")
    ap.add_argument("--force-sdxl-vae-conv-scale", action="store_true",
                    help="guard the SDXL VAE against f16 overflow "
                    "(reference --force-sdxl-vae-conv-scale; here the VAE "
                    "is pinned to f32 instead of conv-weight rescaling)")
    ap.add_argument("--convert-name", action="store_true",
                    help="convert mode: canonicalize tensor names before "
                    "export (reference --convert-name)")
    ap.add_argument("--tensor-type-rules", default="",
                    help="convert: regex=type,... per-tensor quant overrides "
                    "(reference --tensor-type-rules); first matching pattern "
                    "wins, e.g. 'attn=q8_0,^first_stage=f16'")
    ap.add_argument("--imatrix-out", "--imat-out", dest="imatrix_out",
                    help="collect an importance matrix during img_gen and "
                    "save it (reference --imat-out)")
    ap.add_argument("--imatrix", "--imat-in", dest="imatrix",
                    action="append", default=None,
                    help="importance matrix .dat — quantizing conversion "
                    "weights, or continued collection with --imatrix-out; "
                    "repeatable, entries merge additively (reference "
                    "--imat-in)")
    ap.add_argument("--lora-apply-mode", default="auto",
                    choices=["auto", "immediately", "at_runtime"],
                    help="how LoRAs bind to weights (reference "
                    "--lora-apply-mode): auto = merge into dense bases / "
                    "runtime factors on quantized; immediately = always "
                    "fold (requantize on the weight's own grid); at_runtime "
                    "= always attach detachable low-rank factors")
    ap.add_argument("--vae-format", default="auto",
                    choices=["auto", "flux", "sd3", "flux2", "wan"],
                    help="latent-format override for PiD's LQ reference "
                    "encoder (reference --vae-format)")
    ap.add_argument("--backend", default="",
                    help="the device of every module: 'cpu' or 'cuda0'..'cudaN' "
                    "(default: the GPU; a per-module split is not ported)")
    ap.add_argument("--params-backend", default="",
                    help="per-module parameter residency, e.g. 'disk', "
                    "'cpu', or 'diffusion=disk,clip=cpu' (reference "
                    "--params-backend): diffusion=cpu/disk maps to "
                    "--stream-weights host/disk; other modules move to the "
                    "host device")
    ap.add_argument("--split-mode", default="row",
                    choices=["row", "layer"],
                    help="multi-device weight distribution (reference "
                    "--split-mode): on a TPU mesh both modes resolve to "
                    "GSPMD tensor-parallel NamedShardings (row); 'layer' is "
                    "accepted for compat (docs/performance.md#multi-chip)")
    ap.add_argument("--rpc-servers", default="",
                    help="reference --rpc-servers has no TPU analog — "
                    "multi-host runs use jax.distributed (see "
                    "docs/performance.md#multi-chip); passing this errors "
                    "with that pointer")
    ap.add_argument("--timestep-shift", type=int, default=0,
                    help="shifted timestep for NitroFusion models (reference "
                    "--timestep-shift; ~250 NitroSD-Realism, ~500 Vibrant)")
    ap.add_argument("--scm-mask", default="",
                    help="cache-dit SCM per-step compute mask, e.g. "
                    "1,1,1,0,0,1 (reference --scm-mask)")
    ap.add_argument("--scm-policy", default="", choices=["", "dynamic", "static"],
                    help="cache-dit SCM policy (reference --scm-policy)")
    ap.add_argument("--ad-negative-prompt", default=None,
                    help="adetailer inpaint negative prompt")
    ap.add_argument("--ad-model",
                    help="separate checkpoint for the adetailer inpaint pass "
                    "(reference --ad-model); defaults to the main model")
    ap.add_argument("--uncond-diffusion-model",
                    help="standalone unconditional diffusion model (Ideogram4 "
                    "CFG; reference --uncond-diffusion-model)")
    ap.add_argument("--embeddings-connectors",
                    help="LTX-AV embeddings connectors file (learned-register "
                    "text/audio refiners; reference --embeddings-connectors)")
    ap.add_argument("--vae-relative-tile-size", default="",
                    help="VAE tile size as [X]x[Y] fraction of the image "
                    "(<1) or tiles per dim (>=1); overrides --vae-tile-size")
    ap.add_argument("--hires-upscalers-dir", default="",
                    help="dir searched for --hires-upscaler model files")
    ap.add_argument("--disable-image-metadata", action="store_true",
                    help="do not embed generation parameters in output PNGs")
    # metadata-mode output options (reference cli/main.cpp:77,130-140)
    ap.add_argument("--image", default=None,
                    help="image to inspect in metadata mode (reference "
                    "--image, cli/main.cpp:72)")
    ap.add_argument("--metadata-format", default="text",
                    choices=["text", "json"],
                    help="metadata mode output format (reference "
                    "--metadata-format)")
    ap.add_argument("--metadata-brief", action="store_true",
                    help="truncate long metadata text values")
    ap.add_argument("--metadata-all", action="store_true",
                    help="include structural entries (IHDR, IDAT, JPEG "
                    "segments)")
    ap.add_argument("--metadata-raw", action="store_true",
                    help="include raw hex previews for unparsed payloads")
    ap.add_argument("--high-noise-guidance", type=float, default=None,
                    help="distilled guidance for the Wan2.2 high-noise phase")
    ap.add_argument("--hires-upscale-tile-size", type=int, default=256,
                    help="ESRGAN tile size for the hires-fix upscale pass "
                    "(reference --hires-upscale-tile-size)")
    ap.add_argument("--control-net-cpu", action="store_true",
                    help="keep the ControlNet on the host CPU (reference "
                    "--control-net-cpu; per-module placement)")
    ap.add_argument("--increase-ref-index", action="store_true",
                    help="index Kontext reference images 1..N in RoPE "
                    "instead of sharing index 1 (reference "
                    "--increase-ref-index)")
    # accepted-for-compat flags (no-ops on TPU)
    ap.add_argument("--fa", "--diffusion-fa", dest="fa", action="store_true",
                    help="flash attention (always on for eligible shapes on "
                    "TPU; accepted for reference-CLI compat)")
    ap.add_argument("--mmap", action="store_true",
                    help="mmap checkpoints (always on; compat no-op)")
    ap.add_argument("--threads", type=int, default=0,
                    help="ignored (XLA manages threading; compat no-op)")
    ap.add_argument("--offload-to-cpu", action="store_true",
                    help="compat: keep weights in host RAM — maps to "
                    "--stream-weights host on Wan/FLUX/Hunyuan/LTX")
    ap.add_argument("--eager-load", action="store_true",
                    help="load all params at model-load time (already the "
                    "default here; compat no-op)")
    ap.add_argument("--diffusion-conv-direct", action="store_true",
                    help="ggml conv2d-direct toggle; XLA picks conv "
                    "algorithms itself (compat no-op)")
    ap.add_argument("--vae-conv-direct", action="store_true",
                    help="ggml conv2d-direct toggle for the VAE (compat "
                    "no-op)")
    ap.add_argument("--color", action="store_true",
                    help="colorize log level tags (reference --color)")
    ap.add_argument("--temporal-tiling", dest="vae_temporal_tiling",
                    action="store_true",
                    help="alias of --vae-temporal-tiling (reference "
                    "--temporal-tiling)")
    return ap


# the flags the port runs (argparse dests); every other flag must keep its
# default
RUN_FLAGS = frozenset({
    "mode", "mode_flag",
    "model", "diffusion_model", "clip_l", "clip_g", "t5xxl", "vae", "taesd", "t5_tokenizer",
    "llm", "llm_tokenizer",
    "prompt", "negative_prompt", "prompt_file", "width", "height",
    "steps", "cfg_scale", "guidance", "seed", "batch_count", "sampling_method", "schedule",
    "eta", "clip_skip", "rng", "sampler_rng", "prediction",
    # the sampling layer: guidance extensions, sampler args, step caches
    "slg_scale", "skip_layers", "slg_start", "slg_end", "apg_eta", "apg_momentum", "apg_nt",
    "extra_sample_args", "cache", "cache_option", "scm_mask", "scm_policy",
    # the inpainting and instruct-pix2pix UNets: the edit image, image guidance
    "ref_image", "img_cfg_scale",
    # ControlNet on the SD1.x, SD2.x and SDXL UNets, with its canny hint
    "control_net", "control_image", "control_strength", "canny",
    # img2img, masked img2img, custom sigmas and the latent hires fix
    "init_img", "mask", "strength", "sigmas", "hires", "hires_upscaler", "hires_scale",
    "hires_width", "hires_height", "hires_steps", "hires_denoising_strength", "hires_sigmas",
    "vae_tiling", "vae_tile_size", "vae_tile_overlap",
    "dtype", "no_promote_q8", "no_keep_quant", "wtype", "backend", "flow_shift",
    # LoRA (<lora:name:mult> prompt tags) and textual-inversion embeddings
    "lora_model_dir", "lora_apply_mode", "embd_dir",
    "output", "output_begin_idx", "disable_image_metadata", "verbose",
    # vid_gen mode (Wan2.1 T2V)
    "video_frames", "fps", "vae_temporal_tiling", "extra_tiling_args",
    # metadata mode
    "image", "metadata_format", "metadata_brief", "metadata_all", "metadata_raw",
})
MODES = ("img_gen", "vid_gen", "metadata")
DTYPES = ("f32", "bf16")
# --prediction values → the denoiser the port puts in the pipeline's (the
# JAX CLI's map, the denoisers the port has)
PREDICTIONS = ("eps", "v", "edm_v", "flow", "flux_flow")


def unported(args, parser: argparse.ArgumentParser, run_flags=RUN_FLAGS) -> Optional[str]:
    """Why the port cannot run these arguments (None: it can)."""
    from sdtpu_torch.diffusion.samplers import PORTED_METHODS
    from sdtpu_torch.diffusion.schedule import SCHEDULERS
    from sdtpu_torch.io.model_loader import image_families

    for action in parser._actions:
        dest = action.dest
        if dest in run_flags or dest in ("help", "version"):
            continue
        if getattr(args, dest, action.default) != action.default:
            flag = "/".join(action.option_strings)
            if dest == "model_args" and "qwen_image_zero_cond_t" in args.model_args:
                return ("--model-args qwen_image_zero_cond_t (Qwen-Image-Edit 2509's t = 0 "
                        "modulation of reference tokens) is not ported")
            return (f"{flag} is not ported (the port runs {image_families()} txt2img, "
                    "img2img, masked img2img and the latent hires "
                    "fix, the inpainting and instruct-pix2pix UNets, ControlNet, and Wan2.1 "
                    "txt2vid)")
    if args.mode not in MODES:
        return f"mode {args.mode!r} is not ported; the port runs {list(MODES)}"
    if args.mode == "vid_gen" and video_output(args).lower().endswith(VIDEO_CONTAINERS):
        return (f"vid_gen -o {video_output(args)}: the {'/'.join(VIDEO_CONTAINERS)} writers need "
                "Pillow's JPEG / WebP encoders, which are not ported; name a .png to write one PNG "
                "a frame")
    if bool(args.control_net) != bool(args.control_image):
        given = "--control-net" if args.control_net else "--control-image"
        return (f"{given} alone is not ported (the JAX CLI ignores it): a ControlNet runs with "
                "--control-net and --control-image together")
    if args.canny and not args.control_image:
        return "--canny without --control-image is not ported: it preprocesses the control image"
    if args.control_net and (args.hires or args.mode == "vid_gen"):
        return (f"--control-net with {'--hires' if args.hires else 'vid_gen'} is not ported: the "
                "port runs a ControlNet in img_gen without the hires pass")
    if args.hires_upscaler.lower() != "latent":
        return (f"--hires-upscaler {args.hires_upscaler!r}: ESRGAN upscalers are not ported; the "
                "port runs the Latent upscaler")
    if args.sampling_method not in PORTED_METHODS:
        return (f"--sampling-method {args.sampling_method!r} is not ported; "
                f"ported: {list(PORTED_METHODS)}")
    if args.schedule not in SCHEDULERS:
        return f"--schedule {args.schedule!r} is not ported; ported: {list(SCHEDULERS)}"
    if args.prediction is not None and args.prediction not in PREDICTIONS:
        return (f"--prediction {args.prediction}: its denoiser is not ported; ported: "
                f"{list(PREDICTIONS)}")
    if args.dtype is not None and args.dtype not in DTYPES:
        return f"--dtype {args.dtype} is not ported: the kernels take bf16 and float32"
    spec = _parse_assignment_spec(args.backend)
    if set(spec) - {"*"}:
        return f"--backend {args.backend!r}: a per-module split is not ported; name one device"
    if spec and not re.fullmatch(r"cpu|cuda\d*", spec["*"]):
        return (f"--backend {args.backend!r} is not ported: the port runs on 'cpu' or "
                "'cuda0'..'cudaN'")
    return None


def extract_loras(prompt: str):
    """``<lora:name:mult>`` tags out of a prompt → (the prompt without them,
    stripped; [(name, multiplier)]), as the JAX CLI's ``extract_loras``."""
    loras = []

    def repl(m):
        loras.append((m.group(1), float(m.group(2) or 1.0)))
        return ""

    cleaned = re.sub(r"<lora:([^:>]+)(?::([\d.]+))?>", repl, prompt)
    return cleaned.strip(), loras


LORA_EXTENSIONS = (".safetensors", ".ckpt", ".pt")  # the JAX CLI's search order
EMBEDDING_EXTENSIONS = (".safetensors", ".pt", ".ckpt", ".bin")


def apply_prompt_loras(pipe, loras, lora_dir: str, mode: str) -> list:
    """The JAX CLI's LoRA loop: each (name, multiplier) read from
    ``lora_dir``/name + the first of ``LORA_EXTENSIONS`` that exists and
    applied to the pipeline's live diffusion and CLIP weights (the factors
    of a runtime attachment in its compute dtype); a name with no file
    warns → [{name, multiplier, applied, total, read_s, apply_s}] of the
    LoRAs applied."""
    import torch

    from sdtpu_torch.io.model_loader import read_checkpoint_file
    from sdtpu_torch.models.lora import apply_lora, lora_modules

    done = []
    for name, mult in loras:
        for ext in LORA_EXTENSIONS:
            path = os.path.join(lora_dir, name + ext)
            if os.path.exists(path):
                t0 = time.time()
                tensors = read_checkpoint_file(path)
                t1 = time.time()
                applied, total = apply_lora(lora_modules(pipe), tensors, mult, mode=mode,
                                            factor_dtype=pipe.compute_dtype)
                if pipe.device.type == "cuda":
                    torch.cuda.synchronize(pipe.device)
                print(f"lora {name}: applied {applied}/{total} tensors x{mult}")
                done.append({"name": name, "multiplier": mult, "applied": applied, "total": total,
                             "read_s": t1 - t0, "apply_s": time.time() - t1})
                break
        else:
            print(f"warning: lora {name} not found in {lora_dir}")
    return done


def load_embeddings(pipe, embd_dir: str) -> list:
    """The JAX CLI's ``--embd-dir`` loop: every embedding file of the
    directory, in name order, under its stem as the trigger word, where the
    conditioner takes embeddings (SD1.x and SD2.x); a file that fails warns
    → the trigger words loaded."""
    from sdtpu_torch.io.model_loader import read_checkpoint_file

    if not (embd_dir and os.path.isdir(embd_dir) and hasattr(pipe.conditioner, "load_embedding")):
        return []
    loaded = []
    for fn in sorted(os.listdir(embd_dir)):
        stem, ext = os.path.splitext(fn)
        if ext.lower() not in EMBEDDING_EXTENSIONS:
            continue
        try:
            pipe.load_embedding(stem, read_checkpoint_file(os.path.join(embd_dir, fn)))
            print(f"loaded embedding '{stem}'")
            loaded.append(stem)
        except Exception as e:  # noqa: BLE001 -- one file's error, as the JAX CLI reports it
            print(f"warning: embedding {fn}: {e}")
    return loaded


def parse_kv(spec: str) -> dict:
    """key=value,... option args: ints, floats, else the text (the JAX CLI's
    ``_parse_kv``)."""
    out = {}
    for part in spec.split(","):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        try:
            out[k.strip()] = int(v) if v.strip().isdigit() else float(v)
        except ValueError:
            out[k.strip()] = v.strip()
    return out


def cache_options(args) -> dict:
    """--cache-option plus the --scm-mask / --scm-policy shorthands (the JAX
    CLI's ``_cache_options``)."""
    opts = parse_kv(args.cache_option)
    if args.scm_mask:
        opts["scm_mask"] = args.scm_mask
    if args.scm_policy:
        opts["scm_policy_dynamic"] = args.scm_policy != "static"
    return opts


def video_output(args) -> str:
    """vid_gen's output path: ``-o``, or ``output.avi`` where ``-o`` keeps its
    default (the JAX CLI's)."""
    return args.output if args.output != "output.png" else "output.avi"


def _parse_assignment_spec(spec: str) -> dict:
    """--backend specs: 'module=target,...' pairs; a bare value applies to all
    modules ('*')."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            m, dv = part.split("=", 1)
            out[m.strip()] = dv.strip()
        else:
            out["*"] = part
    return out


def resolve_device(backend: str):
    """--backend → the torch device of every module: 'cpu', 'cudaN' → cuda:N,
    none → the GPU, which must exist."""
    import torch

    name = _parse_assignment_spec(backend).get("*", "")
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on an NVIDIA GPU; pass --backend cpu "
                           "to run on the CPU")
    return torch.device("cuda", int(name[len("cuda"):] or 0))


def pretty_progress(step: int, steps: int, time_per_step: float) -> None:
    """In-place progress bar: |====>     | 5/20 - 2.10it/s."""
    width = 50
    filled = int(width * step / max(steps, 1))
    bar = "=" * max(filled - 1, 0) + (">" if 0 < filled < width else "=" * min(filled, 1))
    bar = bar.ljust(width)
    if time_per_step >= 1.0 or time_per_step <= 0:
        rate = f"{time_per_step:.2f}s/it"
    else:
        rate = f"{1.0 / time_per_step:.2f}it/s"
    end = "\n" if step == steps else ""
    print(f"\r|{bar}| {step}/{steps} - {rate}", end=end, file=sys.stderr, flush=True)


def _progress_cb():
    state = {"t": time.time()}

    def cb(step, steps, _x):
        now = time.time()
        pretty_progress(step, steps, now - state["t"])
        state["t"] = now

    return cb


def discover_gguf_tokenizer(*paths):
    """The first tokenizer embedded in the given .gguf files' metadata
    (llama.cpp ``tokenizer.ggml.*``), or None; a file that fails to read
    gives none."""
    from sdtpu_torch.tokenizers.gguf_vocab import tokenizer_from_gguf_file

    for p in paths:
        if p and p.lower().endswith(".gguf"):
            try:
                tok = tokenizer_from_gguf_file(p)
            except Exception:
                tok = None
            if tok is not None:
                print(f"tokenizer from embedded GGUF vocab: {p} ({type(tok).__name__})")
                return tok
    return None


def load_t5_tokenizer(args):
    """--t5-tokenizer (a ``spiece.model`` or a ``tokenizer.json``), else the
    vocab embedded in the T5 or full-checkpoint GGUF, else None → (tokenizer,
    where it came from)."""
    if args.t5_tokenizer:
        if args.t5_tokenizer.endswith(".model"):
            from sdtpu_torch.tokenizers.gguf_vocab import load_spiece_model

            return load_spiece_model(args.t5_tokenizer), args.t5_tokenizer
        from sdtpu_torch.tokenizers.t5 import T5UnigramTokenizer

        return T5UnigramTokenizer.from_tokenizer_json(args.t5_tokenizer), args.t5_tokenizer
    tok = discover_gguf_tokenizer(args.t5xxl, args.model)
    if tok is None:
        print("warning: no T5 tokenizer (no --t5-tokenizer and no vocab in a GGUF): "
              "T5 gets all-zero ids")
        return None, None
    return tok, "gguf:" + next(p for p in (args.t5xxl, args.model) if p and p.lower().endswith(".gguf"))


def load_llm_tokenizer(args):
    """The LLM's tokenizer, as the JAX CLI picks it → (tokenizer, where it
    came from): ``--llm-tokenizer`` (a ``tokenizer.json``), else a "gpt2"
    vocab embedded in the ``--llm`` or ``-m`` GGUF, else the Qwen byte-level
    ids without merges (``Qwen2Tokenizer.byte_fallback``)."""
    from sdtpu_torch.tokenizers.gguf_vocab import tokenizer_from_gguf_file
    from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer

    if args.llm_tokenizer:
        return Qwen2Tokenizer.from_tokenizer_json(args.llm_tokenizer), args.llm_tokenizer
    for p in (args.llm, args.model):
        if p and p.lower().endswith(".gguf"):
            tok = tokenizer_from_gguf_file(p)
            if isinstance(tok, Qwen2Tokenizer):
                print(f"tokenizer from embedded GGUF vocab: {p} (Qwen2Tokenizer)")
                return tok, "gguf:" + p
    print("warning: no tokenizer sidecar for the LLM text encoder: using the Qwen2 byte-level "
          "vocabulary (valid ids, no multi-byte merges; pass --llm-tokenizer tokenizer.json for "
          "exact encoding)")
    return Qwen2Tokenizer.byte_fallback(), "byte_fallback"


def quantize_dense(d: dict, wtype: str):
    """``--type``: the dense weights of a diffusion param dict quantized as
    the JAX CLI quantizes them at load (``quantize_params``, bits 8 for
    q8_0 and 4 for q4_0; weights already quantized stay as they are) → (the
    new dict, how many weights it quantized)."""
    from sdtpu_torch.ops.quant import GroupQuantTensor, Q4Tensor, QuantTensor, quantize_params

    kept = (GroupQuantTensor, Q4Tensor, QuantTensor)
    dense = {k: v for k, v in d.items() if not isinstance(v, kept)}
    done = quantize_params(dense, bits=8 if wtype == "q8_0" else 4)
    n = sum(done[k] is not dense[k] for k in dense)
    return {**{k: v for k, v in d.items() if isinstance(v, kept)}, **done}, n


def _load_pipeline(args, report: Optional[dict] = None):
    """The files → a FLUX, SD1.x, SD2.x, SDXL, SD3, Wan, Z-Image or Qwen-Image pipeline (the
    version the files' fingerprint names; ``--prediction``'s denoiser) on
    ``--backend``'s device, with ``--taesd``'s
    decoder attached.  ``report``
    (when given) gets ``load``: its seconds, ``read_s`` (the files → host
    arrays and quant blocks, the blocks' extraction included), ``stage_s``
    (→ the device) and ``build_s``, and ``pipeline``, the pipeline."""
    import torch

    from sdtpu_torch.config import SDVersion, sd_version_is_sdxl
    from sdtpu_torch.factory import create_pipeline
    from sdtpu_torch.io.model_loader import load_model_bundle, read_checkpoint_file
    from sdtpu_torch.loader import diffusion_to_device, module_to_device
    from sdtpu_torch.models.tae import convert_taesd_name, tae_config_for

    device = resolve_device(args.backend)
    if not (args.model or args.diffusion_model):
        raise SystemExit("error: provide --model or --diffusion-model")
    if args.dtype:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    else:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    bundle = load_model_bundle(model_path=args.model, diffusion_model_path=args.diffusion_model,
                               clip_l_path=args.clip_l, t5xxl_path=args.t5xxl,
                               vae_path=args.vae, keep_quant=not args.no_keep_quant,
                               clip_g_path=args.clip_g, llm_path=args.llm)
    tae_raw = read_checkpoint_file(args.taesd) if args.taesd else None
    t_read = time.time() - t0
    # SD1.x and SD2.x condition on one CLIP (SD2's OpenCLIP-H loads as
    # clip_l), SDXL on CLIP-L and CLIP-G: a missing T5 is no error there
    encoders = {SDVersion.FLUX: ("clip_l", "t5"), SDVersion.SD3: ("clip_l", "clip_g", "t5"),
                SDVersion.WAN2: ("t5",), SDVersion.Z_IMAGE: ("llm",),
                SDVersion.QWEN_IMAGE: ("llm",)}.get(bundle.version, ("clip_l",))
    if sd_version_is_sdxl(bundle.version):
        encoders = ("clip_l", "clip_g")
    missing = [m for m in (*encoders, "vae") if not getattr(bundle, m)]
    if missing:
        raise SystemExit(f"error: no {', '.join(missing)} weights in the given files "
                         "(pass --clip_l, --clip_g, --t5xxl, --llm, --vae)")
    t5_tok, t5_tok_source = load_t5_tokenizer(args) if "t5" in encoders else (None, None)
    llm_tok, llm_tok_source = load_llm_tokenizer(args) if "llm" in encoders else (None, None)
    t0 = time.time()
    # the JAX CLI's rule: --type q8_0 promotes q8_0 blocks per row even under
    # --no-promote-q8, --type q4_0 keeps them in their blocks
    promote = args.wtype == "q8_0" or (args.wtype is None and not args.no_promote_q8)
    params = {"diffusion": diffusion_to_device(bundle.diffusion, dtype, device, promote_q8=promote)}
    bundle.diffusion = None
    for m in (*encoders, "vae"):
        params[m] = module_to_device(getattr(bundle, m), dtype, device)
        setattr(bundle, m, None)
    sync()
    t_stage = time.time() - t0
    n_row = sum(type(v).__name__ == "QuantTensor" for v in params["diffusion"].values())
    n_blocks = sum(type(v).__name__ in ("GroupQuantTensor", "Q4Tensor")
                   for v in params["diffusion"].values())
    if n_row:
        print(f"re-quantized {n_row} diffusion weights to per-row int8 (W8A8 path)")
    if n_blocks:
        print(f"keeping {n_blocks} diffusion weights in checkpoint quant blocks")
    if bundle.vision_tensors:
        print(f"dropped {bundle.vision_tensors} LLM vision-tower tensors (Qwen-Image-Edit's; not "
              "ported)")
    n_typed = 0
    if args.wtype:
        params["diffusion"], n_typed = quantize_dense(params["diffusion"], args.wtype)
        sync()
        print(f"quantized diffusion weights to {args.wtype}")
    t0 = time.time()
    pipe = create_pipeline(bundle.version, params=params, rng_type=args.rng, dtype=dtype,
                           t5_tokenizer=t5_tok, flow_shift=args.flow_shift, device=device,
                           qwen_tokenizer=llm_tok)
    if args.prediction:  # the JAX CLI's denoiser override
        from sdtpu_torch.diffusion import denoiser as dn

        shift = args.flow_shift if args.flow_shift is not None else 3.0
        pipe.denoiser = {"eps": dn.CompVisDenoiser, "v": dn.CompVisVDenoiser,
                         "edm_v": dn.EDMVDenoiser,
                         "flow": lambda: dn.DiscreteFlowDenoiser(shift=shift),
                         "flux_flow": dn.FluxFlowDenoiser}[args.prediction]()
    if args.sampler_rng:
        pipe.sampler_rng_type = args.sampler_rng
    if args.vae_tiling or args.vae_temporal_tiling:
        pipe.set_vae_tiling(True, args.vae_tile_size, args.vae_tile_overlap,
                            temporal=args.vae_temporal_tiling,
                            extra_tiling_args=args.extra_tiling_args)
    if tae_raw is not None:
        tae_p = module_to_device({nk: v for k, v in tae_raw.items()
                                  if (nk := convert_taesd_name(k)) is not None}, dtype, device)
        pipe.set_tae(tae_p, tae_config_for(bundle.version.value, pipe.latent_channels))
        print("TAE attached (decode)")
    embeddings = load_embeddings(pipe, args.embd_dir)
    sync()
    load = {"version": bundle.version.value, "read_s": t_read, "stage_s": t_stage,
            "build_s": time.time() - t0,
            "device": str(device), "dtype": str(dtype).replace("torch.", ""), "tae": bool(tae_raw),
            "w8a8_weights": n_row, "block_weights": n_blocks, "wtype": args.wtype,
            "typed_weights": n_typed, "vision_weights": bundle.vision_tensors,
            "t5_tokenizer": t5_tok_source,
            "llm_tokenizer": llm_tok_source, "embeddings": embeddings}
    print("load " + json.dumps(load))
    if report is not None:
        report.update(load=load, pipeline=pipe)
    return pipe


def _img_gen(args, report: Optional[dict] = None) -> int:
    from sdtpu_torch.config import GenerationParams, SDVersion, sd_version_is_unet_edit
    from sdtpu_torch.utils.image import (build_parameters_text, read_png, resolve_output_path,
                                         write_image)

    init_image = mask_image = ref_images = control_image = None
    try:  # read before the (long) load, so a file the port cannot read fails first
        if args.init_img:
            init_image, _ = read_png(args.init_img)
        if args.mask:
            mask_image = read_png(args.mask)[0][..., 0]
        if args.ref_image:
            ref_images = [read_png(p)[0][..., :3] for p in args.ref_image]
        if args.control_image:
            control_image = read_png(args.control_image)[0][..., :3]
            if control_image.shape[:2] != (args.height, args.width):
                raise ValueError(f"{args.control_image}: {control_image.shape[1]}x"
                                 f"{control_image.shape[0]}, the request {args.width}x{args.height}: "
                                 "the port does not resize control images (the JAX CLI resizes "
                                 "with Pillow's Lanczos)")
            if args.canny:
                from sdtpu_torch.diffusion.preprocessing import canny

                control_image = canny(control_image)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    prompt, loras = extract_loras(args.prompt)
    pipe = _load_pipeline(args, report)
    if pipe.version == SDVersion.WAN2:
        print("error: img_gen on a Wan2.1 model: run -M vid_gen", file=sys.stderr)
        return 2
    if ref_images and not sd_version_is_unet_edit(pipe.version):
        print(f"error: -r/--ref-image on a {pipe.version.value} model: the port takes reference "
              "images on the instruct-pix2pix UNets only", file=sys.stderr)
        return 2
    if args.control_net:
        if pipe.controlnet_fn is None:
            print(f"error: --control-net on a {pipe.version.value} model: the port runs ControlNet "
                  "on the SD1.x, SD2.x and SDXL UNets", file=sys.stderr)
            return 2
        from sdtpu_torch.io.model_loader import load_controlnet
        from sdtpu_torch.loader import module_to_device

        pipe.set_controlnet(module_to_device(load_controlnet(args.control_net), pipe.compute_dtype,
                                             pipe.device))
        print("ControlNet attached")
    applied = apply_prompt_loras(pipe, loras, args.lora_model_dir, args.lora_apply_mode)
    gp = GenerationParams(
        prompt=prompt, negative_prompt=args.negative_prompt, width=args.width,
        height=args.height, sample_steps=args.steps, cfg_scale=args.cfg_scale,
        img_cfg_scale=args.img_cfg_scale, guidance=args.guidance,
        sample_method=args.sampling_method, schedule=args.schedule, seed=args.seed,
        batch_count=args.batch_count, clip_skip=args.clip_skip, eta=args.eta,
        strength=args.strength, slg_scale=args.slg_scale,
        skip_layers=tuple(int(v) for v in args.skip_layers.split(",") if v.strip()),
        slg_start=args.slg_start, slg_end=args.slg_end, apg_eta=args.apg_eta,
        apg_momentum=args.apg_momentum, apg_norm_threshold=args.apg_nt,
        extra_sample_args=args.extra_sample_args, custom_sigmas=args.sigmas)
    t0 = time.time()
    if args.hires:  # the JAX CLI's: the base request, then the latent upscale pass
        res = pipe.txt2img_hires(
            gp, hires_scale=args.hires_scale, hires_steps=args.hires_steps or None,
            hires_strength=args.hires_denoising_strength, hires_width=args.hires_width,
            hires_height=args.hires_height, hires_sigmas=args.hires_sigmas)
    else:
        res = pipe.generate(gp, init_image=init_image, mask_image=mask_image,
                            ref_images=ref_images, progress_callback=_progress_cb(),
                            step_cache=args.cache, cache_options=cache_options(args),
                            control_image=control_image, control_strength=args.control_strength)
    print(f"generated {len(res.images)} image(s) in {time.time() - t0:.2f}s")
    print("timings " + json.dumps(pipe.last_timings))
    paths = []
    for i, img in enumerate(res.images):
        path = resolve_output_path(args.output, i, len(res.images), args.output_begin_idx)
        meta = build_parameters_text(GenerationParams(**{**gp.__dict__, "seed": res.seeds[i]}))
        write_image(path, img, parameters=None if args.disable_image_metadata else meta)
        print(f"saved {path}")
        paths.append(path)
    if report is not None:
        report.update(timings=dict(pipe.last_timings), outputs=paths, seeds=res.seeds,
                      t5_ids=pipe.last_t5_ids, loras=applied)
    return 0


def _vid_gen(args, report: Optional[dict] = None) -> int:
    """txt2vid (the JAX CLI's ``_vid_gen``) on a Wan2.1 T2V model: one PNG a
    frame (``write_video_frames``)."""
    from sdtpu_torch.config import GenerationParams, SDVersion
    from sdtpu_torch.utils.image import write_video_frames

    prompt, _ = extract_loras(args.prompt)  # the JAX CLI drops the tags of a video
    pipe = _load_pipeline(args, report)
    if pipe.version != SDVersion.WAN2:
        print(f"error: vid_gen on a {pipe.version.value} model: the port runs txt2vid on Wan2.1 "
              "T2V", file=sys.stderr)
        return 2
    gp = GenerationParams(  # the JAX CLI's: no batch count, no distilled guidance
        prompt=prompt, negative_prompt=args.negative_prompt, width=args.width,
        height=args.height, sample_steps=args.steps, cfg_scale=args.cfg_scale,
        sample_method=args.sampling_method, schedule=args.schedule, seed=args.seed,
        clip_skip=args.clip_skip, eta=args.eta)
    t0 = time.time()
    res = pipe.generate_video(gp, frames=args.video_frames, progress_callback=_progress_cb())
    print(f"generated {res.frames.shape[1]} frames in {time.time() - t0:.2f}s")
    print("timings " + json.dumps(pipe.last_timings))
    out = video_output(args)
    paths = write_video_frames(out, res.frames[0])
    print(f"saved {out}")
    if report is not None:
        report.update(timings=dict(pipe.last_timings), outputs=paths, seeds=res.seeds,
                      t5_ids=pipe.last_t5_ids)
    return 0


def _metadata(args) -> int:
    """Chunk-level metadata dump of a PNG (the reference's metadata mode)."""
    from sdtpu_torch.utils.image import parse_parameters_text, walk_image_metadata

    path = args.image or args.model or args.output
    entries = walk_image_metadata(path, include_structural=args.metadata_all,
                                  include_raw=args.metadata_raw, brief=args.metadata_brief)
    params = next((e.get("value") for e in entries if e.get("keyword") == "parameters"), None)
    if args.metadata_format == "json":
        out = {"file": path, "entries": entries}
        if params and not args.metadata_brief:
            out["parameters"] = parse_parameters_text(params)
        print(json.dumps(out, indent=2))
        return 0
    for e in entries:
        head = e["chunk"] + (f"/{e['keyword']}" if "keyword" in e else "")
        tail = e.get("value", e.get("raw", ""))
        print(f"{head} ({e['length']} bytes): {tail}")
    if params:
        for k, v in parse_parameters_text(params).items():
            print(f"  {k}: {v}")
    elif not entries:
        print("(no parameters)")
    return 0


def main(argv=None, report: Optional[dict] = None) -> int:
    """Run the CLI; ``report`` (a dict, when given) gets what an img_gen or
    vid_gen run measured: ``load`` (seconds of read / stage / build, the T5 tokenizer's
    source, the embeddings loaded), ``timings`` (cond / sample / decode / total), ``loras``
    (img_gen: ``apply_prompt_loras``'s), ``outputs``, the
    padded ``t5_ids`` T5 was fed for the prompt and the ``pipeline`` that
    answered."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode_flag:
        args.mode = args.mode_flag  # reference -M/--mode spelling
    if args.prompt_file:
        with open(args.prompt_file) as f:
            args.prompt = f.read().strip()
    why = unported(args, parser)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    if args.mode == "metadata":
        return _metadata(args)
    if args.mode == "vid_gen":
        return _vid_gen(args, report)
    return _img_gen(args, report)


if __name__ == "__main__":
    sys.exit(main())
