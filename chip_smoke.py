#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sdtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure (exit code != 0, no result line):
  1. the card's name and power limit (nvidia-smi); no CUDA device → exit 2;
  2. build the hand-written kernels from ``sdtpu_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the FLUX.1-dev txt2img path, with a stated tolerance, and the
     time of both (CUDA events, after warm-up);
  4. a small-input reference check: T5, CLIP, one DiT forward and a VAE
     decode at kernel-shaped small widths, on the card (kernels, bf16)
     against the same weights on the CPU (plain versions, float32);
  5. the main path: ``sdtpu_torch.factory.create_pipeline`` at full
     FLUX.1-dev width (int8 DiT, 4-bit T5-XXL, bf16 CLIP-L and VAE) with
     random weights drawn on the card, VAE tiling on, answering three
     txt2img requests through ``generate`` (one with CFG and a batch of
     two); every kernel's launch count must rise during them.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

DEVICE = "cuda"

KERNEL_INFO = {
    "flash_attention": ("sdtpu_torch/csrc/flash_attention.cu", "sdtpu/ops/flash_attention.py:51"),
    "w8a8_matmul": ("sdtpu_torch/csrc/w8a8_matmul.cu", "sdtpu/ops/quant.py:416"),
    "q4_matmul": ("sdtpu_torch/csrc/q4_matmul.cu", "sdtpu/ops/quant.py:845"),
}

# W8A8 at FLUX.1-dev shapes (M tokens, K in, N out): 4352 = 4096 img + 256 txt
# tokens at 1024², M = 1 for the modulation linears, the embedders and head.
W8A8_CASES = [
    (4352, 3072, 9216), (4352, 3072, 3072), (4352, 3072, 12288), (4352, 12288, 3072),
    (4352, 3072, 21504), (4352, 15360, 3072), (1280, 3072, 21504), (1, 3072, 18432),
    (1, 3072, 9216), (1, 256, 3072), (1, 768, 3072), (256, 4096, 3072), (4096, 64, 3072),
    (4096, 3072, 64),
]
# (B, H, Lq, Lk, D, dtype, bias) — FLUX joint attention at 1024² and 512²,
# CLIP-L with its causal mask, the VAE mid-block per 64-latent tile, and
# float32 parity cases.
FLASH_CASES = [
    (1, 24, 4352, 4352, 128, "bf16", None), (1, 24, 1280, 1280, 128, "bf16", None),
    (2, 12, 77, 77, 64, "bf16", "causal"), (1, 1, 4096, 4096, 512, "bf16", None),
    (1, 2, 300, 200, 512, "bf16", "random"),
    (1, 24, 1280, 1280, 128, "f32", None), (2, 12, 77, 77, 64, "f32", "causal"),
    (1, 1, 1024, 1024, 512, "f32", "random"),
]
# T5-XXL (M = 256 tokens per prompt): q/k/v/o, wi_0/wi_1, wo; one ragged case.
Q4_CASES = [(256, 4096, 4096), (256, 4096, 10240), (256, 10240, 4096), (77, 640, 1001)]

# Why each tolerance:
#   W8A8: both sides accumulate exactly and share the epilogue order → bit-equal.
#   flash bf16: P is rounded to bf16 before P.V in both, but the kernel
#     normalises after the product and the plain version before it, so the
#     two differ by a few bf16 roundings (2^-9 relative each) of the output:
#     2e-2 times max(1, max |out|) — rows that see few keys (CLIP's causal
#     mask) have |out| up to ~4, where one bf16 ulp is already 1.6e-2.
#   flash f32: float32 throughout (TF32 off); only summation order and exp2
#     against exp differ → 1e-4.
#   q4: identical bf16 weights; float32 sums in another order can move the
#     final bf16 rounding by an ulp → 2^-6 of the largest |output|.
FLASH_TOL = {"bf16": 2e-2, "f32": 1e-4}
Q4_REL_TOL = 2.0 ** -6
#   reference check (relative L2 of each output): the card runs bf16, the
#     CPU float32, so this is no precision check; it catches errors of order
#     one.  Sound readings: 4.5e-3 to 1.5e-2 on the card, 5e-3 to 2e-2 for
#     the plain versions in bf16 against float32 on the CPU.  Faults planted
#     in the bf16 plain versions on the CPU read: nibbles swapped 1.3 (T5),
#     causal bias ignored 0.53 (CLIP), the last 128-wide head-dim slice of the
#     VAE's D = 512 attention zeroed 0.082.  Subtler faults (a key tile or a
#     K tile dropped, a wrong softmax scale) read 0.014-0.025 and a shifted
#     scale index reads nothing (synthesized scales are constant); the kernel
#     checks above, with random scales at the slice's shapes, catch those.
REF_REL_TOL = 0.04


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def iters_for(flops: float) -> int:
    return int(max(3, min(50, 2e12 / max(flops, 1.0))))


def _record(results, case) -> None:
    results.append(case)
    print("kernel " + json.dumps(case), flush=True)


def check_w8a8(results):
    import torch

    from sdtpu_torch.ops import quant

    g = torch.Generator(device=DEVICE).manual_seed(1)
    for m, k, n in W8A8_CASES:
        x = torch.randn((m, k), generator=g, device=DEVICE, dtype=torch.bfloat16)
        if m > 1:
            x[0] = 0  # the amax = 0 row
        qt = quant.QuantTensor(
            q=torch.randint(-127, 127, (n, k), generator=g, device=DEVICE, dtype=torch.int8),
            scale=torch.rand((n,), generator=g, device=DEVICE) * 4e-4 + 1e-5)
        got = quant.quant_matmul_w8a8(x, qt)
        want = quant.quant_matmul_w8a8_plain(x, qt)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        it = iters_for(2.0 * m * n * k)
        ms = time_ms(lambda: quant.quant_matmul_w8a8(x, qt), it)
        plain_ms = time_ms(lambda: quant.quant_matmul_w8a8_plain(x, qt), max(3, it // 4))
        ok = bool(torch.equal(got, want))
        _record(results, dict(kernel="w8a8_matmul", shape=[m, k, n], max_abs_err=err, tol=0.0,
                            ok=ok, ms=ms, plain_ms=plain_ms))
        del x, qt, got, want


def check_flash(results):
    import torch

    from sdtpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=DEVICE).manual_seed(2)
    for b, h, lq, lk, d, dt, bias in FLASH_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v = (torch.randn((b, h, l, d), generator=g, device=DEVICE, dtype=dtype)
                   for l in (lq, lk, lk))
        mask = None
        if bias == "causal":
            mask = torch.full((lq, lk), -1e30, device=DEVICE).triu(1)
        elif bias == "random":
            mask = torch.randn((lq, lk), generator=g, device=DEVICE)
        got = fa.flash_attention(q, k, v, mask=mask)
        want = fa.plain_attention(q, k, v, mask=mask)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = FLASH_TOL[dt] * (max(1.0, want.float().abs().max().item()) if dt == "bf16" else 1.0)
        it = iters_for(4.0 * b * h * lq * lk * d)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, mask=mask), it)
        plain_ms = time_ms(lambda: fa.plain_attention(q, k, v, mask=mask), it)
        _record(results, dict(kernel="flash_attention", shape=[b, h, lq, lk, d], dtype=dt,
                            bias=bias, max_abs_err=err, tol=tol,
                            ok=bool(err <= tol and torch.isfinite(got).all()),
                            ms=ms, plain_ms=plain_ms))
        del q, k, v, got, want


def check_q4(results):
    import torch

    from sdtpu_torch.ops import quant
    from sdtpu_torch.weights import Q4_SCALE

    g = torch.Generator(device=DEVICE).manual_seed(3)
    for m, k, n in Q4_CASES:
        x = torch.randn((m, k), generator=g, device=DEVICE, dtype=torch.bfloat16)
        kp = -(-k // quant.Q4_GROUP) * quant.Q4_GROUP
        qt = quant.Q4Tensor(
            packed=torch.randint(0, 256, (n, kp // 2), generator=g, device=DEVICE,
                                 dtype=torch.uint8),
            scale=torch.rand((n, kp // quant.Q4_GROUP), generator=g, device=DEVICE) * Q4_SCALE
            + Q4_SCALE / 2,
            k=k)
        got = quant.q4_matmul(x, qt)
        want = quant.q4_matmul_plain(x, qt)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = Q4_REL_TOL * want.float().abs().max().item()
        it = iters_for(2.0 * m * n * k)
        ms = time_ms(lambda: quant.q4_matmul(x, qt), it)
        plain_ms = time_ms(lambda: quant.q4_matmul_plain(x, qt), it)
        _record(results, dict(kernel="q4_matmul", shape=[m, k, n], max_abs_err=err, tol=tol,
                            ok=bool(err <= tol), ms=ms, plain_ms=plain_ms))
        del x, qt, got, want


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def _to_cpu_f32(params):
    import torch

    from sdtpu_torch.ops.quant import Q4Tensor, QuantTensor

    out = {}
    for k, v in params.items():
        if isinstance(v, QuantTensor):
            out[k] = QuantTensor(v.q.cpu(), v.scale.cpu())
        elif isinstance(v, Q4Tensor):
            out[k] = dataclasses.replace(v, packed=v.packed.cpu(), scale=v.scale.cpu())
        else:
            out[k] = v.to("cpu", torch.float32)
    return out


def reference_check():
    """Small kernel-shaped configs: every kernel on the card (bf16) against
    the plain versions on the CPU (float32), same weights and inputs."""
    import torch

    from sdtpu_torch.models import clip as clip_mod
    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.models import t5 as t5_mod
    from sdtpu_torch.models import vae as vae_mod
    from sdtpu_torch.weights import synthesize

    dit_cfg = flux_mod.FluxConfig(hidden_size=256, num_heads=2, depth=1, depth_single=1,
                                  context_in_dim=512, vec_in_dim=128)
    clip_cfg = dataclasses.replace(clip_mod.CLIP_L_CONFIG, hidden_size=128, intermediate_size=256,
                                   num_layers=2, num_heads=2)
    t5_cfg = t5_mod.T5Config(d_model=512, d_kv=64, d_ff=1024, num_layers=1, num_heads=8)
    vae_cfg = vae_mod.FLUX_VAE_CONFIG
    mods = {
        "dit": (flux_mod.param_specs(dit_cfg), "q8_0"), "clip": (clip_mod.param_specs(clip_cfg), None),
        "t5": (t5_mod.param_specs(t5_cfg), "q4_0"), "vae": (vae_mod.param_specs(vae_cfg), None),
    }
    gpu = {n: synthesize(s, quant=q, seed=i, device=DEVICE, dtype=torch.bfloat16)
           for i, (n, (s, q)) in enumerate(mods.items())}
    cpu = {n: _to_cpu_f32(p) for n, p in gpu.items()}
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 1000, (1, 77), generator=gen)
    ids[0, 20] = clip_cfg.eos_token_id
    t5_ids = torch.randint(0, 32000, (1, 256), generator=gen)
    x = torch.randn((1, 32, 32, 16), generator=gen)
    z = torch.randn((1, 16, 16, 16), generator=gen)
    t = torch.tensor([0.7])
    gd = torch.tensor([3.5])

    def run(p, dev, dtype):
        with torch.inference_mode():
            _, pooled = clip_mod.clip_text_forward(p["clip"], ids.to(dev), clip_cfg,
                                                   return_pooled=True)
            ctx = t5_mod.t5_encoder_forward(p["t5"], t5_ids.to(dev), t5_cfg)
            vel = flux_mod.flux_forward(p["dit"], x.to(dev, dtype), t.to(dev), ctx, pooled,
                                        guidance=gd.to(dev), cfg=dit_cfg)
            img = vae_mod.vae_decode(p["vae"], z.to(dev, dtype), vae_cfg)
        return {"clip_pooled": pooled, "t5": ctx, "flux_forward": vel, "vae_decode": img}

    got = run(gpu, DEVICE, torch.bfloat16)
    want = run(cpu, "cpu", torch.float32)
    out = {}
    for name in got:
        ok = bool(torch.isfinite(got[name]).all())
        rel = _rel(got[name], want[name])
        out[name] = dict(rel_l2=rel, tol=REF_REL_TOL, ok=ok and rel <= REF_REL_TOL)
    return out


def run_pipeline(card: str):
    import numpy as np
    import torch

    from sdtpu.config import GenerationParams, SDVersion
    from sdtpu_torch.factory import create_pipeline
    from sdtpu_torch.weights import weight_bytes

    t0 = time.time()
    pipe = create_pipeline(SDVersion.FLUX, dtype=torch.bfloat16, device=DEVICE, seed=0)
    pipe.set_vae_tiling(True)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    wb = {"diffusion": weight_bytes(pipe.diffusion_params),
          "t5": weight_bytes(pipe.conditioner.pt), "clip_l": weight_bytes(pipe.conditioner.pl),
          "vae": weight_bytes(pipe.vae_params)}
    print(f"pipeline: full-width FLUX.1-dev built in {build_s:.2f} s on {card}; weight bytes "
          + json.dumps(wb))
    requests = [
        GenerationParams(prompt="a photograph of an astronaut riding a horse", width=512,
                         height=512, sample_steps=4, cfg_scale=1.0, guidance=3.5, seed=42,
                         sample_method="euler"),
        GenerationParams(prompt="a red fox in fresh snow, golden hour", negative_prompt="blurry",
                         width=512, height=512, sample_steps=4, cfg_scale=3.0, guidance=3.5,
                         seed=7, batch_count=2, sample_method="euler"),
        GenerationParams(prompt="a lighthouse on a cliff above a stormy sea", width=1024,
                         height=1024, sample_steps=2, cfg_scale=1.0, guidance=3.5, seed=3,
                         sample_method="euler"),
    ]
    reports = []
    for gp in requests:
        torch.cuda.reset_peak_memory_stats()
        res = pipe.generate(gp)
        peak = torch.cuda.max_memory_allocated()
        img, lat = res.images, res.latents
        bc = gp.batch_count
        if img.shape != (bc, gp.height, gp.width, 3) or img.dtype != np.uint8:
            raise RuntimeError(f"image shape {img.shape} {img.dtype} for {gp.width}x{gp.height}")
        if lat.shape != (bc, gp.height // 8, gp.width // 8, pipe.latent_channels) or not np.isfinite(lat).all():
            raise RuntimeError(f"latents {lat.shape} not finite or of the wrong shape")
        if img.std() == 0 or lat.std() == 0:
            raise RuntimeError("constant image or latents")
        tm = pipe.last_timings
        rep = {"size": [gp.width, gp.height], "batch": bc, "cfg_scale": gp.cfg_scale,
               "steps": tm["steps"], "seed": gp.seed,
               "timings_s": {k: tm[k] for k in ("cond", "sample", "decode", "total")},
               "denoise_steps_per_s": tm["steps"] / tm["sample"], "peak_mem_bytes": peak,
               "image_std": float(img.std()), "card": card}
        print("request " + json.dumps(rep))
        reports.append(rep)
    return pipe, requests[-1], build_s, wb, reports


def profile_request(pipe, gp, path: str, card: str) -> dict:
    """One more request under torch.profiler: device time by kernel name, and
    the device's busy share of the request's wall time (a union of kernel
    intervals, so overlapping kernels count once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pipe.generate(gp)
        wall_s = time.time() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, spans = {}, []
    for e in kernels:
        us = e.time_range.elapsed_us()
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += us
        tot[1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    summary = {"card": card, "size": [gp.width, gp.height], "steps": gp.sample_steps,
               "wall_s": wall_s, "timings_s": dict(pipe.last_timings),
               "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / wall_s,
               "kernels": [{"name": n[:90], "ms": v[0] / 1e3, "count": v[1]} for n, v in top[:25]]}
    print("profile " + json.dumps(summary))
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measured number to this JSON file")
    ap.add_argument("--profile", metavar="TABLE",
                    help="after the main path, profile one more 1024² request and write the "
                         "profiler's table to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
          "TF32 off for matmul and cuDNN")

    from sdtpu_torch.ops import _build, flash_attention, quant

    t0 = time.time()
    _build.library()
    build_s = time.time() - t0
    print(f"build: {build_s:.1f} s → {_build.build_dir()}")

    if args.out:
        shutil.copy(_build.build_dir() / "build.log", Path(args.out).with_suffix(".build.log"))

    cases = []
    check_w8a8(cases)
    check_flash(cases)
    check_q4(cases)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"{len(bad)} kernel case(s) disagree with the plain version: {bad}")

    ref = reference_check()
    print("reference " + json.dumps(ref), flush=True)
    if not all(r["ok"] for r in ref.values()):
        raise RuntimeError(f"small-input reference check failed: {ref}")

    wrappers = {"flash_attention": flash_attention.flash_attention,
                "w8a8_matmul": quant.quant_matmul_w8a8, "q4_matmul": quant.q4_matmul}
    for fn in wrappers.values():
        fn.launches = 0
    pipe, last_gp, pipe_build_s, wb, reports = run_pipeline(card)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print("launches " + json.dumps(launches))
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise RuntimeError(f"kernels not launched by the main path: {idle}")
    prof = profile_request(pipe, last_gp, args.profile, card) if args.profile else None
    del pipe

    headline = {"flash_attention": [1, 24, 4352, 4352, 128], "w8a8_matmul": [4352, 3072, 12288],
                "q4_matmul": [256, 4096, 10240]}
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["shape"] == headline[name])
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": max(c["max_abs_err"] for c in mine),
                        "ms": head["ms"], "plain_ms": head["plain_ms"]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "cases": cases, "reference": ref,
                       "pipeline_build_s": pipe_build_s, "weight_bytes": wb,
                       "requests": reports, "launches": launches, "kernels": kernels,
                       "profile": prof}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
