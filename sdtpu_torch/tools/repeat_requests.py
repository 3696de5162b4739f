#!/usr/bin/env python3
"""Answer the same txt2img request several times on one pipeline and print
each answer's timings, to tell a first request's warm-up from a steady
change.

    PYTHONPATH=<checkout> python3 <checkout>/sdtpu_torch/tools/repeat_requests.py \
        [--repeats 8] [--paths int8,w8a16,q8_0_gguf,sd3] [--label name]

For each path, a full-width FLUX.1-dev pipeline with random weights drawn on
the card from seed 0 (int8 DiT, 4-bit T5-XXL, bf16 CLIP-L and VAE, VAE tiling
on, as ``chip_smoke.py`` builds it; ``w8a16`` is the same pipeline under
``SDTPU_QUANT_MODE=w8a16``; ``q8_0_gguf`` the DiT as group-32 int8 blocks)
answers a 512² × 4-step request (seed 42) ``--repeats`` times; ``sd3`` (not
run unless named) is ``chip_smoke.py``'s bf16 SD3.5-Medium pipeline (4-bit
T5-XXL) answering its ``SD3_REQUEST``, the bench's 1024² × 28-step dpm++2m
request at CFG 4.5 (shapes, seeds and builder taken from the
``chip_smoke.py`` beside this script).  The pipeline's prompt cache, in a
checkout that has one, is emptied before each answer, so every answer
encodes its prompt.  One line per
answer: ``repeat {...}`` with its cond / sample / decode seconds, denoise
steps per second and what the caching allocator did during it (new device
segments, i.e. cudaMalloc calls, and allocation retries, each of which frees
the cache and synchronizes).  The script reads only the public entry points,
so ``PYTHONPATH`` may point it at another checkout's package (the kernels are
then built from that checkout's sources), and two checkouts can be compared
on the same card in one session.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

REQUEST = dict(prompt="a photograph of an astronaut riding a horse", width=512, height=512,
               sample_steps=4, cfg_scale=1.0, guidance=3.5, seed=42)
# the caching allocator's counters read around each answer
ALLOCATOR = {"new_segments": "num_device_alloc", "alloc_retries": "num_alloc_retries"}


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pipeline(path: str, card: str):
    import torch

    if path == "sd3":
        return _chip_smoke().build_sd3_pipeline(card)[0]

    from sdtpu_torch.config import SDVersion
    from sdtpu_torch.factory import create_pipeline
    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.weights import synthesize

    dit = None
    if path == "q8_0_gguf":
        dit = synthesize(flux_mod.param_specs(flux_mod.FLUX_DEV_CONFIG), quant="q8_0_gguf", seed=1,
                         device="cuda", dtype=torch.bfloat16)
    pipe = create_pipeline(SDVersion.FLUX, params={"diffusion": dit}, dtype=torch.bfloat16,
                           device="cuda", seed=0)
    pipe.set_vae_tiling(True)
    return pipe


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--paths", default="int8,w8a16,q8_0_gguf")
    ap.add_argument("--label", default="", help="a name for this checkout in the output lines")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("repeat_requests: no CUDA device", file=sys.stderr)
        return 2
    import sdtpu_torch
    from sdtpu_torch.config import GenerationParams
    from sdtpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; package {os.path.dirname(sdtpu_torch.__file__)}", flush=True)
    t0 = time.time()
    _build.library()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    summary = {}
    for path in args.paths.split(","):
        previous = os.environ.pop("SDTPU_QUANT_MODE", None)
        if path == "w8a16":
            os.environ["SDTPU_QUANT_MODE"] = "w8a16"
        try:
            pipe = _pipeline(path, card)
            gp = GenerationParams(**(_chip_smoke().SD3_REQUEST if path == "sd3"
                                     else dict(sample_method="euler", **REQUEST)))
            rates = []
            for i in range(args.repeats):
                getattr(pipe, "_cond_cache", {}).clear()  # each answer encodes its prompt
                before = torch.cuda.memory_stats()
                pipe.generate(gp)
                after = torch.cuda.memory_stats()
                tm = pipe.last_timings
                rates.append(tm["steps"] / tm["sample"])
                print("repeat " + json.dumps({
                    "label": args.label, "path": path, "i": i,
                    "timings_s": {k: tm[k] for k in ("cond", "sample", "decode", "total")},
                    "denoise_steps_per_s": rates[-1],
                    **{k: after.get(key, 0) - before.get(key, 0) for k, key in ALLOCATOR.items()},
                    "card": card}), flush=True)
            summary[path] = {"first": rates[0], "rest_min": min(rates[1:], default=None),
                             "rest_max": max(rates[1:], default=None)}
        finally:
            os.environ.pop("SDTPU_QUANT_MODE", None)
            if previous is not None:
                os.environ["SDTPU_QUANT_MODE"] = previous
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": card, "steps_per_s": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
