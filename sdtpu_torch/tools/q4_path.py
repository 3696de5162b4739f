#!/usr/bin/env python3
"""Answer and profile the ``q4_0`` path's requests with whichever checkout's
package ``PYTHONPATH`` names, so two checkouts can be compared on one card
in one session (``time_dequant.py`` times the kernels alone).

    PYTHONPATH=<checkout> python3 <this checkout>/sdtpu_torch/tools/q4_path.py \
        [--label name] [--out results.json] [--profile table.txt]

The requests and the profiling are ``chip_smoke.py``'s, loaded from this
script's own checkout; the kernels and the pipeline come from the package
on ``PYTHONPATH`` (built from that checkout's sources).  The DiT is
full-width FLUX.1-dev in the ``q4_0`` class on group-32 scales, drawn on the
card as ``chip_smoke.q4_block_dit`` draws it: ``synthesize(quant="q4_0",
seed=1)`` at its default group 64, whose packed bytes do not depend on the
group, with each constant scale repeated onto the group-32 grid (a package
whose ``synthesize`` has no ``group`` argument thus gets the same weights).
Output lines: ``request {...}`` per answer, ``profile {...}`` for one more
1024² request (device time by kernel, busy share) and a summary line with
the launches of the requests.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path


def _chip_smoke():
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def q4_dit(group: int) -> dict:
    import torch

    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.ops.quant import Q4Tensor
    from sdtpu_torch.weights import synthesize

    params = synthesize(flux_mod.param_specs(flux_mod.FLUX_DEV_CONFIG), quant="q4_0", seed=1,
                        device="cuda", dtype=torch.bfloat16)
    for name, v in params.items():
        if isinstance(v, Q4Tensor) and v.group != group:
            params[name] = dataclasses.replace(
                v, scale=v.scale.repeat_interleave(v.group // group, dim=1).contiguous(), group=group)
    return params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--profile", metavar="TABLE", help="write the profiler's table to TABLE with "
                    ".q4_0 before its suffix")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("q4_path: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    import sdtpu_torch
    from sdtpu_torch.ops import _build, quant

    card = cs.card_line()
    print(f"{card}; package {Path(sdtpu_torch.__file__).parent}", flush=True)
    _build.library()

    pipe, info = cs.build_pipeline(card, q4_dit(cs.Q4_DIT_GROUP), f"q4_0 g{cs.Q4_DIT_GROUP}")
    counts = (quant.q4_matmul.launches, getattr(quant.q4_matmul, "launches_wgmma", 0))
    requests = cs.answer(pipe, cs.GGUF_REQUESTS, card, f"q4_0 {args.label}")
    launches = {"q4_matmul": quant.q4_matmul.launches - counts[0],
                "q4_matmul_wgmma": getattr(quant.q4_matmul, "launches_wgmma", 0) - counts[1]}
    prof = None
    if args.profile:
        prof = cs.profile_request(pipe, cs.GGUF_REQUESTS[-1], args.profile, "q4_0", card)
    summary = {"label": args.label, "card": card, "pipeline": info, "launches": launches,
               "steps_per_s": [r["denoise_steps_per_s"] for r in requests]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**summary, "requests": requests, "profile": prof}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
