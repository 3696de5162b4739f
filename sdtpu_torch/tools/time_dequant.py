#!/usr/bin/env python3
"""Time the quantized matmuls (4-bit, group-dequant, affine, W8A16, W8A8)
and flash attention at ``chip_smoke.py``'s shapes with whichever
checkout's package ``PYTHONPATH`` names, so checkouts can be compared on one
card in one call, in turns.

    PYTHONPATH=<checkout> python3 <this checkout>/sdtpu_torch/tools/time_dequant.py \
        [--label name] [--kernels w8a8_matmul,flash_attention,...] [--mid] [--out results.json]

Cases: ``q4_matmul`` at ``Q4_CASES``; ``gq_matmul`` (group 32, and group 16
at ``GQ16_CASES``), ``gq_zero_matmul``, ``w8a16_matmul`` and
``quant_matmul_w8a8`` at the ``W8A8_CASES`` of at least 128 rows (their
TMA + wgmma form); then ``gq_matmul`` (groups 32 and 16), ``w8a16_matmul``
and ``quant_matmul_w8a8`` at the cases of at most ``GQ_GEMV_MAX_M`` rows
(their GEMVs); then the same four at the int8 cases of 9 to 127 rows
(``INT8_SPLITK_SHAPES``: an int8 SDXL UNet's 77-row context projections and
a DiT-wide linear at each x tile; ``quant_matmul_w8a8`` also with float32 x
and at ``W8A8_LONG_K_SHAPES``), which a tree runs in its split-K forms
(an older one in its ``mma.sync`` forms, W8A8 after a row-quantize launch:
both counted); then ``flash_attention`` at the ``FLASH_CASES``;
then the float32 forms of the quantized matmuls, float32 x held to the
float32 limit: ``q4_matmul`` at ``Q4_F32_CASES``, ``gq_matmul`` and
``gq_zero_matmul`` at ``GQ_F32_CASES``, ``w8a16_matmul`` at
``W8A16_F32_CASES``.  ``--kernels`` keeps the cases of the named wrappers
only, ``--dtypes`` those of the named activation types (bf16, f32),
``--mid`` the int8 cases of 9 to 127 rows (and W8A8's long-K ones) only.
The shapes, tolerances, input draws and timing are ``chip_smoke.py``'s,
loaded from this script's own checkout; the kernels come from the package
on ``PYTHONPATH`` (built from that checkout's sources).  Each case is held
to its plain version (W8A8 bit-equal), then timed with CUDA events after
warm-up, and a case of at most ``GQ_GEMV_MAX_M`` rows also on the device
clock (``device_ms``: the CUDA-event time reads the Python wrapper's launch
rate there), as the sum over the kernels a call launches of each one's mean
device time, so that a W8A8 call that quantizes x in a launch of its own
counts both; so is a flash case under 0.1 ms (a split call's combine
included), which also records its ``splits``, and a bf16 4-bit case of 9 to
``Q4_WGMMA_MIN_M`` rows (the split-K form and the wgmma threshold) and an
int8 case of 9 to 127 rows, which record the K ``splits`` where the tree's
library reports them.  One
``kernel {...}`` line per case, then a summary line.
"""
from __future__ import annotations

import argparse
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


def time_flash(cs, g, case, label: str, card: str) -> dict:
    """One ``FLASH_CASES`` case: held to its plain version at
    ``FLASH_TOL`` of the largest |output|, then timed with CUDA events."""
    import torch

    from sdtpu_torch.ops import _build
    from sdtpu_torch.ops import flash_attention as fa

    b, h, lq, lk, d, dt, bias = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v = (torch.randn((b, h, l, d), generator=g, device="cuda", dtype=dtype) for l in (lq, lk, lk))
    mask = None
    if bias == "causal":
        mask = torch.full((lq, lk), -1e30, device="cuda").triu(1)
    elif bias == "random":
        mask = torch.randn((lq, lk), generator=g, device="cuda")
    got, want = fa.flash_attention(q, k, v, mask=mask), fa.plain_attention(q, k, v, mask=mask)
    err = (got.float() - want.float()).abs().max().item()
    tol = cs.FLASH_TOL[dt] * want.float().abs().max().item()
    it = cs.iters_for(4.0 * b * h * lq * lk * d)
    ms = cs.time_ms(lambda: fa.flash_attention(q, k, v, mask=mask), it)
    dev = {}
    if ms < 0.1:
        dev["device_ms"] = cs.device_ms_sum(lambda: fa.flash_attention(q, k, v, mask=mask), it)
    splits = None  # a tree older than the query splits only bf16 and float32 D 512
    if "sdtpu_flash_splits" in _build.QUERIES:
        splits = _build.query("sdtpu_flash_splits", _build.DTYPE_CODES[dtype], b * h, lq, lk, d)
    case = dict(label=label, kernel="flash_attention", shape=[b, h, lq, lk, d], dtype=dt, bias=bias,
                splits=splits, ms=ms, **dev, max_abs_err=err, tol=tol, ok=bool(err <= tol), card=card)
    print("kernel " + json.dumps(case), flush=True)
    return case


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", help="comma-separated wrapper names: time only their cases")
    ap.add_argument("--dtypes", default="bf16,f32",
                    help="comma-separated activation types (bf16, f32): time only their cases")
    ap.add_argument("--mid", action="store_true",
                    help="time only the int8 cases of 9 to 127 rows (and W8A8's long-K ones)")
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_dequant: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    import sdtpu_torch
    from sdtpu_torch.ops import _build, quant
    from sdtpu_torch.weights import Q4_SCALE

    card = cs.card_line()
    print(f"{card}; package {Path(sdtpu_torch.__file__).parent}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.library()

    g = torch.Generator(device="cuda").manual_seed(3)
    big = [s for s in cs.W8A8_CASES if s[0] >= 128]
    plan = [("q4_matmul", s[:3], s[3], "bf16") for s in cs.Q4_CASES]
    plan += [(form, s, 32, "bf16") for s in big
             for form in ("gq_matmul", "gq_zero_matmul", "w8a16_matmul", "quant_matmul_w8a8")]
    plan += [("gq_matmul", s, 16, "bf16") for s in cs.GQ16_CASES if s[0] >= 128]
    small = [s for s in cs.W8A8_CASES if s[0] <= quant.GQ_GEMV_MAX_M]
    plan += [(form, s, 32, "bf16") for s in small
             for form in ("gq_matmul", "w8a16_matmul", "quant_matmul_w8a8")]
    plan += [("gq_matmul", s, 16, "bf16") for s in cs.GQ16_CASES if s[0] <= quant.GQ_GEMV_MAX_M]
    mid = cs.INT8_SPLITK_SHAPES
    plan += [(form, s, group, "bf16") for s in mid
             for form, group in (("gq_matmul", 32), ("gq_matmul", 16), ("w8a16_matmul", None),
                                 ("quant_matmul_w8a8", None))]
    plan += [("quant_matmul_w8a8", s, None, dt) for s in mid + cs.W8A8_LONG_K_SHAPES
             for dt in ("bf16", "f32") if s in cs.W8A8_LONG_K_SHAPES or dt == "f32"]
    plan += [("flash_attention", c, None, c[5]) for c in cs.FLASH_CASES]
    plan += [("q4_matmul", s[:3], s[3], "f32") for s in cs.Q4_F32_CASES]
    plan += [(form, s[:3], s[3], "f32") for s in cs.GQ_F32_CASES for form in ("gq_matmul", "gq_zero_matmul")]
    plan += [("w8a16_matmul", s, None, "f32") for s in cs.W8A16_F32_CASES]
    if args.kernels:
        plan = [p for p in plan if p[0] in args.kernels.split(",")]
    if args.mid:
        plan = [p for p in plan if p[0] not in ("q4_matmul", "flash_attention")
                and tuple(p[1]) in mid + cs.W8A8_LONG_K_SHAPES]
    plan = [p for p in plan if p[3] in args.dtypes.split(",")]
    cases = []
    for form, shape, group, dt in plan:
        if form == "flash_attention":
            cases.append(time_flash(cs, g, shape, args.label, card))
            continue
        m, k, n = shape
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((m, k), generator=g, device="cuda", dtype=dtype)
        if form == "q4_matmul":
            kp = -(-k // quant.Q4_K_MULTIPLE) * quant.Q4_K_MULTIPLE
            qt = quant.Q4Tensor(
                packed=torch.randint(0, 256, (n, kp // 2), generator=g, device="cuda", dtype=torch.uint8),
                scale=torch.rand((n, kp // group), generator=g, device="cuda") * Q4_SCALE + Q4_SCALE / 2,
                k=k, group=group)
            fn, plain = quant.q4_matmul, quant.q4_matmul_plain
            rel = cs.Q4_REL_TOL if dt == "bf16" else cs.GQ_REL_TOL["f32"]
        elif form in ("w8a16_matmul", "quant_matmul_w8a8"):
            qt = quant.QuantTensor(
                q=torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8),
                scale=torch.rand((n,), generator=g, device="cuda") * 4e-4 + 1e-5)
            fn, plain = getattr(quant, form), getattr(quant, f"{form}_plain")
            rel = 0.0 if form == "quant_matmul_w8a8" else cs.GQ_REL_TOL[dt]
        else:
            qt = cs._random_group_weight(g, n, k, group, affine=form == "gq_zero_matmul")
            fn, plain, rel = getattr(quant, form), quant.group_quant_matmul_plain, cs.GQ_REL_TOL[dt]
        got, want = fn(x, qt), plain(x, qt)
        err = (got.float() - want.float()).abs().max().item()
        tol = rel * want.float().abs().max().item()
        it = cs.iters_for(2.0 * m * n * k)
        ms = cs.time_ms(lambda: fn(x, qt), it)
        mid_q4 = form == "q4_matmul" and dt == "bf16" and quant.Q4_GEMV_MAX_M < m <= quant.Q4_WGMMA_MIN_M
        mid_int8 = form != "q4_matmul" and (m, k, n) in mid + cs.W8A8_LONG_K_SHAPES
        dev = ({"device_ms": cs.device_ms_sum(lambda: fn(x, qt), it)}
               if m <= quant.GQ_GEMV_MAX_M or mid_q4 or mid_int8 else {})
        # the K splits where the tree's library reports them (an older tree: no split)
        query = ("sdtpu_q4_splits" if mid_q4 else "sdtpu_w8a8_splits" if form == "quant_matmul_w8a8"
                 else "sdtpu_gq_splits")
        if (mid_q4 or mid_int8) and query in _build.QUERIES:
            dev["splits"] = _build.query(query, m, n, k)
        case = dict(label=args.label, kernel=form, shape=[m, k, n], group=group, dtype=dt, ms=ms, **dev,
                    max_abs_err=err, tol=tol, ok=bool(err <= tol), card=card)
        print("kernel " + json.dumps(case), flush=True)
        cases.append(case)
        del x, qt, got, want
    summary = {"label": args.label, "card": card, "cases": len(cases),
               "ok": all(c["ok"] for c in cases)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**summary, "kernels": cases}, f, indent=1)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
