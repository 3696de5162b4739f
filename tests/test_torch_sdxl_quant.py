"""A quantized SDXL UNet at CFG 1, and ``--type`` in the port's CLI and
server, against ``sdtpu``.

At CFG 1 nothing is batched for guidance, so every transformer block
projects CLIP's 77-token context through ``attn2.to_k`` / ``to_v`` at M = 77
rows: on the card, the int8 matmuls' split-K forms.  Here on the CPU each
wrapper runs its plain version, and the tests hold the slice to the JAX
package on the same weights:

* the small SDXL UNet (linear projections, SDXL's 64-wide head layout cut
  to 16) in three weight classes, quantized by the JAX package and carried
  across by ``from_jax_params``: per-row int8 (W8A8), GGUF-style group-32
  int8 blocks, and q4_0 (4-bit, group 64), each at the golden tolerance
  (rtol = atol = 5e-4).  JAX's ``quant_matmul`` is pinned to
  ``quant_matmul_w8a8``: off the TPU it would dequantize instead.  W8A8
  quantizes each linear's input per row, and float32 sums in another order
  put an activation on the other side of a rounding tie now and then: one
  int8 step moves that row's products, and the following blocks carry it
  on.  So each of the port's per-row int8 linears takes the JAX forward's
  input at the same linear, once its own input agrees with it at the golden
  tolerance.  Readings at this test's input: forced, 1.7e-6 relative L2
  from JAX (max |err| 1.0e-6).  Forced with W8A16 on the same int8 weights
  (the fault the test must see): a later linear's input is 0.015 from
  JAX's, and the output, its inputs unchecked, 1.4e-3 (max |err| 9.7e-4),
  both outside the golden tolerance.  The same two unforced read 8.8e-4
  and 2.1e-3, and at two other inputs 6.9e-5 / 1.8e-6 against 1.9e-3 /
  2.0e-3, which no limit on the unforced forward separates.  The context projections ran at M = 77,
  through the quantized wrappers, and dense weights do not pass.
* ``--type q8_0`` and ``--type q4_0`` through the port's CLI and server on
  the small SDXL file (the bench's request cut to 64²: TAESD-XL, 4 lcm
  steps, CFG 1) give the JAX CLI's images within one uint8 level.  The
  small widths fall under ``quantize_params``' 2**16 elements, so both
  packages quantize from 2**8 here (the JAX function's ``min_size``, the
  port's ``QUANTIZE_MIN_SIZE``), which takes in every linear of the small
  UNet.
"""
import dataclasses
import functools
import os
import queue
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.ops.quant as jq
from sdtpu.models import unet as ju
from sdtpu_torch.factory import sdxl_configs
from sdtpu_torch.models import unet as tu
from sdtpu_torch.ops import basic as tbasic
from sdtpu_torch.ops import quant as tq
from sdtpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py

from _torch_files import (small_sdxl_configs, small_sdxl_pipeline,  # noqa: E402
                          write_small_sdxl_file, write_small_tae_file)

GOLDEN_TOL = dict(rtol=5e-4, atol=5e-4)
MIN_SIZE = 1 << 8  # every linear of the small UNet (its smallest: 32 x 32)
CLASSES = ("q8_0", "q8_0_gguf", "q4_0")
# the small SDXL UNet as the full one runs its transformers: linear
# projections, heads of num_head_channels (16 → 2 and 4 heads), depth 2
TLINEAR = dataclasses.replace(sdxl_configs(small=True)[0], num_heads=None, num_head_channels=16,
                              use_linear_in_transformer=True, transformer_depth=(1, 2))


def _j(cfg):
    return ju.UNetConfig(**dataclasses.asdict(cfg))


def _quantize_jax(params: dict, kind: str) -> dict:
    """The JAX package's classes at the small widths: per-row int8 and q4_0
    by ``quantize_params``, group-32 blocks by ``quantize_group``."""
    if kind == "q8_0":
        return jq.quantize_params(params, min_size=MIN_SIZE)
    if kind == "q4_0":
        return jq.quantize_params(params, min_size=MIN_SIZE, bits=4)
    return {k: (jq.quantize_group(np.asarray(v), 32)
                if np.ndim(v) == 2 and np.size(v) >= MIN_SIZE and k.endswith(".weight") else v)
            for k, v in params.items()}


def _record_rows(monkeypatch) -> list:
    """Every quantized linear the port runs: (rows, class name)."""
    seen = []
    for name in ("quant_matmul", "group_quant_matmul", "q4_matmul"):
        fn = getattr(tbasic, name)

        def rec(x, qt, _fn=fn):
            seen.append((x.numel() // x.shape[-1], type(qt).__name__))
            return _fn(x, qt)

        monkeypatch.setattr(tbasic, name, rec)
    return seen


@pytest.fixture(scope="module")
def unet_params():
    return ju.init_unet_params(_j(TLINEAR), seed=0)


def _take_jax_inputs(monkeypatch, xs, matmul):
    """The port's per-row int8 linears through ``matmul``, each on the JAX
    forward's input at the same linear (``xs``, in call order), once the
    port's own input agrees with it at the golden tolerance."""
    it = iter(xs)

    def run(x, qt):
        xj = torch.from_numpy(np.array(next(it)))
        np.testing.assert_allclose(x.numpy(), xj.numpy(), **GOLDEN_TOL)
        return matmul(xj, qt)

    monkeypatch.setattr(tbasic, "quant_matmul", run)
    return it


@pytest.mark.parametrize("kind", CLASSES)
def test_quantized_unet_at_cfg1_matches_jax(unet_params, monkeypatch, kind):
    jp = _quantize_jax(unet_params, kind)
    tp = from_jax_params(jp, device="cpu")
    cls = {"q8_0": tq.QuantTensor, "q8_0_gguf": tq.GroupQuantTensor, "q4_0": tq.Q4Tensor}[kind]
    attn2 = [k for k in tp if k.endswith(("attn2.to_k.weight", "attn2.to_v.weight"))]
    assert attn2 and all(isinstance(tp[k], cls) for k in attn2)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 16, 8, 4), dtype=np.float32)  # CFG 1: a batch of one
    ts = np.asarray([499.0], np.float32)
    ctx = rng.standard_normal((1, 77, TLINEAR.context_dim), dtype=np.float32)
    y = rng.standard_normal((1, TLINEAR.adm_in_channels), dtype=np.float32)
    inputs = []  # the JAX forward's input at each per-row int8 linear, in call order

    def w8a8(xq, qt):
        inputs.append(xq)
        return jq.quant_matmul_w8a8(xq, qt)

    def fwd(p, x, t, c, y):
        inputs.clear()
        return ju.unet_forward(p, x, t, c, y=y, cfg=_j(TLINEAR)), list(inputs)

    with monkeypatch.context() as m:
        m.setattr(jq, "quant_matmul", w8a8)  # W8A8 on the CPU too
        want, xs = jax.jit(fwd)(jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                                jnp.asarray(y))
    want = np.asarray(want)

    def port(params):
        return tu.unet_forward(params, torch.from_numpy(x), torch.from_numpy(ts),
                               torch.from_numpy(ctx), y=torch.from_numpy(y), cfg=TLINEAR).numpy()

    with monkeypatch.context() as m:
        if kind == "q8_0":
            left = _take_jax_inputs(m, xs, tbasic.quant_matmul)
        seen = _record_rows(m)
        got = port(tp)
    assert got.shape == want.shape == (1, 16, 8, 4)
    np.testing.assert_allclose(got, want, **GOLDEN_TOL)
    if kind == "q8_0":
        assert xs and next(left, None) is None  # every recorded input taken
        # the same check fails with W8A16 on the same weights
        with monkeypatch.context() as m, pytest.raises(AssertionError):
            _take_jax_inputs(m, xs, tq.w8a16_matmul_plain)
            np.testing.assert_allclose(port(tp), want, **GOLDEN_TOL)
    # the context projections ran at M = 77, each through its class's wrapper
    assert [c for rows, c in seen if rows == 77] == [cls.__name__] * len(attn2)
    # and the quantized weights are in the result: dense weights miss it
    assert not np.allclose(port(from_jax_params(unet_params, device="cpu")), want, **GOLDEN_TOL)


# ------------------------------------------------------------------- --type

@pytest.fixture(scope="module")
def sdxl_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sdxl_quant_file")
    return {"model": write_small_sdxl_file(d, small_sdxl_pipeline()),
            "taesd": write_small_tae_file(d)}


@pytest.fixture
def typed(monkeypatch, tmp_path):
    """Both CLIs on the small SDXL configs, quantizing from MIN_SIZE
    elements, with W8A8 on the JAX side (its CPU dispatch would dequantize)."""
    small_sdxl_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    monkeypatch.setattr(jq, "quantize_params", functools.partial(jq.quantize_params,
                                                                 min_size=MIN_SIZE))
    monkeypatch.setattr(tq, "QUANTIZE_MIN_SIZE", MIN_SIZE)
    monkeypatch.setattr(jq, "quant_matmul", jq.quant_matmul_w8a8)


# the bench's SDXL request cut to 64²: TAESD-XL, 4 lcm steps, CFG 1, seed 42
LCM_REQUEST = ["-p", "a photograph of an astronaut riding a horse", "-W", "64", "-H", "64",
               "--steps", "4", "--sampling-method", "lcm", "--cfg-scale", "1", "-s", "42"]


def _jax_png(sdxl_files, wtype, path, request=LCM_REQUEST):
    import sdtpu.cli as jcli

    args = ["-m", sdxl_files["model"], "--taesd", sdxl_files["taesd"], "--type", wtype]
    assert jcli.main(args + request + ["-o", str(path)]) == 0
    from PIL import Image

    return Image.open(path)


@pytest.mark.parametrize("wtype", ["q8_0", "q4_0"])
def test_cli_type_matches_jax_cli(sdxl_files, typed, tmp_path, capsys, wtype):
    from PIL import Image

    from sdtpu_torch import cli

    args = ["-m", sdxl_files["model"], "--taesd", sdxl_files["taesd"], "--type", wtype]
    report = {}
    assert cli.main(args + LCM_REQUEST + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    out = capsys.readouterr().out
    assert f"quantized diffusion weights to {wtype}" in out
    load = report["load"]
    assert load["wtype"] == wtype and load["typed_weights"] > 0
    kind = tq.QuantTensor if wtype == "q8_0" else tq.Q4Tensor
    params = report["pipeline"].diffusion_params
    assert sum(isinstance(v, kind) for v in params.values()) == load["typed_weights"]
    assert all(isinstance(params[k], kind) for k in params
               if k.endswith(("attn2.to_k.weight", "attn2.to_v.weight")))
    a = Image.open(report["outputs"][0])
    b = _jax_png(sdxl_files, wtype, tmp_path / "jax.png")
    assert a.info["parameters"] == b.info["parameters"]
    diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert diff.max() <= 1 and np.asarray(a).std() > 0


def test_type_is_ported_and_checked_by_choice(capsys):
    """``unported()`` lets ``--type`` through; argparse refuses any value but
    q8_0 and q4_0, as in the JAX CLI."""
    from sdtpu_torch import cli

    parser = cli.build_parser()
    for wtype in ("q8_0", "q4_0"):
        assert cli.unported(parser.parse_args(["-m", "x.safetensors", "--type", wtype]),
                            parser) is None
    with pytest.raises(SystemExit):
        parser.parse_args(["-m", "x.safetensors", "--type", "q5_0"])
    assert "invalid choice" in capsys.readouterr().err


def test_quantize_dense_keeps_quantized_weights():
    """``--type`` quantizes only the dense weights: blocks a GGUF kept (or a
    per-row promotion) stay as they were."""
    from sdtpu_torch.cli import quantize_dense

    kept = tq.quantize_group(torch.randn(512, 256))
    dense = torch.randn(512, 256)
    d = {"a.weight": kept, "b.weight": dense, "b.bias": torch.randn(512)}
    out, n = quantize_dense(d, "q8_0")
    assert n == 1 and out["a.weight"] is kept and out["b.bias"] is d["b.bias"]
    assert isinstance(out["b.weight"], tq.QuantTensor)
    out4, n4 = quantize_dense(d, "q4_0")
    assert n4 == 1 and isinstance(out4["b.weight"], tq.Q4Tensor) and out4["a.weight"] is kept


@pytest.mark.parametrize("wtype", ["q8_0", "q4_0"])
def test_server_type_matches_jax_cli(sdxl_files, typed, tmp_path, wtype):
    """``server.main`` reaches ``--type`` through the CLI's loader: one A1111
    lcm request at CFG 1 gives the JAX CLI's image within one uint8 level."""
    import base64
    import io
    import json
    import urllib.request

    from PIL import Image

    from sdtpu_torch import server

    box = queue.Queue()
    report = {}
    argv = ["-m", sdxl_files["model"], "--taesd", sdxl_files["taesd"], "--type", wtype,
            "--backend", "cpu", "--port", "0"]
    thread = threading.Thread(target=server.main, daemon=True,
                              kwargs=dict(argv=argv, report=report, ready=box.put))
    thread.start()
    httpd = box.get(timeout=300)
    try:
        body = {"prompt": "a photograph of an astronaut riding a horse", "width": 64,
                "height": 64, "steps": 4, "cfg_scale": 1.0, "seed": 42, "sampler_name": "lcm"}
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/sdapi/v1/txt2img",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            answer = json.loads(resp.read())
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
    assert report["load"]["wtype"] == wtype and report["load"]["typed_weights"] > 0
    ours = np.asarray(Image.open(io.BytesIO(base64.b64decode(answer["images"][0])))).astype(int)
    theirs = np.asarray(_jax_png(sdxl_files, wtype, tmp_path / "jax.png")).astype(int)
    assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= 1 and ours.std() > 0
