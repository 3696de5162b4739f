"""The port's ControlNet and canny against ``sdtpu``.

The ControlNet copies the small SD1 UNet (``unet_config_for(SD1,
small=True)``; SDXL's small one with its label embedding) on weights from
``init_controlnet_params`` with the zero convs and ``middle_block_out``
redrawn non-zero from a numpy seed, bridged with ``from_jax_params``;
float32 on both sides: rtol = atol = 5e-4, the goldens' tolerance (sums in
another order, MKL / oneDNN against XLA).  The same holds the controlled
UNet forward and a small SD1 pipeline's latent under a canny hint.
``canny`` is host numpy in both packages: bit-equal.  ``load_controlnet``
reads a ControlNet file under CompVis or diffusers names to the JAX
loader's dict, and the CLI answers ``--control-net`` / ``--control-image``
/ ``--canny`` with a diffusers-named ControlNet and a diffusers-named SD1
UNet as the JAX CLI does.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.diffusion.preprocessing import canny as jcanny
from sdtpu.factory import unet_config_for as jax_unet_config_for
from sdtpu.models import controlnet as jcn
from sdtpu.models import unet as ju
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.diffusion.preprocessing import canny
from sdtpu_torch.factory import unet_config_for
from sdtpu_torch.models import controlnet as tcn
from sdtpu_torch.models import unet as tu
from sdtpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py

from _torch_files import small_sd1_configs, small_sd1_pipeline, write_small_sd1_file  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-4)


def _files_cfg():
    """The small SD1 UNet with two resblocks a level: the diffusers names
    number the blocks three a level (``convert_diffusers_unet_name``'s
    default), as the full UNets have them."""
    return dataclasses.replace(unet_config_for(SDVersion.SD1, small=True), num_res_blocks=2)


def _cn_params(jcfg, seed=1):
    """The JAX ControlNet init with its taps redrawn non-zero."""
    p = jcn.init_controlnet_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed)
    for k in p:
        if k.startswith(("zero_convs.", "middle_block_out.")):
            p[k] = jnp.asarray(rng.standard_normal(p[k].shape, dtype=np.float32) * 0.05)
    return p


@pytest.fixture(scope="module", params=["SD1", "SDXL"])
def family(request):
    name = request.param
    jcfg = jax_unet_config_for(getattr(jconfig.SDVersion, name), small=True)
    tcfg = unet_config_for(getattr(SDVersion, name), small=True)
    jp = _cn_params(jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    hint = rng.random((1, 64, 64, 3), dtype=np.float32).repeat(2, axis=0)
    ts = np.asarray([801.0, 12.5], np.float32)
    ctx = rng.standard_normal((2, 77, jcfg.context_dim), dtype=np.float32)
    y = rng.standard_normal((2, jcfg.adm_in_channels), dtype=np.float32) if jcfg.adm_in_channels else None
    return name, jcfg, tcfg, jp, from_jax_params(jp, device="cpu"), (x, hint, ts, ctx, y)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_controlnet_specs_match_jax_init(family):
    _, _, tcfg, jp, _, _ = family
    specs = tcn.controlnet_specs(tcfg)
    assert {k: s for k, (s, _) in specs.items()} == {k: tuple(v.shape) for k, v in jp.items()}


def test_controlnet_forward_matches_jax(family):
    _, jcfg, tcfg, jp, tp, (x, hint, ts, ctx, y) = family
    want_c, want_m = jcn.controlnet_forward(jp, _j(x), _j(hint), _j(ts), _j(ctx), y=_j(y), cfg=jcfg)
    got_c, got_m = tcn.controlnet_forward(tp, _t(x), _t(hint), _t(ts), _t(ctx), y=_t(y), cfg=tcfg)
    assert len(got_c) == len(want_c) == len(tu._block_layout(tcfg)[0])
    for g, w in zip(got_c + [got_m], list(want_c) + [want_m]):
        assert float(np.abs(np.asarray(w)).max()) > 0  # the taps are live
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_controlled_unet_forward_matches_jax(family):
    """The UNet with each side's ControlNet residuals at strength 0.7: the
    same as the JAX one, and unlike the forward without them."""
    _, jcfg, tcfg, jp, tp, (x, hint, ts, ctx, y) = family
    jup = ju.init_unet_params(jcfg, seed=2)
    tup = from_jax_params(jup, device="cpu")
    jc = jcn.controlnet_forward(jp, _j(x), _j(hint), _j(ts), _j(ctx), y=_j(y), cfg=jcfg)
    tc = tcn.controlnet_forward(tp, _t(x), _t(hint), _t(ts), _t(ctx), y=_t(y), cfg=tcfg)
    want = ju.unet_forward(jup, _j(x), _j(ts), _j(ctx), y=_j(y), cfg=jcfg, controls=jc,
                           control_strength=0.7)
    got = tu.unet_forward(tup, _t(x), _t(ts), _t(ctx), y=_t(y), cfg=tcfg, controls=tc,
                          control_strength=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tu.unet_forward(tup, _t(x), _t(ts), _t(ctx), y=_t(y), cfg=tcfg)
    assert float((got - plain).abs().max()) > 1e-2


def _structured(size=64, seed=3):
    """A uint8 image with edges (a disc and a bar over noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    img = (rng.random((size, size, 3)) * 40).astype(np.uint8)
    img[(yy - size / 2) ** 2 + (xx - size / 3) ** 2 < (size / 5) ** 2] = (220, 180, 40)
    img[size // 6:size // 4, :] = (20, 200, 240)
    return img


@pytest.mark.parametrize("case", ["rgb", "noise", "gray", "inverse", "thresholds"])
def test_canny_is_bit_equal(case):
    img = _structured() if case != "noise" else np.random.default_rng(4).integers(
        0, 256, (48, 40, 3), dtype=np.uint8)
    kw = {}
    if case == "gray":
        img = img[..., 1]
    if case == "inverse":
        kw = dict(inverse=True)
    if case == "thresholds":
        kw = dict(low_threshold=0.02, high_threshold=0.3, weak=0.25, strong=0.9)
    got, want = canny(img, **kw), jcanny(img, **kw)
    assert got.dtype == np.uint8 and got.shape == img.shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)
    assert 0 < int((got > 0).sum()) < got.size


def test_sd1_controlnet_pipeline_matches_jax():
    """A small SD1 pipeline with a ControlNet and a canny hint at strength
    0.8, CFG 5 over three euler_a steps: the latent within the goldens'
    tolerance of the JAX pipeline's, and away from the one without the
    hint."""
    from sdtpu_torch.factory import create_pipeline

    jpipe = small_sd1_pipeline()
    jcfg = jax_unet_config_for(jconfig.SDVersion.SD1, small=True)
    cn = _cn_params(jcfg, seed=9)
    jpipe.set_controlnet(cn)
    params = {"diffusion": from_jax_params(jpipe.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(jpipe.conditioner.params, device="cpu"),
              "vae": from_jax_params(jpipe.vae_params, device="cpu"),
              "controlnet": from_jax_params(cn, device="cpu")}
    tpipe = create_pipeline(SDVersion.SD1, params=params, small=True, device="cpu")
    hint = canny(_structured())
    gp = GenerationParams(prompt="a lighthouse", negative_prompt="blurry", width=64, height=64,
                          sample_steps=3, cfg_scale=5.0, seed=4, sample_method="euler_a")
    want = jpipe.generate(jconfig.GenerationParams(**dataclasses.asdict(gp)), control_image=hint,
                          control_strength=0.8)
    got = tpipe.generate(gp, control_image=hint, control_strength=0.8)
    np.testing.assert_allclose(got.latents, want.latents, **TOL)
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1
    plain = tpipe.generate(gp)
    assert np.abs(plain.latents - got.latents).max() > 1e-2


def test_load_controlnet_reads_both_namings_as_the_jax_loader(tmp_path):
    """``tools/controlnet_file.py`` at a small SD1 config: the CompVis and
    the diffusers file load to the same dict, the JAX loader's."""
    from sdtpu.io.model_loader import load_controlnet as jload
    from sdtpu_torch.io.model_loader import load_controlnet
    from sdtpu_torch.tools.controlnet_file import file_specs, write_controlnet_files

    cfg = _files_cfg()
    out = write_controlnet_files(tmp_path, device="cpu", cfg=cfg)
    a, b = (load_controlnet(out["paths"][k]) for k in ("original", "diffusers"))
    assert sorted(a) == sorted(b) == sorted(file_specs(cfg))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], jload(out["paths"]["diffusers"])[k])


def test_cli_controlnet_canny_on_diffusers_files_matches_jax_cli(monkeypatch, tmp_path):
    """``--control-net`` (a diffusers ControlNet file) ``--control-image``
    ``--canny`` ``--control-strength`` on a small SD1 file (two resblocks a
    level, as the diffusers names number them) with its UNet
    replaced by the same UNet under diffusers names (``--diffusion-model``):
    the image within one uint8 level of the JAX CLI's, the same
    ``parameters``; a control image of another size exits 2."""
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli
    from sdtpu_torch.tools.controlnet_file import write_controlnet_files
    from sdtpu_torch.tools.sd15_file import write_unet_files
    from sdtpu_torch.utils.image import write_image

    small_sd1_configs(monkeypatch)
    cfg = _files_cfg()
    monkeypatch.setattr(tu, "SD1_UNET_CONFIG", cfg)
    monkeypatch.setattr(ju, "SD1_UNET_CONFIG", ju.UNetConfig(**dataclasses.asdict(cfg)))
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    jp = small_sd1_pipeline()
    jp.diffusion_params = ju.init_unet_params(ju.SD1_UNET_CONFIG, seed=1)
    model = write_small_sd1_file(tmp_path, jp)
    unet = write_unet_files(tmp_path, device="cpu", cfg=cfg)["paths"]["diffusers"]
    cn = write_controlnet_files(tmp_path, device="cpu", cfg=cfg)["paths"]["diffusers"]
    hint = str(tmp_path / "hint.png")
    write_image(hint, _structured())
    args = ["-m", model, "--diffusion-model", unet, "-p", "a lighthouse", "-W", "64", "-H", "64",
            "--steps", "2", "--cfg-scale", "4", "-s", "2", "--control-net", cn, "--control-image",
            hint, "--canny", "--control-strength", "0.6"]
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")], report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    assert report["pipeline"].controlnet_params is not None
    a, b = Image.open(report["outputs"][0]), Image.open(str(tmp_path / "jax.png"))
    assert a.info["parameters"] == b.info["parameters"]
    assert np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max() <= 1
    write_image(hint, _structured(32))
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "x.png")]) == 2


def test_controlnet_refusals():
    """A tiny UNet has no ControlNet; the CLI refuses a ControlNet without
    its hint (and the reverse) and under ``--hires`` by name."""
    from sdtpu_torch import cli
    from sdtpu_torch.factory import create_pipeline

    pipe = create_pipeline(SDVersion.SDXS_512_DS, small=True, device="cpu")
    with pytest.raises(NotImplementedError, match="SDXS_512_DS"):
        pipe.set_controlnet({})
    parser = cli.build_parser()
    for argv, flag in ((["--control-image", "h.png"], "--control-image"),
                       (["--control-net", "c.safetensors", "--control-image", "h.png", "--hires"],
                        "--hires"), (["--canny"], "--canny")):
        why = cli.unported(parser.parse_args(["-m", "x.safetensors", *argv]), parser)
        assert why and flag in why and "not ported" in why


@pytest.mark.parametrize("name", ["SD1", "SDXL"])
def test_attention_calls_count_the_controlnet_forward(monkeypatch, name):
    """A full-width ControlNet forward under CFG, on the meta device (shapes
    only), makes ``chip_smoke.CONTROLNET_ATTENTION_CALLS`` attention calls
    per head dim, which the card check adds to the UNet's in each call."""
    import chip_smoke

    seen = {}

    def counting(q, k, v, *a, **kw):
        seen[q.shape[-1]] = seen.get(q.shape[-1], 0) + 1
        return torch.empty_like(q)

    monkeypatch.setattr(tu, "attention", counting)
    cfg = unet_config_for(getattr(SDVersion, name))
    side = 64 if name == "SD1" else 128
    meta = {k: torch.empty(s, device="meta") for k, (s, _) in tcn.controlnet_specs(cfg).items()}
    y = torch.empty((2, cfg.adm_in_channels), device="meta") if cfg.adm_in_channels else None
    controls, middle = tcn.controlnet_forward(
        meta, torch.empty((2, side, side, 4), device="meta"), torch.empty((2, 8 * side, 8 * side, 3), device="meta"),
        torch.empty((2,), device="meta"), torch.empty((2, 77, cfg.context_dim), device="meta"), y=y, cfg=cfg)
    assert len(controls) == len(tu._block_layout(cfg)[0]) and middle.shape[0] == 2
    assert seen == chip_smoke.CONTROLNET_ATTENTION_CALLS[name]


def test_control_image_without_a_controlnet_raises():
    """A control image on a pipeline with no ControlNet attached raises by
    name (the JAX pipeline ignores it), and so does one of another size."""
    from sdtpu_torch.factory import create_pipeline

    pipe = create_pipeline(SDVersion.SD1, small=True, device="cpu")
    gp = GenerationParams(prompt="x", width=64, height=64, sample_steps=1)
    with pytest.raises(ValueError, match="no ControlNet attached"):
        pipe.generate(gp, control_image=_structured())
    pipe.set_controlnet(from_jax_params(_cn_params(jax_unet_config_for(jconfig.SDVersion.SD1, small=True)),
                                        device="cpu"))
    with pytest.raises(ValueError, match="does not resize"):
        pipe.generate(gp, control_image=_structured(32))
