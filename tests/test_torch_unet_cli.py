"""The port's CLI on SD2.x, SD1.5-inpainting and instruct-pix2pix single
files against the JAX CLI on the same small files (``tests/_torch_files.py``:
the JAX package's small pipelines of those versions under the LDM names,
SD2's text tower under OpenCLIP's), with their full-size configs swapped
for the small ones (``small_unet_family_configs``): ``--prediction v``,
``heun``, ``-i`` / ``--mask`` on the inpainting UNet, ``-r`` and
``--img-cfg-scale`` on pix2pix; images within one uint8 level, the same
``parameters`` text.  ``-r`` on another model exits 2, and
``tools/sd2_file.py`` / ``tools/sd15_file.py`` (9 and 8 input channels)
write files both loaders fingerprint alike.  (The refusals of unported
``--prediction`` values are ``tests/test_torch_cli.py``'s.)
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py

from _torch_files import (small_unet_family_configs, write_init_and_mask,  # noqa: E402
                          write_small_unet_file)


@pytest.fixture(scope="module")
def unet_files(tmp_path_factory):
    """{version name: a small single file} of SD2, SD1 inpainting and SD1
    pix2pix."""
    import sdtpu.config as jconfig
    from sdtpu.factory import create_pipeline as jax_create_pipeline

    d = tmp_path_factory.mktemp("unet_files")
    return {name: write_small_unet_file(
                d, jax_create_pipeline(getattr(jconfig.SDVersion, name.upper()), small=True,
                                       seed=0), name)
            for name in ("sd2", "sd1_inpaint", "sd1_pix2pix")}


UNET_FILE_REQUESTS = {
    # SD2.1-v: the v denoiser, heun's two calls a step, CFG with a negative
    # prompt, clip skip 2 by default
    "sd2_v_heun": ("sd2", ["-p", "a lighthouse at dusk", "-n", "blurry", "-W", "64", "-H", "64",
                           "--steps", "3", "--cfg-scale", "6", "--prediction", "v",
                           "--sampling-method", "heun", "-s", "3"], ()),
    # SD2 eps at clip skip 1 (the final layer and its norm), euler_a
    "sd2_eps_clip_skip_1": ("sd2", ["-p", "a lighthouse at dusk", "-W", "64", "-H", "64",
                                    "--steps", "2", "--clip-skip", "1", "-s", "4"], ()),
    # SD1.5-inpainting: the init image and the mask into the model's input,
    # the whole schedule (strength 1), image guidance apart from CFG
    "sd1_inpaint_mask": ("sd1_inpaint", ["-p", "a red sofa", "-W", "64", "-H", "64", "--steps",
                                         "3", "--strength", "1.0", "--img-cfg-scale", "2",
                                         "-s", "5"], ("init", "mask")),
    # instruct-pix2pix: the edit image by -r, image guidance at 1.5
    "sd1_pix2pix_ref": ("sd1_pix2pix", ["-p", "make it snow", "-W", "64", "-H", "64", "--steps",
                                        "3", "--cfg-scale", "7.5", "--img-cfg-scale", "1.5",
                                        "--sampling-method", "euler", "-s", "6"], ("ref",)),
}


@pytest.mark.parametrize("name", sorted(UNET_FILE_REQUESTS))
def test_cli_sd2_inpaint_and_pix2pix_files_match_jax_cli(unet_files, monkeypatch, tmp_path, name):
    """``-m`` with a small SD2.x (OpenCLIP-H under ``cond_stage_model.model.``),
    SD1.5-inpainting or instruct-pix2pix single file, ``--prediction v``,
    ``-i`` / ``--mask`` on the inpainting UNet, ``-r`` and
    ``--img-cfg-scale`` on pix2pix: images within one uint8 level of the
    JAX CLI's, the same ``parameters`` text."""
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli

    small_unet_family_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    family, argv, images = UNET_FILE_REQUESTS[name]
    init, mask = write_init_and_mask(tmp_path)
    extra = {"init": ["-i", init], "mask": ["--mask", mask], "ref": ["-r", init]}
    args = ["-m", unet_files[family]] + argv + [a for k in images for a in extra[k]]
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    assert report["load"]["version"] == family
    assert type(report["pipeline"].denoiser).__name__ == (
        "CompVisVDenoiser" if "--prediction" in argv else "CompVisDenoiser")
    a, b = Image.open(report["outputs"][0]), Image.open(str(tmp_path / "jax.png"))
    assert a.info["parameters"] == b.info["parameters"] and a.size == b.size
    assert np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max() <= 1


def test_ref_image_off_the_pix2pix_unets_exits_2(unet_files, monkeypatch, tmp_path, capsys):
    """``-r`` on a model that takes no edit image (an SD2 file) exits 2
    naming the flag and the model."""
    from sdtpu_torch import cli

    small_unet_family_configs(monkeypatch)
    init, _ = write_init_and_mask(tmp_path)
    assert cli.main(["-m", unet_files["sd2"], "-p", "x", "-W", "64", "-H", "64", "--steps", "1",
                     "-r", init, "--backend", "cpu", "-o", str(tmp_path / "x.png")]) == 2
    err = capsys.readouterr().err
    assert "--ref-image" in err and "sd2" in err


@pytest.mark.parametrize("tool,version", [("sd2_file", "sd2"), ("sd15_file", "sd1_inpaint"),
                                          ("sd15_file", "sd1_pix2pix")])
def test_sd2_and_sd15_file_tools_write_files_the_cli_answers_from(monkeypatch, tmp_path, tool,
                                                                  version):
    """``tools/sd2_file.py`` (OpenCLIP-H under its own names, 24 resblocks
    at full width: one more than the config reads) and ``tools/sd15_file.py``
    with 9 and 8 input channels, at the small configs: fingerprinted alike
    by both packages' loaders and answered by the port's CLI."""
    import importlib

    from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
    from sdtpu_torch import cli
    from sdtpu_torch.io.model_loader import load_model_bundle

    small_unet_family_configs(monkeypatch)
    mod = importlib.import_module(f"sdtpu_torch.tools.{tool}")
    in_channels = {"sd2": 4, "sd1_inpaint": 9, "sd1_pix2pix": 8}[version]
    if tool == "sd2_file":
        import sdtpu_torch.models.clip as tclip

        monkeypatch.setattr(mod, "OPEN_CLIP_H", dataclasses.replace(
            tclip.CLIP_H_CONFIG, num_layers=tclip.CLIP_H_CONFIG.num_layers + 1,
            projection_dim=tclip.CLIP_H_CONFIG.hidden_size))
        out = mod.write_sd2_file(tmp_path / "m.safetensors", device="cpu")
    else:
        out = mod.write_sd15_file(tmp_path / "m.safetensors", device="cpu", in_channels=in_channels)
    assert out["tensors"] == len(mod.file_specs(in_channels))
    got = load_model_bundle(model_path=out["path"])
    want = jax_load_model_bundle(model_path=out["path"]).version.value
    assert got.version.value == want == version
    assert got.diffusion["input_blocks.0.0.weight"].shape[1] == in_channels
    report = {}
    init, _ = write_init_and_mask(tmp_path)
    argv = ["-m", out["path"], "-p", "a cat", "-W", "64", "-H", "64", "--steps", "2",
            "--backend", "cpu", "-o", str(tmp_path / "out.png")]
    assert cli.main(argv + (["-r", init] if version == "sd1_pix2pix" else []), report=report) == 0
    assert report["load"]["version"] == version and report["timings"]["steps"] == 2
