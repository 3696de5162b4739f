"""The port's CLI against the JAX CLI, on the same small checkpoint files.

Both CLIs load the files written by ``tests/_torch_files.py`` (the JAX
package's small FLUX weights as a q8_0 DiT GGUF, CLIP-L and VAE
safetensors, a q8_0 T5 GGUF under llama.cpp names with an embedded vocab;
its small SD1 and SDXL weights as float16 single-file checkpoints, beside
a TAESD-XL decoder file; its small SD3 weights as an SD3.5 set: the MMDiT
and the VAE in one float16 file, CLIP-L, CLIP-G and a q8_0 T5 GGUF beside
it; its small Wan2.1 T2V weights as a Wan set: the DiT and the VAE as
float16 safetensors, a q8_0 UMT5 GGUF), with their full-size configs
swapped for the small ones.  The port runs
with ``--backend cpu``.  Their images may differ by one uint8 level (a
float32 pixel on a rounding boundary); the ``parameters`` text is equal.
img2img (``-i``, ``--mask``, ``--strength``, ``--sigmas``) and the latent
hires fix (``--hires*``) run on the FLUX files and the SD1 file against
the JAX CLI the same way, from PNGs Pillow wrote.  Unported flags, modes
and values (an ESRGAN ``--hires-upscaler`` among them), and init images
the port cannot read, exit 2 before anything loads.
"""
import dataclasses
import json
import os
import struct
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py

from _torch_files import (small_configs, small_jax_pipeline, small_sd1_configs,  # noqa: E402
                          small_sd1_pipeline, small_sd3_configs, small_sd3_pipeline,
                          small_sdxl_configs, small_sdxl_pipeline, small_wan_configs,
                          small_wan_pipeline, write_init_and_mask, write_small_flux_files,
                          write_small_sd1_file, write_small_sd3_files, write_small_sdxl_file,
                          write_small_tae_file, write_small_wan_files)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_files")
    return d, write_small_flux_files(d, small_jax_pipeline())


@pytest.fixture
def small(monkeypatch, tmp_path):
    small_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))


def _file_args(paths):
    return ["--diffusion-model", paths["diffusion_model"], "--clip_l", paths["clip_l"],
            "--t5xxl", paths["t5xxl"], "--vae", paths["vae"]]


REQUESTS = {
    # the default sampler (euler_a) and schedule, no CFG
    "euler_a": ["-p", "a red fox in snow", "-W", "64", "-H", "64", "--steps", "3",
                "--cfg-scale", "1.0", "-s", "5"],
    # CFG, a negative prompt, a batch of two, the flux schedule, euler_a's
    # noise (eta 1), VAE tiling
    "cfg_batch_tiled": ["-p", "the golden lantern on a wooden table", "-n", "blurry",
                        "-W", "96", "-H", "64", "--steps", "2", "--cfg-scale", "2.5",
                        "--guidance", "4.0", "-b", "2", "--schedule", "flux", "--eta", "1.0",
                        "-s", "11", "--vae-tiling", "--vae-tile-size", "8",
                        "--vae-tile-overlap", "2"],
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_cli_images_match_jax_cli(files, small, tmp_path, name, capsys):
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu.tokenizers.gguf_vocab import tokenizer_from_gguf_file
    from sdtpu_torch import cli

    _, paths = files
    args = _file_args(paths) + REQUESTS[name]
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    n = 2 if "-b" in args else 1
    outs = report["outputs"]
    assert len(outs) == n
    for i, ours in enumerate(outs):
        theirs = str(tmp_path / (f"jax_{i}.png" if n > 1 else "jax.png"))
        assert os.path.basename(ours) == os.path.basename(theirs).replace("jax", "port")
        a, b = Image.open(ours), Image.open(theirs)
        assert a.info["parameters"] == b.info["parameters"]
        diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
        assert diff.max() <= 1
    assert report["load"]["t5_tokenizer"] == "gguf:" + paths["t5xxl"]
    prompt = args[args.index("-p") + 1]
    tok = tokenizer_from_gguf_file(paths["t5xxl"])
    # the ids T5 was fed: the prompt's, padded to the full-size sequence (256)
    assert report["t5_ids"] == tok.pad(tok.encode(prompt, add_eos=True), 256)[0]
    assert any(report["t5_ids"][:-1])
    assert set(report["timings"]) == {"cond", "sample", "decode", "total", "steps"}


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_metadata_mode_matches_jax(tmp_path, capsys, monkeypatch, fmt):
    import sdtpu.cli as jcli
    from sdtpu_torch import cli
    from sdtpu_torch.utils.image import write_image

    path = str(tmp_path / "m.png")
    write_image(path, np.full((8, 8, 3), 7, np.uint8),
                parameters="a cat\nNegative prompt: dog\nSteps: 4, Sampler: euler_a, Seed: 3")
    argv = ["metadata", "--image", path, "--metadata-format", fmt, "--metadata-all"]
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))  # the JAX CLI makes it
    capsys.readouterr()
    assert cli.main(argv) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert ours == capsys.readouterr().out
    assert "euler_a" in ours


UNPORTED = [
    ["--lora-model-dir", "loras"], ["--hires-upscaler", "RealESRGAN_x4plus"],
    ["--upscale-model", "esrgan.pth"], ["--auto-fit", "8"],
    ["--sampling-method", "dpm2"], ["--schedule", "karras"], ["--fa"], ["--no-progress"],
    ["--vae-on-cpu"], ["--control-net", "cn.safetensors"], ["--audio-vae", "audio.gguf"],
    ["--backend", "clip=cpu,diffusion=cuda0"], ["--backend", "tpu0"], ["--dtype", "f16"],
    ["-p", "a <lora:detail:0.8> cat"], ["convert"], ["-M", "vid_gen"],
    ["--embd-dir", "embeddings"],  # textual inversion (SD1's EmbeddingMixin)
    ["--taesd", "taesd.safetensors", "--taesd-preview-only"],  # the port has no preview
    # denoisers the port does not have
    ["--prediction", "edm_v"], ["--prediction", "sefi_flow"], ["--prediction", "minit2i_flow"],
]


@pytest.mark.parametrize("extra", UNPORTED, ids=[" ".join(a) for a in UNPORTED])
def test_unported_arguments_exit_2(tmp_path, capsys, extra):
    from sdtpu_torch import cli

    missing = str(tmp_path / "missing.gguf")  # nothing is read before the refusal
    assert cli.main(["--diffusion-model", missing] + extra) == 2
    err = capsys.readouterr().err
    assert "not ported" in err
    named = [a for a in extra if a.startswith("-") and a not in ("-p", "-M")]
    named += ["LoRA"] if "<lora:" in " ".join(extra) else []
    named += [a for a in extra if a in ("convert", "vid_gen")]
    assert any(n in err for n in named), err


def test_missing_modules_are_refused(files, small, tmp_path):
    from sdtpu_torch import cli

    _, paths = files
    with pytest.raises(SystemExit, match="vae"):
        cli.main(["--diffusion-model", paths["diffusion_model"], "--clip_l", paths["clip_l"],
                  "--t5xxl", paths["t5xxl"], "--backend", "cpu", "-o", str(tmp_path / "x.png")])


def test_flux_files_tool_writes_a_set_the_cli_answers_from(small, tmp_path):
    """``sdtpu_torch.tools.flux_files`` (the card check's file set: q8_0 DiT
    and T5 GGUFs from raw blocks, T5 under llama.cpp names with its vocab,
    CLIP-L bf16, the VAE with its encoder) at the small configs, answered by
    the port's CLI and read back in metadata mode."""
    from sdtpu_torch import cli
    from sdtpu_torch.io.gguf import GGUFFile
    from sdtpu_torch.tools.flux_files import write_flux_files
    from sdtpu_torch.utils.image import decode_png

    files = write_flux_files(tmp_path / "set", double=1, single=2, device="cpu",
                             min_quant_elems=1024)
    paths = files["paths"]
    assert all(os.path.getsize(p) == files["bytes"][f] for f, p in paths.items())
    f = GGUFFile(paths["t5xxl"])
    try:
        assert f.tensor_type("token_embd.weight") == "q8_0"
        assert len(f.metadata["tokenizer.ggml.tokens"]) == 256
    finally:
        f.close()
    report = {}
    out = str(tmp_path / "out.png")
    argv = _file_args(paths) + ["-p", "a lantern on a wooden table", "-W", "64", "-H", "64",
                                "--steps", "2", "--sampling-method", "euler", "--vae-tiling",
                                "--backend", "cpu", "-o", out]
    assert cli.main(argv, report=report) == 0
    assert report["load"]["t5_tokenizer"] == "gguf:" + paths["t5xxl"]
    ids = report["t5_ids"]
    eos = ids.index(1)
    assert len(ids) == 256 and any(ids[:eos]) and not any(ids[eos + 1:])
    with open(out, "rb") as f:
        img, params = decode_png(f.read())
    assert img.shape == (64, 64, 3) and img.std() > 0
    assert params.startswith("a lantern on a wooden table\nSteps: 2, Sampler: euler")
    assert report["pipeline"].diffusion_fn is not None


@pytest.fixture(scope="module")
def sd1_file(tmp_path_factory):
    return write_small_sd1_file(tmp_path_factory.mktemp("sd1_file"), small_sd1_pipeline())


SD1_REQUESTS = {
    # the bench's sampler and CFG (euler_a, 7), the default schedule
    "euler_a_cfg": ["-p", "an astronaut riding a horse", "-W", "64", "-H", "64", "--steps", "3",
                    "--cfg-scale", "7.0", "-s", "42"],
    # dpm++2m, a negative prompt, a batch of two, clip skip 2, a prompt of
    # two 77-token chunks
    "dpmpp2m_batch": ["-p", "a red fox " + "in deep snow " * 30, "-n", "blurry", "-W", "64",
                      "-H", "96", "--steps", "2", "--sampling-method", "dpm++2m", "-b", "2",
                      "--clip-skip", "2", "-s", "7"],
}


@pytest.mark.parametrize("name", sorted(SD1_REQUESTS))
def test_cli_sd1_file_matches_jax_cli(sd1_file, monkeypatch, tmp_path, name):
    """``-m`` with an SD1 single-file checkpoint: both CLIs fingerprint it as
    SD1 and split it by its LDM prefixes; no T5 is asked for."""
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli

    small_sd1_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    args = ["-m", sd1_file] + SD1_REQUESTS[name]
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    assert report["load"]["version"] == "sd1" and report["load"]["t5_tokenizer"] is None
    assert report["t5_ids"] is None
    n = 2 if "-b" in args else 1
    assert len(report["outputs"]) == n
    for i, ours in enumerate(report["outputs"]):
        theirs = str(tmp_path / (f"jax_{i}.png" if n > 1 else "jax.png"))
        a, b = Image.open(ours), Image.open(theirs)
        assert a.info["parameters"] == b.info["parameters"]
        diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
        assert diff.max() <= 1


def test_sd15_file_tool_writes_a_file_the_cli_answers_from(monkeypatch, tmp_path):
    """``sdtpu_torch.tools.sd15_file`` (the card check's SD1.5 file: float16,
    the LDM names, the VAE's encoder and quant convs) at the small configs,
    fingerprinted as SD1 by both packages' loaders and answered by the
    port's CLI."""
    from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
    from sdtpu_torch import cli
    from sdtpu_torch.io.model_loader import load_model_bundle
    from sdtpu_torch.io.safetensors import load_safetensors
    from sdtpu_torch.tools.sd15_file import file_specs, write_sd15_file

    small_sd1_configs(monkeypatch)
    out = write_sd15_file(tmp_path / "sd15.safetensors", device="cpu")
    assert os.path.getsize(out["path"]) > out["bytes"] - 1 and out["tensors"] == len(file_specs())
    with open(out["path"], "rb") as f:
        header = json.loads(f.read(struct.unpack("<Q", f.read(8))[0]))
    assert {v["dtype"] for v in header.values()} == {"F16"}
    tensors = load_safetensors(out["path"])
    assert set(tensors) == set(file_specs()) and "first_stage_model.quant_conv.weight" in tensors
    assert load_model_bundle(model_path=out["path"]).version.value == "sd1"
    assert jax_load_model_bundle(model_path=out["path"]).version.value == "sd1"
    report = {}
    png = str(tmp_path / "out.png")
    assert cli.main(["-m", out["path"], "-p", "a cat", "-W", "64", "-H", "64", "--steps", "2",
                     "--backend", "cpu", "-o", png], report=report) == 0
    assert report["load"]["version"] == "sd1" and report["timings"]["steps"] == 2


IMG2IMG_REQUESTS = {
    # (family, argv, with the init image, with the mask)
    "flux_mask": ("flux", ["-p", "a lantern on a wooden table", "-W", "64", "-H", "64", "--steps",
                           "4", "--sampling-method", "euler", "--cfg-scale", "1.0", "--guidance",
                           "3.0", "-s", "5", "--strength", "0.6"], True, True),
    # custom sigmas cut by strength
    "flux_sigmas": ("flux", ["-p", "a red fox in snow", "-W", "64", "-H", "64", "--sigmas",
                             "1.0,0.7,0.4,0.15", "--strength", "0.8", "--sampling-method", "euler",
                             "--cfg-scale", "1.0", "-s", "6"], True, False),
    # euler_a's noise (eta 1) for the cut steps, CFG, a batch of two
    "sd1_cfg_batch": ("sd1", ["-p", "an astronaut riding a horse", "-n", "blurry", "-W", "64",
                              "-H", "64", "--steps", "3", "--cfg-scale", "5", "-b", "2", "--eta",
                              "1.0", "--strength", "0.5", "-s", "8"], True, False),
    # a given size (up on one axis, down on the other), its own steps,
    # strength and sigmas (--hires-scale runs in the pipeline's test)
    "sd1_hires_size": ("sd1", ["-p", "a watercolour harbour", "-W", "64", "-H", "64", "--steps",
                               "3", "--cfg-scale", "1", "-s", "9", "--sampling-method", "euler",
                               "--hires", "--hires-width", "96", "--hires-height", "48",
                               "--hires-steps", "2", "--hires-denoising-strength", "0.6",
                               "--hires-sigmas", "10,3,1"], False, False),
}


@pytest.mark.parametrize("name", sorted(IMG2IMG_REQUESTS))
def test_cli_img2img_and_hires_match_jax_cli(request, monkeypatch, tmp_path, name):
    """``-i`` (an RGBA PNG Pillow wrote), ``--mask`` (a grey one: channel
    0), ``--strength``, ``--sigmas`` and ``--hires`` with the latent
    upscaler on the small FLUX files and the SD1 file: images within one
    uint8 level of the JAX CLI's, the same ``parameters`` text; the loaded
    VAE keeps its encoder."""
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli

    family, argv, with_init, with_mask = IMG2IMG_REQUESTS[name]
    if family == "flux":
        args = _file_args(request.getfixturevalue("files")[1])
        small_configs(monkeypatch)
    else:
        args = ["-m", request.getfixturevalue("sd1_file")]
        small_sd1_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    init, mask = write_init_and_mask(tmp_path)
    args += argv + (["-i", init] if with_init else []) + (["--mask", mask] if with_mask else [])
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    assert "encoder.conv_in.weight" in report["pipeline"].vae_params
    assert ("encode" in report["timings"]) == with_init
    n = 2 if "-b" in args else 1
    for i, ours in enumerate(report["outputs"]):
        theirs = str(tmp_path / (f"jax_{i}.png" if n > 1 else "jax.png"))
        a, b = Image.open(ours), Image.open(theirs)
        assert a.info["parameters"] == b.info["parameters"] and a.size == b.size
        diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
        assert diff.max() <= 1
    assert len(report["outputs"]) == n


def test_unreadable_init_images_exit_2_by_name(tmp_path, capsys):
    """A JPEG init image and a palette mask fail before anything loads."""
    from PIL import Image

    from sdtpu_torch import cli

    rgb = np.zeros((16, 16, 3), dtype=np.uint8)
    jpg, pal = str(tmp_path / "in.jpg"), str(tmp_path / "mask.png")
    Image.fromarray(rgb).save(jpg, format="JPEG")
    Image.fromarray(rgb).quantize(4).save(pal)
    missing = str(tmp_path / "missing.gguf")
    for extra, name in ((["-i", jpg], "JPEG"), (["--mask", pal], "palette")):
        assert cli.main(["--diffusion-model", missing] + extra) == 2
        assert name in capsys.readouterr().err


@pytest.fixture(scope="module")
def sdxl_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sdxl_file")
    jp = small_sdxl_pipeline()
    return {"model": write_small_sdxl_file(d, jp), "taesd": write_small_tae_file(d), "dir": d,
            "jp": jp}


SDXL_REQUESTS = {
    # the bench's request, cut to 64²: TAESD-XL, 4 lcm steps, CFG 1, seed 42
    "lcm_taesd": (["-p", "a photograph of an astronaut riding a horse", "-W", "64", "-H", "64",
                   "--steps", "4", "--sampling-method", "lcm", "--cfg-scale", "1", "-s", "42"],
                  True),
    # the full VAE: euler, CFG 5, a negative prompt, a wide image, VAE tiling
    "euler_cfg_vae": (["-p", "a red fox in snow", "-n", "blurry", "-W", "96", "-H", "64",
                       "--steps", "3", "--sampling-method", "euler", "--cfg-scale", "5", "-s", "7",
                       "--vae-tiling", "--vae-tile-size", "8", "--vae-tile-overlap", "2"], False),
}


@pytest.mark.parametrize("name", sorted(SDXL_REQUESTS))
def test_cli_sdxl_file_matches_jax_cli(sdxl_files, monkeypatch, tmp_path, name):
    """``-m`` with an SDXL single-file checkpoint (SGM names, CLIP-G under
    OpenCLIP's), with ``--taesd`` and with the full VAE: both CLIPs
    fingerprint it as SDXL; the images lie within one uint8 level."""
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli

    small_sdxl_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    req, tae = SDXL_REQUESTS[name]
    args = ["-m", sdxl_files["model"]] + req + (["--taesd", sdxl_files["taesd"]] if tae else [])
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    assert report["load"]["version"] == "sdxl" and report["load"]["tae"] is tae
    a, b = Image.open(report["outputs"][0]), Image.open(str(tmp_path / "jax.png"))
    assert a.info["parameters"] == b.info["parameters"]
    diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert diff.max() <= 1 and np.asarray(a).std() > 0


def _same_modules(got, want, modules):
    assert got.version.value == want.version.value == "sdxl"
    for m in modules:
        g, w = getattr(got, m), getattr(want, m)
        assert sorted(g) == sorted(w), m
        for k, v in w.items():
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(v), err_msg=f"{m}.{k}")


def test_sdxl_split_modules_matches_jax(sdxl_files, tmp_path):
    """The single file by its SGM prefixes (CLIP-G renamed, ``in_proj``
    split, ``text_projection`` transposed), and a file set with a separate
    ``--clip_g`` (``text_encoders.clip_g.transformer.``): the port's
    ``split_modules`` equals the JAX one by value, and CLIP-G lands under
    ``param_specs``' names."""
    from sdtpu.io.model_loader import load_model_bundle as jload
    from sdtpu.io.model_loader import split_modules as jsplit
    from sdtpu.io.safetensors import save_safetensors
    from sdtpu_torch.factory import sdxl_configs
    from sdtpu_torch.io.model_loader import load_model_bundle, split_modules
    from sdtpu_torch.io.safetensors import load_safetensors
    from sdtpu_torch.models import clip as tclip

    mods = ("diffusion", "clip_l", "clip_g", "vae")
    tensors = load_safetensors(sdxl_files["model"])
    got, want = split_modules(tensors), jsplit(tensors)
    _same_modules(got, want, mods)
    assert set(got.clip_g) == set(tclip.param_specs(sdxl_configs(small=True)[2]))
    assert not got.extra
    pg = sdxl_files["jp"].conditioner.pg
    np.testing.assert_allclose(got.clip_g["text_projection.weight"],
                               np.asarray(pg["text_projection.weight"]), atol=1e-3)
    d = tmp_path
    jp = sdxl_files["jp"]
    host = lambda p: {k: np.asarray(v, dtype=np.float32) for k, v in p.items()}  # noqa: E731
    paths = {"diffusion_model_path": f"{d}/unet.safetensors", "clip_l_path": f"{d}/l.safetensors",
             "clip_g_path": f"{d}/g.safetensors", "vae_path": f"{d}/vae.safetensors"}
    for key, p in (("diffusion_model_path", jp.diffusion_params), ("clip_l_path", jp.conditioner.pl),
                   ("clip_g_path", jp.conditioner.pg), ("vae_path", jp.vae_params)):
        save_safetensors(paths[key], host(p))
    _same_modules(load_model_bundle(**paths), jload(**paths), mods)


def test_sdxl_variants_stay_refused(sdxl_files, tmp_path):
    """SSD-1B (no 10-deep middle block) stays refused by name; SDXL inpaint
    (a 9-channel stem) and pix2pix (8) load, fingerprinted as both
    packages' loaders do."""
    from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
    from sdtpu.io.safetensors import save_safetensors
    from sdtpu_torch.io.model_loader import load_model_bundle
    from sdtpu_torch.io.safetensors import load_safetensors

    tensors = load_safetensors(sdxl_files["model"])
    stem = "model.diffusion_model.input_blocks.0.0.weight"
    w = tensors[stem]
    for name, extra in (("sdxl_inpaint", 5), ("sdxl_pix2pix", 4)):
        t = dict(tensors)
        t[stem] = np.concatenate([w, np.zeros((w.shape[0], extra) + w.shape[2:], w.dtype)], axis=1)
        path = str(tmp_path / f"{name}.safetensors")
        save_safetensors(path, t)
        got = load_model_bundle(model_path=path)
        assert got.version.value == jax_load_model_bundle(model_path=path).version.value == name
        assert got.diffusion[stem[len("model.diffusion_model."):]].shape[1] == 4 + extra
    ssd = {k: v for k, v in tensors.items() if ".middle_block.1.transformer_blocks." not in k}
    path = str(tmp_path / "sdxl_ssd1b.safetensors")
    save_safetensors(path, ssd)
    with pytest.raises(NotImplementedError, match="sdxl_ssd1b"):
        load_model_bundle(model_path=path)


def test_sdxl_file_tool_writes_files_the_cli_answers_from(monkeypatch, tmp_path):
    """``sdtpu_torch.tools.sdxl_file`` (the card check's SDXL and TAESD-XL
    files, float16) at the small configs: fingerprinted as SDXL by both
    packages' loaders, the TAE file under the raw names, answered by the
    port's CLI with ``--taesd`` and read back in metadata mode."""
    from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
    from sdtpu_torch import cli
    from sdtpu_torch.io.model_loader import load_model_bundle
    from sdtpu_torch.io.safetensors import load_safetensors
    from sdtpu_torch.models.tae import TAESD_XL_CONFIG, convert_taesd_name, param_specs
    from sdtpu_torch.tools.sdxl_file import file_specs, tae_file_specs, write_sdxl_files
    from sdtpu_torch.utils.image import decode_png

    small_sdxl_configs(monkeypatch)
    out = write_sdxl_files(tmp_path / "set", device="cpu")
    paths = out["paths"]
    assert out["tensors"] == {"model": len(file_specs()), "taesd": len(tae_file_specs())}
    assert all(os.path.getsize(p) >= out["bytes"][k] for k, p in paths.items())
    for p in paths.values():
        with open(p, "rb") as f:
            header = json.loads(f.read(struct.unpack("<Q", f.read(8))[0]))
        assert {v["dtype"] for v in header.values()} == {"F16"}
    tae = load_safetensors(paths["taesd"])
    assert "decoder.1.weight" in tae and "decoder.0.weight" not in tae
    assert {convert_taesd_name(k) for k in tae} == set(param_specs(TAESD_XL_CONFIG))
    assert load_model_bundle(model_path=paths["model"]).version.value == "sdxl"
    assert jax_load_model_bundle(model_path=paths["model"]).version.value == "sdxl"
    report = {}
    png = str(tmp_path / "out.png")
    assert cli.main(["-m", paths["model"], "--taesd", paths["taesd"], "-p", "a cat", "-W", "64",
                     "-H", "64", "--steps", "2", "--sampling-method", "lcm", "--cfg-scale", "1",
                     "--backend", "cpu", "-o", png], report=report) == 0
    assert report["load"]["version"] == "sdxl" and report["load"]["tae"]
    with open(png, "rb") as f:
        img, params = decode_png(f.read())
    assert img.shape == (64, 64, 3) and img.std() > 0
    assert "Sampler: lcm" in params


@pytest.mark.parametrize("shift", [None, "2.0"])
def test_flow_shift_does_for_flux_what_the_jax_cli_does(files, small, tmp_path, shift):
    """``--flow-shift`` reaches ``create_pipeline`` in both CLIs; FLUX takes
    no flow shift there, so both answer the image they answer without it."""
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli

    _, paths = files
    args = _file_args(paths) + REQUESTS["euler_a"] + (["--flow-shift", shift] if shift else [])
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    a, b = (np.asarray(Image.open(str(tmp_path / f"{n}.png"))).astype(int) for n in ("port", "jax"))
    assert np.abs(a - b).max() <= 1
    assert report["pipeline"].denoiser.shift == 1.15  # FluxFlowDenoiser's own


@pytest.fixture(scope="module")
def sd3_files(tmp_path_factory):
    """The small SD3 set, and the MMDiT and the VAE as files of their own
    (internal names, float32)."""
    from sdtpu.io.safetensors import save_safetensors

    d = tmp_path_factory.mktemp("sd3_files")
    jp = small_sd3_pipeline()
    paths = write_small_sd3_files(d, jp)
    for key, params in (("diffusion_model", jp.diffusion_params), ("vae", jp.vae_params)):
        paths[key] = f"{d}/{key}.safetensors"
        save_safetensors(paths[key], {k: np.asarray(v, np.float32) for k, v in params.items()})
    return paths


SD3_REQUESTS = {
    # the bench's request (bench_sd35_medium), cut to 64² and 4 steps: -m
    # with the MMDiT and the VAE, the three encoders beside it
    "dpmpp2m_cfg": (["-p", "a photograph of an astronaut riding a horse", "-n", "blurry",
                     "-W", "64", "-H", "64", "--steps", "4", "--sampling-method", "dpm++2m",
                     "--cfg-scale", "4.5", "-s", "42"], "model"),
    # every module in a file of its own, another flow shift, euler_a's noise,
    # a wide image, a batch of two, VAE tiling
    "flow_shift_euler_a": (["-p", "a red fox in snow", "-n", "blurry", "-W", "96", "-H", "64",
                            "--steps", "3", "--cfg-scale", "3", "--eta", "1.0", "-b", "2",
                            "-s", "7", "--flow-shift", "2.0", "--vae-tiling", "--vae-tile-size", "8",
                            "--vae-tile-overlap", "2"], "separate"),
}


@pytest.mark.parametrize("name", sorted(SD3_REQUESTS))
def test_cli_sd3_files_match_jax_cli(sd3_files, monkeypatch, tmp_path, name):
    """The SD3 set through both CLIs: both fingerprint it as SD3 (the MMDiT
    config from the weights), find the T5 tokenizer in the GGUF and take
    ``--flow-shift``; the images lie within one uint8 level, the
    ``parameters`` text is equal."""
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli

    small_sd3_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    req, layout = SD3_REQUESTS[name]
    p = sd3_files
    enc = ["--clip_l", p["clip_l"], "--clip_g", p["clip_g"], "--t5xxl", p["t5xxl"]]
    files = (["-m", p["model"]] if layout == "model"
             else ["--diffusion-model", p["diffusion_model"], "--vae", p["vae"]])
    args = files + enc + req
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    assert report["load"]["version"] == "sd3"
    assert report["load"]["t5_tokenizer"] == "gguf:" + p["t5xxl"]
    assert report["pipeline"].denoiser.shift == (2.0 if "--flow-shift" in req else 3.0)
    n = 2 if "-b" in req else 1
    assert len(report["outputs"]) == n
    for i, ours in enumerate(report["outputs"]):
        a = Image.open(ours)
        b = Image.open(str(tmp_path / (f"jax_{i}.png" if n > 1 else "jax.png")))
        assert a.info["parameters"] == b.info["parameters"]
        diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
        assert diff.max() <= 1 and np.asarray(a).std() > 0
    assert any(report["t5_ids"][:-1]) and len(report["t5_ids"]) == 77


def test_sd3_file_tool_writes_files_the_cli_answers_from(monkeypatch, tmp_path):
    """``sdtpu_torch.tools.sd3_file`` (the card check's SD3.5-Medium set) at
    small configs: float16 safetensors for the single file (MMDiT-X + VAE,
    no quant_conv) and both CLIPs, a q8_0 T5 GGUF with its vocab;
    fingerprinted as SD3 by both packages' loaders, the MMDiT config as an
    MMDiT-X with qk norms, answered by the port's CLI and read back."""
    from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
    from sdtpu_torch import cli
    from sdtpu_torch.io.gguf import GGUFFile
    from sdtpu_torch.io.model_loader import load_model_bundle
    from sdtpu_torch.models import mmdit as tm
    from sdtpu_torch.tools.sd3_file import file_specs, write_sd3_files
    from sdtpu_torch.utils.image import decode_png

    small_sd3_configs(monkeypatch)
    out = write_sd3_files(tmp_path / "set", device="cpu", min_quant_elems=1024)
    paths = out["paths"]
    assert out["tensors"] == {k: len(v) for k, v in file_specs().items()}
    assert all(os.path.getsize(p) >= out["bytes"][k] for k, p in paths.items())
    for key in ("model", "clip_l", "clip_g"):
        with open(paths[key], "rb") as f:
            header = json.loads(f.read(struct.unpack("<Q", f.read(8))[0]))
        assert {v["dtype"] for v in header.values()} == {"F16"}
        if key == "model":
            assert not any("quant_conv" in k for k in header)
    f = GGUFFile(paths["t5xxl"])
    try:
        assert f.tensor_type("token_embd.weight") == "q8_0"
    finally:
        f.close()
    enc = {"clip_l_path": paths["clip_l"], "clip_g_path": paths["clip_g"],
           "t5xxl_path": paths["t5xxl"]}
    bundle = load_model_bundle(model_path=paths["model"], **enc)
    assert bundle.version.value == "sd3"
    assert jax_load_model_bundle(model_path=paths["model"], **enc).version.value == "sd3"
    shapes = {k: tuple(v.shape) for k, v in bundle.diffusion.items()}
    det = tm.detect_mmdit_config(list(shapes), shapes)
    # the fingerprint takes the vector's width from its base config (2048)
    assert det == dataclasses.replace(tm.SD35_MEDIUM_CONFIG, adm_in_channels=det.adm_in_channels)
    report = {}
    png = str(tmp_path / "out.png")
    assert cli.main(["-m", paths["model"], "--clip_l", paths["clip_l"], "--clip_g", paths["clip_g"],
                     "--t5xxl", paths["t5xxl"], "-p", "a cat", "-n", "blurry", "-W", "64", "-H",
                     "64", "--steps", "2", "--sampling-method", "dpm++2m", "--cfg-scale", "4.5",
                     "--backend", "cpu", "-o", png], report=report) == 0
    assert report["load"]["version"] == "sd3"
    with open(png, "rb") as f:
        img, params = decode_png(f.read())
    assert img.shape == (64, 64, 3) and img.std() > 0
    assert "Sampler: dpm++2m" in params


@pytest.fixture(scope="module")
def wan_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wan_files")
    return write_small_wan_files(d, small_wan_pipeline())


def _wan_args(p):
    return ["--diffusion-model", p["diffusion_model"], "--vae", p["vae"], "--t5xxl", p["t5xxl"]]


WAN_REQUESTS = {
    # the bench's request (bench_wan21_t2v), cut to 64x48, 5 frames and 3
    # steps, with its tiling (spatial tiles, temporal windows of 5, overlap 1)
    "bench_tiled": ["-p", "a corgi running on a beach", "-n", "static", "-W", "64", "-H", "48",
                    "--video-frames", "5", "--steps", "3", "--cfg-scale", "6", "--sampling-method",
                    "euler", "-s", "42", "--vae-tiling", "--vae-tile-size", "4",
                    "--vae-tile-overlap", "2", "--vae-temporal-tiling", "--extra-tiling-args",
                    "temporal_tile_frames=5,temporal_tile_overlap=1"],
    # 11 frames rounded down to 9, another flow shift, euler_a's noise, the
    # temporal windows alone (spatial tiles of the default size)
    "flow_shift_temporal": ["-p", "a red fox in snow", "-W", "64", "-H", "64", "--video-frames",
                            "11", "--steps", "2", "--cfg-scale", "4", "--eta", "1.0", "-s", "7",
                            "--flow-shift", "3.0", "--temporal-tiling", "--extra-tiling-args",
                            "temporal_tile_frames=2,temporal_tile_overlap=1"],
}


@pytest.mark.parametrize("name", sorted(WAN_REQUESTS))
def test_cli_vid_gen_matches_jax_cli(wan_files, monkeypatch, tmp_path, name):
    """The Wan set through both CLIs' ``vid_gen``: both fingerprint it as
    Wan2 (the DiT config from the weights), find the UMT5 tokenizer in the
    GGUF and take ``--flow-shift``; ``-o name.png`` writes ``name_0000.png``
    ... one a frame, 1 + 4k of them, each within one uint8 level of the JAX
    CLI's."""
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli

    small_wan_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    args = ["-M", "vid_gen"] + _wan_args(wan_files) + WAN_REQUESTS[name]
    report = {}
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    assert report["load"]["version"] == "wan2"
    assert report["load"]["t5_tokenizer"] == "gguf:" + wan_files["t5xxl"]
    pipe = report["pipeline"]
    assert pipe.denoiser.shift == (3.0 if "--flow-shift" in WAN_REQUESTS[name] else 5.0)
    assert pipe.diffusion_params["blocks.1.ffn.0.weight"].shape == (128, 64)
    n = 5 if name == "bench_tiled" else 9
    assert report["outputs"] == [str(tmp_path / f"port_{i:04d}.png") for i in range(n)]
    assert report["timings"]["frames"] == n and not os.path.exists(tmp_path / f"port_{n:04d}.png")
    for i in range(n):
        a = np.asarray(Image.open(str(tmp_path / f"port_{i:04d}.png"))).astype(int)
        b = np.asarray(Image.open(str(tmp_path / f"jax_{i:04d}.png"))).astype(int)
        assert a.shape == b.shape == (int(args[args.index("-H") + 1]), int(args[args.index("-W") + 1]), 3)
        assert np.abs(a - b).max() <= 1
    assert np.asarray(Image.open(report["outputs"][0])).std() > 0
    assert any(report["t5_ids"][:-1]) and len(report["t5_ids"]) == 512


@pytest.mark.parametrize("output", [None, "clip.avi", "clip.webp", "clip.gif", "clip.webm"])
def test_vid_gen_video_containers_exit_2(tmp_path, capsys, output):
    """The default ``output.avi`` and every container the JAX CLI writes
    through Pillow's JPEG / WebP encoders exit 2 by name, before anything
    loads."""
    from sdtpu_torch import cli

    argv = ["-M", "vid_gen", "--diffusion-model", str(tmp_path / "missing.safetensors")]
    if output:
        argv += ["-o", str(tmp_path / output)]
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and (output or "output.avi") in err and "Pillow" in err


def test_wan_modes_need_their_model(wan_files, files, small, monkeypatch, tmp_path, capsys):
    """img_gen on a Wan model and vid_gen on an image model exit 2 by name;
    a Wan set without UMT5 is refused naming it; the server refuses a Wan
    model (its video answer is an animated WebP) and a request's
    ``video_frames``."""
    from sdtpu_torch import cli, server

    small_wan_configs(monkeypatch)
    _, flux = files
    out = ["--backend", "cpu", "-o", str(tmp_path / "x.png"), "--steps", "1", "-W", "32", "-H", "32"]
    assert cli.main(_wan_args(wan_files) + out) == 2
    assert "vid_gen" in capsys.readouterr().err
    assert cli.main(["-M", "vid_gen"] + _file_args(flux) + out) == 2
    assert "txt2vid on Wan2.1" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="t5"):
        cli.main(["-M", "vid_gen", "--diffusion-model", wan_files["diffusion_model"], "--vae",
                  wan_files["vae"]] + out)
    assert server.main(_wan_args(wan_files) + ["--backend", "cpu", "--port", "0"]) == 2
    assert "video_frames" in capsys.readouterr().err
    assert server.UNPORTED_FIELDS["video_frames"] == "video"


def test_wan_file_tool_writes_files_the_cli_answers_from(monkeypatch, tmp_path):
    """``sdtpu_torch.tools.wan_file`` (the card check's Wan2.1-T2V-1.3B set)
    at small configs: float16 safetensors for the DiT and the VAE's decoder,
    a q8_0 UMT5 GGUF with a relative bias in every block and its vocab;
    fingerprinted as Wan2 by both packages' loaders, the DiT config as the
    base one, answered by the port's CLI with 1 + 4k PNG frames."""
    from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
    from sdtpu_torch import cli
    from sdtpu_torch.io.gguf import GGUFFile
    from sdtpu_torch.io.model_loader import load_model_bundle
    from sdtpu_torch.models import wan as tw
    from sdtpu_torch.tools.wan_file import file_specs, write_wan_files
    from sdtpu_torch.utils.image import decode_png

    small_wan_configs(monkeypatch)
    out = write_wan_files(tmp_path / "set", device="cpu", min_quant_elems=1024)
    paths = out["paths"]
    assert out["tensors"] == {k: len(v) for k, v in file_specs().items()}
    assert all(os.path.getsize(p) >= out["bytes"][k] for k, p in paths.items())
    for key in ("diffusion_model", "vae"):
        with open(paths[key], "rb") as f:
            header = json.loads(f.read(struct.unpack("<Q", f.read(8))[0]))
        assert {v["dtype"] for v in header.values()} == {"F16"}
    f = GGUFFile(paths["t5xxl"])
    try:
        assert f.tensor_type("token_embd.weight") == "q8_0"
        assert f.tensor_type("enc.blk.1.attn_rel_b.weight") == "f32"
    finally:
        f.close()
    kw = dict(diffusion_model_path=paths["diffusion_model"], vae_path=paths["vae"],
              t5xxl_path=paths["t5xxl"])
    bundle = load_model_bundle(**kw)
    assert bundle.version.value == jax_load_model_bundle(**kw).version.value == "wan2"
    shapes = {k: tuple(v.shape) for k, v in bundle.diffusion.items()}
    assert tw.detect_wan_config(list(shapes), shapes) == tw.WAN21_T2V_1_3B_CONFIG
    report = {}
    png = str(tmp_path / "out.png")
    assert cli.main(["-M", "vid_gen", "--diffusion-model", paths["diffusion_model"], "--vae",
                     paths["vae"], "--t5xxl", paths["t5xxl"], "-p", "a cat", "-n", "static", "-W",
                     "32", "-H", "32", "--video-frames", "6", "--steps", "2", "--sampling-method",
                     "euler", "--cfg-scale", "6", "--backend", "cpu", "-o", png], report=report) == 0
    assert report["load"]["version"] == "wan2" and len(report["outputs"]) == 5
    with open(report["outputs"][-1], "rb") as f:
        img, params = decode_png(f.read())
    assert img.shape == (32, 32, 3) and img.std() > 0 and not params
