"""The port's CLI against the JAX CLI, on the same small checkpoint files.

Both CLIs load the files written by ``tests/_torch_files.py`` (the JAX
package's small FLUX weights as a q8_0 DiT GGUF, CLIP-L and VAE
safetensors, a q8_0 T5 GGUF under llama.cpp names with an embedded vocab;
its small SD1 weights as one float16 single-file checkpoint), with their
full-size configs swapped for the small ones.  The port runs
with ``--backend cpu``.  Their images may differ by one uint8 level (a
float32 pixel on a rounding boundary); the ``parameters`` text is equal.
Unported flags, modes and values exit 2 before anything loads.
"""
import json
import os
import struct
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py

from _torch_files import (small_configs, small_jax_pipeline, small_sd1_configs,  # noqa: E402
                          small_sd1_pipeline, write_small_flux_files, write_small_sd1_file)


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
    ["--lora-model-dir", "loras"], ["--init-img", "in.png"], ["--hires"], ["--type", "q8_0"],
    ["--sampling-method", "heun"], ["--schedule", "karras"], ["--fa"], ["--no-progress"],
    ["--vae-on-cpu"], ["--control-net", "cn.safetensors"], ["--llm", "qwen.gguf"],
    ["--backend", "clip=cpu,diffusion=cuda0"], ["--backend", "tpu0"], ["--dtype", "f16"],
    ["-p", "a <lora:detail:0.8> cat"], ["convert"], ["-M", "vid_gen"],
    ["--embd-dir", "embeddings"],  # textual inversion (SD1's EmbeddingMixin)
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
