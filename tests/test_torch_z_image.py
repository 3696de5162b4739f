"""The port's Z-Image txt2img slice against the JAX package, on the CPU.

The same numpy-seeded parameters go through both packages
(``from_jax_params``): the Z-Image DiT with its pad tokens, 3-axis RoPE
and GQA, the ``ZImageConditioner`` on the Qwen3 LLM, and the whole
pipeline (``generate``: the golden fixture, and CFG over two contexts of
different lengths).  The loader's Z-Image fingerprint and diffusers names
are held to the JAX package's; ``tools/z_image_file.py``'s set, at small
configs, is answered by the port's CLI (against the JAX CLI on the same
files) and server.  Tolerances:
  - the forwards and the conditioner in float32: rtol = atol = 5e-4 (the
    same float32 formulas; XLA's and MKL's sums in another order);
  - the pipelines: the golden's rtol = atol = 5e-4 on latents, images within
    one uint8 level (a float32 pixel on a rounding boundary).
Full-width specs are compared by name and shape only; the full-width call
counts run on the meta device.
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

import sdtpu.config as jconfig
from sdtpu.conditioning import conditioner as jcond
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu.io.detect import detect_version as jdetect_version
from sdtpu.io.name_conversion import convert_diffusers_lumina2_name as jlumina2_name
from sdtpu.models import llm as jllm
from sdtpu.models import z_image as jzi
from sdtpu.tokenizers.qwen2 import Qwen2Tokenizer as JQwen2Tokenizer
from sdtpu.utils.device_init import param_specs as jparam_specs
from sdtpu_torch.conditioning import conditioner as tcond
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline, z_image_configs
from sdtpu_torch.io import model_loader as tml
from sdtpu_torch.models import llm as tllm
from sdtpu_torch.models import z_image as tzi
from sdtpu_torch.tokenizers.bpe import bytes_to_unicode
from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer
from sdtpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "z_image_euler.npz")
TSMALL, TLLM, TVAE = z_image_configs(small=True)


def _jdit(cfg):
    return jzi.ZImageConfig(**dataclasses.asdict(cfg))


def _perturbed(p: dict, seed: int) -> dict:
    """Norm gains around 1 and biases around 0, drawn from ``seed``."""
    g = np.random.default_rng(seed)
    out = dict(p)
    for k, v in p.items():
        if k.endswith(("norm.weight", "norm1.weight", "norm2.weight", "cap_embedder.0.weight")):
            out[k] = jnp.asarray(1.0 + 0.2 * g.standard_normal(v.shape, dtype=np.float32))
        elif k.endswith(".bias"):
            out[k] = jnp.asarray(0.05 * g.standard_normal(v.shape, dtype=np.float32))
    return out


def _small_tokenizers():
    """A Qwen2 tokenizer whose ids fit the small LLM's 256-piece vocab: the
    byte units at 0..252, the chat template's specials at 253..255 (both
    packages)."""
    vocab = {ch: i for i, ch in enumerate(list(bytes_to_unicode().values())[:253])}
    special = {"<|im_start|>": 253, "<|im_end|>": 254, "<|endoftext|>": 255}
    return Qwen2Tokenizer(vocab, [], special), JQwen2Tokenizer(vocab, [], special)


def test_configs_match():
    assert _jdit(tzi.Z_IMAGE_CONFIG) == jzi.Z_IMAGE_CONFIG
    # the JAX factory's small Z-Image configs (sdtpu/factory.py, _create_z_image_pipeline)
    assert _jdit(TSMALL) == jzi.ZImageConfig(
        hidden_size=48, in_channels=4, out_channels=4, num_layers=2, num_refiner_layers=1,
        head_dim=12, num_heads=4, num_kv_heads=2, multiple_of=16, cap_feat_dim=32,
        axes_dim=(4, 4, 4))
    assert jllm.LLMConfig(**dataclasses.asdict(TLLM)) == dataclasses.replace(
        jllm.QWEN3_8B_CONFIG, num_layers=2, hidden_size=32, intermediate_size=64, num_heads=4,
        num_kv_heads=2, head_dim=8, vocab_size=256)


def test_full_width_specs_and_fingerprint_match_jax():
    """``param_specs`` holds ``init_z_image_params``' names and shapes (6.15e9
    parameters); both packages' ``detect_z_image_config`` read the config
    back and ``detect_version`` names Z-Image."""
    cfg = tzi.Z_IMAGE_CONFIG
    want = jparam_specs(jzi.init_z_image_params, jzi.Z_IMAGE_CONFIG, 0)
    got = tzi.param_specs(cfg)
    assert sorted(got) == sorted(want)
    assert all(tuple(want[k].shape) == got[k][0] for k in got)
    assert round(sum(int(np.prod(s)) for s, _ in got.values()) / 1e9, 2) == 6.15
    shapes = {k: s for k, (s, _) in got.items()}
    assert tzi.detect_z_image_config(shapes.keys(), shapes) == cfg
    assert jzi.detect_z_image_config(shapes.keys(), shapes) == jzi.Z_IMAGE_CONFIG
    names = [tml.DIFFUSION_PREFIX + k for k in shapes]
    assert tml.detect_version(names, {}) == SDVersion.Z_IMAGE
    assert jdetect_version(names, {}).value == "z_image"


@pytest.fixture(scope="module")
def dit_params():
    jp = _perturbed(jzi.init_z_image_params(_jdit(TSMALL), seed=4), 5)
    return jp, from_jax_params(jp, device="cpu")


@pytest.mark.parametrize("b,h,w,n_ctx", [(1, 8, 8, 24), (2, 9, 7, 40), (2, 12, 10, 32)],
                         ids=["8x8_ctx24", "9x7_ctx40", "12x10_ctx32"])
def test_z_image_forward_matches_jax(dit_params, b, h, w, n_ctx):
    """Both streams padded to 32 (or not), an odd latent padded to the patch
    and cropped back, a batch of two timesteps."""
    jp, tp = dit_params
    jforward = jax.jit(functools.partial(jzi.z_image_forward, cfg=_jdit(TSMALL)))
    g = np.random.default_rng(h * w + n_ctx)
    x = g.standard_normal((b, h, w, TSMALL.in_channels), dtype=np.float32)
    t = np.array([700.0, 120.0][:b], np.float32)
    ctx = g.standard_normal((b, n_ctx, TSMALL.cap_feat_dim), dtype=np.float32)
    want = np.asarray(jforward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    got = tzi.z_image_forward(tp, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                              cfg=TSMALL)
    assert got.shape == want.shape == (b, h, w, TSMALL.out_channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("hp,wp,n_txt", [(4, 4, 32), (5, 3, 64), (64, 64, 64)])
def test_rope_matches_jax(hp, wp, n_txt):
    want = np.asarray(jzi.z_image_rope(hp, wp, n_txt, jzi.Z_IMAGE_CONFIG))
    got = tzi.z_image_rope(hp, wp, n_txt, tuple(tzi.Z_IMAGE_CONFIG.axes_dim),
                           tzi.Z_IMAGE_CONFIG.theta, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_latents_are_refused(dit_params):
    _, tp = dit_params
    with pytest.raises(NotImplementedError, match="ref_latents"):
        tzi.z_image_forward(tp, torch.zeros((1, 8, 8, 4)), torch.zeros(1), torch.zeros((1, 4, 32)),
                            cfg=TSMALL, ref_latents=[torch.zeros((1, 8, 8, 4))])


def test_forward_calls_at_full_width(monkeypatch):
    """At full width on the meta device: one 1024² forward under CFG (a
    40-token prompt, padded to 64) makes ``chip_smoke.Z_IMAGE_ATTENTION_CALLS``
    attention calls at D 128: 2 context-refiner ones over the 64 text
    tokens, 2 noise-refiner ones over the 4096 image tokens, 30 over both."""
    import chip_smoke

    seen = []

    def counting(q, k, v, *a, **kw):
        seen.append(tuple(q.shape[:3]) + (k.shape[2], q.shape[3]))
        return torch.empty_like(q)

    monkeypatch.setattr(tzi, "attention", counting)
    cfg = tzi.Z_IMAGE_CONFIG
    p = {k: torch.empty(s, device="meta") for k, (s, _) in tzi.param_specs(cfg).items()}
    out = tzi.z_image_forward(p, torch.empty((2, 128, 128, 16), device="meta"),
                              torch.empty((2,), device="meta"),
                              torch.empty((2, 40, 2560), device="meta"), cfg=cfg)
    assert out.shape == (2, 128, 128, 16)
    assert len(seen) == chip_smoke.Z_IMAGE_ATTENTION_CALLS == 34
    assert seen.count((2, 30, 64, 64, 128)) == 2
    assert seen.count((2, 30, 4096, 4096, 128)) == 2
    assert seen.count((2, 30, 4160, 4160, 128)) == 30


@pytest.fixture(scope="module")
def jpipe():
    return jax_create_pipeline(jconfig.SDVersion.Z_IMAGE, small=True, seed=0)


@pytest.mark.parametrize("tokenized", [False, True], ids=["no_tokenizer", "tokenizer"])
def test_conditioner_matches_jax(jpipe, tokenized):
    """The LLM's states after layer ``num_layers - 1``, no final norm: the
    ids 0..23 without a tokenizer, else the chat-wrapped prompt's."""
    ttok, jtok = _small_tokenizers() if tokenized else (None, None)
    jc = jpipe.conditioner
    pl = _perturbed(jc.pl, 6)
    j = jcond.ZImageConditioner(jtok, pl, jc.cl)
    t = tcond.ZImageConditioner(ttok, from_jax_params(pl, device="cpu"), TLLM, device="cpu")
    text = "a (red:1.3) fox in snow"
    want = np.asarray(j.get_learned_condition(text).c_crossattn)
    got = t.get_learned_condition(text).c_crossattn
    n = len(ttok.encode(t.TEMPLATE.format(text))) if tokenized else 24
    assert got.shape == want.shape == (1, n, TLLM.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def pipes(jpipe):
    c = jpipe.conditioner
    params = {"diffusion": from_jax_params(jpipe.diffusion_params, device="cpu"),
              "llm": from_jax_params(c.pl, device="cpu"),
              "vae": from_jax_params(jpipe.vae_params, device="cpu")}
    return params, create_pipeline(SDVersion.Z_IMAGE, params=params, small=True, device="cpu")


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=4.0, seed=11, sample_method="euler")
    base.update(kw)
    return GenerationParams(**base)


def test_reproduces_z_image_golden_latents(pipes):
    """``tests/test_golden_latents.py``'s ``z_image_euler`` case: 64², 3 euler
    steps at CFG 4, shift 3, no tokenizer."""
    _, tp = pipes
    assert tp.denoiser.shift == 3.0 and tp.latent_channels == 4
    res = tp.generate(_gp())
    want = np.load(GOLDEN)["latents"]
    assert res.latents.shape == want.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(res.latents, want, rtol=5e-4, atol=5e-4)


def test_cfg_over_contexts_of_different_lengths_matches_jax(pipes):
    """With a tokenizer the prompt and the negative prompt encode to
    different lengths; the shorter context is zero-padded for the batch-2
    CFG forward, as the JAX pipeline pads it.  A wide latent, 2 steps."""
    params, _ = pipes
    ttok, jtok = _small_tokenizers()
    tp = create_pipeline(SDVersion.Z_IMAGE, params=params, small=True, device="cpu",
                         qwen_tokenizer=ttok)
    jp = jax_create_pipeline(jconfig.SDVersion.Z_IMAGE, small=True, seed=0, qwen_tokenizer=jtok)
    gp = _gp(width=80, height=48, sample_steps=2, negative_prompt="blurry, low quality, watermark")
    got = tp.generate(gp)
    want = jp.generate(jconfig.GenerationParams(**dataclasses.asdict(gp)))
    c, u = tp._cond_cache[next(iter(tp._cond_cache))]
    assert c.c_crossattn.shape[1] != u.c_crossattn.shape[1]
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert got.images.shape == want.images.shape == (1, 48, 80, 3) and got.images.std() > 0
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


def test_img2img_matches_jax(jpipe, pipes):
    """``generate(init_image=...)`` on Z-Image: the init image through the
    FLUX VAE's encoder (held to the JAX one's), 3 of 4 steps at strength
    0.6 (the first sampled sigma below 1, so the init latent enters the
    start), the noise scaled around the init latent; latents at the
    golden's 5e-4 and images within one uint8 level of the JAX pipeline's."""
    _, tp = pipes
    gp = _gp(sample_steps=4, strength=0.6)
    img = np.random.default_rng(4).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    np.testing.assert_allclose(tp.encode_image(img), jpipe.encode_image(img), rtol=5e-4, atol=5e-4)
    want = jpipe.generate(jconfig.GenerationParams(**dataclasses.asdict(gp)), init_image=img)
    got = tp.generate(gp, init_image=img)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1
    assert tp.last_timings["steps"] == jpipe.last_timings["steps"] == 3
    assert tp.last_timings["encode"] > 0


def test_synthesized_small_pipeline_runs():
    """Random weights drawn by the port itself, the default dtype (float32),
    without CFG."""
    tp = create_pipeline(SDVersion.Z_IMAGE, small=True, seed=3, device="cpu")
    assert tp.compute_dtype == torch.float32
    res = tp.generate(_gp(sample_steps=2, cfg_scale=1.0))
    assert res.images.shape == (1, 64, 64, 3) and np.isfinite(res.latents).all()
    assert res.images.std() > 0


def test_mismatched_llm_width_is_refused(pipes):
    """An LLM whose width is not the DiT's ``cap_feat_dim`` is refused (the
    JAX factory's full-width default pairs Qwen3-8B's 4096 with 2560)."""
    params, _ = pipes
    wide = tllm.param_specs(dataclasses.replace(TLLM, hidden_size=64))
    with pytest.raises(ValueError, match="cap_feat_dim"):
        create_pipeline(SDVersion.Z_IMAGE, device="cpu", params={
            "llm": {k: torch.empty(s, device="meta") for k, (s, _) in wide.items()},
            "diffusion": params["diffusion"]})


def test_full_width_without_tokenizer_uses_byte_fallback():
    """At full width (weights on the meta device) a pipeline built without
    a tokenizer warns and tokenizes with the Qwen2 byte-level vocabulary, so
    two prompts give two id lists; the small configs keep None (ids 0..23)."""
    from sdtpu_torch.models import vae as tvae

    dit, llm, vae = z_image_configs(small=False)
    specs = {"diffusion": tzi.param_specs(dit), "llm": tllm.param_specs(llm),
             "vae": tvae.vae_specs(vae)}
    params = {m: {k: torch.empty(s, device="meta") for k, (s, _) in sp.items()}
              for m, sp in specs.items()}
    with pytest.warns(UserWarning, match="byte-level"):
        tp = create_pipeline(SDVersion.Z_IMAGE, params=params, device="cpu")
    tok = tp.conditioner.tokenizer
    assert isinstance(tok, Qwen2Tokenizer) and tp.conditioner.cl == tllm.QWEN3_4B_CONFIG
    wrap = tcond.ZImageConditioner.TEMPLATE
    assert tok.encode(wrap.format("a fox")) != tok.encode(wrap.format("a lighthouse"))
    assert tok.encode("a fox") == JQwen2Tokenizer.byte_fallback().encode("a fox")
    small = create_pipeline(SDVersion.Z_IMAGE, small=True, seed=3, device="cpu")
    assert small.conditioner.tokenizer is None


# ------------------------------------------------------------- loader


@pytest.mark.parametrize("name", [
    "all_x_embedder.2-1.weight", "all_final_layer.2-1.linear.bias",
    "layers.3.attention.to_q.weight", "noise_refiner.0.attention.to_v.bias",
    "context_refiner.1.attention.norm_k.weight", "layers.0.attention.to_out.0.weight",
    "layers.0.feed_forward.w2.weight", "cap_embedder.1.weight", "x_pad_token",
])
def test_diffusers_lumina2_names_match(name):
    assert tml.convert_diffusers_lumina2_name(name) == jlumina2_name(name)


def test_diffusers_z_image_round_trips(dit_params):
    """A DiT under diffusers Lumina-2 names (q / k / v split) loads back as
    its original names and values."""
    jp, _ = dit_params
    host = {k: np.asarray(v) for k, v in jp.items()}
    diff = {}
    for k, v in host.items():
        if k.endswith("attention.qkv.weight"):
            pre = k[:-len("qkv.weight")]
            nh, nkv, hd = TSMALL.num_heads, TSMALL.num_kv_heads, TSMALL.head_dim
            for part, a in zip("qkv", np.split(v, [nh * hd, (nh + nkv) * hd])):
                diff[f"{pre}to_{part}.weight"] = a
        elif k.startswith("x_embedder."):
            diff["all_x_embedder.2-1." + k[len("x_embedder."):]] = v
        else:
            diff[k.replace("attention.out.", "attention.to_out.0.")] = v
    back = tml.convert_diffusers_diffusion_names(diff)
    assert sorted(back) == sorted(host)
    for k, v in host.items():
        np.testing.assert_array_equal(back[k], v)


def test_llm_vision_tower_is_refused(tmp_path):
    from sdtpu.io.safetensors import save_safetensors

    z = np.zeros((4, 4), np.float32)
    save_safetensors(str(tmp_path / "dit.safetensors"), {"cap_embedder.0.weight": z[0]})
    save_safetensors(str(tmp_path / "llm.safetensors"), {"model.visual.blocks.0.attn.qkv.weight": z})
    with pytest.raises(NotImplementedError, match="vision tower"):
        tml.load_model_bundle(diffusion_model_path=str(tmp_path / "dit.safetensors"),
                              llm_path=str(tmp_path / "llm.safetensors"))


# ------------------------------------------------------- files, CLI, server

# the file set's LLM: the small Qwen3 with Qwen's full 151936-id vocab (the
# file's "gpt2" vocab pins the specials at 151643..151656); its DiT: the
# small one 192 wide (16 heads of 12 over 8 KV heads), so that its qkv, FFN
# and adaLN weights reach the loader's 2**16-element floor and are promoted
# onto W8A8
FILE_LLM = dataclasses.replace(TLLM, vocab_size=151936)
FILE_DIT = dataclasses.replace(TSMALL, hidden_size=192, num_heads=16, num_kv_heads=8)


def small_z_image_configs(monkeypatch):
    """Swap the full-size configs both CLIs load Z-Image with for small
    ones: the DiT's base (``detect_z_image_config`` keeps its axes and FFN
    rounding), Qwen3's base (``detect_llm_config`` counts heads by its head
    width) and the FLUX VAE; and, for ``tools/z_image_file.py``, Qwen3-4B."""
    import sdtpu.models.vae as jvae
    import sdtpu_torch.models.vae as tvae

    monkeypatch.setattr(tzi, "Z_IMAGE_CONFIG", FILE_DIT)
    monkeypatch.setattr(jzi, "Z_IMAGE_CONFIG", _jdit(FILE_DIT))
    monkeypatch.setattr(tllm, "QWEN3_8B_CONFIG", FILE_LLM)
    monkeypatch.setattr(tllm, "QWEN3_4B_CONFIG", FILE_LLM)
    monkeypatch.setattr(jllm, "QWEN3_8B_CONFIG", jllm.LLMConfig(**dataclasses.asdict(FILE_LLM)))
    monkeypatch.setattr(tvae, "FLUX_VAE_CONFIG", TVAE)
    monkeypatch.setattr(jvae, "FLUX_VAE_CONFIG", jvae.VAEConfig(**dataclasses.asdict(TVAE)))


@pytest.fixture
def z_files(monkeypatch, tmp_path):
    from sdtpu_torch.tools.z_image_file import write_z_image_files

    small_z_image_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))  # the JAX CLI makes it
    files = write_z_image_files(tmp_path / "set", device="cpu", min_quant_elems=1024)
    p = files["paths"]
    assert all(os.path.getsize(path) == files["bytes"][k] for k, path in p.items())
    return ["--diffusion-model", p["diffusion_model"], "--llm", p["llm"], "--vae", p["vae"]]


REQUEST = ["-p", "a red fox in fresh snow", "-n", "blurry", "-W", "64", "-H", "48", "--steps", "2",
           "--cfg-scale", "4", "--sampling-method", "euler", "-s", "7"]


def test_z_image_files_answer_the_cli_as_the_jax_cli(z_files, tmp_path):
    """``tools/z_image_file.py``'s set (a q8_0 GGUF DiT, promoted onto W8A8; a
    q4_0 GGUF Qwen3 under llama.cpp names with its "gpt2" vocab; the VAE)
    answered by ``cli.main`` with the GGUF's tokenizer, as the JAX CLI
    answers it."""
    import sdtpu.cli as jcli
    from sdtpu.io.gguf import GGUFFile
    from sdtpu_torch import cli
    from sdtpu_torch.utils.image import decode_png

    f = GGUFFile(z_files[3])
    try:
        assert f.tensor_type("blk.0.attn_q.weight") == "q4_0"
        assert f.tensor_type("token_embd.weight") == "q4_0"
    finally:
        f.close()
    ours, theirs, rep = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png"), {}
    assert cli.main(z_files + REQUEST + ["--backend", "cpu", "-o", ours], report=rep) == 0
    load = rep["load"]
    assert load["version"] == "z_image" and load["llm_tokenizer"] == "gguf:" + z_files[3]
    assert load["w8a8_weights"] > 0 and load["block_weights"] == 0
    assert rep["pipeline"].conditioner.cl == FILE_LLM
    assert jcli.main(z_files + REQUEST + ["-o", theirs]) == 0
    a, params = decode_png(open(ours, "rb").read())
    b, _ = decode_png(open(theirs, "rb").read())
    assert a.shape == (48, 64, 3) and a.std() > 0 and "Sampler: euler" in params
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_llm_tokenizer_sources(z_files, tmp_path, capsys):
    """``--llm-tokenizer`` (a tokenizer.json) comes first; an LLM file with no
    vocab falls back to Qwen's byte-level ids, with a warning."""
    import json

    from sdtpu.io.safetensors import save_safetensors
    from sdtpu_torch import cli
    from sdtpu_torch.io.model_loader import read_checkpoint_file

    tj = tmp_path / "tokenizer.json"
    vocab = {ch: i for i, ch in enumerate(bytes_to_unicode().values())}
    tj.write_text(json.dumps({"model": {"vocab": vocab, "merges": ["a b"]}, "added_tokens": [
        {"content": t, "id": i} for t, i in Qwen2Tokenizer.CANONICAL_SPECIAL.items()]}))
    rep = {}
    argv = REQUEST[:2] + ["--steps", "1", "-W", "32", "-H", "32", "--cfg-scale", "1", "--backend",
                          "cpu", "-o", str(tmp_path / "a.png")]
    assert cli.main(z_files + argv + ["--llm-tokenizer", str(tj)], report=rep) == 0
    assert rep["load"]["llm_tokenizer"] == str(tj)
    bare = str(tmp_path / "llm.safetensors")
    save_safetensors(bare, {k: np.asarray(v, np.float32) for k, v in
                            read_checkpoint_file(z_files[3]).items()})
    files = list(z_files)
    files[3] = bare
    capsys.readouterr()
    assert cli.main(files + argv, report=rep) == 0
    assert rep["load"]["llm_tokenizer"] == "byte_fallback"
    assert "no tokenizer sidecar" in capsys.readouterr().out


def test_z_image_server_answers_a1111_from_files(z_files, tmp_path):
    """``server.main`` on the same set answers an A1111 txt2img request with
    the port CLI's image for the same request."""
    import base64
    import io
    import json
    import urllib.request

    from PIL import Image

    from sdtpu_torch import cli, server
    from sdtpu_torch.utils.image import decode_png

    box = queue.Queue()
    thread = threading.Thread(target=server.main, daemon=True, kwargs=dict(
        argv=z_files + ["--backend", "cpu", "--port", "0"], ready=box.put))
    thread.start()
    httpd = box.get(timeout=300)
    try:
        body = {"prompt": "a red fox in fresh snow", "negative_prompt": "blurry", "width": 64,
                "height": 48, "steps": 2, "cfg_scale": 4, "seed": 7, "sampler_name": "euler"}
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/sdapi/v1/txt2img",
                                     data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            code, resp = r.status, json.loads(r.read())
        version = httpd.manager.pipeline.version.value
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
    assert code == 200 and version == "z_image"
    ours = np.asarray(Image.open(io.BytesIO(base64.b64decode(resp["images"][0])))).astype(int)
    png = str(tmp_path / "cli.png")
    assert cli.main(z_files + REQUEST + ["--backend", "cpu", "-o", png]) == 0
    theirs, _ = decode_png(open(png, "rb").read())
    assert ours.shape == theirs.shape == (48, 64, 3) and np.array_equal(ours, theirs)


def test_vid_gen_on_z_image_exits_2(z_files, tmp_path, capsys):
    from sdtpu_torch import cli

    assert cli.main(["-M", "vid_gen"] + z_files + ["-p", "x", "--backend", "cpu", "-o",
                                                   str(tmp_path / "v.png")]) == 2
    assert "vid_gen on a z_image model" in capsys.readouterr().err
