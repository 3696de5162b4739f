"""The port's Qwen-Image slice against the JAX package, on the CPU.

The same numpy-seeded parameters go through both packages
(``from_jax_params``): the joint-stream DiT, the ``QwenImageConditioner`` on
the Qwen2.5-VL text tower, and the whole pipeline (``generate``: the
``qwen_euler`` golden, CFG over two contexts of different lengths, img2img
and masked img2img through the Wan VAE's encoder in image mode).  The
loader's Qwen-Image fingerprint and refusals are held to the JAX package's;
``tools/qwen_image_file.py``'s set, at small configs, is answered by the
port's CLI (against the JAX CLI on the same files, txt2img and ``-i``
img2img) and server.  Tolerances:
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
from sdtpu.models import llm as jllm
from sdtpu.models import qwen_image as jqi
from sdtpu.tokenizers.qwen2 import Qwen2Tokenizer as JQwen2Tokenizer
from sdtpu.utils.device_init import param_specs as jparam_specs
from sdtpu_torch.conditioning import conditioner as tcond
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline, qwen_image_configs
from sdtpu_torch.io import model_loader as tml
from sdtpu_torch.models import llm as tllm
from sdtpu_torch.models import qwen_image as tqi
from sdtpu_torch.models import wan_vae as twv
from sdtpu_torch.tokenizers.bpe import bytes_to_unicode
from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer
from sdtpu_torch.weights import from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "qwen_euler.npz")
TOL = dict(rtol=5e-4, atol=5e-4)
TSMALL, TLLM, TVAE = qwen_image_configs(small=True)


def _jdit(cfg):
    return jqi.QwenImageConfig(**dataclasses.asdict(cfg))


def _jllm(cfg):
    return jllm.LLMConfig(**dataclasses.asdict(cfg))


def _perturbed(p: dict, seed: int) -> dict:
    """Norm gains around 1 and biases around 0, drawn from ``seed``."""
    g = np.random.default_rng(seed)
    out = dict(p)
    for k, v in p.items():
        if k.endswith(".bias"):
            out[k] = jnp.asarray(0.05 * g.standard_normal(v.shape, dtype=np.float32))
        elif k.endswith(".weight") and v.ndim == 1:
            out[k] = jnp.asarray(1.0 + 0.2 * g.standard_normal(v.shape, dtype=np.float32))
    return out


def _small_tokenizers():
    """A Qwen2 tokenizer whose ids fit the small LLM's 256-piece vocab: the
    byte units at 0..252, the chat template's specials at 253..255 (both
    packages)."""
    vocab = {ch: i for i, ch in enumerate(list(bytes_to_unicode().values())[:253])}
    special = {"<|im_start|>": 253, "<|im_end|>": 254, "<|endoftext|>": 255}
    return Qwen2Tokenizer(vocab, [], special), JQwen2Tokenizer(vocab, [], special)


def test_configs_and_template_match():
    assert _jdit(tqi.QWEN_IMAGE_CONFIG) == jqi.QWEN_IMAGE_CONFIG
    # the JAX factory's small Qwen-Image configs (sdtpu/factory.py, _create_qwen_image_pipeline)
    assert _jdit(TSMALL) == jqi.QwenImageConfig(
        in_channels=16, out_channels=4, num_layers=2, head_dim=16, num_heads=4,
        joint_attention_dim=48, axes_dim=(4, 6, 6))
    assert _jllm(TLLM) == jllm.LLMConfig(num_layers=2, hidden_size=48, intermediate_size=96,
                                         num_heads=4, num_kv_heads=2, head_dim=12, vocab_size=256)
    assert twv.WanVAEConfig(dim=8, z_dim=4, num_res_blocks=1) == TVAE
    assert tllm.CHAT_TEMPLATES["qwen_image"] == jllm.CHAT_TEMPLATES["qwen_image"]


def test_full_width_specs_and_fingerprint_match_jax():
    """``param_specs`` holds ``init_qwen_image_params``' names and shapes
    (20.43e9 parameters); both packages' ``detect_qwen_image_config`` read
    the config back and ``detect_version`` names Qwen-Image; the LLM's
    specs hold ``init_llm_params``' (Qwen2.5-VL-7B, qkv biases)."""
    cfg = tqi.QWEN_IMAGE_CONFIG
    want = jparam_specs(jqi.init_qwen_image_params, jqi.QWEN_IMAGE_CONFIG, 0)
    got = tqi.param_specs(cfg)
    assert {k: tuple(v.shape) for k, v in want.items()} == {k: s for k, (s, _) in got.items()}
    assert round(sum(int(np.prod(s)) for s, _ in got.values()) / 1e9, 2) == 20.43
    assert tqi.detect_qwen_image_config(got) == cfg
    assert jqi.detect_qwen_image_config(list(got)) == jqi.QWEN_IMAGE_CONFIG
    names = [tml.DIFFUSION_PREFIX + k for k in got]
    shapes = {tml.DIFFUSION_PREFIX + k: s for k, (s, _) in got.items()}
    assert tml.detect_version(names, shapes) == SDVersion.QWEN_IMAGE
    assert jdetect_version(names, shapes).value == "qwen_image"
    want = jparam_specs(jllm.init_llm_params, jllm.QWEN25_VL_7B_CONFIG, 0)
    got = tllm.param_specs(tllm.QWEN25_VL_7B_CONFIG)
    assert {k: tuple(v.shape) for k, v in want.items()} == {k: s for k, (s, _) in got.items()}
    shapes = {k: s for k, (s, _) in got.items()}
    assert tllm.detect_llm_config(shapes, shapes) == tllm.QWEN25_VL_7B_CONFIG


@pytest.mark.parametrize("variant,word", [
    ("mage", "mage_flow"), ("layered", "qwen_layered"), ("zero_cond", "zero_cond_t")])
def test_unported_variants_refused_by_name(tmp_path, variant, word):
    """Mage-Flow (``img_in`` 128 wide) and the layered variant
    (``addition_t_embedding``) fingerprint as themselves in both packages
    and the loader refuses them; Edit 2509's ``__index_timestep_zero__``
    marker loads as Qwen-Image and the factory refuses its zero_cond_t."""
    from sdtpu.io.safetensors import save_safetensors

    z = np.zeros((4, 4), np.float32)
    dit = {"transformer_blocks.0.img_mod.1.weight": z, "img_in.weight": np.zeros((4, 64), np.float32)}
    if variant == "mage":
        dit["img_in.weight"] = np.zeros((4, 128), np.float32)
    elif variant == "layered":
        dit["time_text_embed.addition_t_embedding.weight"] = z
    else:
        dit["__index_timestep_zero__"] = z[0]
    names = [tml.DIFFUSION_PREFIX + k for k in dit]
    shapes = {tml.DIFFUSION_PREFIX + k: v.shape for k, v in dit.items()}
    path = str(tmp_path / "dit.safetensors")
    save_safetensors(path, dit)
    if variant == "zero_cond":
        assert tml.detect_version(names, shapes) == SDVersion.QWEN_IMAGE
        bundle = tml.load_model_bundle(diffusion_model_path=path)
        with pytest.raises(NotImplementedError, match=word):
            create_pipeline(SDVersion.QWEN_IMAGE, params={"diffusion": bundle.diffusion},
                            device="cpu")
        return
    assert tml.detect_version(names, shapes).value == jdetect_version(names, shapes).value == word
    with pytest.raises(NotImplementedError, match=word):
        tml.load_model_bundle(diffusion_model_path=path)


def test_llm_vision_tower_is_set_aside(tmp_path):
    """A Qwen2.5-VL file's ``model.visual.*`` tensors are counted
    (``ModelBundle.vision_tensors``) and dropped, not put in the text tower,
    and a given LLM dict's ``visual.*`` ones are dropped by the factory;
    nothing runs them, and the edit path raises by name."""
    from sdtpu.io.safetensors import save_safetensors

    z = np.zeros((4, 4), np.float32)
    save_safetensors(str(tmp_path / "dit.safetensors"), {"transformer_blocks.0.img_mod.1.weight": z})
    save_safetensors(str(tmp_path / "llm.safetensors"), {
        "model.visual.blocks.0.attn.qkv.weight": z, "model.norm.weight": z[0]})
    bundle = tml.load_model_bundle(diffusion_model_path=str(tmp_path / "dit.safetensors"),
                                   llm_path=str(tmp_path / "llm.safetensors"))
    assert bundle.version == SDVersion.QWEN_IMAGE
    assert bundle.vision_tensors == 1
    assert list(bundle.llm) == ["model.norm.weight"]
    # a library caller's LLM params with the tower under ``visual.``: dropped by the factory
    tp = create_pipeline(SDVersion.QWEN_IMAGE, small=True, seed=1, device="cpu")
    llm = {**tp.conditioner.pl, "visual.blocks.0.attn.qkv.weight": torch.zeros(4, 4)}
    tp = create_pipeline(SDVersion.QWEN_IMAGE, small=True, device="cpu", params={"llm": llm})
    assert not any(k.startswith("visual.") for k in tp.conditioner.pl)
    with pytest.raises(NotImplementedError, match="Qwen-Image-Edit"):
        tp.conditioner.get_learned_condition("x", ref_images=[np.zeros((8, 8, 3), np.uint8)])


@pytest.mark.parametrize("n,k", [(6, 3072), (5, 544)], ids=["k3072", "k544_padded"])
def test_q4_0_blocks_become_q4tensors_without_widening(n, k):
    """``from_host_quant`` moves q4_0's nibbles into the ``Q4Tensor`` order on
    the device: bit-equal to packing the unpacked int8 values (the generic
    path, K padded to the 64-wide tile with zeros), and its dequantized
    values are the blocks' own."""
    from sdtpu_torch.io.gguf import HostQuant
    from sdtpu_torch.ops import quant

    g = np.random.default_rng(k)
    h = HostQuant(g.integers(0, 256, n * k // 2, dtype=np.uint8),
                  (g.random(n * k // 32) * 0.01 + 0.001).astype(np.float32), None, (n, k), 32,
                  "q4_0", qbits=4)
    qt = quant.from_host_quant(h, "cpu")
    kp = -(-k // quant.Q4_K_MULTIPLE) * quant.Q4_K_MULTIPLE
    want = quant._pack_nibbles(torch.from_numpy(np.pad(h.unpack_q().reshape(n, k), ((0, 0), (0, kp - k)))))
    assert isinstance(qt, quant.Q4Tensor) and torch.equal(qt.packed, want)
    np.testing.assert_array_equal(quant.dequantize_q4(qt, torch.float32).numpy(),
                                  h.dequantize().reshape(n, k))


@pytest.mark.parametrize("qtype", ["q8_0", "q4_0", "q4_1"])
def test_host_quant_values_match_host_dequantize(qtype):
    """The loader dequantizes a text encoder's GGUF blocks after moving them
    to the device (``host_quant_values``): the host's float32 values, bit
    for bit (q4_0 from its packed nibbles, q4_1 with its zero point)."""
    from sdtpu_torch.io import gguf
    from sdtpu_torch.ops.quant import host_quant_values

    x = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    t = {"q8_0": gguf.GGML_Q8_0, "q4_0": gguf.GGML_Q4_0, "q4_1": gguf.GGML_Q4_1}[qtype]
    h = gguf.extract_blocks(getattr(gguf, f"quantize_{qtype}")(x).reshape(-1), t, x.size, x.shape)
    np.testing.assert_array_equal(host_quant_values(h, "cpu").numpy(), h.dequantize())


@pytest.fixture(scope="module")
def dit_params():
    jp = _perturbed(jqi.init_qwen_image_params(_jdit(TSMALL), seed=4), 5)
    return jp, from_jax_params(jp, device="cpu")


# head_dim 128 over the full-width axes (16, 56, 56), two heads, one block
NARROW = dataclasses.replace(TSMALL, in_channels=64, out_channels=16, num_layers=1, head_dim=128,
                             num_heads=2, joint_attention_dim=64, axes_dim=(16, 56, 56))
FORWARD_CASES = {"8x8_ctx12": (TSMALL, 1, 8, 8, 12), "12x10_ctx20": (TSMALL, 2, 12, 10, 20),
                 "narrow_hd128": (NARROW, 2, 8, 6, 16)}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_qwen_image_forward_matches_jax(dit_params, case):
    """A batch of two timesteps in the denoiser's scale (sigma · 1000), the
    RoPE ids' text run and centred grid, the (scale, shift) final norm."""
    cfg, b, h, w, n_ctx = FORWARD_CASES[case]
    if cfg is TSMALL:
        jp, tp = dit_params
    else:
        jp = _perturbed(jqi.init_qwen_image_params(_jdit(cfg), seed=6), 7)
        tp = from_jax_params(jp, device="cpu")
    jforward = jax.jit(functools.partial(jqi.qwen_image_forward, cfg=_jdit(cfg)))
    g = np.random.default_rng(h * w + n_ctx)
    x = g.standard_normal((b, h, w, cfg.out_channels), dtype=np.float32)
    t = np.array([700.0, 120.0][:b], np.float32)
    ctx = g.standard_normal((b, n_ctx, cfg.joint_attention_dim), dtype=np.float32)
    want = np.asarray(jforward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    got = tqi.qwen_image_forward(tp, torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx), cfg=cfg)
    assert got.shape == want.shape == (b, h, w, cfg.out_channels)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("lt,hp,wp", [(7, 5, 3), (164, 64, 64)])
def test_rope_ids_match_jax(lt, hp, wp, monkeypatch):
    """The ids the JAX forward builds (captured from its ``rope_freqs``)."""
    seen = []
    real = jqi.rope_freqs
    monkeypatch.setattr(jqi, "rope_freqs", lambda ids, *a: seen.append(ids) or real(ids, *a))
    cfg = _jdit(TSMALL)
    p = jqi.init_qwen_image_params(dataclasses.replace(cfg, num_layers=0), seed=0)
    jqi.qwen_image_forward(p, jnp.zeros((1, 2 * hp, 2 * wp, 4)), jnp.zeros(1),
                           jnp.zeros((1, lt, 48)), cfg=dataclasses.replace(cfg, num_layers=0))
    np.testing.assert_array_equal(tqi.qwen_image_ids(lt, hp, wp), seen[0])


def test_reference_latents_are_refused(dit_params):
    _, tp = dit_params
    with pytest.raises(NotImplementedError, match="ref_latents"):
        tqi.qwen_image_forward(tp, torch.zeros((1, 8, 8, 4)), torch.zeros(1),
                               torch.zeros((1, 4, 48)), cfg=TSMALL, ref_latents=[torch.zeros((1, 8, 8, 4))])


def test_forward_calls_at_full_width(monkeypatch):
    """At full width on the meta device: one 1024² forward under CFG (a
    164-row context) makes ``chip_smoke.QWEN_IMAGE_ATTENTION_CALLS`` joint
    attentions at D 128 over 164 + 4096 tokens, and each linear takes the
    rows ``chip_smoke.qwen_image_linear_rows`` gives it; so a q4_0 file's DiT
    runs the 4-bit GEMV at the modulation (B rows) and wgmma at both
    streams, ``img_in`` (K 64) in group-dequant blocks, and the per-row int8
    DiT of the W8A8 check (B = 1, 64 context rows) all three W8A8 forms."""
    import chip_smoke

    seen, rows = [], {}

    def counting(q, k, v, *a, **kw):
        seen.append(tuple(q.shape[:3]) + (k.shape[2], q.shape[3]))
        return torch.empty_like(q)

    cfg = tqi.QWEN_IMAGE_CONFIG
    p = {k: torch.empty(s, device="meta") for k, (s, _) in tqi.param_specs(cfg).items()}
    names = {id(v): k for k, v in p.items()}
    real_linear = tqi.linear

    def recording(x, weight, bias=None):
        rows[names[id(weight)]] = x.numel() // x.shape[-1]
        return real_linear(x, weight, bias)

    monkeypatch.setattr(tqi, "attention", counting)
    monkeypatch.setattr(tqi, "linear", recording)
    lt = 164
    out = tqi.qwen_image_forward(p, torch.empty((2, 128, 128, 16), device="meta"),
                                 torch.empty((2,), device="meta"),
                                 torch.empty((2, lt, 3584), device="meta"), cfg=cfg)
    assert out.shape == (2, 128, 128, 16)
    assert len(seen) == chip_smoke.QWEN_IMAGE_ATTENTION_CALLS == 60
    assert set(seen) == {(2, 24, lt + 4096, lt + 4096, 128)}
    assert len(rows) == 2 + 2 + 60 * 14 + 2
    assert rows == {n: chip_smoke.qwen_image_linear_rows(n, 2, lt) for n in rows}
    assert chip_smoke.qwen_image_file_forms(2, lt) == {
        "q4_matmul_gemv": 120, "q4_matmul_splitk": 0, "q4_matmul_wgmma": 722, "gq_matmul": 0,
        "gq_matmul_ws": 1}
    assert chip_smoke.qwen_image_w8a8_forms(1, 64) == {
        "w8a8_matmul_gemv": 123, "w8a8_matmul_splitk": 361, "w8a8_matmul_wgmma": 362}


def test_encode_rows_of_the_card_requests():
    """The byte-level ids of the card's Qwen-Image prompts: 198 and 181 (the
    LLM's linears in their wgmma form), contexts of 164 and 147 rows."""
    import chip_smoke

    rows = chip_smoke.qwen_image_encode_rows([chip_smoke.QWEN_IMAGE_REQUEST])
    assert rows == [198, 181]
    tok, (template, drop) = Qwen2Tokenizer.byte_fallback(), tllm.CHAT_TEMPLATES["qwen_image"]
    assert len(tok.encode(template.format(chip_smoke.QWEN_IMAGE_REQUEST["prompt"]))) - drop == 164
    assert chip_smoke.QWEN_IMAGE_FLASH_CASES[0][2] == 164 + 4096


@pytest.fixture(scope="module")
def jpipe():
    return jax_create_pipeline(jconfig.SDVersion.QWEN_IMAGE, small=True, seed=0)


@pytest.mark.parametrize("tokenized", [False, True], ids=["no_tokenizer", "tokenizer"])
def test_conditioner_matches_jax(jpipe, tokenized):
    """The LLM's states after the final norm, the template's first 34 ids
    dropped; without a tokenizer the ids 0..47, 8 dropped."""
    ttok, jtok = _small_tokenizers() if tokenized else (None, None)
    jc = jpipe.conditioner
    pl = _perturbed(jc.pl, 6)
    j = jcond.QwenImageConditioner(jtok, pl, jc.cl)
    t = tcond.QwenImageConditioner(ttok, from_jax_params(pl, device="cpu"), TLLM, device="cpu")
    text = "a (red:1.3) fox in snow"
    want = np.asarray(j.get_learned_condition(text).c_crossattn)
    got = t.get_learned_condition(text).c_crossattn
    n = len(ttok.encode(t.template.format(text))) - 34 if tokenized else 40
    assert got.shape == want.shape == (1, n, TLLM.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(NotImplementedError, match="Qwen-Image-Edit"):
        t.get_learned_condition(text, ref_images=[np.zeros((8, 8, 3), np.uint8)])


@pytest.fixture(scope="module")
def pipes(jpipe):
    c = jpipe.conditioner
    params = {"diffusion": from_jax_params(jpipe.diffusion_params, device="cpu"),
              "llm": from_jax_params(c.pl, device="cpu"),
              "vae": from_jax_params(jpipe.vae_params, device="cpu")}
    return params, create_pipeline(SDVersion.QWEN_IMAGE, params=params, small=True, device="cpu")


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=4.0, seed=11, sample_method="euler")
    base.update(kw)
    return GenerationParams(**base)


def _jgp(gp):
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


def test_reproduces_qwen_golden_latents(pipes):
    """``tests/test_golden_latents.py``'s ``qwen_euler`` case: 64², 3 euler
    steps at CFG 4, shift 3, no tokenizer."""
    _, tp = pipes
    assert tp.denoiser.shift == 3.0 and tp.latent_channels == 4
    res = tp.generate(_gp())
    want = np.load(GOLDEN)["latents"]
    assert res.latents.shape == want.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(res.latents, want, **TOL)


def test_cfg_over_contexts_of_different_lengths_matches_jax(pipes):
    """With a tokenizer the prompt and the negative prompt encode to
    different lengths; the shorter context is zero-padded, its pad tokens
    unmasked in the joint attention, as the JAX pipeline runs it.  A wide
    latent, 2 steps."""
    params, _ = pipes
    ttok, jtok = _small_tokenizers()
    tp = create_pipeline(SDVersion.QWEN_IMAGE, params=params, small=True, device="cpu",
                         qwen_tokenizer=ttok)
    jp = jax_create_pipeline(jconfig.SDVersion.QWEN_IMAGE, small=True, seed=0, qwen_tokenizer=jtok)
    gp = _gp(width=80, height=48, sample_steps=2, cfg_scale=2.5,
             negative_prompt="blurry, low quality, watermark")
    got, want = tp.generate(gp), jp.generate(_jgp(gp))
    c, u = tp._cond_cache[next(iter(tp._cond_cache))]
    assert c.c_crossattn.shape[1] != u.c_crossattn.shape[1]
    np.testing.assert_allclose(got.latents, want.latents, **TOL)
    assert got.images.shape == want.images.shape == (1, 48, 80, 3) and got.images.std() > 0
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


def _init_image(seed=0, size=64):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("masked", [False, True], ids=["img2img", "masked"])
def test_img2img_matches_jax(jpipe, pipes, masked):
    """The init image through the Wan VAE's encoder (one frame), 3 of 4
    steps at strength 0.6 (the first sampled sigma below 1, so the init
    latent enters the start; masked: the right half regenerates); latents
    and images as the JAX pipeline's."""
    _, tp = pipes
    gp = _gp(sample_steps=4, strength=0.6, cfg_scale=2.5)
    img = _init_image(4)
    mask = None
    if masked:
        mask = np.zeros((64, 64), dtype=np.uint8)
        mask[:, 32:] = 255
    np.testing.assert_allclose(tp.encode_image(img), jpipe.encode_image(img), **TOL)
    want, got = jpipe.img2img(_jgp(gp), img, mask), tp.img2img(gp, img, mask)
    np.testing.assert_allclose(got.latents, want.latents, **TOL)
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1
    assert tp.last_timings["steps"] == jpipe.last_timings["steps"] == 3
    assert tp.last_timings["encode"] > 0


def test_mismatched_llm_width_and_f32_memory_are_refused(pipes, monkeypatch):
    """An LLM whose width is not the DiT's ``joint_attention_dim`` is
    refused; a full-width DiT that would not fit the card's free memory is
    refused before it is drawn (81.7e9 bytes in float32 against 80e9)."""
    from sdtpu_torch import factory

    params, _ = pipes
    wide = tllm.param_specs(dataclasses.replace(TLLM, hidden_size=64, head_dim=16))
    with pytest.raises(ValueError, match="joint_attention_dim"):
        create_pipeline(SDVersion.QWEN_IMAGE, device="cpu", params={
            "llm": {k: torch.empty(s, device="meta") for k, (s, _) in wide.items()},
            "diffusion": params["diffusion"]})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (80e9, 80e9))
    specs = tqi.param_specs(tqi.QWEN_IMAGE_CONFIG)
    with pytest.raises(MemoryError, match="Qwen-Image DiT in torch.float32 is 81.7 GB"):
        factory._check_fits(specs, torch.float32, "cuda", "the Qwen-Image DiT")
    factory._check_fits(specs, torch.bfloat16, "cuda", "the Qwen-Image DiT")


def test_full_width_without_tokenizer_uses_byte_fallback():
    """At full width (weights on the meta device) a pipeline built without
    a tokenizer warns and tokenizes with the Qwen2 byte-level vocabulary;
    the LLM fingerprints as Qwen2.5-VL-7B, the VAE as the Wan 2.1 VAE; the
    small configs keep None."""
    dit, llm, vae = qwen_image_configs(small=False)
    specs = {"diffusion": tqi.param_specs(dit), "llm": tllm.param_specs(llm),
             "vae": twv.param_specs(vae, decode_only=False)}
    params = {m: {k: torch.empty(s, device="meta") for k, (s, _) in sp.items()}
              for m, sp in specs.items()}
    with pytest.warns(UserWarning, match="byte-level"):
        tp = create_pipeline(SDVersion.QWEN_IMAGE, params=params, device="cpu")
    tok = tp.conditioner.tokenizer
    assert isinstance(tok, Qwen2Tokenizer) and tp.conditioner.cl == tllm.QWEN25_VL_7B_CONFIG
    wrap = tp.conditioner.template
    assert tok.encode(wrap.format("a fox")) == JQwen2Tokenizer.byte_fallback().encode(wrap.format("a fox"))
    assert tp.latent_channels == 16
    small = create_pipeline(SDVersion.QWEN_IMAGE, small=True, seed=3, device="cpu")
    assert small.conditioner.tokenizer is None


# ------------------------------------------------------- files, CLI, server

# the file set's DiT: the small one 128 wide (4 heads of 32, axes (8, 12,
# 12)) over a 64-wide context, so its linears take q4_0 blocks; its LLM: the
# small Qwen2.5-VL 64 wide with Qwen's full 152064-id vocab (the file's
# "gpt2" vocab pins the specials at 151643..151656)
FILE_DIT = dataclasses.replace(TSMALL, head_dim=32, axes_dim=(8, 12, 12), joint_attention_dim=64)
FILE_LLM = dataclasses.replace(TLLM, hidden_size=64, intermediate_size=128, head_dim=16,
                               vocab_size=152064)


def small_qwen_image_configs(monkeypatch):
    """Swap the full-size configs both CLIs load Qwen-Image with for small
    ones: the DiT's base (``detect_qwen_image_config`` reads only the depth),
    Qwen2.5-VL's base (``detect_llm_config`` counts heads by its head
    width) and, for ``tools/qwen_image_file.py``, the Wan VAE (both loaders
    read its widths from the file)."""
    monkeypatch.setattr(tqi, "QWEN_IMAGE_CONFIG", FILE_DIT)
    monkeypatch.setattr(jqi, "QWEN_IMAGE_CONFIG", _jdit(FILE_DIT))
    monkeypatch.setattr(tllm, "QWEN25_VL_7B_CONFIG", FILE_LLM)
    monkeypatch.setattr(jllm, "QWEN25_VL_7B_CONFIG", _jllm(FILE_LLM))
    monkeypatch.setattr(twv, "WAN21_VAE_CONFIG", TVAE)


@pytest.fixture
def qwen_files(monkeypatch, tmp_path):
    from sdtpu_torch.tools.qwen_image_file import write_qwen_image_files

    small_qwen_image_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))  # the JAX CLI makes it
    files = write_qwen_image_files(tmp_path / "set", device="cpu", min_quant_elems=1024)
    p = files["paths"]
    assert all(os.path.getsize(path) == files["bytes"][k] for k, path in p.items())
    init = str(tmp_path / "init.png")
    from sdtpu_torch.utils.image import write_image

    write_image(init, _init_image(9, 32)[:, :, :3][:32, :32].repeat(2, 0)[:48, :].repeat(2, 1))
    return ["--diffusion-model", p["diffusion_model"], "--llm", p["llm"], "--vae", p["vae"]], init


REQUEST = ["-p", "a red fox in fresh snow", "-n", "blurry", "-W", "64", "-H", "48", "--steps", "2",
           "--cfg-scale", "2.5", "--sampling-method", "euler", "-s", "7"]


@pytest.mark.parametrize("img2img", [False, True], ids=["txt2img", "img2img"])
def test_qwen_image_files_answer_the_cli_as_the_jax_cli(qwen_files, tmp_path, img2img):
    """``tools/qwen_image_file.py``'s set (a q4_0 GGUF DiT kept in its
    blocks; a q4_0 GGUF Qwen2.5-VL under llama.cpp names with its "gpt2"
    vocab; the Wan VAE with its encoder) answered by ``cli.main`` with the
    GGUF's tokenizer, as the JAX CLI answers it; with ``-i`` an img2img at
    strength 0.75."""
    import sdtpu.cli as jcli
    from sdtpu.io.gguf import GGUFFile
    from sdtpu_torch import cli
    from sdtpu_torch.utils.image import decode_png

    files, init = qwen_files
    f = GGUFFile(files[1])
    try:
        assert f.tensor_type("transformer_blocks.0.img_mlp.net.0.proj.weight") == "q4_0"
    finally:
        f.close()
    extra = ["-i", init, "--strength", "0.75"] if img2img else []
    ours, theirs, rep = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png"), {}
    assert cli.main(files + REQUEST + extra + ["--backend", "cpu", "-o", ours], report=rep) == 0
    load = rep["load"]
    assert load["version"] == "qwen_image" and load["llm_tokenizer"] == "gguf:" + files[3]
    assert load["block_weights"] > 0 and load["w8a8_weights"] == 0
    assert rep["pipeline"].conditioner.cl == FILE_LLM
    assert ("encode" in rep["timings"]) == img2img
    assert jcli.main(files + REQUEST + extra + ["-o", theirs]) == 0
    a, params = decode_png(open(ours, "rb").read())
    b, _ = decode_png(open(theirs, "rb").read())
    assert a.shape == (48, 64, 3) and a.std() > 0 and "Sampler: euler" in params
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("flag,word", [
    (["--qwen-image-layers", "4"], "--qwen-image-layers"),
    (["--model-args", "qwen_image_zero_cond_t=true"], "qwen_image_zero_cond_t"),
    (["-r", "REF"], "-r/--ref-image on a qwen_image model"),
])
def test_unported_qwen_image_flags_exit_2(qwen_files, tmp_path, capsys, flag, word):
    from sdtpu_torch import cli

    files, init = qwen_files
    flag = [init if a == "REF" else a for a in flag]
    assert cli.main(files + ["-p", "x", "-W", "32", "-H", "32", "--steps", "1", "--backend", "cpu",
                             "-o", str(tmp_path / "o.png")] + flag) == 2
    assert word in capsys.readouterr().err


def test_qwen_image_server_answers_a1111_from_files(qwen_files, tmp_path):
    """``server.main`` on the same set answers an A1111 txt2img and an
    img2img request with the port CLI's images for the same requests."""
    import base64
    import io
    import json
    import urllib.request

    from PIL import Image

    from sdtpu_torch import cli, server
    from sdtpu_torch.utils.image import decode_png

    files, init = qwen_files
    box = queue.Queue()
    thread = threading.Thread(target=server.main, daemon=True, kwargs=dict(
        argv=files + ["--backend", "cpu", "--port", "0"], ready=box.put))
    thread.start()
    httpd = box.get(timeout=300)
    body = {"prompt": "a red fox in fresh snow", "negative_prompt": "blurry", "width": 64,
            "height": 48, "steps": 2, "cfg_scale": 2.5, "seed": 7, "sampler_name": "euler"}
    answers = {}
    try:
        for route, extra in (("txt2img", {}), ("img2img", {
                "init_images": [base64.b64encode(open(init, "rb").read()).decode()],
                "denoising_strength": 0.75})):
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/sdapi/v1/{route}",
                data=json.dumps({**body, **extra}).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                assert r.status == 200
                answers[route] = np.asarray(Image.open(io.BytesIO(base64.b64decode(
                    json.loads(r.read())["images"][0])))).astype(int)
        version = httpd.manager.pipeline.version.value
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
    assert version == "qwen_image"
    for route, extra in (("txt2img", []), ("img2img", ["-i", init, "--strength", "0.75"])):
        png = str(tmp_path / f"cli_{route}.png")
        assert cli.main(files + REQUEST + extra + ["--backend", "cpu", "-o", png]) == 0
        theirs, _ = decode_png(open(png, "rb").read())
        assert answers[route].shape == theirs.shape == (48, 64, 3)
        assert np.array_equal(answers[route], theirs)
