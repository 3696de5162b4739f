"""LoRA, textual-inversion embeddings and the torch checkpoint reader of the
port against the JAX package's, on the CPU.

``sdtpu_torch.models.lora.apply_lora`` against ``sdtpu.models.lora.apply_lora``
on the same file tensors (``sdtpu_torch.tools.lora_file``) and the same
weights (built in the JAX package's classes, then bridged by
``from_jax_params``): every key style (kohya unet / te / te1 + te2, PEFT,
the diffusers processor form) on every weight class (dense float32 and
bf16, per-row int8, int8 with runtime factors, dense with runtime factors,
4-bit, GGUF blocks symmetric and affine) in every mode, and LoCon (k×k and
Tucker), LoHa (plain and Tucker) and LoKr.  Dense merges and factors agree
within 1e-6 relative (a bf16 merge to one bf16 step on at most 0.1 % of
entries); requantized integers are equal, or one step apart on at most
0.1 % of entries, with equal scales.  ``linear`` on runtime factors against
the JAX forms; ``set_loras`` epochs on the small SD1 pipeline against the
JAX pipeline's; a small SD1 image through both CLIs with a ``<lora:...>``
tag; an embedding's token ids and condition against ``EmbeddingMixin``'s;
the JAX pipeline's sampler keys of ``extra_sample_args``.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.models import lora as jlora
from sdtpu.ops import quant as jquant
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline
from sdtpu_torch.models import lora as tlora
from sdtpu_torch.ops import quant as tquant
from sdtpu_torch.tools.lora_file import lora_tensors, write_ckpt, write_safetensors
from sdtpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py

from _torch_files import small_sd1_configs, small_sd1_pipeline, write_small_sd1_file  # noqa: E402

MODES = ("auto", "immediately", "at_runtime")
BASES = ("dense_f32", "dense_bf16", "int8", "int8_lora", "lora", "q4", "gq", "gq_affine")
# key style → the modules its file patches
STYLES = {"kohya_unet": ("diffusion",), "kohya_te": ("clip_l",),
          "kohya_te1_te2": ("clip_l", "clip_g"), "peft": ("diffusion", "clip_l"),
          "diffusers": ("diffusion",)}
SHAPES = {"m.0.attn.to_q.weight": (64, 128), "m.0.attn.to_out.0.weight": (64, 64),
          "m.1.proj.weight": (96, 128)}


def _jax_base(kind: str, w: np.ndarray, rng):
    if kind == "dense_f32":
        return jnp.asarray(w)
    if kind == "dense_bf16":
        return jnp.asarray(w, jnp.bfloat16)
    if kind == "int8":
        return jquant.quantize_per_channel(w)
    factors = (jnp.asarray(rng.standard_normal((2, w.shape[1])).astype(np.float32) * 0.03),
               jnp.asarray(rng.standard_normal((w.shape[0], 2)).astype(np.float32) * 0.03))
    if kind == "int8_lora":
        qt = jquant.quantize_per_channel(w)
        return jquant.QuantLoraTensor(qt.q, qt.scale, *factors)
    if kind == "lora":
        return jquant.LoraTensor(jnp.asarray(w), *factors)
    if kind == "q4":  # a group-32 base comes back at the default 64
        return jquant.quantize_q4(w, group=32)
    g = jquant.quantize_group(w, group=32)
    if kind == "gq":
        return g
    zero = jnp.asarray(rng.standard_normal(g.scale.shape).astype(np.float32) * 1e-3)
    return jquant.GroupQuantTensor(g.q, g.scale, zero, k=g.k, group=g.group)


def _modules(base: str, names, seed: int = 0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {m: {n: _jax_base(base, (rng.standard_normal(s) * 0.02).astype(np.float32), rng)
                for n, s in shapes.items()} for m in names}


def _steps_apart(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    """Integers (or bf16 bit patterns) equal, or one step apart on at most
    0.1 % of entries."""
    d = (a.long() - b.long()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3, (what, d.max(), (d > 0).float().mean())


def _close(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype == torch.bfloat16:
        _steps_apart(a.view(torch.int16), b.view(torch.int16), what)
        return
    rel = (a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)
    assert rel <= 1e-6, (what, float(rel))


def _nibbles(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(p.shape[0], -1)


def _same_weight(got, want, what: str) -> None:
    """A port weight against a JAX one bridged into the port's classes."""
    assert type(got) is type(want), (what, type(got).__name__, type(want).__name__)
    if isinstance(want, torch.Tensor):
        _close(got, want, what)
    elif isinstance(want, tquant.LoraTensor):
        for f in want._fields:
            _close(getattr(got, f), getattr(want, f), f"{what}.{f}")
    elif isinstance(want, (tquant.QuantTensor, tquant.QuantLoraTensor)):
        _steps_apart(got.q, want.q, what)
        assert torch.equal(got.scale, want.scale), what
        if isinstance(want, tquant.QuantLoraTensor):
            _close(got.lora_down, want.lora_down, what + ".lora_down")
            _close(got.lora_up, want.lora_up, what + ".lora_up")
    elif isinstance(want, tquant.Q4Tensor):
        assert (got.k, got.group) == (want.k, want.group), what
        _steps_apart(_nibbles(got.packed), _nibbles(want.packed), what)
        assert torch.equal(got.scale, want.scale), what
    else:
        assert (got.k, got.group, got.zero is None) == (want.k, want.group, want.zero is None), what
        _steps_apart(got.q, want.q, what)
        assert torch.equal(got.scale, want.scale), what


def _apply_both(jmods: dict, tensors: dict, mult: float, mode: str):
    tmods = {m: from_jax_params(p, device="cpu") for m, p in jmods.items()}
    want = jlora.apply_lora(jmods, tensors, mult, mode=mode)
    got = tlora.apply_lora(tmods, tensors, mult, mode=mode)
    assert got == want
    for m, params in jmods.items():
        bridged = from_jax_params(params, device="cpu")
        for n in params:
            _same_weight(tmods[m][n], bridged[n], f"{m}/{n}")
    return got, tmods


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("style", sorted(STYLES))
def test_apply_lora_matches_jax(style, base, mode):
    jmods = _modules(base, STYLES[style])
    shapes = {m: {n: SHAPES[n] for n in SHAPES} for m in STYLES[style]}
    tensors = lora_tensors(shapes, rank=4, seed=1, style=style.split("_")[0])
    tensors["lora_unet_no_such_layer.lora_down.weight"] = np.ones((4, 8), np.float32)
    (applied, total), tmods = _apply_both(jmods, tensors, 0.8, mode)
    patchable = 2 if style == "diffusers" else 3 * len(STYLES[style])
    assert total == patchable + 1 and applied == patchable
    patched = [v for p in tmods.values() for n, v in p.items()
               if style != "diffusers" or ".attn." in n]
    kinds = {type(v).__name__ for v in patched}
    if base == "q4":
        assert {v.group for v in patched} == {64}
    if base.startswith("gq"):  # an affine base is requantized symmetric
        assert all(v.zero is None for v in patched)
    if base == "int8":
        assert kinds == {"QuantTensor" if mode == "immediately" else "QuantLoraTensor"}
    if base == "dense_f32":
        assert kinds == {"LoraTensor" if mode == "at_runtime" else "Tensor"}


CONV_SHAPES = {"m.0.conv.weight": (32, 16, 3, 3), "m.0.proj_in.weight": (32, 16, 1, 1),
               "m.0.ff.weight": (64, 128)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["locon", "locon_tucker", "loha", "loha_tucker", "lokr"])
def test_other_adapters_match_jax(kind, mode):
    """LoCon (k×k down; Tucker ``lora_mid``) and Tucker LoHa on convolutions,
    which merge in every mode; plain LoHa and LoKr on dense, int8 and 4-bit
    linears (they have no runtime form: an int8 base takes them only under
    ``immediately``)."""
    bases = ("dense_f32", "int8", "q4") if kind in ("loha", "lokr") else ("dense_f32",)
    for base in bases:
        shapes = CONV_SHAPES if base == "dense_f32" else {"m.0.ff.weight": (64, 128)}
        jmods = _modules(base, ("diffusion",), seed=3, shapes=shapes)
        tensors = lora_tensors({"diffusion": shapes}, rank=4, seed=2, kind=kind)
        (applied, total), _ = _apply_both(jmods, tensors, 1.3, mode)
        assert total == len(tlora.group_lora_tensors(tensors)) > 0
        skipped = base == "int8" and mode != "immediately"
        assert applied == (0 if skipped else total)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", ["lora", "int8_lora"])
def test_linear_on_runtime_factors_matches_jax(base, dtype):
    """``linear`` on a LoraTensor against the JAX ``linear``; on a
    QuantLoraTensor against the port's W8A8 (off the TPU the JAX
    ``quant_matmul`` runs no W8A8) plus the JAX factor products: h = x·downᵀ
    in x's dtype, y + (h·upᵀ) in y's, then the bias."""
    import jax

    from sdtpu.ops.basic import linear as jlinear
    from sdtpu_torch.ops.basic import linear

    rng = np.random.default_rng(5)
    w = _jax_base(base, (rng.standard_normal((48, 64)) * 0.05).astype(np.float32), rng)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tw = from_jax_params({"w": w}, device="cpu", dtype=tdt)["w"]
    got = linear(torch.from_numpy(x).to(tdt), tw, torch.from_numpy(bias))
    if base == "lora":
        jw = jquant.LoraTensor(w.w.astype(jdt), w.lora_down.astype(jdt), w.lora_up.astype(jdt))
        want = jlinear(jnp.asarray(x, jdt), jw, jnp.asarray(bias))
    else:
        y = tquant.quant_matmul_w8a8(torch.from_numpy(x).to(tdt), tquant.QuantTensor(tw.q, tw.scale))
        xj = jnp.asarray(x, jdt)
        h = jax.lax.dot_general(xj, w.lora_down.astype(jdt), (((2,), (1,)), ((), ())))
        lo = jax.lax.dot_general(h, w.lora_up.astype(jdt), (((2,), (1,)), ((), ())))
        want = (jnp.asarray(y.float().numpy(), jdt) + lo.astype(jdt)) + jnp.asarray(bias, jdt)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == want.shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


# ------------------------------------------------------------- pipelines


@pytest.fixture(scope="module")
def sd1():
    jp = small_sd1_pipeline()
    params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(jp.conditioner.params, device="cpu"),
              "vae": from_jax_params(jp.vae_params, device="cpu")}
    shapes = {"diffusion": {k: v.shape for k, v in jp.diffusion_params.items()},
              "clip_l": {k: v.shape for k, v in jp.conditioner.params.items()}}
    return jp, create_pipeline(SDVersion.SD1, params=params, small=True, device="cpu"), shapes


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=2, cfg_scale=4.0, seed=11, sample_method="euler")
    base.update(kw)
    return GenerationParams(**base)


def _jgp(gp):
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


def test_set_loras_epochs_match_jax(sd1):
    """Dense epochs against the JAX ``set_loras`` (weights and images, merged
    and at runtime); a second set re-derives from the base rather than
    adding to it; ``[]`` restores every weight bit for bit, as the same
    objects."""
    jp, tp, shapes = sd1
    base = dict(tp.diffusion_params)
    a = lora_tensors({"diffusion": shapes["diffusion"]}, rank=4, seed=7)
    b = lora_tensors({"diffusion": shapes["diffusion"]}, rank=2, seed=8, std=0.05)
    jbase = dict(jp.diffusion_params)
    try:
        for loras, mode in (([(a, 0.5)], "auto"), ([(a, 1.0), (b, 0.7)], "auto"),
                            ([(b, 1.2)], "at_runtime")):
            tp.set_loras(loras, mode)
            jp.set_loras(loras, mode)
            bridged = from_jax_params(jp.diffusion_params, device="cpu")
            assert set(tp.diffusion_params) == set(bridged)
            for n, want in bridged.items():
                _same_weight(tp.diffusion_params[n], want, n)
            if len(loras) == 1 and mode == "auto":
                continue  # the image of a merged set: the next epoch's
            gp = _gp()
            got, want = tp.generate(gp), jp.generate(_jgp(gp))
            np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
        assert any(isinstance(v, tquant.LoraTensor) for v in tp.diffusion_params.values())
    finally:
        tp.set_loras([])
        jp.set_loras([])
        jp.diffusion_params = jbase
    assert tp.diffusion_params.keys() == base.keys()
    assert all(tp.diffusion_params[k] is v for k, v in base.items())


@pytest.mark.parametrize("bits", [8, 4])
def test_set_loras_on_quantized_bases(sd1, bits):
    """The small SD1 UNet quantized (per-row int8, or 4-bit at group 64):
    ``set_loras`` in each mode (4-bit: one, they all merge) against the JAX
    ``apply_lora`` on a copy of the JAX weights quantized alike (the JAX
    ``set_loras`` cannot snapshot a quantized weight); runtime factors keep
    the int8 base's tensors and are attached in the compute dtype; an image
    runs; ``[]`` restores the quantized base."""
    jp, tp, shapes = sd1
    jq = jquant.quantize_params(dict(jp.diffusion_params), min_size=1024, bits=bits)
    tq = from_jax_params(jq, device="cpu")
    assert sum(isinstance(v, (tquant.QuantTensor, tquant.Q4Tensor)) for v in tq.values()) > 10
    params = {"diffusion": tq, "clip_l": tp.conditioner.params, "vae": tp.vae_params}
    qp = create_pipeline(SDVersion.SD1, params=params, small=True, device="cpu")
    lora = lora_tensors({"diffusion": shapes["diffusion"]}, rank=4, seed=9)
    for mode in MODES if bits == 8 else ("auto",):  # a 4-bit base merges in every mode
        want = dict(jq)
        jlora.apply_lora({"diffusion": want}, lora, 0.9, mode=mode)
        qp.set_loras([(lora, 0.9)], mode)
        for n, w in from_jax_params(want, device="cpu").items():
            _same_weight(qp.diffusion_params[n], w, f"{mode}/{n}")
        runtime = [v for v in qp.diffusion_params.values() if isinstance(v, tquant.QuantLoraTensor)]
        assert bool(runtime) == (bits == 8 and mode != "immediately")
        assert all(v.q is tq[n].q for n, v in qp.diffusion_params.items()
                   if isinstance(v, tquant.QuantLoraTensor))
        assert all(v.lora_down.dtype == qp.compute_dtype for v in runtime)
    assert np.isfinite(qp.generate(_gp(cfg_scale=1.0)).latents).all()
    qp.set_loras([])
    assert all(qp.diffusion_params[k] is v for k, v in tq.items())


@pytest.fixture(scope="module")
def sd1_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sd1_lora")
    jp = small_sd1_pipeline()
    loras, embd = d / "loras", d / "embeddings"
    loras.mkdir()
    embd.mkdir()
    shapes = {"diffusion": {k: v.shape for k, v in jp.diffusion_params.items()},
              "clip_l": {k: v.shape for k, v in jp.conditioner.params.items()}}
    write_ckpt(str(loras / "style.ckpt"), lora_tensors(shapes, rank=4, seed=3, std=0.06))
    write_safetensors(str(loras / "detail.safetensors"),
                      lora_tensors({"diffusion": shapes["diffusion"]}, rank=2, seed=4, std=0.08))
    hidden = jp.conditioner.params["text_model.embeddings.token_embedding.weight"].shape[1]
    rng = np.random.default_rng(6)
    write_safetensors(str(embd / "mytoken.safetensors"),
                      {"emb_params": (rng.standard_normal((2, hidden)) * 0.5).astype(np.float32)})
    return write_small_sd1_file(d, jp), str(loras), str(embd)


CLI_CASES = {
    # unet + te keys from a torch .ckpt at 0.8, the default mode
    "ckpt_te": ["-p", "a cat <lora:style:0.8> on a sofa", "--lora-model-dir", "{loras}"],
    # a unet LoRA from .safetensors at runtime, an embedding's trigger word,
    # and a name with no file (warned about, skipped)
    "safetensors_embd": ["-p", "a <lora:detail> mytoken house <lora:missing:2>",
                         "--lora-model-dir", "{loras}", "--lora-apply-mode", "at_runtime",
                         "--embd-dir", "{embd}"],
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_lora_tags_match_jax_cli(sd1_files, monkeypatch, tmp_path, capsys, name):
    from PIL import Image

    import sdtpu.cli as jcli
    from sdtpu_torch import cli

    path, loras, embd = sd1_files
    small_sd1_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    args = ["-m", path, "-W", "64", "-H", "64", "--steps", "2", "--cfg-scale", "3", "-s", "5",
            "--sampling-method", "euler"]
    args += [a.format(loras=loras, embd=embd) for a in CLI_CASES[name]]
    report = {}
    capsys.readouterr()
    assert cli.main(args + ["--backend", "cpu", "-o", str(tmp_path / "port.png")],
                    report=report) == 0
    ours = capsys.readouterr().out
    assert jcli.main(args + ["-o", str(tmp_path / "jax.png")]) == 0
    theirs = capsys.readouterr().out
    lines = [ln for ln in theirs.splitlines() if ln.startswith(("lora ", "warning: lora",
                                                                "loaded embedding"))]
    assert lines and all(ln in ours.splitlines() for ln in lines), (lines, ours)
    assert [(r["name"], r["applied"]) for r in report["loras"]] == [
        (ln.split()[1][:-1], int(ln.split()[3].split("/")[0])) for ln in lines
        if ln.startswith("lora ")]
    if name == "ckpt_te":
        style = report["loras"][0]
        assert style["applied"] == style["total"] > 80 and "x0.8" in lines[0]
    else:
        assert any(ln.startswith("lora detail: applied ") for ln in lines)
        assert "loaded embedding 'mytoken'" in lines and any("missing" in ln for ln in lines)
        assert any(isinstance(v, tquant.LoraTensor)
                   for v in report["pipeline"].diffusion_params.values())
    a, b = Image.open(str(tmp_path / "port.png")), Image.open(str(tmp_path / "jax.png"))
    assert a.info["parameters"] == b.info["parameters"] and "<lora" not in a.info["parameters"]
    assert np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max() <= 1


def test_embedding_matches_embedding_mixin(sd1):
    """An embedding's rows and trigger ids against the JAX conditioner's
    (the file forms ``emb_params``, ``string_to_param`` and a single
    tensor), the condition of a prompt with the trigger word in any case,
    and ``pipe.load_embedding`` emptying the prompt cache."""
    import copy

    jp, tp, _ = sd1
    jc = copy.copy(jp.conditioner)
    jc.init_embeddings()
    tc = tp.conditioner
    table = "text_model.embeddings.token_embedding.weight"
    saved = tc.params[table]
    rng = np.random.default_rng(12)
    hidden = saved.shape[1]
    files = {"tok_a": {"emb_params": rng.standard_normal((2, hidden)).astype(np.float32)},
             "tok_bb": {"string_to_param": {
                 "*": rng.standard_normal((1, hidden)).astype(np.float32)}},
             "tok_c": {"vec": rng.standard_normal(hidden).astype(np.float32)}}
    try:
        tp._cond_cache[("x",)] = None
        for name, vectors in files.items():
            jc.load_embedding(name, vectors)
            tp.load_embedding(name, vectors)
            assert not tp._cond_cache
        n = saved.shape[0]
        assert tc._embeddings == jc._embeddings == {"tok_a": [n, n + 1], "tok_bb": [n + 2],
                                                    "tok_c": [n + 3]}
        np.testing.assert_array_equal(tc.params[table].numpy(), np.asarray(jc.params[table]))
        prompt = "a TOK_A dog, tok_bb and tok_cat tok_c"
        for span in ("TOK_A dog", "tok_bb and tok_cat tok_c"):
            assert tc._encode_with_embeddings(tc.tokenizer, span) == \
                jc._encode_with_embeddings(jc.tokenizer, span)
        got = tc.get_learned_condition(prompt).c_crossattn.numpy()
        want = np.asarray(jc.get_learned_condition(prompt).c_crossattn)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        with pytest.raises(ValueError, match="dim"):
            tp.load_embedding("bad", np.zeros((1, hidden + 1), np.float32))
    finally:
        tc.params[table] = saved
        tc.init_embeddings()


@pytest.mark.parametrize("spec", ["noise_clip_std=2,foo=1", "foo=1,gamma=1.5"])
def test_extra_sample_args_take_the_jax_keys(sd1, spec):
    """``extra_sample_args``: the JAX pipeline's sampler keys pass (a key no
    method reads, ``noise_clip_std``, changes nothing), any other key is
    dropped, as the JAX pipeline parses them."""
    jp, tp, _ = sd1
    gp = _gp(extra_sample_args=spec, sample_method="euler_ge" if "gamma" in spec else "euler")
    got, want = tp.generate(gp), jp.generate(_jgp(gp))
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    if "gamma" not in spec:
        plain = tp.generate(_gp()).latents
        np.testing.assert_array_equal(got.latents, plain)


@pytest.mark.parametrize("version", ["FLUX", "SD2", "SDXL", "SD3", "WAN2", "Z_IMAGE", "QWEN_IMAGE"])
def test_every_family_resolves_the_jax_names(version):
    """A kohya LoRA over every 2-D weight of the JAX package's small pipeline
    (its diffusion model, CLIP-L and CLIP-G) resolves whole on the port's
    pipeline of the same family (``applied == total``): the port's weights
    carry the JAX package's canonical names."""
    from sdtpu.factory import create_pipeline as jax_create_pipeline

    jp = jax_create_pipeline(getattr(jconfig.SDVersion, version), small=True, seed=0)
    jmods = {"diffusion": jp.diffusion_params}
    cond = jp.conditioner
    for module, attrs in (("clip_l", ("pl", "params")), ("clip_g", ("pg",))):
        found = [getattr(cond, a) for a in attrs if isinstance(getattr(cond, a, None), dict)]
        if found and version not in ("Z_IMAGE", "QWEN_IMAGE"):
            jmods[module] = found[0]
    shapes = {m: {k: v.shape for k, v in p.items()} for m, p in jmods.items()}
    tensors = lora_tensors(shapes, rank=2, seed=1)
    tp = create_pipeline(getattr(SDVersion, version), small=True, device="cpu")
    mods = tlora.lora_modules(tp)
    assert set(mods) == set(jmods)
    applied, total = tlora.apply_lora(mods, tensors, 1.0)
    assert applied == total == len(tensors) // 3 > 0
