"""The port's host layer against the JAX package's originals, on the same inputs.

``sdtpu_torch`` keeps its own copies of the host code it needs (config, RNG,
CLIP tokenizer, prompt parser, GGUF and safetensors readers, the FLUX model
loader).  Each copy is held to its original here: the noise streams and the
written GGUF bytes are identical, tokens, parsed prompts, loaded blocks and
bundles are equal.  The port's entry points default to the card, and its
``SDVersion`` is a class of its own.
"""
import dataclasses
import inspect

import numpy as np
import pytest

import sdtpu.config as jconfig
import sdtpu.io.gguf as jgguf
import sdtpu.rng as jrng
from sdtpu.conditioning.prompt_parser import parse_prompt_attention as jparse
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
from sdtpu.io.safetensors import save_safetensors
from sdtpu.tokenizers.clip import CLIPTokenizer as JCLIPTokenizer
from sdtpu_torch import config as tconfig
from sdtpu_torch import rng as trng
from sdtpu_torch.conditioning.prompt_parser import parse_prompt_attention as tparse
from sdtpu_torch.io import gguf as tgguf
from sdtpu_torch.io.model_loader import load_model_bundle
from sdtpu_torch.tokenizers.clip import CLIPTokenizer


# ------------------------------------------------------------- config, RNG


def test_config_copies_match():
    assert [(m.name, m.value) for m in tconfig.SDVersion] == \
        [(m.name, m.value) for m in jconfig.SDVersion]
    fields = [(f.name, f.default) for f in dataclasses.fields(tconfig.GenerationParams)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(jconfig.GenerationParams)]
    assert tconfig.SDVersion.FLUX != jconfig.SDVersion.FLUX  # two enum classes


@pytest.mark.parametrize("kind", ["cuda", "cpu", "std_default"])
@pytest.mark.parametrize("seed,shape", [(0, (7,)), (42, (64, 64, 16)), (2 ** 33 + 5, (3, 17, 5)),
                                        (123456789, (1, 128, 128, 16))])
def test_rng_streams_bit_equal(kind, seed, shape):
    got = trng.create_rng(kind, seed).randn_shape(shape)
    want = jrng.create_rng(kind, seed).randn_shape(shape)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_rng_continues_like_jax():
    """Two draws from one generator: the stream's offset advances alike."""
    for kind in ("cuda", "cpu"):
        t, j = trng.create_rng(kind, 9), jrng.create_rng(kind, 9)
        for n in (5, 300):
            np.testing.assert_array_equal(t.randn(n), j.randn(n))


# ------------------------------------------------- tokenizer, prompt parser

PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "a (red:1.3) fox in [fresh] snow, ((golden hour))",
    "portrait BREAK studio lighting BREAK (film grain:0.8)",
    "café crème brûlée, naïve Übermensch — 東京の夜景 🌃",
    "escaped \\(parens\\) and \\[brackets\\] (a:1.2 b) [[c]] (d))",
    "",
    "word " * 90,
]


@pytest.mark.parametrize("prompt", PROMPTS, ids=[f"prompt{i}" for i in range(len(PROMPTS))])
def test_parse_prompt_attention_matches(prompt):
    assert tparse(prompt) == jparse(prompt)


@pytest.fixture(scope="module")
def tokenizers():
    return CLIPTokenizer(), JCLIPTokenizer()


@pytest.mark.parametrize("prompt", PROMPTS, ids=[f"prompt{i}" for i in range(len(PROMPTS))])
def test_clip_tokenizer_matches(tokenizers, prompt):
    tok, jtok = tokenizers
    assert tok.encode(prompt) == jtok.encode(prompt)
    assert (tok.bos_token_id, tok.eos_token_id) == (jtok.bos_token_id, jtok.eos_token_id)


# ------------------------------------------------------------------ GGUF

# byte spans holding f16 floats inside one block, per type (the rest is
# integer payload, so random bytes are valid blocks)
F16_SPANS = {
    tgguf.GGML_Q4_0: [(0, 2)], tgguf.GGML_Q4_1: [(0, 2), (2, 4)], tgguf.GGML_Q5_0: [(0, 2)],
    tgguf.GGML_Q5_1: [(0, 2), (2, 4)], tgguf.GGML_Q8_0: [(0, 2)],
    tgguf.GGML_Q2_K: [(80, 82), (82, 84)], tgguf.GGML_Q3_K: [(108, 110)],
    tgguf.GGML_Q4_K: [(0, 2), (2, 4)], tgguf.GGML_Q5_K: [(0, 2), (2, 4)],
    tgguf.GGML_Q6_K: [(208, 210)],
}


def _raw_blocks(ggml_type, n_elems, seed):
    block_elems, block_bytes = tgguf.BLOCK_INFO[ggml_type]
    nb = n_elems // block_elems
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(nb, block_bytes), dtype=np.uint8)
    for lo, hi in F16_SPANS[ggml_type]:
        raw[:, lo:hi] = (rng.standard_normal(nb) * 0.05).astype(np.float16).view(np.uint8).reshape(nb, 2)
    return raw.reshape(-1)


def _same_host_quant(a, b):
    assert type(a).__name__ == type(b).__name__ == "HostQuant"
    assert (a.shape, a.group, a.type_name, a.qbits) == (b.shape, b.group, b.type_name, b.qbits)
    np.testing.assert_array_equal(a.q, b.q)
    np.testing.assert_array_equal(a.scale, b.scale)
    assert (a.zero is None) == (b.zero is None)
    if a.zero is not None:
        np.testing.assert_array_equal(a.zero, b.zero)


def test_ggml_tables_match():
    assert tgguf.BLOCK_INFO == jgguf.BLOCK_INFO
    assert set(tgguf.EXTRACT_FNS) == set(jgguf.EXTRACT_FNS) == set(F16_SPANS)
    assert tgguf.TYPE_NAMES == jgguf.TYPE_NAMES


@pytest.mark.parametrize("ggml_type", sorted(F16_SPANS))
def test_extract_blocks_and_dequantize_match(ggml_type):
    n, k = 6, 512
    raw = _raw_blocks(ggml_type, n * k, seed=ggml_type)
    got = tgguf.extract_blocks(raw, ggml_type, n * k, (n, k))
    want = jgguf.extract_blocks(raw, ggml_type, n * k, (n, k))
    _same_host_quant(got, want)
    np.testing.assert_array_equal(got.unpack_q(), want.unpack_q())
    np.testing.assert_array_equal(got.dequantize(), want.dequantize())
    np.testing.assert_array_equal(tgguf.dequantize(raw, ggml_type, n * k),
                                  jgguf.dequantize(raw, ggml_type, n * k))


@pytest.mark.parametrize("qtype", ["q8_0", "q4_0", "q4_1"])
def test_quantize_fns_match(qtype):
    x = np.random.default_rng(1).standard_normal((8, 256)).astype(np.float32)
    x[2] = 0.0
    fn = f"quantize_{qtype}"
    np.testing.assert_array_equal(getattr(tgguf, fn)(x), getattr(jgguf, fn)(x))


def _tensors(seed=0):
    """A small DiT-like dict: 2-D weights of quantizable and ragged widths,
    1-D vectors, one 4-D tensor and an f16 one."""
    rng = np.random.default_rng(seed)
    return {
        "blocks.0.attn.qkv.weight": rng.standard_normal((96, 64), dtype=np.float32) * 0.02,
        "blocks.0.attn.qkv.bias": rng.standard_normal(96, dtype=np.float32),
        "blocks.0.mlp.0.weight": rng.standard_normal((128, 64), dtype=np.float32) * 0.02,
        "blocks.0.mlp.2.weight": rng.standard_normal((64, 128), dtype=np.float32) * 0.02,
        "blocks.0.norm.scale": np.ones(64, np.float32),
        "txt_in.weight": rng.standard_normal((64, 48), dtype=np.float32),  # K = 48: no block fits
        "conv.weight": rng.standard_normal((8, 4, 3, 3), dtype=np.float32),
        "half.weight": rng.standard_normal((32, 32)).astype(np.float16),
    }


TYPE_RULES = [(r"\.mlp\.0\.", "q4_0"), (r"\.mlp\.2\.", "q4_1"), (r"^half\.", "f16")]


@pytest.mark.parametrize("out_type,rules", [("q8_0", TYPE_RULES), ("q4_0", []), ("q4_1", []),
                                            ("f16", []), ("f32", TYPE_RULES)])
def test_save_gguf_writes_the_same_bytes(tmp_path, out_type, rules):
    tensors = _tensors()
    tp, jp = tmp_path / "port.gguf", tmp_path / "jax.gguf"
    tgguf.save_gguf(str(tp), tensors, out_type=out_type, type_rules=rules)
    jgguf.save_gguf(str(jp), tensors, out_type=out_type, type_rules=rules)
    assert tp.read_bytes() == jp.read_bytes()


@pytest.mark.parametrize("out_type", ["q8_0", "q4_0", "q4_1"])
def test_load_gguf_keep_quant_matches(tmp_path, out_type):
    path = str(tmp_path / "m.gguf")
    jgguf.save_gguf(path, _tensors(), out_type=out_type, type_rules=TYPE_RULES)
    got = tgguf.load_gguf(path, keep_quant=True)
    want = jgguf.load_gguf(path, keep_quant=True)
    assert list(got) == list(want)
    tf, jf = tgguf.GGUFFile(path), jgguf.GGUFFile(path)
    try:
        for name in want:
            assert tf.tensor_type(name) == jf.tensor_type(name)
            assert tuple(got[name].shape) == tuple(want[name].shape)
            if type(want[name]).__name__ == "HostQuant":
                _same_host_quant(got[name], want[name])
            else:
                assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))
            np.testing.assert_array_equal(tf.tensor(name), jf.tensor(name))
    finally:
        tf.close()
        jf.close()
    assert sum(type(v).__name__ == "HostQuant" for v in got.values()) >= 3


# ------------------------------------------------------- FLUX model loader


@pytest.fixture(scope="module")
def small_dit():
    jp = jax_create_pipeline(jconfig.SDVersion.FLUX, small=True, seed=0)
    return {k: np.asarray(v) for k, v in jp.diffusion_params.items()}


def _to_diffusers(d):
    """Internal FLUX names → diffusers ``FluxTransformer2DModel`` names (the
    fused qkv / linear1 split back into q, k, v and the MLP input)."""
    fixed = {"time_in.in_layer": "time_text_embed.timestep_embedder.linear_1",
             "time_in.out_layer": "time_text_embed.timestep_embedder.linear_2",
             "vector_in.in_layer": "time_text_embed.text_embedder.linear_1",
             "vector_in.out_layer": "time_text_embed.text_embedder.linear_2",
             "guidance_in.in_layer": "time_text_embed.guidance_embedder.linear_1",
             "guidance_in.out_layer": "time_text_embed.guidance_embedder.linear_2",
             "txt_in": "context_embedder", "img_in": "x_embedder",
             "final_layer.linear": "proj_out",
             "final_layer.adaLN_modulation.1": "norm_out.linear"}
    double = {"img_mod.lin": "norm1.linear", "txt_mod.lin": "norm1_context.linear",
              "img_mlp.0": "ff.net.0.proj", "img_mlp.2": "ff.net.2",
              "txt_mlp.0": "ff_context.net.0.proj", "txt_mlp.2": "ff_context.net.2",
              "img_attn.proj": "attn.to_out.0", "txt_attn.proj": "attn.to_add_out",
              "img_attn.norm.query_norm.scale": "attn.norm_q.weight",
              "img_attn.norm.key_norm.scale": "attn.norm_k.weight",
              "txt_attn.norm.query_norm.scale": "attn.norm_added_q.weight",
              "txt_attn.norm.key_norm.scale": "attn.norm_added_k.weight"}
    single = {"modulation.lin": "norm.linear", "linear2": "proj_out",
              "norm.query_norm.scale": "attn.norm_q.weight",
              "norm.key_norm.scale": "attn.norm_k.weight"}
    hidden = d["img_in.weight"].shape[0]
    out = {}
    for name, v in d.items():
        head, _, suffix = name.rpartition(".")
        if name.startswith("double_blocks."):
            _, i, rest = name.split(".", 2)
            pre = f"transformer_blocks.{i}."
            side, _, tail = rest.partition(".")
            if tail.startswith("qkv."):
                parts = ("to_q", "to_k", "to_v") if side == "img_attn" else \
                    ("add_q_proj", "add_k_proj", "add_v_proj")
                for p, chunk in zip(parts, np.split(v, 3, axis=0)):
                    out[f"{pre}attn.{p}.{suffix}"] = chunk
                continue
            key = rest if rest in double else rest.rpartition(".")[0]
            out[pre + double[key] + ("" if rest in double else "." + suffix)] = v
        elif name.startswith("single_blocks."):
            _, i, rest = name.split(".", 2)
            pre = f"single_transformer_blocks.{i}."
            if rest.startswith("linear1."):
                bounds = [hidden, 2 * hidden, 3 * hidden]
                for p, chunk in zip(("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp"),
                                    np.split(v, bounds, axis=0)):
                    out[f"{pre}{p}.{suffix}"] = chunk
                continue
            key = rest if rest in single else rest.rpartition(".")[0]
            out[pre + single[key] + ("" if rest in single else "." + suffix)] = v
        else:
            out[fixed[head] + "." + suffix] = v
    return out


def _same_bundle(got, want):
    assert got.version == tconfig.SDVersion.FLUX and want.version == jconfig.SDVersion.FLUX
    assert got.version.value == want.version.value
    assert sorted(got.diffusion) == sorted(want.diffusion)
    for name, w in want.diffusion.items():
        g = got.diffusion[name]
        if type(w).__name__ == "HostQuant":
            _same_host_quant(g, w)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("fmt", ["gguf", "safetensors"])
@pytest.mark.parametrize("names", ["internal", "diffusers"])
def test_load_model_bundle_matches(small_dit, tmp_path, fmt, names):
    d = _to_diffusers(small_dit) if names == "diffusers" else small_dit
    path = str(tmp_path / f"flux_small.{fmt}")
    if fmt == "gguf":
        jgguf.save_gguf(path, d, out_type="q8_0", type_rules=[(r"mlp", "q4_1")])
    else:
        save_safetensors(path, d)
    got = load_model_bundle(diffusion_model_path=path, keep_quant=True)
    want = jax_load_model_bundle(diffusion_model_path=path, keep_quant=True)
    _same_bundle(got, want)
    assert sorted(got.diffusion) == sorted(small_dit)


def test_diffusers_names_round_trip(small_dit):
    from sdtpu_torch.io.model_loader import convert_diffusers_diffusion_names

    back = convert_diffusers_diffusion_names(_to_diffusers(small_dit))
    assert sorted(back) == sorted(small_dit)
    for k, v in small_dit.items():
        np.testing.assert_array_equal(back[k], v)


def test_load_model_bundle_refuses_other_families(tmp_path):
    path = str(tmp_path / "unet.safetensors")
    save_safetensors(path, {"input_blocks.0.0.weight": np.zeros((4, 4, 3, 3), np.float32)})
    with pytest.raises(NotImplementedError):
        load_model_bundle(diffusion_model_path=path, keep_quant=True)


# --------------------------------------------------------- card by default


def _entry_points():
    from sdtpu_torch import factory, loader, pipeline, weights
    from sdtpu_torch.conditioning import conditioner
    from sdtpu_torch.ops import quant

    return {
        "create_pipeline": factory.create_pipeline, "DiffusionPipeline": pipeline.DiffusionPipeline,
        "FluxConditioner": conditioner.FluxConditioner,
        "load_flux_diffusion": loader.load_flux_diffusion,
        "diffusion_to_device": loader.diffusion_to_device, "synthesize": weights.synthesize,
        "from_jax_params": weights.from_jax_params, "repack_q4": weights.repack_q4,
        "from_host_quant": quant.from_host_quant,
        "rowwise_requant_from_host_quant": quant.rowwise_requant_from_host_quant,
        "host_params_to_device": quant.host_params_to_device,
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    assert inspect.signature(_entry_points()[name]).parameters["device"].default == "cuda"
