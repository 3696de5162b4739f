"""The port's host layer against the JAX package's originals, on the same inputs.

``sdtpu_torch`` keeps its own copies of the host code it needs (config, RNG,
CLIP tokenizer, prompt parser, GGUF and safetensors readers, the FLUX model
loader).  Each copy is held to its original here: the noise streams and the
written GGUF bytes are identical, tokens, parsed prompts, loaded blocks and
bundles are equal, torch checkpoints read alike and run no pickled code.
The port's entry points default to the card, and its
``SDVersion`` is a class of its own.
"""
import dataclasses
import inspect
import io
import os
import sys

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

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py


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


# ------------------------------------------------------ torch checkpoints


def _torch_tensors():
    import torch

    g = torch.Generator().manual_seed(0)
    return {"a.weight": torch.randn(6, 5, generator=g), "b.half": torch.randn(7, generator=g).half(),
            "c.bf16": torch.randn(3, 4, generator=g).bfloat16(),
            "d.transposed": torch.randn(4, 3, generator=g).t(), "e.int": torch.arange(6),
            "f.view": torch.randn(10, generator=g)[2:7], "g.double": torch.randn(2, 2).double()}


@pytest.mark.parametrize("wrap", ["state_dict", "bare"])
@pytest.mark.parametrize("fmt", ["zip", "legacy"])
def test_torch_checkpoint_reader_matches(tmp_path, fmt, wrap):
    """``io.torch_ckpt`` against ``sdtpu.io.torch_ckpt`` on torch's ZIP and
    legacy files (float16 / bf16 / float64 widened to float32, strided
    views, integers; a ``state_dict`` wrapper unwrapped), and both against
    the tensors saved; ``read_checkpoint_file`` takes .ckpt / .pt / .pth /
    .bin."""
    import torch

    import sdtpu.io.torch_ckpt as jckpt
    from sdtpu_torch.io import torch_ckpt as tckpt
    from sdtpu_torch.io.model_loader import read_checkpoint_file

    tensors = _torch_tensors()
    path = str(tmp_path / "m.ckpt")
    torch.save({"state_dict": tensors, "epoch": 3} if wrap == "state_dict" else tensors, path,
               _use_new_zipfile_serialization=fmt == "zip")
    got, want = tckpt.load_torch_checkpoint(path), jckpt.load_torch_checkpoint(path)
    assert list(got) == list(want) == list(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(got[name], t.float().numpy() if t.is_floating_point()
                                      else t.numpy())
    for ext in (".pt", ".pth", ".bin"):
        os.replace(path, path := str(tmp_path / ("m" + ext)))
        assert list(read_checkpoint_file(path)) == list(tensors)


@pytest.mark.parametrize("fmt", ["zip", "legacy"])
def test_torch_checkpoint_reader_runs_no_pickle_code(tmp_path, fmt):
    """A file that pickles a call beside its tensors (here ``open(path, "w")``,
    which would leave a file behind): the restricted unpickler resolves no
    global outside its allow-list, so nothing runs and only the tensors come
    back."""
    import torch

    from sdtpu_torch.io import torch_ckpt as tckpt

    marker = tmp_path / "ran"

    class Call:
        def __reduce__(self):
            return open, (str(marker), "w")

    path = str(tmp_path / "evil.pt")
    torch.save({"w": torch.ones(2, 3), "callback": Call()}, path,
               _use_new_zipfile_serialization=fmt == "zip")
    got = tckpt.load_torch_checkpoint(path)
    assert not marker.exists()
    assert list(got) == ["w"] and got["w"].tolist() == [[1.0] * 3] * 2
    unpickler = tckpt._SafeUnpickler(io.BytesIO(b""))
    for module, name in (("builtins", "open"), ("os", "system"), ("builtins", "eval")):
        assert isinstance(unpickler.find_class(module, name), tckpt._Inert)


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


@pytest.mark.parametrize("tensors,family", [
    # SD1 tiny: no middle block, output block 7 kept
    ({"input_blocks.0.0.weight": np.zeros((4, 4, 3, 3), np.float32),
      "output_blocks.7.1.proj_in.weight": np.zeros((8, 8), np.float32)}, "sd1_tiny_unet"),
    # SSD-1B: SDXL's label embedding without the 10-deep middle block
    ({"input_blocks.0.0.weight": np.zeros((4, 4, 3, 3), np.float32),
      "label_emb.0.0.weight": np.zeros((8, 16), np.float32)}, "sdxl_ssd1b"),
    # SD2 tiny: a 1024-wide cross-attention context, no middle block
    ({"input_blocks.0.0.weight": np.zeros((4, 4, 3, 3), np.float32),
      "input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight": np.zeros((8, 1024), np.float32),
      "output_blocks.2.0.in_layers.0.weight": np.zeros((8,), np.float32)},
     "sd2_tiny_unet"),
])
def test_load_model_bundle_refuses_other_families(tmp_path, tensors, family):
    """The port loads FLUX, the SD1.x / SD2.x / SDXL UNets (their inpainting
    and pix2pix stems and their tiny distills too), SD3 and Wan2.1 T2V:
    the tiny UNets, refused before the port had them, load with the JAX
    loader's version; SDXL's SSD-1B, which the JAX factory cannot run
    (it hands SSD-1B the 10-deep SDXL config), is refused by name."""
    path = str(tmp_path / "unet.safetensors")
    save_safetensors(path, tensors)
    if family == "sdxl_ssd1b":
        with pytest.raises(NotImplementedError, match=f"a {family}"):
            load_model_bundle(diffusion_model_path=path, keep_quant=True)
        return
    got = load_model_bundle(diffusion_model_path=path, keep_quant=True)
    assert got.version.value == family
    assert jax_load_model_bundle(diffusion_model_path=path).version.value == family


# --------------------------------------------------------- card by default


def _entry_points():
    from sdtpu_torch import factory, loader, pipeline, weights
    from sdtpu_torch.conditioning import conditioner
    from sdtpu_torch.ops import quant

    return {
        "create_pipeline": factory.create_pipeline, "DiffusionPipeline": pipeline.DiffusionPipeline,
        "FluxConditioner": conditioner.FluxConditioner,
        "SD3Conditioner": conditioner.SD3Conditioner,
        "ZImageConditioner": conditioner.ZImageConditioner,
        "load_flux_diffusion": loader.load_flux_diffusion,
        "diffusion_to_device": loader.diffusion_to_device, "synthesize": weights.synthesize,
        "from_jax_params": weights.from_jax_params, "repack_q4": weights.repack_q4,
        "from_host_quant": quant.from_host_quant,
        "rowwise_requant_from_host_quant": quant.rowwise_requant_from_host_quant,
        "host_params_to_device": quant.host_params_to_device,
        "module_to_device": loader.module_to_device,
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    assert inspect.signature(_entry_points()[name]).parameters["device"].default == "cuda"


@pytest.mark.parametrize("entry", ["cli", "server"])
def test_cli_and_server_run_on_the_card_unless_asked(entry, tmp_path, monkeypatch):
    """With no --backend the CLI and the server take the GPU, and raise
    where there is none (before they read a file); --backend cpu or cudaN
    names one device for every module."""
    import torch

    from sdtpu_torch import cli, server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = cli.main if entry == "cli" else server.main
    with pytest.raises(RuntimeError, match="--backend cpu"):
        main(["--diffusion-model", str(tmp_path / "missing.gguf"), "-p", "x"])
    assert cli.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        cli.resolve_device("cuda1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cli.resolve_device("") == torch.device("cuda", 0)
    assert cli.resolve_device("cuda1") == torch.device("cuda", 1)


# --------------------------------------------------------- T5 tokenizer


T5_PROMPTS = PROMPTS + [
    "a red fox in snow",
    "  the   golden\tlantern \n on a wooden table  ",
    "a (red:1.3) fox BREAK in snow, ((golden hour))",
    "zzqx 12:34 — ünïcödé 日本",
]


def _t5_sources(tmp_path):
    """The same unigram vocab as a tokenizer.json, a GGUF's embedded
    metadata and a spiece.model → {source: (port tokenizer, JAX tokenizer)}."""
    import json as _json

    from _torch_files import spiece_model_bytes
    from sdtpu.tokenizers import gguf_vocab as jvocab
    from sdtpu.tokenizers.t5 import T5UnigramTokenizer as JT5
    from sdtpu_torch.tokenizers import gguf_vocab as tvocab
    from sdtpu_torch.tokenizers.t5 import T5UnigramTokenizer as TT5
    from sdtpu_torch.tools.flux_files import synthetic_t5_vocab

    md = synthetic_t5_vocab(512, seed=3)
    tj = tmp_path / "tokenizer.json"
    tj.write_text(_json.dumps({"model": {"type": "Unigram", "unk_id": 2, "vocab": [
        [p, s] for p, s in zip(md["tokenizer.ggml.tokens"], md["tokenizer.ggml.scores"])]}}))
    gg = str(tmp_path / "t5.gguf")
    jgguf.save_gguf(gg, {"x.weight": np.zeros(4, np.float32)}, metadata=md)
    sp = tmp_path / "spiece.model"
    sp.write_bytes(spiece_model_bytes(md))
    return {"tokenizer.json": (TT5.from_tokenizer_json(str(tj)), JT5.from_tokenizer_json(str(tj))),
            "gguf": (tvocab.tokenizer_from_gguf_file(gg), jvocab.tokenizer_from_gguf_file(gg)),
            "spiece.model": (tvocab.load_spiece_model(str(sp)), jvocab.load_spiece_model(str(sp)))}


@pytest.fixture(scope="module")
def t5_tokenizers(tmp_path_factory):
    return _t5_sources(tmp_path_factory.mktemp("t5tok"))


@pytest.mark.parametrize("source", ["tokenizer.json", "gguf", "spiece.model"])
@pytest.mark.parametrize("prompt", T5_PROMPTS, ids=[f"prompt{i}" for i in range(len(T5_PROMPTS))])
def test_t5_tokenizer_ids_match(t5_tokenizers, source, prompt):
    tok, jtok = t5_tokenizers[source]
    assert type(tok).__module__ == "sdtpu_torch.tokenizers.t5"
    ids = tok.encode(prompt, add_eos=True)
    assert ids == jtok.encode(prompt, add_eos=True)
    assert tok.pad(ids, 32) == jtok.pad(ids, 32)
    assert tok.decode(ids) == jtok.decode(ids)
    assert (tok.unk_id, tok.eos_token_id, tok.pad_token_id) == \
        (jtok.unk_id, jtok.eos_token_id, jtok.pad_token_id)


def test_gguf_vocab_other_models_give_none():
    """No vocab, or a vocab of a model the port has no tokenizer for (a
    BERT WordPiece), gives None, as in the JAX package; a "gpt2" byte-level
    BPE vocab gives the Qwen2 tokenizer (``test_qwen2_tokenizer_ids_match``)."""
    from sdtpu.tokenizers import gguf_vocab as jvocab
    from sdtpu_torch.tokenizers.gguf_vocab import tokenizer_from_gguf_metadata
    from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer

    assert tokenizer_from_gguf_metadata({}) is None
    md = {"tokenizer.ggml.model": "bert", "tokenizer.ggml.tokens": ["a", "b"]}
    assert tokenizer_from_gguf_metadata(md) is None and jvocab.tokenizer_from_gguf_metadata(md) is None
    md = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": ["a", "b"],
          "tokenizer.ggml.merges": ["a b"]}
    assert isinstance(tokenizer_from_gguf_metadata(md), Qwen2Tokenizer)


# ------------------------------------------------------- Qwen2 tokenizer

QWEN_PROMPTS = T5_PROMPTS + [
    "<|im_start|>user\na red fox in fresh snow<|im_end|>\n<|im_start|>assistant\n",
    "it's 1234567 o'clock, we'll SEE -- café ☕\r\n\n  tabs\tand  spaces ",
    "<|endoftext|><|im_end|>x<|vision_pad|>",
]


def _qwen_merges():
    """A few byte-level merges in rank order (GPT-2's byte→unicode units, so
    "Ġ" is a space)."""
    return [("Ġ", "a"), ("r", "e"), ("Ġ", "re"), ("o", "x"), ("f", "ox"), ("Ġ", "fox"),
            ("i", "n"), ("Ġ", "in"), ("s", "n"), ("o", "w"), ("sn", "ow"), ("1", "2"), ("'", "s")]


def _qwen_sources(tmp_path):
    """The same byte-level vocab (the 256 byte units, the merges' tokens, the
    specials at Qwen's ids) as a tokenizer.json and a GGUF's "gpt2" metadata,
    and the merge-free ``byte_fallback`` → {source: (port, JAX)}."""
    import json as _json

    from sdtpu.tokenizers import gguf_vocab as jvocab
    from sdtpu.tokenizers.qwen2 import Qwen2Tokenizer as JQ
    from sdtpu_torch.tokenizers import gguf_vocab as tvocab
    from sdtpu_torch.tokenizers.bpe import bytes_to_unicode
    from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer as TQ

    merges = _qwen_merges()
    tokens = list(bytes_to_unicode().values()) + sorted({a + b for a, b in merges})
    special = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
               "<|vision_pad|>": 151654}
    tj = tmp_path / "tokenizer.json"
    tj.write_text(_json.dumps({
        "model": {"vocab": {t: i for i, t in enumerate(tokens)},
                  "merges": [f"{a} {b}" for a, b in merges]},
        "added_tokens": [{"id": i, "content": t} for t, i in special.items()]}))
    n = 151655
    names = tokens + [f"[PAD{i}]" for i in range(len(tokens), n)]
    types = [1] * len(tokens) + [5] * (n - len(tokens))
    for t, i in special.items():
        names[i], types[i] = t, 3
    md = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": names,
          "tokenizer.ggml.token_type": types, "tokenizer.ggml.merges": [f"{a} {b}" for a, b in merges],
          "tokenizer.ggml.eos_token_id": 151645, "tokenizer.ggml.padding_token_id": 151643}
    gg = str(tmp_path / "qwen.gguf")
    jgguf.save_gguf(gg, {"x.weight": np.zeros(4, np.float32)}, metadata=md)
    return {"tokenizer.json": (TQ.from_tokenizer_json(str(tj)), JQ.from_tokenizer_json(str(tj))),
            "gguf": (tvocab.tokenizer_from_gguf_file(gg), jvocab.tokenizer_from_gguf_file(gg)),
            "byte_fallback": (TQ.byte_fallback(), JQ.byte_fallback())}


@pytest.fixture(scope="module")
def qwen_tokenizers(tmp_path_factory):
    return _qwen_sources(tmp_path_factory.mktemp("qwentok"))


@pytest.mark.parametrize("source", ["tokenizer.json", "gguf", "byte_fallback"])
@pytest.mark.parametrize("prompt", QWEN_PROMPTS, ids=[f"prompt{i}" for i in range(len(QWEN_PROMPTS))])
def test_qwen2_tokenizer_ids_match(qwen_tokenizers, source, prompt):
    tok, jtok = qwen_tokenizers[source]
    assert type(tok).__module__ == "sdtpu_torch.tokenizers.qwen2"
    ids = tok.encode(prompt)
    assert ids == jtok.encode(prompt) and bool(ids) == bool(prompt)
    assert (tok.eos_token_id, tok.pad_token_id) == (jtok.eos_token_id, jtok.pad_token_id) == (151645, 151643)


def test_qwen2_merges_apply(qwen_tokenizers):
    """The merges of the tokenizer.json and the GGUF take effect ("Ġfox"
    one id) where the byte fallback spells the bytes out."""
    text = " fox"
    merged = qwen_tokenizers["tokenizer.json"][0].encode(text)
    assert merged == qwen_tokenizers["gguf"][0].encode(text) and len(merged) == 1
    assert len(qwen_tokenizers["byte_fallback"][0].encode(text)) == 4


def test_z_image_file_vocab_is_the_byte_fallback():
    """``tools/z_image_file.py``'s "gpt2" vocab tokenizes as
    ``Qwen2Tokenizer.byte_fallback`` in both packages."""
    from sdtpu.tokenizers import gguf_vocab as jvocab
    from sdtpu_torch.tokenizers import gguf_vocab as tvocab
    from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer
    from sdtpu_torch.tools.z_image_file import qwen_byte_vocab

    md = qwen_byte_vocab(151936)
    text = "<|im_start|>user\na lighthouse, 12 o'clock<|im_end|>\n"
    want = Qwen2Tokenizer.byte_fallback().encode(text)
    assert tvocab.tokenizer_from_gguf_metadata(md).encode(text) == want
    assert jvocab.tokenizer_from_gguf_metadata(md).encode(text) == want


# ------------------------------------------------------ names, bundles

VAE_NAMES = ["encoder.conv_in.weight", "decoder.conv_norm_out.bias",
             "decoder.mid_block.resnets.1.conv_shortcut.weight",
             "encoder.mid_block.attentions.0.to_out.0.weight",
             "decoder.mid_block.attentions.0.query.bias",
             "encoder.down_blocks.2.downsamplers.0.conv.weight",
             "decoder.up_blocks.0.resnets.2.norm1.weight",
             "decoder.up_blocks.3.upsamplers.0.conv.bias", "post_quant_conv.weight",
             "encoder.block.0.layer.0.SelfAttention.q.weight", "decoder.up.0.block.0.conv1.weight",
             "model.diffusion_model.double_blocks.0.img_mod.lin.weight",
             "text_encoders.clip_l.transformer.text_model.final_layer_norm.weight",
             "first_stage_model.decoder.conv_in.weight", "shared.weight"]


@pytest.mark.parametrize("name", VAE_NAMES)
def test_canonicalize_name_matches(name):
    from sdtpu.io import name_conversion as jnc
    from sdtpu_torch.io import model_loader as tml

    assert tml.canonicalize_name(name) == jnc.canonicalize_name(name)
    assert tml.convert_diffusers_vae_name(name) == jnc.convert_diffusers_vae_name(name)


LLM_GGUF_NAMES = ["token_embd.weight", "output_norm.weight", "blk.0.attn_q.weight",
                  "blk.3.attn_k.bias", "blk.35.attn_v.weight", "blk.1.attn_output.weight",
                  "blk.2.attn_q_norm.weight", "blk.2.attn_k_norm.weight", "blk.7.attn_norm.weight",
                  "blk.7.ffn_norm.weight", "blk.4.ffn_gate.weight", "blk.4.ffn_up.weight",
                  "blk.4.ffn_down.weight", "blk.10.attn_q.bias", "blk.12.attn_v.bias"]


@pytest.mark.parametrize("name", LLM_GGUF_NAMES)
def test_gguf_llm_names_match(name):
    """llama.cpp GGUF LLM names → HF names, as the JAX loader maps them; the
    Z-Image file tool's names map back to HF ones."""
    from sdtpu.io.name_conversion import convert_gguf_llm_name as jconv
    from sdtpu_torch.io.model_loader import convert_gguf_llm_name
    from sdtpu_torch.tools.z_image_file import gguf_llm_name

    hf = convert_gguf_llm_name(name)
    assert hf == jconv(name)
    assert gguf_llm_name(hf) == name


def test_llm_bundle_matches_jax(tmp_path):
    """A Z-Image set (a DiT with ``cap_embedder``, a Qwen3 GGUF under
    llama.cpp names, a VAE) loads into the same modules in both packages."""
    from sdtpu_torch.io.model_loader import load_model_bundle as tload

    g = np.random.default_rng(0)
    dit = {"cap_embedder.0.weight": g.standard_normal(32).astype(np.float32),
           "layers.0.attention.qkv.weight": g.standard_normal((96, 32)).astype(np.float32)}
    llm = {"token_embd.weight": g.standard_normal((300, 64)).astype(np.float32),
           "blk.0.attn_q.weight": g.standard_normal((64, 64)).astype(np.float32),
           "blk.0.attn_q_norm.weight": g.standard_normal(8).astype(np.float32),
           "output_norm.weight": g.standard_normal(64).astype(np.float32)}
    vae = {"decoder.conv_in.weight": g.standard_normal((8, 4, 3, 3)).astype(np.float32)}
    paths = {k: str(tmp_path / f"{k}.{ext}") for k, ext in (("dit", "safetensors"), ("llm", "gguf"),
                                                             ("vae", "safetensors"))}
    save_safetensors(paths["dit"], dit)
    jgguf.save_gguf(paths["llm"], llm, out_type="q8_0")
    save_safetensors(paths["vae"], vae)
    kw = dict(diffusion_model_path=paths["dit"], llm_path=paths["llm"], vae_path=paths["vae"])
    got, want = tload(**kw), jax_load_model_bundle(**kw)
    assert got.version.value == want.version.value == "z_image"
    for m in ("diffusion", "llm", "vae"):
        g_, w_ = getattr(got, m), getattr(want, m)
        assert sorted(g_) == sorted(w_), m
        for k in w_:
            np.testing.assert_array_equal(np.asarray(g_[k], np.float32), np.asarray(w_[k], np.float32),
                                          err_msg=f"{m}.{k}")


@pytest.mark.parametrize("name", ["enc.blk.3.attn_rel_b.weight", "enc.blk.0.ffn_gate.weight",
                                  "enc.output_norm.weight", "token_embd.weight"])
def test_gguf_t5_names_match(name):
    from sdtpu.io.name_conversion import convert_gguf_t5_name as jconv
    from sdtpu_torch.io.model_loader import convert_gguf_t5_name
    from sdtpu_torch.tools.flux_files import gguf_t5_name

    assert convert_gguf_t5_name(name) == jconv(name)
    assert gguf_t5_name(convert_gguf_t5_name(name)) == name


def _same_module(got, want, name):
    assert sorted(got) == sorted(want), name
    for k, w in want.items():
        g = got[k]
        if type(w).__name__ == "HostQuant":
            _same_host_quant(g, w)
        else:  # a text encoder's or the VAE's blocks: equal once dequantized
            assert tuple(g.shape) == tuple(w.shape), k
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


@pytest.fixture(scope="module")
def flux_files(tmp_path_factory):
    from _torch_files import small_jax_pipeline, write_small_flux_files

    jp = small_jax_pipeline()
    d = tmp_path_factory.mktemp("flux_files")
    return jp, d, write_small_flux_files(d, jp)


@pytest.mark.parametrize("layout", ["split_gguf", "split_safetensors", "single_safetensors"])
def test_load_model_bundle_all_modules_match(flux_files, tmp_path, layout):
    """Split files (the DiT and T5 as q8_0 GGUFs, T5 under llama.cpp names
    with an embedded vocab), the same as safetensors, and one full
    checkpoint holding every module under its prefix."""
    jp, _, paths = flux_files
    host = lambda p: {k: np.asarray(v, dtype=np.float32) for k, v in p.items()}  # noqa: E731
    if layout == "split_gguf":
        kw = dict(diffusion_model_path=paths["diffusion_model"], clip_l_path=paths["clip_l"],
                  t5xxl_path=paths["t5xxl"], vae_path=paths["vae"])
    elif layout == "split_safetensors":
        kw = {}
        for flag, mod in (("diffusion_model", jp.diffusion_params), ("t5xxl", jp.conditioner.pt)):
            kw[f"{flag}_path"] = str(tmp_path / f"{flag}.safetensors")
            save_safetensors(kw[f"{flag}_path"], host(mod))
        kw.update(clip_l_path=paths["clip_l"], vae_path=paths["vae"])
    else:
        full = {}
        for prefix, mod in (("model.diffusion_model.", jp.diffusion_params),
                            ("text_encoders.clip_l.transformer.", jp.conditioner.pl),
                            ("text_encoders.t5xxl.transformer.", jp.conditioner.pt),
                            ("first_stage_model.", jp.vae_params)):
            full.update({prefix + k: v for k, v in host(mod).items()})
        kw = {"model_path": str(tmp_path / "flux_full.safetensors")}
        save_safetensors(kw["model_path"], full)
    got = load_model_bundle(keep_quant=True, **kw)
    want = jax_load_model_bundle(keep_quant=True, **kw)
    assert got.version.value == want.version.value == "flux"
    for mod in ("diffusion", "clip_l", "t5", "vae"):
        _same_module(getattr(got, mod), getattr(want, mod), mod)
    assert sorted(got.extra) == sorted(want.extra)
    assert any(k.startswith("encoder.") for k in got.vae)  # the encoder is read, and unused


# ------------------------------------------------------ image metadata


def _gps():
    base = dict(prompt="a lantern, (warm:1.2)\nsecond line", width=768, height=512,
                sample_steps=4, cfg_scale=3.5, seed=7, sample_method="euler_a")
    return [base, dict(base, negative_prompt="blurry, low quality", clip_skip=2),
            dict(base, prompt="", cfg_scale=1.0, schedule="flux")]


@pytest.mark.parametrize("i", range(3))
def test_parameters_text_matches(i):
    from sdtpu.utils.image import build_parameters_text as jbuild
    from sdtpu.utils.image import parse_parameters_text as jparse_params
    from sdtpu_torch.utils.image import build_parameters_text, parse_parameters_text

    kw = _gps()[i]
    text = build_parameters_text(tconfig.GenerationParams(**kw))
    assert text == jbuild(jconfig.GenerationParams(**kw))
    assert text == build_parameters_text(tconfig.GenerationParams(**kw), extra=None)
    assert parse_parameters_text(text) == jparse_params(text)


@pytest.mark.parametrize("options", [{}, {"include_structural": True},
                                     {"include_raw": True, "brief": True}])
def test_png_and_metadata_walk_match(tmp_path, options):
    """The port's PNG writer is the JAX package's zlib writer byte for byte,
    and both metadata walks read the same entries."""
    from sdtpu.utils import image as jimage
    from sdtpu_torch.utils import image as timage

    img = np.random.default_rng(0).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    text = "a long prompt " * 20 + "\nSteps: 4, Sampler: euler_a, Seed: 7"
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    timage.write_image(str(ours), img, parameters=text)
    jimage._write_png_fallback(str(theirs), img, text)
    assert ours.read_bytes() == theirs.read_bytes()
    assert timage.walk_image_metadata(str(ours), **options) == \
        jimage.walk_image_metadata(str(theirs), **options)
    back, params = timage.decode_png(ours.read_bytes())
    np.testing.assert_array_equal(back, img)
    assert params == text
    pil_img, pil_params = jimage.read_png(str(ours))
    np.testing.assert_array_equal(pil_img, img)
    assert pil_params == text
    assert timage.image_to_base64(img, parameters=text) == \
        __import__("base64").b64encode(ours.read_bytes()).decode()


def test_image_formats_that_need_pillow_are_refused(tmp_path):
    from sdtpu_torch.utils import image as timage

    img = np.zeros((8, 8, 3), np.uint8)
    for ext in ("jpg", "jpeg", "webp"):
        with pytest.raises(ValueError, match="Pillow"):
            timage.write_image(str(tmp_path / f"x.{ext}"), img)
    with pytest.raises(ValueError, match="Pillow"):
        timage.image_to_base64(img, fmt="jpeg")


@pytest.mark.parametrize("output,i,n,begin", [("out.png", 0, 1, None), ("out.png", 1, 3, None),
                                               ("img_%03d.png", 2, 3, 5), ("a/b.png", 0, 2, -1)])
def test_resolve_output_path_matches(output, i, n, begin):
    from sdtpu.cli import resolve_output_path as jresolve
    from sdtpu_torch.utils.image import resolve_output_path

    assert resolve_output_path(output, i, n, begin) == jresolve(output, i, n, begin)


# ------------------------------------------------------------- sampler


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0, 2.0])
@pytest.mark.parametrize("is_flow", [True, False])
def test_ancestral_steps_match(eta, is_flow):
    from sdtpu.diffusion.samplers import ancestral_steps as jsteps
    from sdtpu_torch.diffusion.samplers import ancestral_steps

    sigmas = np.array([1.0, 0.93, 0.71, 0.4, 0.12, 0.0], np.float32)
    for got, want in zip(ancestral_steps(sigmas, eta, is_flow), jsteps(sigmas, eta, is_flow)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ CLI parser


def test_cli_parser_is_the_jax_one():
    """The same flags, defaults and help, but the three whose help names the
    port's device and kernels."""
    from sdtpu.cli import build_parser as jbuild
    from sdtpu_torch.cli import RUN_FLAGS, build_parser

    card_help = {"dtype", "backend", "no_promote_q8"}
    ours, theirs = build_parser()._actions, jbuild()._actions
    assert [a.option_strings for a in ours] == [a.option_strings for a in theirs]
    for a, b in zip(ours, theirs):
        assert (a.dest, a.default, a.choices, a.nargs, a.type) == \
            (b.dest, b.default, b.choices, b.nargs, b.type), a.dest
        if a.dest not in card_help | {"help", "version"}:
            assert a.help == b.help, a.dest
    assert RUN_FLAGS <= {a.dest for a in ours}
