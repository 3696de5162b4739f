"""The port's decoder LLM text encoder (``sdtpu_torch.models.llm``) against
the JAX package's, on the CPU.

The same numpy-seeded parameters go through both packages
(``from_jax_params``), with the norm gains and biases drawn away from the
init's ones and zeros so that each is seen.  Tolerances: the forwards in
float32 at rtol = atol = 5e-4 (the same float32 formulas; XLA's and MKL's
sums and trig in another order over a few small layers).  Full-width specs
are compared by name and shape only (``device_init.param_specs`` builds no
array); the full-width call counts run on the meta device.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.models import llm as jllm
from sdtpu.utils.device_init import param_specs as jparam_specs
from sdtpu_torch.factory import z_image_configs
from sdtpu_torch.models import llm as tllm
from sdtpu_torch.weights import from_jax_params

QWEN3_SMALL = tllm.LLMConfig(**{**dataclasses.asdict(tllm.QWEN3_8B_CONFIG), "num_layers": 3,
                                "hidden_size": 32, "intermediate_size": 64, "num_heads": 4,
                                "num_kv_heads": 2, "head_dim": 8, "vocab_size": 300})
QWEN25_SMALL = tllm.LLMConfig(**{**dataclasses.asdict(tllm.QWEN25_VL_7B_CONFIG), "num_layers": 2,
                                 "hidden_size": 48, "intermediate_size": 80, "num_heads": 6,
                                 "num_kv_heads": 2, "head_dim": 8, "vocab_size": 300})


def _j(cfg):
    return jllm.LLMConfig(**dataclasses.asdict(cfg))


def _perturbed(p: dict, seed: int) -> dict:
    """Norm gains around 1 and biases around 0, drawn from ``seed``."""
    g = np.random.default_rng(seed)
    out = dict(p)
    for k, v in p.items():
        if k.endswith(("norm.weight", "layernorm.weight")):
            out[k] = jnp.asarray(1.0 + 0.2 * g.standard_normal(v.shape, dtype=np.float32))
        elif k.endswith(".bias"):
            out[k] = jnp.asarray(0.05 * g.standard_normal(v.shape, dtype=np.float32))
    return out


def _params(cfg, seed):
    jp = _perturbed(jllm.init_llm_params(_j(cfg), seed=seed), seed + 100)
    return jp, from_jax_params(jp, device="cpu")


@pytest.mark.parametrize("port,ref", [
    (tllm.QWEN25_VL_7B_CONFIG, jllm.QWEN25_VL_7B_CONFIG), (tllm.QWEN3_8B_CONFIG, jllm.QWEN3_8B_CONFIG),
    (tllm.QWEN3_4B_CONFIG, jllm.QWEN3_4B_CONFIG),
], ids=["qwen2.5vl_7b", "qwen3_8b", "qwen3_4b"])
def test_configs_match(port, ref):
    assert _j(port) == ref


@pytest.mark.parametrize("name", ["QWEN3_4B_CONFIG", "QWEN25_VL_7B_CONFIG"])
def test_full_width_specs_and_detection_match_jax(name):
    """``param_specs`` holds ``init_llm_params``' names and shapes, and both
    packages' ``detect_llm_config`` read the config back from them."""
    cfg = getattr(tllm, name)
    want = jparam_specs(jllm.init_llm_params, getattr(jllm, name), 0)
    got = tllm.param_specs(cfg)
    assert sorted(got) == sorted(want)
    assert all(tuple(want[k].shape) == got[k][0] for k in got)
    shapes = {k: s for k, (s, _) in got.items()}
    arch = "qwen3" if cfg.arch == "qwen3" else "qwen2.5vl"
    assert tllm.detect_llm_config(shapes.keys(), shapes, arch=arch) == cfg
    assert jllm.detect_llm_config(shapes.keys(), shapes, arch=arch) == _j(cfg)


def test_z_image_full_width_draws_qwen3_4b():
    """The full-width Z-Image set pairs Qwen3-4B (hidden 2560) with the DiT's
    cap_feat_dim 2560: the JAX factory's Qwen3-8B default (hidden 4096) is
    not copied."""
    dit, llm, _ = z_image_configs(small=False)
    assert llm == tllm.QWEN3_4B_CONFIG and llm.hidden_size == dit.cap_feat_dim == 2560
    assert jllm.QWEN3_8B_CONFIG.hidden_size != dit.cap_feat_dim


def _ids(b, l, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(np.int32)


@pytest.mark.parametrize("cfg,kw", [
    (QWEN3_SMALL, dict()),
    (QWEN3_SMALL, dict(output_layer=2)),
    (QWEN3_SMALL, dict(output_layers=(1, 3, 4))),
    (QWEN3_SMALL, dict(output_layer=3, mask=True)),
    (QWEN25_SMALL, dict()),
    (QWEN25_SMALL, dict(output_layer=1, mask=True)),
], ids=["qwen3", "qwen3_layer2", "qwen3_layers", "qwen3_pad_mask", "qwen25vl", "qwen25vl_pad_mask"])
def test_llm_forward_matches_jax(cfg, kw):
    """GQA, the per-head q/k norms (Qwen3), the q/k/v biases (Qwen2.5-VL),
    the hidden state after a layer or several concatenated, and a padding
    mask (the last three tokens of the second row padded)."""
    kw = dict(kw)
    jp, tp = _params(cfg, seed=3)
    ids = _ids(2, 11, cfg.vocab_size)
    mask = None
    if kw.pop("mask", False):
        mask = np.ones((2, 11), np.float32)
        mask[1, -3:] = 0
    jforward = jax.jit(functools.partial(jllm.llm_forward, cfg=_j(cfg), **kw))
    want = np.asarray(jforward(jp, jnp.asarray(ids),
                               attention_mask=None if mask is None else jnp.asarray(mask)))
    got = tllm.llm_forward(tp, torch.from_numpy(ids.astype(np.int64)), cfg,
                           attention_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_neox_rope_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 17, 16)).astype(np.float32)
    pos = np.arange(17)
    want = np.asarray(jllm._neox_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = tllm._neox_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,word", [
    ("GEMMA2_2B_CONFIG", "Gemma norms"), ("GEMMA3_12B_CONFIG", "sliding-window"),
    ("MISTRAL_SMALL_32_CONFIG", "adjacent-pair RoPE"), ("QWEN3_VL_8B_CONFIG", "imrope"),
    ("GPT_OSS_20B_CONFIG", "YaRN"), ("GPT_OSS_20B_CONFIG", "attention sinks"),
    ("GPT_OSS_20B_CONFIG", "mixture-of-experts"),
])
def test_unported_llm_features_raise_by_name(name, word):
    cfg = tllm.LLMConfig(**dataclasses.asdict(getattr(jllm, name)))
    with pytest.raises(NotImplementedError, match=word):
        tllm.check_supported(cfg)
    with pytest.raises(NotImplementedError, match=word):
        tllm.llm_forward({}, torch.zeros((1, 2), dtype=torch.int64), cfg)
    with pytest.raises(NotImplementedError, match=word):
        tllm.param_specs(cfg)


def test_unported_arch_is_refused_by_detection():
    with pytest.raises(NotImplementedError, match="gemma2_2b"):
        tllm.detect_llm_config([], {}, arch="gemma2_2b")


def test_prompt_encode_calls_at_full_width(monkeypatch):
    """At full width on the meta device (shapes only): a Z-Image prompt
    encode runs ``num_layers - 1`` = 35 Qwen3-4B layers, 7 linears each
    (``chip_smoke.Z_IMAGE_LLM_LINEARS``) and one plain attention each
    (``chip_smoke.Z_IMAGE_LLM_LAYERS``), all at the prompt's rows."""
    import chip_smoke
    from sdtpu_torch.conditioning.conditioner import ZImageConditioner
    from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer

    linears, attns = [], []
    real_linear, real_attention = tllm.linear, tllm.attention

    def counted_linear(x, w, b=None):
        linears.append(x.shape[-2])
        return real_linear(x, w, b)

    def counted_attention(q, k, v, mask=None, flash=None, **kw):
        attns.append((q.shape, flash))
        return real_attention(q, k, v, mask=mask, flash=flash, **kw)

    monkeypatch.setattr(tllm, "linear", counted_linear)
    monkeypatch.setattr(tllm, "attention", counted_attention)
    cfg = tllm.QWEN3_4B_CONFIG
    p = {k: torch.empty(s, device="meta") for k, (s, _) in tllm.param_specs(cfg).items()}
    cond = ZImageConditioner(Qwen2Tokenizer.byte_fallback(), p, cfg, device="meta")
    prompt = "a red fox in fresh snow, golden hour"
    c = cond.get_learned_condition(prompt).c_crossattn
    n = len(Qwen2Tokenizer.byte_fallback().encode(ZImageConditioner.TEMPLATE.format(prompt)))
    assert n == 19 + len(prompt.encode()) and 8 < n < 128  # the 4-bit split-K form's rows
    assert c.shape == (1, n, 2560)
    assert len(linears) == chip_smoke.Z_IMAGE_LLM_LINEARS == 35 * 7 and set(linears) == {n}
    assert len(attns) == chip_smoke.Z_IMAGE_LLM_LAYERS == 35
    assert all(f is False and s == (1, 32, n, 128) for s, f in attns)
