"""The port's tiny UNets (SD1 tiny, SDXS-512-DS, SD2 tiny, SDXS-0.9) against
``sdtpu``.

Configs, block layouts (CompVis numbering with holes, no middle block),
head counts (SDXS-0.9's 5 x 64 run as one head of 320) and param specs are
compared at full width, where they are host Python on both sides: equal.
The forwards run at a small width where the 5-head rule still fires (160
channels in 32-channel heads; SD1's 8 heads over 160), on weights from
``init_unet_params`` bridged with ``from_jax_params``, float32 on both
sides: rtol = atol = 5e-4, the goldens' tolerance (sums in another order,
MKL / oneDNN against XLA).  The factory builds each tiny version, and the
loader fingerprints each from its names as the JAX loader does.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.factory import unet_config_for as jax_unet_config_for
from sdtpu.io.safetensors import save_safetensors
from sdtpu.models import unet as ju
from sdtpu_torch.config import SDVersion
from sdtpu_torch.factory import create_pipeline, unet_config_for
from sdtpu_torch.models import unet as tu
from sdtpu_torch.weights import from_jax_params

TINY = ("SD1_TINY_UNET", "SDXS_512_DS", "SD2_TINY_UNET", "SDXS_09")
FULL_WIDTH = TINY + ("SD1", "SD2", "SDXL")


def _configs(name: str):
    return unet_config_for(getattr(SDVersion, name)), jax_unet_config_for(getattr(jconfig.SDVersion, name))


def _small(cfg):
    """A tiny config cut in width: 160 channels at every level, SD1's in 8
    heads, SD2's in 32-channel heads (5: SDXS-0.9's rule turns them into
    one of 160), a 64-wide context."""
    cfg = dataclasses.replace(cfg, model_channels=160, channel_mult=(1, 1, 1), context_dim=64)
    return cfg if cfg.num_head_channels is None else dataclasses.replace(cfg, num_head_channels=32)


@pytest.mark.parametrize("name", TINY)
def test_tiny_configs_match(name):
    port, ref = _configs(name)
    assert type(ref)(**dataclasses.asdict(port)) == ref
    assert port.tiny_unet and port.sdxs09_wide_head == (name == "SDXS_09")


@pytest.mark.parametrize("name", FULL_WIDTH)
def test_block_layout_and_heads_match(name):
    """``_block_layout`` (the tiny UNets' holes: input blocks 1, 4, 7, the
    shifted upsamples) and ``_heads_for`` at each level's width."""
    port, ref = _configs(name)
    assert tu._block_layout(port) == ju._block_layout(ref)
    for mult in port.channel_mult:
        ch = mult * port.model_channels
        assert tu._heads_for(port, ch) == ju._heads_for(ref, ch)
    if name == "SDXS_09":
        assert tu._heads_for(port, 320) == 1 and tu._heads_for(port, 640) == 10


@pytest.mark.parametrize("name", TINY)
def test_tiny_param_specs_match_unet_param_shapes(name):
    port, ref = _configs(name)
    want = {k: (shape, {"w": "normal", "g": "ones", "b": "zeros"}[kind])
            for k, (kind, shape) in ju.unet_param_shapes(ref).items()}
    specs = tu.param_specs(port)
    assert specs == want
    assert not any(k.startswith("middle_block.") for k in specs)


@pytest.mark.parametrize("name", TINY)
def test_tiny_forward_matches_jax(name):
    port, ref = _configs(name)
    port, ref = _small(port), _small(ref)
    jp = ju.init_unet_params(ref, seed=3)
    tp = from_jax_params(jp, device="cpu")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    ts = np.asarray([999.0, 411.25], np.float32)
    ctx = rng.standard_normal((2, 77, 64), dtype=np.float32)
    want = ju.unet_forward(jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), cfg=ref)
    got = tu.unet_forward(tp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                          cfg=port)
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)


def test_sdxs09_runs_one_head_of_its_width(monkeypatch):
    """SDXS-0.9's 160-channel level at the small width attends as one head
    of 160 (``_heads_for``'s rule), SD2 tiny's as five of 32."""
    seen = []
    real = tu.attention

    def spy(q, k, v, *a, **kw):
        seen.append(tuple(q.shape[1:2]) + (q.shape[-1],))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(tu, "attention", spy)
    for name, want in (("SDXS_09", (1, 160)), ("SD2_TINY_UNET", (5, 32))):
        cfg = _small(_configs(name)[0])
        p = {k: torch.zeros(s) for k, (s, _) in tu.param_specs(cfg).items()}
        seen.clear()
        tu.unet_forward(p, torch.zeros((1, 8, 8, 4)), torch.zeros(1), torch.zeros((1, 5, 64)), cfg=cfg)
        assert set(seen) == {want}


@pytest.mark.parametrize("name", TINY)
def test_factory_and_loader_take_the_tiny_versions(tmp_path, name):
    """``create_pipeline`` builds each tiny version (small: the JAX
    factory's small SD1 UNet), and a diffusion file with the tiny layout's
    names loads with the version the JAX loader fingerprints (SD2 tiny for
    SDXS-0.9's layout, as there)."""
    from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
    from sdtpu_torch.io.model_loader import UNET_VERSIONS, load_model_bundle

    version = getattr(SDVersion, name)
    assert version in UNET_VERSIONS
    pipe = create_pipeline(version, small=True, device="cpu")
    assert pipe.version == version and pipe.controlnet_fn is None
    cfg = _configs(name)[0]
    tensors = {k: np.zeros((1,) * len(s), np.float32) for k, (s, _) in tu.param_specs(cfg).items()}
    for k in tensors:  # the shapes detection reads
        if k == "input_blocks.0.0.weight" or k.endswith("attn2.to_k.weight") or k.endswith("attn1.to_k.weight"):
            tensors[k] = np.zeros(tu.param_specs(cfg)[k][0], np.float16)
    path = str(tmp_path / "tiny.safetensors")
    save_safetensors(path, tensors)
    got = load_model_bundle(diffusion_model_path=path)
    assert got.version.value == jax_load_model_bundle(diffusion_model_path=path).version.value
    # the JAX fingerprint names SDXS-0.9 where output block 7's attn1.to_k
    # is 1024 wide; the config's is 320, so its layout reads as SD2 tiny
    assert got.version == (SDVersion.SD2_TINY_UNET if name == "SDXS_09" else version)


@pytest.mark.parametrize("name", TINY)
def test_attention_calls_count_the_tiny_forwards(monkeypatch, name):
    """A full-width tiny UNet forward at 512² under CFG, on the meta device
    (shapes only), makes ``chip_smoke.TINY_ATTENTION_CALLS`` attention calls
    per head dim, the counts the card check holds its flash launches to
    (SDXS-0.9: six at D 320)."""
    import chip_smoke

    seen = {}

    def counting(q, k, v, *a, **kw):
        seen[q.shape[-1]] = seen.get(q.shape[-1], 0) + 1
        return torch.empty_like(q)

    monkeypatch.setattr(tu, "attention", counting)
    cfg = _configs(name)[0]
    p = {k: torch.empty(shape, device="meta") for k, (shape, _) in tu.param_specs(cfg).items()}
    out = tu.unet_forward(p, torch.empty((2, 64, 64, 4), device="meta"), torch.empty((2,), device="meta"),
                          torch.empty((2, 77, cfg.context_dim), device="meta"), cfg=cfg)
    assert out.shape == (2, 64, 64, 4)
    assert seen == chip_smoke.TINY_ATTENTION_CALLS[name]
