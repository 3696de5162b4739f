"""The inpainting and instruct-pix2pix UNets: the port's small SD1 / SD2 /
SDXL inpainting (9 input channels) and SD1 / SDXL pix2pix (8) pipelines
against the JAX pipelines on the same weights.

Weights come from ``sdtpu.factory.create_pipeline(<version>, small=True,
seed=0)`` through ``from_jax_params``, the 9- and 8-channel stems too; the
noise comes from the port's own ``sdtpu_torch.rng``.  Each request runs
through both ``generate``s: the concat latents ([mask, masked image's
latent] for inpainting, the edit image's latent for pix2pix) follow the
latent unscaled, and image guidance (``img_cfg_scale`` apart from
``cfg_scale`` under CFG) adds a third forward.  Latents are held at the
goldens' rtol = atol = 5e-4, images within one uint8 level.
"""
import dataclasses

import numpy as np
import pytest
import torch

import sdtpu.config as jconfig
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline
from sdtpu_torch.models import unet as tu
from sdtpu_torch.weights import from_jax_params

@pytest.fixture(scope="module")
def pairs():
    """name → (JAX pipeline, port pipeline) of a small ``name`` pipeline on
    the same weights, each built on first use."""
    built = {}

    def pair(name: str):
        if name not in built:
            jp = jax_create_pipeline(getattr(jconfig.SDVersion, name), small=True, seed=0)
            cond = jp.conditioner
            params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
                      "vae": from_jax_params(jp.vae_params, device="cpu")}
            if name.startswith("SDXL"):
                params["clip_l"] = from_jax_params(cond.pl, device="cpu")
                params["clip_g"] = from_jax_params(cond.pg, device="cpu")
            else:
                params["clip_l"] = from_jax_params(cond.params, device="cpu")
            built[name] = jp, create_pipeline(getattr(SDVersion, name), params=params,
                                              small=True, device="cpu")
        return built[name]

    return pair


def _images(size=64, seed=21):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    mask = np.zeros((size, size), np.uint8)
    mask[:, size // 2:] = 255
    return img, mask


def _gp(**kw):
    base = dict(prompt="a golden retriever", negative_prompt="blurry", width=64, height=64,
                sample_steps=3, cfg_scale=4.0, seed=11, sample_method="euler")
    base.update(kw)
    return GenerationParams(**base)


def _both(pair, gp, **images):
    jp, tp = pair
    want = jp.generate(jconfig.GenerationParams(**dataclasses.asdict(gp)), **images)
    got = tp.generate(gp, **images)
    np.testing.assert_allclose(got.latents, want.latents, rtol=5e-4, atol=5e-4)
    assert got.seeds == want.seeds
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1
    return got, tp


INPAINT_CASES = {
    # an init image and a mask at strength 1: the whole schedule from noise
    "mask_strength_1": (dict(sample_method="euler_a", strength=1.0), True, True),
    # an init image, a mask and a cut schedule, image guidance apart from CFG
    "mask_cut_img_cfg": (dict(strength=0.6, img_cfg_scale=2.0), True, True),
    # no init image: the mask all ones, the masked latent zeros
    "txt2img": (dict(sample_method="euler_a", eta=1.0), False, False),
    # an init image without a mask: everything masked
    "init_no_mask": (dict(strength=0.8, cfg_scale=1.0, batch_count=2), True, False),
}


# every case on SD1 inpainting; SD2's and SDXL's with and without an init
# image (the module stays quick)
INPAINT_RUNS = ([("SD1_INPAINT", c) for c in sorted(INPAINT_CASES)]
                + [(n, c) for n in ("SD2_INPAINT", "SDXL_INPAINT")
                   for c in ("mask_cut_img_cfg", "txt2img")])


@pytest.mark.parametrize("name,case", INPAINT_RUNS)
def test_inpaint_latents_match_jax(pairs, name, case):
    kw, with_init, with_mask = INPAINT_CASES[case]
    img, mask = _images()
    images = dict(init_image=img if with_init else None, mask_image=mask if with_mask else None)
    got, tp = _both(pairs(name), _gp(**kw), **images)
    assert ("encode" in tp.last_timings) == with_init
    assert got.latents.shape[-1] == 4
    assert tp.diffusion_params["input_blocks.0.0.weight"].shape[1] == 9


PIX2PIX_CASES = {
    # the init image as the edit image (and the img2img start), image CFG 1.5
    "init_img_cfg": (dict(img_cfg_scale=1.5, strength=1.0), "init"),
    # a reference image of another size: its latent resized bilinearly
    "ref_resized_img_cfg": (dict(img_cfg_scale=1.5, sample_method="euler_a"), "ref"),
    # img_cfg_scale equal to cfg_scale: no third forward
    "ref_img_cfg_equal": (dict(img_cfg_scale=4.0), "ref"),
    # no edit image: the concat zeros
    "no_image": (dict(img_cfg_scale=2.0, sample_method="euler_a"), None),
}


# every case on SD1 pix2pix; SDXL's with image guidance apart from and
# equal to CFG
PIX2PIX_RUNS = ([("SD1_PIX2PIX", c) for c in sorted(PIX2PIX_CASES)]
                + [("SDXL_PIX2PIX", c) for c in ("ref_resized_img_cfg", "ref_img_cfg_equal")])


@pytest.mark.parametrize("name,case", PIX2PIX_RUNS)
def test_pix2pix_latents_match_jax(pairs, name, case, monkeypatch):
    kw, source = PIX2PIX_CASES[case]
    img, _ = _images()
    ref, _ = _images(size=48, seed=5)
    images = {"init": dict(init_image=img), "ref": dict(ref_images=[ref]), None: {}}[source]
    _, tp = pairs(name)
    calls = []
    fn = tp.diffusion_fn
    monkeypatch.setattr(tp, "diffusion_fn",
                        lambda *a, **k: calls.append(a[1].shape) or fn(*a, **k))
    _both(pairs(name), _gp(**kw), **images)
    gp = _gp(**kw)
    third = gp.img_cfg_scale != gp.cfg_scale
    assert len(calls) == gp.sample_steps * (2 if third else 1)
    assert calls[0][-1] == 8 and calls[0][0] == 2  # the CFG batch, latent + edit latent
    if third:
        assert calls[1][0] == 1 and calls[1][-1] == 8


def test_from_jax_params_bridges_the_9_channel_stem(pairs):
    """The inpainting UNet's params bridge by name and shape, the 9-channel
    stem included; a UNet forward of the bridged weights takes 9 channels
    and answers 4."""
    jp, tp = pairs("SD1_INPAINT")
    specs = tu.param_specs(dataclasses.replace(tu.UNetConfig(
        model_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(1, 2),
        transformer_depth=(1, 1), context_dim=64, num_heads=2), in_channels=9))
    assert set(tp.diffusion_params) == set(specs) == set(jp.diffusion_params)
    stem = tp.diffusion_params["input_blocks.0.0.weight"]
    assert tuple(stem.shape) == specs["input_blocks.0.0.weight"][0] == (32, 9, 3, 3)
    np.testing.assert_array_equal(stem.numpy(),
                                  np.asarray(jp.diffusion_params["input_blocks.0.0.weight"]))
    out = tp.diffusion_fn(tp.diffusion_params, torch.zeros((1, 8, 8, 9)), torch.zeros(1),
                          torch.zeros((1, 77, 64)), None)
    assert tuple(out.shape) == (1, 8, 8, 4)


def test_reference_images_are_refused_off_the_pix2pix_unets(pairs):
    """``generate(ref_images=...)`` raises by name on a model that takes no
    edit image."""
    _, tp = pairs("SD1_INPAINT")
    with pytest.raises(NotImplementedError, match="ref_images.*SD1_INPAINT"):
        tp.generate(_gp(), ref_images=[_images()[0]])
