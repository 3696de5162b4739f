"""The port's img2img path against the JAX package's, on the CPU.

The VAE encoder (``vae_encode_moments`` / ``vae_encode``) at four small
configs shaped as the port's VAEs (SD's 4 latent channels with
``quant_conv``, SDXL's scale, FLUX's and SD3's 16 channels with a shift and
no ``quant_conv``), ``tiled_encode`` (the one-tile shortcut and a ragged 3 x
3 grid), ``encode_image`` with tiling off and on, ``generate`` from an init
image at strengths 0.5 and 1.0 on the small SD1 and FLUX pipelines, the
mask, the latent hires fix up and down, custom sigmas, the prompt cache and
``free_conditioner_params``; weights come from the JAX factories through
``from_jax_params``, inputs are drawn with numpy from a seed.  Tolerances:
the encoder and the encode paths at rtol 1e-4 / atol 1e-5 (float32 on both
sides); pipeline latents at the golden tolerance, rtol = atol = 5e-4; the
bilinear latent resize at 1e-5.  ``decode_png`` is held against Pillow on
PNGs Pillow writes and on PNGs written here with each of the five row
filters (and rows of None, Sub and Up above and below a band of Average and
Paeth rows), at every colour type the port reads: equal bytes.
"""
import dataclasses
import io
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import sdtpu.config as jconfig
import sdtpu.models.tiling as jtiling
import sdtpu.models.vae as jvae
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu_torch.config import GenerationParams, SDVersion
from sdtpu_torch.factory import create_pipeline
from sdtpu_torch.models import tiling as ttiling
from sdtpu_torch.models import vae as tvae
from sdtpu_torch.pipeline import FREED_ERROR, resize_latents
from sdtpu_torch.utils import image as timage
from sdtpu_torch.weights import from_jax_params, weight_bytes

TOL = dict(rtol=1e-4, atol=1e-5)
GOLDEN_TOL = dict(rtol=5e-4, atol=5e-4)
SMALL = dict(base_channels=32, channel_mult=(1, 2, 2, 2), num_res_blocks=1)
# (config fields, whether the params keep quant_conv / post_quant_conv)
VAE_CASES = {
    "sd": (dict(SMALL), True),
    "sdxl": (dict(SMALL, scale_factor=0.13025), True),
    "flux": (dict(SMALL, z_channels=16, scale_factor=0.3611, shift_factor=0.1159), False),
    "sd3": (dict(SMALL, z_channels=16, scale_factor=1.5305, shift_factor=0.0609), False),
}


def _vae_pair(name):
    fields, quant_conv = VAE_CASES[name]
    jcfg, tcfg = jvae.VAEConfig(**fields), tvae.VAEConfig(**fields)
    jp = jvae.init_vae_params(jcfg, seed=1)
    if not quant_conv:
        jp = {k: v for k, v in jp.items() if "quant_conv." not in k}
    return jcfg, tcfg, jp, from_jax_params(jp, device="cpu")


def _pixels(rng, shape):
    return np.clip(rng.standard_normal(shape, dtype=np.float32) * 0.5, -1, 1)


@pytest.mark.parametrize("name", sorted(VAE_CASES))
def test_vae_encode_matches_jax(name):
    jcfg, tcfg, jp, tp = _vae_pair(name)
    rng = np.random.default_rng(0)
    x = _pixels(rng, (2, 32, 48, 3))
    noise = rng.standard_normal((2, 4, 6, tcfg.z_channels), dtype=np.float32)
    want = np.asarray(jvae.vae_encode_moments(jp, jnp.asarray(x), jcfg))
    got = tvae.vae_encode_moments(tp, torch.from_numpy(x), tcfg).numpy()
    assert got.shape == want.shape == (2, 4, 6, 2 * tcfg.z_channels)
    np.testing.assert_allclose(got, want, **TOL)
    for nz in (None, noise):
        want = np.asarray(jvae.vae_encode(jp, jnp.asarray(x), None if nz is None else jnp.asarray(nz),
                                          jcfg))
        got = tvae.vae_encode(tp, torch.from_numpy(x), None if nz is None else torch.from_numpy(nz),
                              tcfg).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(VAE_CASES))
def test_vae_specs_are_the_jax_init_layout(name):
    """Both halves' names, shapes and order are ``init_vae_params``'s (the
    order ``synthesize`` draws them in)."""
    fields, _ = VAE_CASES[name]
    jp = jvae.init_vae_params(jvae.VAEConfig(**fields), seed=0)
    specs = tvae.vae_specs(tvae.VAEConfig(**fields))
    assert list(specs) == list(jp)
    assert all(specs[k][0] == tuple(v.shape) for k, v in jp.items())


@pytest.mark.parametrize("size", [(2, 24, 40), (1, 72, 80)], ids=["one_tile", "grid_3x3_ragged"])
def test_tiled_encode_matches_jax(size):
    """Tiles of 32 pixels overlapping by 8 (strides of 24): 24 x 40 pixels
    is one tile (the shortcut), 72 x 80 a 3 x 3 grid whose last row and
    column sit flush with the edge."""
    jcfg, tcfg, jp, tp = _vae_pair("sd")
    x = _pixels(np.random.default_rng(1), size + (3,))
    want = np.asarray(jtiling.tiled_encode(lambda t: jvae.vae_encode(jp, t, cfg=jcfg), x, tile=32,
                                           overlap=8))
    got = ttiling.tiled_encode(lambda t: tvae.vae_encode(tp, t, cfg=tcfg), torch.from_numpy(x),
                               tile=32, overlap=8).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (size[0], size[1] // 8,
                                                                    size[2] // 8, 4)
    np.testing.assert_allclose(got, want, **TOL)


def _bridge(version):
    jp = jax_create_pipeline(getattr(jconfig.SDVersion, version.name), small=True, seed=0)
    if version == SDVersion.FLUX:
        params = {"clip_l": jp.conditioner.pl, "t5": jp.conditioner.pt}
    else:
        params = {"clip_l": jp.conditioner.params}
    params.update(diffusion=jp.diffusion_params, vae=jp.vae_params)
    params = {k: from_jax_params(v, device="cpu") for k, v in params.items()}
    return jp, create_pipeline(version, params=params, small=True, device="cpu")


@pytest.fixture(scope="module")
def sd1():
    return _bridge(SDVersion.SD1)


@pytest.fixture(scope="module")
def flux():
    return _bridge(SDVersion.FLUX)


def _init_image(seed=0, size=64):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8)


def _gp(**kw):
    base = dict(prompt="a red fox in snow", negative_prompt="blurry", width=64, height=64,
                sample_steps=4, cfg_scale=4.0, seed=3, sample_method="euler")
    base.update(kw)
    return GenerationParams(**base)


def _jgp(gp):
    return jconfig.GenerationParams(**dataclasses.asdict(gp))


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
def test_encode_image_matches_jax(sd1, tiled):
    """Tiled: tiles of 4 latent pixels overlapping by 1 (32 and 8 pixels) over
    a 64² image; a float image in [0, 1] as well as uint8."""
    jp, tp = sd1
    for p in (jp, tp):
        p.set_vae_tiling(tiled, tile_size=4, overlap=1)
    try:
        img = _init_image(2)
        for image in (img, img.astype(np.float32) / 255.0):
            want, got = jp.encode_image(image), tp.encode_image(image)
            assert got.dtype == np.float32 and got.shape == want.shape == (1, 8, 8, 4)
            np.testing.assert_allclose(got, want, **TOL)
    finally:
        for p in (jp, tp):
            p.set_vae_tiling(False)


IMG2IMG = [
    ("sd1", dict(strength=0.5)),
    ("sd1", dict(strength=1.0, sample_method="euler_a", eta=1.0, batch_count=2)),
    ("flux", dict(strength=0.5, cfg_scale=1.0, guidance=3.0)),
    ("flux", dict(strength=1.0, sample_method="euler_a", eta=1.0)),
]


@pytest.mark.parametrize("family,kw", IMG2IMG, ids=[f"{f}_{kw['strength']}" for f, kw in IMG2IMG])
def test_img2img_matches_jax(sd1, flux, family, kw):
    """The cut schedule (3 of 4 steps at 0.5, all 4 at 1.0), the noise
    scaled around the init latent and, with euler_a at eta 1, the per-step
    noise drawn for the cut step count after the latent noise."""
    jp, tp = {"sd1": sd1, "flux": flux}[family]
    gp = _gp(**kw)
    img = _init_image(4)
    want, got = jp.img2img(_jgp(gp), img), tp.img2img(gp, img)
    np.testing.assert_allclose(got.latents, want.latents, **GOLDEN_TOL)
    assert got.seeds == want.seeds and got.images.shape == want.images.shape
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1
    assert tp.last_timings["steps"] == jp.last_timings["steps"] == (3 if gp.strength < 1 else 4)
    assert tp.last_timings["encode"] > 0


@pytest.mark.parametrize("steps,strength,sigmas,want", [
    (4, 0.5, "", 3), (4, 0.75, "", 4), (4, 1.0, "", 4), (10, 0.3, "", 4), (3, 0.1, "", 1),
    (20, 0.75, "", 16), (4, 0.5, "14.6,7.0,3.0,1.0,0.5,0.2", 4),
], ids=lambda v: str(v))
def test_strength_cuts_the_schedule(sd1, steps, strength, sigmas, want):
    """``t_enc = int(n · strength)``, one fewer where it is n, over
    ``len(sigmas) - 1`` steps (the custom list's six, with its 0 appended):
    the port's step count at 16² (a 2 x 2 latent) and
    ``chip_smoke.img2img_steps`` (what the card check expects) against the
    JAX pipeline's cut, which ``test_img2img_matches_jax`` and
    ``test_custom_sigmas_match_jax`` read from the JAX pipeline itself."""
    import chip_smoke

    _, tp = sd1
    gp = _gp(width=16, height=16, sample_steps=steps, strength=strength, custom_sigmas=sigmas,
             cfg_scale=1.0)
    tp.generate(gp, init_image=_init_image(5, 16))
    assert tp.last_timings["steps"] == want
    if not sigmas:
        assert chip_smoke.img2img_steps(steps, strength) == want


@pytest.mark.parametrize("family", ["sd1", "flux"])
def test_masked_img2img_matches_jax(sd1, flux, family):
    """The right half regenerates (255), the left half keeps the init image
    (0): the latents match the JAX pipeline's, and with euler, which ends at
    sigma 0, the kept half of the final latent is the init latent."""
    jp, tp = {"sd1": sd1, "flux": flux}[family]
    gp = _gp(strength=0.75, batch_count=2)
    img = _init_image(6)
    mask = np.zeros((64, 64), dtype=np.uint8)
    mask[:, 32:] = 255
    want, got = jp.img2img(_jgp(gp), img, mask), tp.img2img(gp, img, mask)
    np.testing.assert_allclose(got.latents, want.latents, **GOLDEN_TOL)
    init = tp.encode_image(img)
    np.testing.assert_allclose(got.latents[:, :, :4], np.broadcast_to(init[:, :, :4], (2, 8, 4, init.shape[-1])),
                               rtol=0, atol=1e-5)
    assert np.abs(got.latents[:, :, 4:] - init[:, :, 4:]).max() > 0.1


@pytest.mark.parametrize("lh,lw", [(12, 12), (4, 4), (12, 5), (3, 16)],
                         ids=["up", "down", "up_down", "down_up"])
def test_resize_latents_matches_jax_image_resize(lh, lw):
    x = np.random.default_rng(7).standard_normal((2, 8, 8, 4), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, lh, lw, 4), method="bilinear"))
    np.testing.assert_allclose(resize_latents(torch.from_numpy(x), lh, lw).numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("base,kw", [
    ({}, dict(hires_scale=1.5)),
    (dict(custom_sigmas="14.6,5.0,1.2"), dict(hires_scale=0.5, hires_steps=2,
                                               hires_sigmas="10,4,1.5,0.5")),
], ids=["up", "down"])
def test_txt2img_hires_matches_jax(sd1, base, kw):
    """The base request (down: txt2img on custom sigmas), its latents
    resized (up, and down with its own steps and custom hires sigmas), then
    the img2img pass at strength 0.7; a given width and height run through
    the CLI's test."""
    jp, tp = sd1
    gp = _gp(sample_steps=3, **base)
    want = jp.txt2img_hires(_jgp(gp), hires_strength=0.7, **kw)
    got = tp.txt2img_hires(gp, hires_strength=0.7, **kw)
    assert got.latents.shape == want.latents.shape
    np.testing.assert_allclose(got.latents, want.latents, **GOLDEN_TOL)
    assert tp.last_timings["steps"] == jp.last_timings["steps"]


def test_esrgan_hires_and_unported_inputs_raise_by_name(sd1, tmp_path):
    _, tp = sd1
    with pytest.raises(NotImplementedError, match="ESRGAN"):
        tp.txt2img_hires(_gp(), upscaler="esrgan")
    with pytest.raises(ValueError, match="does not match"):
        tp.img2img(_gp(width=32, height=32), _init_image(0, 64))
    wan = create_pipeline(SDVersion.WAN2, small=True, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder"):
        wan.encode_image(_init_image(0, 16))
    with pytest.raises(NotImplementedError, match="init_image"):
        wan.generate_video(_gp(width=16, height=16), frames=1, init_image=_init_image(0, 16))


def test_encode_with_a_tae_decoder_attached_raises_by_name(sd1):
    """A TAESD decoder swaps the VAE params for the TAE's, which hold no
    encoder: the JAX pipeline fails there, the port refuses by name; after
    ``set_tae(None)`` both encode alike again."""
    from sdtpu.models.tae import TAESD_CONFIG, init_tae_params

    jp, tp = sd1
    img = _init_image(4, 32)
    jtae = init_tae_params(TAESD_CONFIG, seed=3)
    jp.set_tae(jtae, TAESD_CONFIG)
    tp.set_tae(from_jax_params(jtae, device="cpu"))
    try:
        with pytest.raises(Exception):
            jp.encode_image(img)
        with pytest.raises(NotImplementedError, match="TAESD"):
            tp.encode_image(img)
    finally:
        jp.set_tae(None)
        tp.set_tae(None)
    np.testing.assert_allclose(tp.encode_image(img), jp.encode_image(img), **TOL)


@pytest.mark.parametrize("family", ["sd1", "flux"])
def test_custom_sigmas_match_jax(sd1, flux, family):
    """A custom sigma list without its trailing 0 (its 4 steps, whatever
    ``sample_steps`` says), cut by strength on img2img to 3; txt2img on
    custom sigmas runs in the hires test's base request."""
    jp, tp = {"sd1": sd1, "flux": flux}[family]
    sig = "14.6,6.0,2.0,0.6" if family == "sd1" else "1.0,0.8,0.55,0.3"
    gp = _gp(custom_sigmas=sig, sample_steps=20, cfg_scale=1.0, strength=0.6)
    img = _init_image(8)
    want, got = jp.generate(_jgp(gp), init_image=img), tp.generate(gp, init_image=img)
    np.testing.assert_allclose(got.latents, want.latents, **GOLDEN_TOL)
    assert tp.last_timings["steps"] == jp.last_timings["steps"] == 3


def _counting(p, calls):
    inner = p.conditioner.get_learned_condition

    def counted(*a, **kw):
        calls.append(a[0])
        return inner(*a, **kw)

    p.conditioner.get_learned_condition = counted


def test_repeat_prompt_does_not_call_the_conditioner(sd1):
    """The second request of a prompt (and of its negative prompt under CFG)
    comes from the cache on both sides; a new size is a new key."""
    jp, tp = sd1
    calls = {"jax": [], "port": []}
    _counting(jp, calls["jax"])
    _counting(tp, calls["port"])
    try:
        gp = _gp(prompt="a lighthouse at dusk", sample_steps=2, seed=9)
        first = tp.generate(gp)
        jp.generate(_jgp(gp))
        again = tp.generate(gp)
        jp.generate(_jgp(gp))
        other = dataclasses.replace(gp, width=32)
        tp.generate(other)
        jp.generate(_jgp(other))
    finally:
        del jp.conditioner.get_learned_condition, tp.conditioner.get_learned_condition
    assert calls["port"] == calls["jax"] == ["a lighthouse at dusk", "blurry"] * 2
    np.testing.assert_array_equal(again.latents, first.latents)


def test_freed_pipeline_answers_cached_prompts_only():
    """``free_params_immediately``: the text encoders' tensors go after the
    first request's conditioning (their bytes reported), a cached prompt is
    still answered with the same latents, a new one raises the JAX
    package's error; on the JAX pipeline alike."""
    jp, tp = _bridge(SDVersion.SD1)
    held = weight_bytes(tp.conditioner.params)
    gp = _gp(sample_steps=2, cfg_scale=1.0)
    before = tp.generate(gp)
    assert tp.free_conditioner_params() == held > 0
    assert tp.conditioner.params is None and tp.free_conditioner_params() == 0
    np.testing.assert_array_equal(tp.generate(gp).latents, before.latents)
    jp.generate(_jgp(gp))
    assert jp.free_conditioner_params() > 0
    new = dataclasses.replace(gp, prompt="a prompt never encoded")
    with pytest.raises(RuntimeError) as theirs:
        jp.generate(_jgp(new))
    with pytest.raises(RuntimeError) as ours:
        tp.generate(new)
    assert str(ours.value) == str(theirs.value) == FREED_ERROR


def test_free_params_immediately_frees_after_conditioning():
    _, tp = _bridge(SDVersion.FLUX)
    tp.free_params_immediately = True
    res = tp.generate(_gp(sample_steps=2, cfg_scale=1.0))
    assert np.isfinite(res.latents).all() and tp.conditioner.pl is None and tp.conditioner.pt is None


def test_synthesized_pipelines_draw_the_encoder():
    """A VAE the factory draws has both halves (``init_vae_params``'s
    names), so a pipeline built from no params encodes."""
    from sdtpu_torch.factory import sd3_configs

    tp = create_pipeline(SDVersion.SD3, small=True, seed=2, device="cpu")
    assert set(tp.vae_params) == set(tvae.vae_specs(sd3_configs(small=True)[4]))
    z = tp.encode_image(_init_image(1, 32))
    assert z.shape == (1, 4, 4, tp.latent_channels) and np.isfinite(z).all()


# ------------------------------------------------------------------ PNGs


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(pixels: np.ndarray, ctype: int, filters) -> bytes:
    """[H, W, C] uint8 → PNG bytes, row y filtered with ``filters[y % n]``."""
    h, w, ch = pixels.shape
    rows, prior = [], np.zeros(w * ch, dtype=np.int64)
    for y in range(h):
        x = pixels[y].reshape(-1).astype(np.int64)
        a = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        f = filters[y % len(filters)]
        pred = [0, a, prior, (a + prior) // 2, _paeth(a, prior, c)][f]
        rows.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prior = x

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (timage.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


CTYPES = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}


def _pixels_u8(ctype, seed=0, h=13, w=17):
    ch = len(CTYPES[ctype])
    y, x = np.mgrid[0:h, 0:w]
    smooth = (x[..., None] * 9 + y[..., None] * 5 + np.arange(ch) * 40) % 256
    noise = np.random.default_rng(seed).integers(0, 256, (h, w, ch))
    return np.where(noise % 3 == 0, noise, smooth).astype(np.uint8)  # both runs and jumps


def _pillow_rgb(blob):
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


@pytest.mark.parametrize("ctype", sorted(CTYPES), ids=lambda c: CTYPES[c])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4],
                                     [2, 1, 0, 4, 1, 2, 0, 3, 4, 2, 2, 1, 0]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed", "band"])
def test_decode_png_reads_each_filter_as_pillow(ctype, filters):
    blob = _png(_pixels_u8(ctype), ctype, filters)
    got, params = timage.decode_png(blob)
    assert got.dtype == np.uint8 and params is None
    np.testing.assert_array_equal(got, _pillow_rgb(blob))


@pytest.mark.parametrize("mode", ["L", "RGB", "LA", "RGBA"])
def test_decode_png_reads_pillow_files(mode, tmp_path):
    """PNGs Pillow writes (its own filter choice and compression) with a
    ``parameters`` text: the pixels Pillow reads back, the text, and
    ``read_png`` / ``base64_png_to_image`` on the same file."""
    from PIL.PngImagePlugin import PngInfo

    arr = _pixels_u8({"L": 0, "RGB": 2, "LA": 4, "RGBA": 6}[mode], seed=3, h=40, w=56)
    img = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode=mode)
    info = PngInfo()
    info.add_text("parameters", "a cat\nSteps: 3, Sampler: euler")
    path = tmp_path / f"{mode}.png"
    img.save(path, format="PNG", pnginfo=info)
    blob = path.read_bytes()
    got, params = timage.read_png(str(path))
    np.testing.assert_array_equal(got, _pillow_rgb(blob))
    assert params == Image.open(path).info["parameters"]
    import base64

    b64 = base64.b64encode(blob).decode()
    for data in (b64, "data:image/png;base64," + b64):
        np.testing.assert_array_equal(timage.base64_png_to_image(data), got)


def _refused_blobs():
    rgb = _pixels_u8(2)
    out = {}
    for fmt, name in (("JPEG", "JPEG"), ("WEBP", "WebP")):
        buf = io.BytesIO()
        try:
            Image.fromarray(rgb).save(buf, format=fmt)
        except (KeyError, OSError):  # a Pillow built without the encoder
            continue
        out[name] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb).quantize(8).save(buf, format="PNG")
    out["palette"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(buf, format="PNG")
    out["16-bit"] = buf.getvalue()
    blob = bytearray(_png(rgb, 2, [0]))
    ihdr = bytes(blob[12:29])
    ihdr = ihdr[:16] + b"\x01"  # the interlace byte
    blob[12:29] = ihdr
    blob[29:33] = struct.pack(">I", zlib.crc32(ihdr))
    out["interlaced"] = bytes(blob)
    return out


@pytest.mark.parametrize("name", ["JPEG", "WebP", "palette", "16-bit", "interlaced"])
def test_decode_png_refuses_what_it_does_not_read_by_name(name):
    blobs = _refused_blobs()
    if name not in blobs:
        pytest.skip(f"this Pillow writes no {name}")
    with pytest.raises(ValueError, match=name):
        timage.decode_png(blobs[name])
