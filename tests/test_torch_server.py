"""The port's HTTP server against the JAX package's, on the same weights.

The JAX small FLUX pipeline and the port's pipeline bridged from it
(``from_jax_params``, on the CPU) each sit behind their package's handler
on ``127.0.0.1``.  The same requests to both give images at most one uint8
level apart with equal ``parameters`` text; an async job reports its
progress and completes, a queued job cancels; img2img with a mask (A1111
and native) and ``enable_hr`` (A1111, and the native schema's ``hires``
object) match the JAX server's images; unported routes answer 501,
unported request fields (an ESRGAN ``hr_upscaler``, a JPEG init image) 400.  ``server.main`` also loads a small SDXL file
with a TAESD-XL decoder (``tests/_torch_files.py``), and a small SD3.5 file
set, and answers an A1111 request with the JAX CLI's image on the same
files.  On a small SD1.5-inpainting file ``/sdapi/v1/img2img`` with a mask
and ``img_cfg_scale``, and on a small instruct-pix2pix file an A1111
request with ``extra_images`` and ``img_cfg_scale``, answer with the JAX
CLI's image on the same file and request.
"""
import base64
import io
import json
import os
import queue
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import sdtpu.cli as jcli
import sdtpu.config as jconfig
import sdtpu.server as jserver
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu_torch import server
from sdtpu_torch.config import SDVersion
from sdtpu_torch.factory import create_pipeline
from sdtpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))  # tests/_torch_files.py

from _torch_files import (small_sd3_configs, small_sdxl_configs,  # noqa: E402
                          small_unet_family_configs, write_small_sd3_files, write_small_sdxl_file,
                          write_small_tae_file, write_small_unet_file)


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    jp = jax_create_pipeline(jconfig.SDVersion.FLUX, small=True, seed=0)
    params = {"diffusion": from_jax_params(jp.diffusion_params, device="cpu"),
              "clip_l": from_jax_params(jp.conditioner.pl, device="cpu"),
              "t5": from_jax_params(jp.conditioner.pt, device="cpu"),
              "vae": from_jax_params(jp.vae_params, device="cpu")}
    tp = create_pipeline(SDVersion.FLUX, params=params, small=True, device="cpu")
    ours = server.make_server(tp, "127.0.0.1", 0)
    theirs = ThreadingHTTPServer(("127.0.0.1", 0), jserver.make_handler(jserver.JobManager(jp)))
    yield {"port": _serve(ours), "jax": _serve(theirs), "manager": ours.manager}
    for httpd in (ours, theirs):
        httpd.shutdown()
        httpd.server_close()
    ours.manager.close()


def _call(base, path, body=None):
    """→ (status, parsed json)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(b64):
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return np.asarray(img).astype(int), img.info.get("parameters")


def _same_images(ours, theirs):
    assert len(ours) == len(theirs) >= 1
    for a, b in zip(ours, theirs):
        (ia, pa), (ib, pb) = _png(a), _png(b)
        assert pa == pb and "Version: sdtpu" in pa
        assert ia.shape == ib.shape and np.abs(ia - ib).max() <= 1


EXTRA = ('<sd_cpp_extra_args>{"sample_params": {"sample_steps": 2, "sample_method": "euler"}, '
         '"seed": 9, "cfg_scale": 1.0}</sd_cpp_extra_args>')
SYNC = {
    # no sampler named: euler_a
    "txt2img": ("/sdapi/v1/txt2img", {"prompt": "a red fox in snow", "width": 64, "height": 64,
                                      "steps": 2, "cfg_scale": 1.0, "seed": 3}),
    "txt2img_cfg": ("/sdapi/v1/txt2img", {"prompt": "a cat", "negative_prompt": "dog",
                                          "width": 64, "height": 64, "steps": 2, "seed": 4,
                                          "cfg_scale": 2.0, "sampler_name": "Euler A",
                                          "eta": 1.0, "batch_size": 2}),
    "openai": ("/v1/images/generations", {"prompt": "a lantern " + EXTRA, "size": "64x64"}),
}


@pytest.mark.parametrize("name", sorted(SYNC))
def test_sync_routes_match_jax(servers, name):
    path, body = SYNC[name]
    code, ours = _call(servers["port"], path, body)
    jcode, theirs = _call(servers["jax"], path, body)
    assert code == jcode == 200
    key = (lambda r: r["images"]) if path.startswith("/sdapi") else \
        (lambda r: [d["b64_json"] for d in r["data"]])
    _same_images(key(ours), key(theirs))


def _img2img_bodies():
    rng = np.random.default_rng(21)
    init = "data:image/png;base64," + _b64(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    mask = np.zeros((64, 64), np.uint8)
    mask[:, 32:] = 255
    base = {"prompt": "a lantern on a wooden table", "width": 64, "height": 64, "steps": 3,
            "cfg_scale": 1.0, "seed": 4, "sampler_name": "euler"}
    return {
        # A1111 img2img: a data-URL init image, a grey mask, denoising_strength
        "img2img_mask": ("/sdapi/v1/img2img", dict(base, init_images=[init], denoising_strength=0.6,
                                                   mask=_b64(mask, mode="L"))),
        # enable_hr on txt2img: the latent upscaler by its A1111 name
        "txt2img_hr": ("/sdapi/v1/txt2img", dict(base, enable_hr=True, hr_scale=1.5,
                                                 hr_upscaler="Latent (nearest-exact)",
                                                 denoising_strength=0.7)),
        # the native schema's hires object, to a given size with its own steps
        "native_hires": ("/sdcpp/v1/img_gen", {
            "prompt": "a paper boat", "width": 64, "height": 64, "seed": 5,
            "sample_params": {"sample_steps": 2, "sample_method": "euler",
                              "guidance": {"txt_cfg": 1.0}},
            "hires": {"enabled": True, "target_width": 96, "target_height": 64, "steps": 2,
                      "denoising_strength": 0.5}}),
        # a native job from an init image
        "native_img2img": ("/sdcpp/v1/img_gen", dict(base, init_image=init, strength=0.5)),
    }


@pytest.mark.parametrize("name", ["img2img_mask", "txt2img_hr", "native_hires", "native_img2img"])
def test_img2img_and_hires_requests_match_jax(servers, name):
    path, body = _img2img_bodies()[name]
    out = {}
    for side in ("port", "jax"):
        code, resp = _call(servers[side], path, body)
        if path == "/sdcpp/v1/img_gen":
            assert code == 202
            resp, _ = _wait(servers[side], resp["id"])
            assert resp["status"] == "completed", resp
        else:
            assert code == 200, resp
        out[side] = resp["images"]
    _same_images(out["port"], out["jax"])
    want = (96, 64) if name == "native_hires" else (96, 96) if name == "txt2img_hr" else (64, 64)
    assert _png(out["port"][0])[0].shape[:2] == want[::-1]


def _wait(base, job_id, timeout=300):
    seen, t0 = [], time.time()
    while time.time() - t0 < timeout:
        _, job = _call(base, f"/sdcpp/v1/jobs/{job_id}")
        seen.append(job["progress"])
        if job["status"] in ("completed", "failed", "cancelled"):
            return job, seen
        time.sleep(0.01)
    raise TimeoutError(job_id)


def test_async_job_matches_jax_with_progress(servers):
    body = {"prompt": "a paper boat", "width": 64, "height": 64, "seed": 2,
            "sample_params": {"sample_steps": 3, "guidance": {"txt_cfg": 1.0,
                                                              "distilled_guidance": 2.0}}}
    jobs = {}
    for side in ("port", "jax"):
        code, resp = _call(servers[side], "/sdcpp/v1/img_gen", body)
        assert code == 202 and resp["status"] == "queued"
        jobs[side], seen = _wait(servers[side], resp["id"])
        assert jobs[side]["status"] == "completed", jobs[side]
        assert (jobs[side]["step"], jobs[side]["steps"], seen[-1]) == (3, 3, 1.0)
    _same_images(jobs["port"]["images"], jobs["jax"]["images"])


def test_queued_job_cancels(servers):
    base, manager = servers["port"], servers["manager"]
    body = {"prompt": "a dog", "width": 64, "height": 64, "steps": 1, "cfg_scale": 1.0}
    with manager.ctx_mutex:  # the first job holds the worker; the second waits in the queue
        first = _call(base, "/sdcpp/v1/img_gen", body)[1]["id"]
        second = _call(base, "/sdcpp/v1/img_gen", body)[1]["id"]
        t0 = time.time()
        while manager.jobs[first].status != "running" and time.time() - t0 < 30:
            time.sleep(0.01)
        assert _call(base, "/sdapi/v1/progress")[0] == 200
        assert _call(base, f"/sdcpp/v1/jobs/{second}/cancel", {}) == (200, {"cancelled": True})
        assert _call(base, f"/sdcpp/v1/jobs/{second}")[1]["status"] == "cancelled"
    assert _wait(base, first)[0]["status"] == "completed"
    assert _call(base, "/sdcpp/v1/jobs/nope/cancel", {})[0] == 404


def _b64(array, fmt="PNG", mode=None) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(array, mode=mode).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def test_unported_request_fields_fail_by_name(servers):
    base = servers["port"]
    jpeg = _b64(np.zeros((64, 64, 3), np.uint8), "JPEG")
    for body, name in (({"prompt": "x", "init_images": [jpeg]}, "JPEG"),
                       ({"prompt": "x", "sampler_name": "DPM++ 2M"}, "dpm++_2m"),
                       ({"prompt": "x", "enable_hr": True, "hr_upscaler": "R-ESRGAN 4x+"},
                        "ESRGAN"),
                       ({"prompt": "x", "scheduler": "karras"}, "karras")):
        code, resp = _call(base, "/sdapi/v1/txt2img", body)
        assert code == 400 and name in resp["error"], resp
    code, resp = _call(base, "/v1/images/generations", {"prompt": "x", "output_format": "jpeg"})
    assert code == 400 and "Pillow" in resp["error"]
    code, resp = _call(base, "/sdcpp/v1/img_gen", {"prompt": "x", "lora": [{"name": "a"}]})
    job, _ = _wait(base, resp["id"])
    assert job["status"] == "failed" and "LoRA" in job["error"]


def test_video_frames_are_refused_by_name(servers):
    """A request's ``video_frames`` (the reference answers with an animated
    WebP) stays refused by name: the port's video runs through the CLI's
    ``vid_gen``."""
    base = servers["port"]
    code, resp = _call(base, "/sdapi/v1/txt2img", {"prompt": "x", "video_frames": 33})
    assert code == 400 and "video" in resp["error"], resp
    code, resp = _call(base, "/sdcpp/v1/img_gen", {"prompt": "x", "video_frames": 33})
    job, _ = _wait(base, resp["id"])
    assert job["status"] == "failed" and "video" in job["error"]


@pytest.mark.parametrize("method,path", [("GET", "/"), ("GET", "/sdapi/v1/loras"),
                                         ("GET", "/sdapi/v1/upscalers"), ("GET", "/nope"),
                                         ("POST", "/sdapi/v1/extra-single-image"),
                                         ("POST", "/v1/images/edits"),
                                         ("POST", "/sdcpp/v1/vid_gen")])
def test_unported_routes_answer_501(servers, method, path):
    code, resp = _call(servers["port"], path, {} if method == "POST" else None)
    assert code == 501 and path in resp["error"] and "not ported" in resp["error"]


def test_listings_name_what_the_port_runs(servers):
    base = servers["port"]
    ported = ["euler", "euler_a", "heun", "dpm++2s_a", "dpm++2m", "ipndm", "lcm"]
    assert [s["name"] for s in _call(base, "/sdapi/v1/samplers")[1]] == ported
    assert [s["name"] for s in _call(base, "/sdapi/v1/schedulers")[1]] == ["discrete", "flux"]
    caps = _call(base, "/sdcpp/v1/capabilities")[1]
    assert caps["modes"] == ["img_gen"] and caps["samplers"] == ported
    assert _call(base, "/v1/models")[1]["data"][0]["id"] == "sdtpu"
    assert _call(base, "/sdapi/v1/sd-models")[0] == 200
    assert _call(base, "/sdapi/v1/options", {"foo": 1}) == (200, {})
    assert _call(base, "/sdapi/v1/options")[1]["foo"] == 1


def test_server_main_refuses_unported_flags(capsys):
    assert server.main(["--upscaler-dir", "ups"]) == 2
    assert "--upscaler-dir" in capsys.readouterr().err


def test_sdxl_server_answers_a1111_lcm_from_files(monkeypatch, tmp_path):
    """``server.main`` on a small SDXL single file with ``--taesd`` (the
    CLI's loader) answers one A1111 request with ``sampler_name`` lcm: the
    image of the JAX CLI on the same files and request, within one uint8
    level."""
    small_sdxl_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    model, tae = write_small_sdxl_file(tmp_path), write_small_tae_file(tmp_path)
    box = queue.Queue()
    thread = threading.Thread(target=server.main, daemon=True, kwargs=dict(
        argv=["-m", model, "--taesd", tae, "--backend", "cpu", "--port", "0"], ready=box.put))
    thread.start()
    httpd = box.get(timeout=300)
    try:
        body = {"prompt": "an astronaut riding a horse", "width": 64, "height": 64, "steps": 2,
                "cfg_scale": 1.0, "seed": 42, "sampler_name": "lcm"}
        code, resp = _call(f"http://127.0.0.1:{httpd.server_address[1]}", "/sdapi/v1/txt2img", body)
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
    assert code == 200, resp
    ours, params = _png(resp["images"][0])
    assert "Sampler: lcm" in params and ours.std() > 0
    png = str(tmp_path / "jax.png")
    assert jcli.main(["-m", model, "--taesd", tae, "-p", body["prompt"], "-W", "64", "-H", "64",
                      "--steps", "2", "--cfg-scale", "1", "-s", "42", "--sampling-method", "lcm",
                      "-o", png]) == 0
    from PIL import Image  # as _png reads the answers

    theirs = np.asarray(Image.open(png)).astype(int)
    assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= 1


def test_sd3_server_answers_a1111_dpmpp2m_from_files(monkeypatch, tmp_path):
    """``server.main`` on a small SD3.5 set (``-m`` with the MMDiT and the
    VAE, ``--clip_l``, ``--clip_g``, ``--t5xxl``) answers the bench's request
    on the A1111 route (``sampler_name`` dpm++2m, CFG 4.5, a negative
    prompt): the JAX CLI's image on the same files and request, within one
    uint8 level.  (The A1111 display name "DPM++ 2M" maps to ``dpm++_2m`` in
    both servers, which no sampler takes:
    ``test_unported_request_fields_fail_by_name``.)"""
    small_sd3_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    p = write_small_sd3_files(tmp_path)
    files = ["-m", p["model"], "--clip_l", p["clip_l"], "--clip_g", p["clip_g"], "--t5xxl", p["t5xxl"]]
    box = queue.Queue()
    thread = threading.Thread(target=server.main, daemon=True, kwargs=dict(
        argv=files + ["--backend", "cpu", "--port", "0"], ready=box.put))
    thread.start()
    httpd = box.get(timeout=300)
    try:
        body = {"prompt": "a photograph of an astronaut riding a horse", "negative_prompt": "blurry",
                "width": 64, "height": 64, "steps": 3, "cfg_scale": 4.5, "seed": 42,
                "sampler_name": "dpm++2m"}
        code, resp = _call(f"http://127.0.0.1:{httpd.server_address[1]}", "/sdapi/v1/txt2img", body)
        version = httpd.manager.pipeline.version.value
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
    assert code == 200, resp
    assert version == "sd3"
    ours, params = _png(resp["images"][0])
    assert "Sampler: dpm++2m" in params and ours.std() > 0
    png = str(tmp_path / "jax.png")
    assert jcli.main(files + ["-p", body["prompt"], "-n", "blurry", "-W", "64", "-H", "64",
                              "--steps", "3", "--cfg-scale", "4.5", "-s", "42",
                              "--sampling-method", "dpm++2m", "-o", png]) == 0
    from PIL import Image  # as _png reads the answers

    theirs = np.asarray(Image.open(png)).astype(int)
    assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= 1


def test_reference_images_are_refused_off_the_pix2pix_unets(servers):
    """``extra_images`` on a model that takes no edit image (FLUX) answers
    400 naming it."""
    code, resp = _call(servers["port"], "/sdapi/v1/txt2img",
                       {"prompt": "x", "extra_images": [_b64(np.zeros((8, 8, 3), np.uint8))]})
    assert code == 400 and "reference images" in resp["error"], resp


@pytest.mark.parametrize("version", ["sd1_inpaint", "sd1_pix2pix"])
def test_inpaint_and_pix2pix_servers_answer_from_files(monkeypatch, tmp_path, version):
    """``server.main`` on a small SD1.5-inpainting file answers a masked
    ``/sdapi/v1/img2img`` (strength 1, ``img_cfg_scale`` 2), on a small
    instruct-pix2pix file an A1111 txt2img with the edit image in
    ``extra_images`` and ``img_cfg_scale`` 1.5: the JAX CLI's image (``-i``
    / ``--mask``, or ``-r``, and ``--img-cfg-scale``) on the same file and
    request, within one uint8 level."""
    from PIL import Image

    import sdtpu.cli as jcli

    small_unet_family_configs(monkeypatch)
    monkeypatch.setenv("SDTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    model = write_small_unet_file(
        tmp_path, jax_create_pipeline(getattr(jconfig.SDVersion, version.upper()), small=True,
                                      seed=0), version)
    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[:, 32:] = 255
    init_png, mask_png = str(tmp_path / "init.png"), str(tmp_path / "mask.png")
    Image.fromarray(img).save(init_png)
    Image.fromarray(mask, mode="L").save(mask_png)
    body = {"prompt": "a red sofa", "width": 64, "height": 64, "steps": 3, "seed": 8,
            "sampler_name": "euler"}
    argv = ["-p", body["prompt"], "-W", "64", "-H", "64", "--steps", "3", "-s", "8",
            "--sampling-method", "euler"]
    if version == "sd1_inpaint":
        route = "/sdapi/v1/img2img"
        body.update(init_images=[_b64(img)], mask=_b64(mask, mode="L"), denoising_strength=1.0,
                    img_cfg_scale=2.0)
        argv += ["-i", init_png, "--mask", mask_png, "--strength", "1.0", "--img-cfg-scale", "2"]
    else:
        route = "/sdapi/v1/txt2img"
        body.update(extra_images=[_b64(img)], cfg_scale=7.5, img_cfg_scale=1.5)
        argv += ["-r", init_png, "--cfg-scale", "7.5", "--img-cfg-scale", "1.5"]
    box = queue.Queue()
    thread = threading.Thread(target=server.main, daemon=True, kwargs=dict(
        argv=["-m", model, "--backend", "cpu", "--port", "0"], ready=box.put))
    thread.start()
    httpd = box.get(timeout=300)
    try:
        code, resp = _call(f"http://127.0.0.1:{httpd.server_address[1]}", route, body)
        loaded = httpd.manager.pipeline.version.value
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
    assert code == 200, resp
    assert loaded == version
    ours, _ = _png(resp["images"][0])
    png = str(tmp_path / "jax.png")
    assert jcli.main(["-m", model] + argv + ["-o", png]) == 0
    theirs = np.asarray(Image.open(png)).astype(int)
    assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= 1
