"""HTTP server for the PyTorch/CUDA port: FLUX.1, SD1.x, SD2.x, SDXL, SD3, Z-Image and
Qwen-Image txt2img, img2img, masked img2img and the latent hires fix (the UNets' inpainting and
instruct-pix2pix variants too) behind the reference's three API families
(this package's copy of ``sdtpu/server.py``: ``Job``, ``JobManager``,
``flatten_native_params``, ``extract_extra_args``, ``params_from_json``, the image part
of ``run_generation``, ``make_handler``, ``serve`` and ``main``).

    python -m sdtpu_torch.server --diffusion-model flux1-dev-q8_0.gguf \\
        --clip_l clip_l.safetensors --t5xxl t5xxl-q8_0.gguf --vae ae.safetensors \\
        --port 7860
    python -m sdtpu_torch.server -m sdxl.safetensors --taesd taesdxl.safetensors --port 7860
    python -m sdtpu_torch.server -m sd3.5_medium.safetensors --clip_l clip_l.safetensors \\
        --clip_g clip_g.safetensors --t5xxl t5xxl-q8_0.gguf --port 7860
    python -m sdtpu_torch.server --diffusion-model z_image_turbo-q8_0.gguf \\
        --llm Qwen3-4B-q4_0.gguf --vae ae.safetensors --port 7860
    python -m sdtpu_torch.server --diffusion-model qwen-image-q4_0.gguf \\
        --llm Qwen2.5-VL-7B-q4_0.gguf --vae wan_2.1_vae.safetensors --port 7860

Routes the port answers:
  native:  POST /sdcpp/v1/img_gen (async job), GET /sdcpp/v1/jobs/<id>,
           POST /sdcpp/v1/jobs/<id>/cancel, GET /sdcpp/v1/capabilities
  A1111:   POST /sdapi/v1/txt2img, POST /sdapi/v1/img2img, GET/POST /sdapi/v1/options,
           GET /sdapi/v1/{samplers,schedulers,sd-models,progress}
  OpenAI:  POST /v1/images/generations, GET /v1/models
img2img takes ``init_images`` (or ``init_image``) and ``mask`` as base64 PNGs
(the mask's channel 0; 1 regenerate, 0 keep; on an inpainting UNet both go
into the model's input) with ``denoising_strength``; ``img_cfg_scale`` sets
the image guidance of the inpainting and pix2pix UNets, and on a pix2pix
UNet ``extra_images`` (base64 PNGs) names the edit image;
``enable_hr`` on a request without an init image runs the hires fix
(``hr_scale``, ``hr_resize_x`` / ``hr_resize_y``, ``hr_steps``,
``denoising_strength``) with a latent ``hr_upscaler`` (``Latent*``, or the
names the JAX server also resizes in latent space: ``Lanczos``, ``Nearest``,
``None``).  Every other route answers 501 with a JSON error naming it (no
web UI).  A request that asks for what the port does not run (reference
images on any other model, an ESRGAN ``hr_upscaler``, LoRA, video, a sampler outside
samplers.PORTED_METHODS, jpeg / webp output, a JPEG or WebP init image)
answers 400, or fails its job, naming it.  A Wan2.1 model is refused at
load (the reference's video answer is an animated WebP): the CLI's
``-M vid_gen`` runs it.

One generation at a time (a mutex around the pipeline); the native family
is async, with a job queue, per-step progress and cancellation.  The
loader is the port CLI's (``sdtpu_torch.cli._load_pipeline``), so the
server takes the CLI's files (``--taesd`` too), ``--backend`` and dtype rule.
"""
from __future__ import annotations

import json
import re
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from sdtpu_torch.config import GenerationParams
from sdtpu_torch.diffusion.samplers import PORTED_METHODS
from sdtpu_torch.diffusion.schedule import SCHEDULERS

# request fields of what the port does not run, and what each names
UNPORTED_FIELDS = {"extra_images": "reference images", "video_frames": "video",
                   "frames": "video", "lora": "LoRA"}
# hr_upscaler names the JAX server resizes in latent space (any other names
# an ESRGAN model)
LATENT_UPSCALERS = ("latent", "lanczos", "nearest", "none")


class Job:
    def __init__(self, params: dict):
        self.id = uuid.uuid4().hex[:16]
        self.params = params
        self.status = "queued"  # queued | running | completed | failed | cancelled
        self.images = []
        self.error = None
        self.cancel_requested = threading.Event()
        self.created = time.time()
        self.step = 0
        self.steps = 0

    @property
    def progress(self) -> float:
        return self.step / self.steps if self.steps else 0.0


class JobManager:
    """Async worker queue: one worker thread runs the queued jobs in order."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.jobs: Dict[str, Job] = {}
        self.queue = []
        self.lock = threading.Lock()
        self.wake = threading.Condition(self.lock)
        self.ctx_mutex = threading.Lock()  # one generation at a time
        self.options: Dict[str, object] = {"sd_model_checkpoint": "loaded"}
        self._closed = False
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def submit(self, params: dict) -> Job:
        job = Job(params)
        with self.wake:
            self.jobs[job.id] = job
            self.queue.append(job.id)
            self.wake.notify()
        return job

    def cancel(self, job_id: str) -> bool:
        with self.lock:
            job = self.jobs.get(job_id)
            if job is None:
                return False
            if job.status == "queued":
                self.queue.remove(job_id)
                job.status = "cancelled"
            else:
                job.cancel_requested.set()
            return True

    def close(self) -> None:
        """Stop the worker once its current job ends (queued jobs stay)."""
        with self.wake:
            self._closed = True
            self.wake.notify()
        self.worker.join()

    def _run(self):
        while True:
            with self.wake:
                while not self.queue and not self._closed:
                    self.wake.wait()
                if self._closed:
                    return
                job = self.jobs[self.queue.pop(0)]
                job.status = "running"
            try:
                with self.ctx_mutex:
                    if job.cancel_requested.is_set():
                        job.status = "cancelled"
                        continue
                    job.images = run_generation(self.pipeline, job.params, job=job)
                    job.status = (
                        "cancelled" if job.cancel_requested.is_set() else "completed"
                    )
            except Exception as e:  # noqa: BLE001 — job error surface
                job.error = str(e)
                job.status = "failed"


def flatten_native_params(data: dict) -> dict:
    """Flatten the native nested schema (sample_params / guidance / slg /
    hires objects) onto the flat request keys params_from_json reads.  Flat
    keys already present win (they came from the outer body)."""
    out = dict(data)
    sp = data.get("sample_params") or {}
    for k in ("scheduler", "sample_method", "sample_steps", "eta",
              "shifted_timestep", "flow_shift"):
        if k in sp and sp[k] is not None:
            out.setdefault("schedule" if k == "scheduler" else k, sp[k])
    g = sp.get("guidance")
    if not isinstance(g, dict) and isinstance(data.get("guidance"), dict):
        g = data["guidance"]
    if isinstance(g, dict):
        if g.get("txt_cfg") is not None:
            out.setdefault("cfg_scale", g["txt_cfg"])
        if g.get("img_cfg") is not None:
            out.setdefault("img_cfg_scale", g["img_cfg"])
        if g.get("distilled_guidance") is not None:
            out.setdefault("guidance", g["distilled_guidance"])
        slg = g.get("slg") or {}
        if slg.get("scale") is not None:
            out.setdefault("slg_scale", slg["scale"])
        if slg.get("layers"):
            out.setdefault("skip_layers", slg["layers"])
        if slg.get("layer_start") is not None:
            out.setdefault("slg_start", slg["layer_start"])
        if slg.get("layer_end") is not None:
            out.setdefault("slg_end", slg["layer_end"])
    hr = data.get("hires") or {}
    if hr.get("enabled"):
        out.setdefault("enable_hr", True)
        for src, dst in (("upscaler", "hr_upscaler"), ("scale", "hr_scale"),
                         ("target_width", "hr_resize_x"),
                         ("target_height", "hr_resize_y"),
                         ("steps", "hr_steps"),
                         ("denoising_strength", "denoising_strength")):
            if hr.get(src) is not None:
                out.setdefault(dst, hr[src])
    if isinstance(out.get("guidance"), dict):
        out.pop("guidance")
    return out


_EXTRA_ARGS_RE = re.compile(r"<sd_cpp_extra_args>(.*?)</sd_cpp_extra_args>", re.S)


def extract_extra_args(data: dict) -> dict:
    """Pull a ``<sd_cpp_extra_args>{json}</sd_cpp_extra_args>`` block out of
    the prompt and merge its native-schema fields over the request.  Raises
    ValueError on malformed JSON."""
    prompt = data.get("prompt", "")
    if not isinstance(prompt, str):
        return data
    m = _EXTRA_ARGS_RE.search(prompt)
    if not m:
        return data
    try:
        extra = json.loads(m.group(1))
    except json.JSONDecodeError as e:
        raise ValueError(f"invalid sd_cpp_extra_args: {e}")
    if not isinstance(extra, dict):
        raise ValueError("sd_cpp_extra_args must be a json object")
    out = dict(data)
    out["prompt"] = _EXTRA_ARGS_RE.sub("", prompt).strip()
    out.update(extra)  # native fields override the outer compat body
    return flatten_native_params(out)


def params_from_json(data: dict) -> GenerationParams:
    """Map request JSON (native/A1111 field names) onto GenerationParams."""
    data = flatten_native_params(data)
    seed = int(data.get("seed", 42))
    if seed < 0:  # A1111 convention: -1 = randomize
        import random

        seed = random.randrange(1 << 31)
    return GenerationParams(
        prompt=data.get("prompt", ""),
        negative_prompt=data.get("negative_prompt", ""),
        width=int(data.get("width", 512)),
        height=int(data.get("height", 512)),
        sample_steps=int(data.get("sample_steps", data.get("steps", 20))),
        cfg_scale=float(data.get("cfg_scale", 7.0)),
        guidance=float(data.get("guidance", 3.5)),
        seed=seed,
        batch_count=int(data.get("batch_count", data.get("batch_size", 1))),
        sample_method=str(
            data.get("sample_method", data.get("sampler_name", "euler_a"))
        ).lower().replace(" ", "_"),
        schedule=str(data.get("schedule", data.get("scheduler", "discrete"))).lower(),
        clip_skip=int(data.get("clip_skip", -1)),
        strength=float(data.get("strength", data.get("denoising_strength", 0.75))),
        eta=float(data.get("eta", 0.0)),
        slg_scale=float(data.get("slg_scale", 0.0)),
        skip_layers=tuple(data.get("skip_layers", (7, 8, 9))),
        slg_start=float(data.get("slg_start", 0.01)),
        slg_end=float(data.get("slg_end", 0.2)),
        img_cfg_scale=(float(data["img_cfg_scale"])
                       if data.get("img_cfg_scale") is not None else None),
    )


def _refuse_unported(data: dict, gp: GenerationParams, takes_refs: bool = False) -> None:
    """Raise ValueError naming the first field the port does not run;
    ``takes_refs``: the pipeline takes ``extra_images`` (a pix2pix UNet)."""
    for field, what in UNPORTED_FIELDS.items():
        if data.get(field) and not (takes_refs and field == "extra_images"):
            raise ValueError(f"request field {field!r}: {what} is not ported "
                             "(the port runs FLUX.1, SD1.x, SD2.x, SDXL and SD3 txt2img, "
                             "img2img, masked img2img and the latent hires fix, and reference "
                             "images on the instruct-pix2pix UNets)")
    hr_name = str(data.get("hr_upscaler", "Latent"))
    if data.get("enable_hr") and not hr_name.lower().startswith(LATENT_UPSCALERS):
        raise ValueError(f"hr_upscaler {hr_name!r}: ESRGAN upscalers are not ported; the port "
                         "runs the latent upscaler")
    if gp.sample_method not in PORTED_METHODS:
        raise ValueError(f"sampler {gp.sample_method!r} is not ported; "
                         f"ported: {list(PORTED_METHODS)}")
    if gp.schedule not in SCHEDULERS:
        raise ValueError(f"schedule {gp.schedule!r} is not ported; ported: {list(SCHEDULERS)}")
    if gp.slg_scale != 0.0:
        raise ValueError("skip-layer guidance (slg_scale) is not ported")


def run_generation(pipeline, data: dict, job: Optional[Job] = None):
    """One txt2img, img2img or hires request → base64 PNGs with the webui
    parameters text.  Runs on the pipeline's device whatever thread calls
    it."""
    import contextlib

    import torch

    from sdtpu_torch.config import sd_version_is_unet_edit
    from sdtpu_torch.utils.image import base64_png_to_image, build_parameters_text, image_to_base64

    data = flatten_native_params(data)
    gp = params_from_json(data)
    takes_refs = sd_version_is_unet_edit(pipeline.version)
    _refuse_unported(data, gp, takes_refs)
    out_fmt = str(data.get("output_format", "png")).lower()
    if out_fmt != "png":
        raise ValueError(f"output_format {out_fmt!r} needs Pillow, which the port does not use; "
                         "the port encodes png")
    init_image = mask_image = None
    init_b64 = data.get("init_images") or data.get("init_image")
    if isinstance(init_b64, list):
        init_b64 = init_b64[0] if init_b64 else None
    if init_b64:
        init_image = base64_png_to_image(init_b64)
    if data.get("mask"):
        mask_image = base64_png_to_image(data["mask"])[..., 0]
    kw = {}
    if takes_refs and data.get("extra_images"):  # the JAX server's A1111 reference images
        kw["ref_images"] = [base64_png_to_image(b) for b in data["extra_images"]]
    if job is not None:
        # per-step progress + mid-run cancellation
        def _progress(step, steps, _x):
            job.step, job.steps = step, steps

        kw["progress_callback"] = _progress
        kw["cancel_check"] = job.cancel_requested.is_set
    dev = pipeline.device
    ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
    with ctx:
        if data.get("enable_hr") and init_image is None:  # the JAX server's hires fix
            res = pipeline.txt2img_hires(
                gp, hires_scale=float(data.get("hr_scale", 2.0) or 2.0),
                hires_steps=int(data.get("hr_steps", 0) or 0) or None,
                hires_strength=float(data.get("denoising_strength", 0.7)),
                hires_width=int(data.get("hr_resize_x", 0) or 0),
                hires_height=int(data.get("hr_resize_y", 0) or 0))
        else:
            res = pipeline.generate(gp, init_image=init_image, mask_image=mask_image, **kw)
    out = []
    for i, img in enumerate(res.images):
        meta = build_parameters_text(GenerationParams(**{**gp.__dict__, "seed": res.seeds[i]}))
        out.append(image_to_base64(img, fmt=out_fmt, parameters=meta))
    return out


def make_handler(manager: JobManager):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print("http: " + fmt % args, file=sys.stderr)

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _not_ported(self, method: str, p: str):
            self._json({"error": f"{method} {p} is not ported (the port serves FLUX.1, "
                                  "SD1.x, SD2.x, SDXL and SD3 txt2img and img2img)"}, 501)

        def _read_json(self) -> Optional[dict]:
            """→ parsed body, or None after replying 400 to a bad payload."""
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            try:
                body = json.loads(self.rfile.read(n))
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                self._json({"error": f"invalid json: {e}"}, 400)
                return None
            if not isinstance(body, dict):
                self._json({"error": "request body must be a json object"}, 400)
                return None
            return body

        def _generate(self, data: dict):
            """A synchronous request → its images, or None after a 400."""
            try:
                data = extract_extra_args(data)
                with manager.ctx_mutex:
                    return run_generation(manager.pipeline, data)
            except ValueError as e:
                self._json({"error": str(e)}, 400)
                return None

        # ----------------------------------------------------------- GET
        def do_GET(self):
            p = self.path.split("?")[0]
            if p == "/sdcpp/v1/capabilities":
                self._json({"modes": ["img_gen"], "samplers": list(PORTED_METHODS),
                            "schedulers": list(SCHEDULERS), "version": "sdtpu_torch-0.1"})
            elif p.startswith("/sdcpp/v1/jobs/"):
                job = manager.jobs.get(p.rsplit("/", 1)[-1])
                if job is None:
                    self._json({"error": "not found"}, 404)
                    return
                out = {"id": job.id, "status": job.status, "error": job.error,
                       "progress": job.progress, "step": job.step, "steps": job.steps}
                if job.status == "completed":
                    out["images"] = job.images
                self._json(out)
            elif p == "/sdapi/v1/samplers":
                self._json([{"name": s, "aliases": [s], "options": {}} for s in PORTED_METHODS])
            elif p == "/sdapi/v1/schedulers":
                self._json([{"name": s, "label": s} for s in SCHEDULERS])
            elif p == "/sdapi/v1/sd-models":
                self._json([{"title": "loaded", "model_name": "loaded"}])
            elif p == "/sdapi/v1/options":
                self._json(dict(manager.options))
            elif p == "/sdapi/v1/progress":
                running = [j for j in manager.jobs.values() if j.status == "running"]
                j = running[0] if running else None
                self._json({"progress": j.progress if j else 0.0,
                            "state": ({"sampling_step": j.step, "sampling_steps": j.steps}
                                      if j else {})})
            elif p == "/v1/models":
                self._json({"object": "list", "data": [{"id": "sdtpu", "object": "model"}]})
            else:
                self._not_ported("GET", p)

        # ---------------------------------------------------------- POST
        def do_POST(self):
            p = self.path.split("?")[0]
            if p == "/sdcpp/v1/img_gen":
                data = self._read_json()
                if data is None:
                    return
                job = manager.submit(data)
                self._json({"id": job.id, "status": job.status}, 202)
            elif p.startswith("/sdcpp/v1/jobs/") and p.endswith("/cancel"):
                ok = manager.cancel(p.split("/")[-2])
                self._json({"cancelled": ok}, 200 if ok else 404)
            elif p == "/sdapi/v1/options":
                data = self._read_json()
                if data is None:
                    return
                manager.options.update(data)
                self._json({})
            elif p in ("/sdapi/v1/txt2img", "/sdapi/v1/img2img"):
                data = self._read_json()
                if data is None:
                    return
                images = self._generate(data)
                if images is not None:
                    self._json({"images": images, "parameters": data, "info": "{}"})
            elif p == "/v1/images/generations":
                data = self._read_json()
                if data is None:
                    return
                req = {
                    "prompt": data.get("prompt", ""),
                    "batch_count": int(data.get("n", 1)),
                    "output_format": data.get("output_format", "png"),
                    "output_compression": data.get("output_compression", 90),
                }
                size = data.get("size", "512x512")
                if "x" in str(size):
                    w, h = str(size).split("x")
                    req["width"], req["height"] = int(w), int(h)
                images = self._generate(req)
                if images is not None:
                    self._json({"created": int(time.time()),
                                "output_format": req.get("output_format", "png"),
                                "data": [{"b64_json": b64} for b64 in images]})
            else:
                self._not_ported("POST", p)

    return Handler


def make_server(pipeline, host: str = "127.0.0.1", port: int = 7860) -> ThreadingHTTPServer:
    """→ the HTTP server, bound and not yet serving, its JobManager as
    ``.manager``."""
    manager = JobManager(pipeline)
    server = ThreadingHTTPServer((host, port), make_handler(manager))
    server.manager = manager
    return server


def serve(pipeline, host: str = "127.0.0.1", port: int = 7860, ready=None) -> None:
    """Serve until ``shutdown()``; ``ready(server)`` runs once it is bound."""
    server = make_server(pipeline, host, port)
    print(f"sdtpu_torch server listening on http://{host}:{server.server_address[1]}",
          flush=True)
    if ready is not None:
        ready(server)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        server.manager.close()


def build_parser():
    from sdtpu_torch.cli import build_parser as build_cli_parser

    ap = build_cli_parser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--upscaler-dir", default="",
                    help="dir listed by /sdapi/v1/upscalers")
    return ap


def main(argv=None, report: Optional[dict] = None, ready=None) -> int:
    """Load the pipeline from the CLI's file flags and serve it; ``report``
    gets the load's seconds (``sdtpu_torch.cli.main``'s), ``ready(server)``
    runs once the server is bound (``server.shutdown()`` ends ``main``)."""
    from sdtpu_torch.cli import RUN_FLAGS, _load_pipeline, unported

    parser = build_parser()
    args = parser.parse_args(argv)
    why = unported(args, parser, RUN_FLAGS | {"host", "port"})
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    pipe = _load_pipeline(args, report)
    if pipe.version.value == "wan2":
        print("error: a Wan2.1 model: the server's video generation (video_frames, answered with "
              "an animated WebP) is not ported; run python -m sdtpu_torch.cli -M vid_gen",
              file=sys.stderr)
        return 2
    serve(pipe, args.host, args.port, ready=ready)
    return 0


if __name__ == "__main__":
    sys.exit(main())
