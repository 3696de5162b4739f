"""Small FLUX, SD1, SDXL and SD3 checkpoint files for the port's entry-point
tests.

The weights are the JAX package's small FLUX pipeline (``create_pipeline(
SDVersion.FLUX, small=True, seed=0)``), written as a user's file set: the DiT
as a q8_0 GGUF, CLIP-L as safetensors, T5 as a q8_0 GGUF under llama.cpp
names with a unigram vocab embedded as ``tokenizer.ggml.*``, and the VAE
(encoder included) as safetensors; the vocab and the llama.cpp names are
``sdtpu_torch.tools.flux_files``'s.  ``small_configs`` swaps the full-size
configs the CLIs load with for the small ones, in both packages.  The SD1
file is the JAX package's small SD1 pipeline as one float16 safetensors
under the LDM names; ``small_sd1_configs`` swaps SD1's full-size configs.
The SDXL file is the JAX package's small SDXL pipeline as one float16
safetensors under the SGM names, CLIP-G under OpenCLIP's (the fused
``in_proj``, ``text_projection`` as [width, proj]); the TAESD-XL file the
decoder of ``init_tae_params(TAESD_XL_CONFIG, seed=5)`` under the raw
``taesd`` names (the Clamp at decoder index 0); ``small_sdxl_configs``
swaps SDXL's full-size configs.  The SD3 set is the JAX package's small SD3
pipeline as an SD3.5 user's files: the MMDiT and the VAE in one float16
single file, CLIP-L and CLIP-G float16 under HF names, T5 as a q8_0 GGUF
with its vocab; ``small_sd3_configs`` swaps SD3's full-size configs.  The
Wan set is the JAX package's small Wan2.1 T2V pipeline as a Wan user's
files: the DiT and the VAE as float16 safetensors under their original
names, UMT5 as a q8_0 GGUF under llama.cpp names with its vocab;
``small_wan_configs`` swaps Wan's full-size configs.  The SD2.x,
inpainting and instruct-pix2pix files are the JAX package's small pipelines
of those versions as single files under the LDM names, SD2's text tower
under OpenCLIP's (``cond_stage_model.model.``, one resblock more than the
config reads and a square ``text_projection``, as SD2.x files hold them);
``small_unet_family_configs`` swaps the SD1 and SD2 UNets', CLIP-L's,
CLIP-H's and the SD VAE's full-size configs.
"""
import dataclasses
import struct

import numpy as np

import sdtpu.config as jconfig
from sdtpu.factory import create_pipeline as jax_create_pipeline
from sdtpu.io.gguf import save_gguf
from sdtpu.io.safetensors import save_safetensors
from sdtpu_torch.tools.flux_files import gguf_t5_name, synthetic_t5_vocab


def spiece_model_bytes(md: dict) -> bytes:
    """The vocab of GGUF ``tokenizer.ggml.*`` metadata ``md`` as a
    SentencePiece ModelProto holding only its pieces (field 1)."""
    def varint(v):
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    blob = bytearray()
    for piece, score, t in zip(md["tokenizer.ggml.tokens"], md["tokenizer.ggml.scores"],
                               md["tokenizer.ggml.token_type"]):
        raw = piece.encode("utf-8")
        sp = b"\x0a" + varint(len(raw)) + raw + b"\x15" + struct.pack("<f", score)
        sp += b"\x18" + varint(t)
        blob += b"\x0a" + varint(len(sp)) + sp
    return bytes(blob)


def small_jax_pipeline():
    return jax_create_pipeline(jconfig.SDVersion.FLUX, small=True, seed=0)


def write_small_flux_files(directory, jp=None) -> dict:
    """The small pipeline's weights as a FLUX file set → {flag: path}."""
    jp = jp or small_jax_pipeline()
    d = str(directory)
    host = lambda p: {k: np.asarray(v, dtype=np.float32) for k, v in p.items()}  # noqa: E731
    paths = {"diffusion_model": f"{d}/flux_small_q8_0.gguf", "clip_l": f"{d}/clip_l.safetensors",
             "t5xxl": f"{d}/t5_small_q8_0.gguf", "vae": f"{d}/ae.safetensors"}
    save_gguf(paths["diffusion_model"], host(jp.diffusion_params), out_type="q8_0")
    save_safetensors(paths["clip_l"], host(jp.conditioner.pl))
    save_gguf(paths["t5xxl"], {gguf_t5_name(k): v for k, v in host(jp.conditioner.pt).items()},
              out_type="q8_0", metadata=synthetic_t5_vocab(256))
    save_safetensors(paths["vae"], host(jp.vae_params))
    return paths


def small_configs(monkeypatch):
    """Swap the four full-size configs both CLIs load FLUX with for the small
    FLUX configs of both factories."""
    import sdtpu.models.clip as jclip
    import sdtpu.models.flux as jflux
    import sdtpu.models.t5 as jt5
    import sdtpu.models.vae as jvae
    import sdtpu_torch.models.clip as tclip
    import sdtpu_torch.models.flux as tflux
    import sdtpu_torch.models.t5 as tt5
    import sdtpu_torch.models.vae as tvae
    from sdtpu_torch.factory import flux_configs

    dit, clip, t5, vae, _ = flux_configs(small=True)
    for (tmod, jmod), name, small in (((tflux, jflux), "FLUX_DEV_CONFIG", dit),
                                      ((tclip, jclip), "CLIP_L_CONFIG", clip),
                                      ((tt5, jt5), "T5_XXL_CONFIG", t5),
                                      ((tvae, jvae), "FLUX_VAE_CONFIG", vae)):
        monkeypatch.setattr(tmod, name, small)
        monkeypatch.setattr(jmod, name, type(getattr(jmod, name))(**dataclasses.asdict(small)))


def small_sd1_pipeline():
    return jax_create_pipeline(jconfig.SDVersion.SD1, small=True, seed=0)


def write_small_sd1_file(directory, jp=None) -> str:
    """The small SD1 pipeline's weights as one single-file checkpoint under
    the LDM names (``model.diffusion_model.``, ``cond_stage_model.transformer.``,
    ``first_stage_model.``), float16 as SD1.5 files ship → its path."""
    jp = jp or small_sd1_pipeline()
    path = f"{directory}/sd15_small.safetensors"
    host = {}
    for prefix, params in (("model.diffusion_model.", jp.diffusion_params),
                           ("cond_stage_model.transformer.", jp.conditioner.params),
                           ("first_stage_model.", jp.vae_params)):
        host.update({prefix + k: np.asarray(v, dtype=np.float16) for k, v in params.items()})
    save_safetensors(path, host)
    return path


def small_sd1_configs(monkeypatch):
    """Swap the three full-size configs both CLIs load SD1 with for the
    small SD1 configs of both factories."""
    import sdtpu.models.clip as jclip
    import sdtpu.models.unet as junet
    import sdtpu.models.vae as jvae
    import sdtpu_torch.models.clip as tclip
    import sdtpu_torch.models.unet as tunet
    import sdtpu_torch.models.vae as tvae
    from sdtpu_torch.factory import sd1_configs

    unet, clip, vae = sd1_configs(small=True)
    for (tmod, jmod), name, small in (((tunet, junet), "SD1_UNET_CONFIG", unet),
                                      ((tclip, jclip), "CLIP_L_CONFIG", clip),
                                      ((tvae, jvae), "SD_VAE_CONFIG", vae)):
        monkeypatch.setattr(tmod, name, small)
        monkeypatch.setattr(jmod, name, type(getattr(jmod, name))(**dataclasses.asdict(small)))


def write_small_unet_file(directory, jp, name: str) -> str:
    """A small SD1.x / SD2.x pipeline of any stem as one float16 single file
    under the LDM names (SD2's text tower under OpenCLIP's, with an extra
    resblock and a square projection) → its path."""
    path = f"{directory}/{name}_small.safetensors"
    text = dict(jp.conditioner.params)
    if jp.conditioner.is_sd2:
        layers = "text_model.encoder.layers."
        n = 1 + max(int(k.split(".")[3]) for k in text if k.startswith(layers))
        text.update({k.replace("layers.0.", f"layers.{n}."): v for k, v in text.items()
                     if k.startswith("text_model.encoder.layers.0.")})
        width = text["text_model.final_layer_norm.weight"].shape[0]
        text["text_projection.weight"] = np.eye(width, dtype=np.float32)
        text_prefix, text = "cond_stage_model.model.", to_open_clip(text)
    else:
        text_prefix = "cond_stage_model.transformer."
    host = {}
    for prefix, params in (("model.diffusion_model.", jp.diffusion_params), (text_prefix, text),
                           ("first_stage_model.", jp.vae_params)):
        host.update({prefix + k: np.asarray(v, dtype=np.float16) for k, v in params.items()})
    save_safetensors(path, host)
    return path


def small_unet_family_configs(monkeypatch):
    """Swap the full-size configs both CLIs load SD1.x and SD2.x with (their
    inpainting stems too) for the small ones of both factories: the small
    SD1 UNet, its CLIP-L (SD2's text tower too) and its VAE."""
    import sdtpu.models.clip as jclip
    import sdtpu.models.unet as junet
    import sdtpu.models.vae as jvae
    import sdtpu_torch.models.clip as tclip
    import sdtpu_torch.models.unet as tunet
    import sdtpu_torch.models.vae as tvae
    from sdtpu_torch.factory import sd1_configs

    unet, clip, vae = sd1_configs(small=True)
    inpaint = dataclasses.replace(unet, in_channels=9)
    for (tmod, jmod), name, small in (((tunet, junet), "SD1_UNET_CONFIG", unet),
                                      ((tunet, junet), "SD2_UNET_CONFIG", unet),
                                      ((tunet, junet), "SD1_INPAINT_UNET_CONFIG", inpaint),
                                      ((tunet, junet), "SD2_INPAINT_UNET_CONFIG", inpaint),
                                      ((tclip, jclip), "CLIP_L_CONFIG", clip),
                                      ((tclip, jclip), "CLIP_H_CONFIG", clip),
                                      ((tvae, jvae), "SD_VAE_CONFIG", vae)):
        monkeypatch.setattr(tmod, name, small)
        monkeypatch.setattr(jmod, name, type(getattr(jmod, name))(**dataclasses.asdict(small)))


def write_init_and_mask(directory):
    """An RGBA init image and a grey mask (the right half regenerates) as
    Pillow writes them → (init path, mask path)."""
    from PIL import Image

    rng = np.random.default_rng(12)
    rgba = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
    mask = np.zeros((64, 64), dtype=np.uint8)
    mask[:, 32:] = 255
    init, m = str(directory / "init.png"), str(directory / "mask.png")
    Image.fromarray(rgba, mode="RGBA").save(init)
    Image.fromarray(mask, mode="L").save(m)
    return init, m


def small_sdxl_pipeline():
    return jax_create_pipeline(jconfig.SDVersion.SDXL, small=True, seed=0)


def to_open_clip(params: dict) -> dict:
    """A CLIP text tower under HF names → OpenCLIP's names: q, k and v fused
    into ``in_proj``, the projection as [width, proj]."""
    out = {}
    fixed = {"text_model.embeddings.token_embedding.weight": "token_embedding.weight",
             "text_model.embeddings.position_embedding.weight": "positional_embedding",
             "text_model.final_layer_norm.weight": "ln_final.weight",
             "text_model.final_layer_norm.bias": "ln_final.bias"}
    sub = {"layer_norm1": "ln_1", "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc",
           "mlp.fc2": "mlp.c_proj", "self_attn.out_proj": "attn.out_proj"}
    for k, v in params.items():
        v = np.asarray(v, dtype=np.float32)
        if k in fixed:
            out[fixed[k]] = v
        elif k == "text_projection.weight":
            out["text_projection"] = np.ascontiguousarray(v.T)
        elif ".self_attn.q_proj." in k:
            i, kind = k.split(".")[3], k.rsplit(".", 1)[1]
            parts = [np.asarray(params[k.replace("q_proj", p)], np.float32)
                     for p in ("q_proj", "k_proj", "v_proj")]
            out[f"transformer.resblocks.{i}.attn.in_proj_{kind}"] = np.concatenate(parts, axis=0)
        elif ".self_attn.k_proj." in k or ".self_attn.v_proj." in k:
            continue
        else:
            i, rest = k.split(".")[3], k.split(".", 4)[4]
            for a, b in sub.items():
                if rest.startswith(a + "."):
                    rest = b + rest[len(a):]
            out[f"transformer.resblocks.{i}.{rest}"] = v
    return out


def write_small_sdxl_file(directory, jp=None) -> str:
    """The small SDXL pipeline's weights as one single-file checkpoint under
    the SGM names, float16 → its path."""
    jp = jp or small_sdxl_pipeline()
    path = f"{directory}/sdxl_small.safetensors"
    host = {}
    for prefix, params in (("model.diffusion_model.", jp.diffusion_params),
                           ("conditioner.embedders.0.transformer.", jp.conditioner.pl),
                           ("conditioner.embedders.1.model.", to_open_clip(jp.conditioner.pg)),
                           ("first_stage_model.", jp.vae_params)):
        host.update({prefix + k: np.asarray(v, dtype=np.float16) for k, v in params.items()})
    save_safetensors(path, host)
    return path


def small_tae_params():
    from sdtpu.models import tae as jtae

    p = jtae.init_tae_params(jtae.TAESD_XL_CONFIG, seed=5)
    return {k: v for k, v in p.items() if k.startswith("decoder.")}


def write_small_tae_file(directory) -> str:
    """TAESD-XL's decoder under the raw names (index + 1), float16 → its path."""
    path = f"{directory}/taesdxl_small.safetensors"
    host = {}
    for k, v in small_tae_params().items():
        _, _, idx, rest = k.split(".", 3)
        host[f"decoder.{int(idx) + 1}.{rest}"] = np.asarray(v, dtype=np.float16)
    save_safetensors(path, host)
    return path


def small_sdxl_configs(monkeypatch):
    """Swap the four full-size configs both CLIs load SDXL with for the
    small SDXL configs of both factories."""
    import sdtpu.models.clip as jclip
    import sdtpu.models.unet as junet
    import sdtpu.models.vae as jvae
    import sdtpu_torch.models.clip as tclip
    import sdtpu_torch.models.unet as tunet
    import sdtpu_torch.models.vae as tvae
    from sdtpu_torch.factory import sdxl_configs

    unet, clip_l, clip_g, vae = sdxl_configs(small=True)
    for (tmod, jmod), name, small in (((tunet, junet), "SDXL_UNET_CONFIG", unet),
                                      ((tclip, jclip), "CLIP_L_CONFIG", clip_l),
                                      ((tclip, jclip), "CLIP_G_CONFIG", clip_g),
                                      ((tvae, jvae), "SDXL_VAE_CONFIG", vae)):
        monkeypatch.setattr(tmod, name, small)
        monkeypatch.setattr(jmod, name, type(getattr(jmod, name))(**dataclasses.asdict(small)))


def small_sd3_pipeline():
    return jax_create_pipeline(jconfig.SDVersion.SD3, small=True, seed=0)


def write_small_sd3_files(directory, jp=None) -> dict:
    """The small SD3 pipeline's weights as an SD3.5 file set → {key: path}:
    the MMDiT and the VAE in one float16 single file (``model.diffusion_model.``,
    ``first_stage_model.``), CLIP-L and CLIP-G as float16 safetensors under HF
    names, T5 as a q8_0 GGUF under llama.cpp names with a unigram vocab."""
    jp = jp or small_sd3_pipeline()
    d = str(directory)
    paths = {"model": f"{d}/sd3_small.safetensors", "clip_l": f"{d}/clip_l.safetensors",
             "clip_g": f"{d}/clip_g.safetensors", "t5xxl": f"{d}/t5_small_q8_0.gguf"}
    host = {}
    for prefix, params in (("model.diffusion_model.", jp.diffusion_params),
                           ("first_stage_model.", jp.vae_params)):
        host.update({prefix + k: np.asarray(v, dtype=np.float16) for k, v in params.items()})
    save_safetensors(paths["model"], host)
    for key, params in (("clip_l", jp.conditioner.pl), ("clip_g", jp.conditioner.pg)):
        save_safetensors(paths[key], {k: np.asarray(v, dtype=np.float16) for k, v in params.items()})
    save_gguf(paths["t5xxl"], {gguf_t5_name(k): np.asarray(v, dtype=np.float32)
                               for k, v in jp.conditioner.pt.items()},
              out_type="q8_0", metadata=synthetic_t5_vocab(256))
    return paths


def small_sd3_configs(monkeypatch):
    """Swap the full-size configs both CLIs load SD3 with (CLIP-L, CLIP-G,
    the SD3 VAE; the MMDiT and T5 configs come from the weights) for the
    small SD3 configs of both factories; and, for the port's
    ``tools/sd3_file.py``, SD3.5-Medium's MMDiT and T5-XXL for small ones
    (the MMDiT with qk RMS norms and one MMDiT-X block, its vector as wide
    as the file's pooled CLIP-L (768) and CLIP-G outputs)."""
    import sdtpu.models.clip as jclip
    import sdtpu.models.vae as jvae
    import sdtpu_torch.models.clip as tclip
    import sdtpu_torch.models.mmdit as tmmdit
    import sdtpu_torch.models.t5 as tt5
    import sdtpu_torch.models.vae as tvae
    from sdtpu_torch.factory import sd3_configs

    dit, clip_l, clip_g, t5, vae = sd3_configs(small=True)
    for (tmod, jmod), name, small in (((tclip, jclip), "CLIP_L_CONFIG", clip_l),
                                      ((tclip, jclip), "CLIP_G_CONFIG", clip_g),
                                      ((tvae, jvae), "SD3_VAE_CONFIG", vae)):
        monkeypatch.setattr(tmod, name, small)
        monkeypatch.setattr(jmod, name, type(getattr(jmod, name))(**dataclasses.asdict(small)))
    monkeypatch.setattr(tmmdit, "SD35_MEDIUM_CONFIG", dataclasses.replace(
        dit, qk_norm="rms", num_x_self_attn_layers=1, adm_in_channels=768 + clip_g.projection_dim))
    monkeypatch.setattr(tt5, "T5_XXL_CONFIG", t5)


def small_wan_pipeline():
    return jax_create_pipeline(jconfig.SDVersion.WAN2, small=True, seed=0)


def write_small_wan_files(directory, jp=None) -> dict:
    """The small Wan pipeline's weights as a Wan file set → {CLI flag: path}:
    the DiT and the VAE as float16 safetensors (original names), UMT5 as a
    q8_0 GGUF under llama.cpp names with a unigram vocab."""
    jp = jp or small_wan_pipeline()
    d = str(directory)
    paths = {"diffusion_model": f"{d}/wan_small.safetensors", "vae": f"{d}/wan_vae_small.safetensors",
             "t5xxl": f"{d}/umt5_small_q8_0.gguf"}
    for key, params in (("diffusion_model", jp.diffusion_params), ("vae", jp.vae_params)):
        save_safetensors(paths[key], {k: np.asarray(v, dtype=np.float16) for k, v in params.items()})
    save_gguf(paths["t5xxl"], {gguf_t5_name(k): np.asarray(v, dtype=np.float32)
                               for k, v in jp.conditioner.pt.items()},
              out_type="q8_0", metadata=synthetic_t5_vocab(256))
    return paths


def small_wan_configs(monkeypatch):
    """Swap the full-size Wan configs for the small ones of both factories:
    the DiT's base config (both packages fingerprint a given DiT from it:
    its width is under the 128-wide heads' rule), and, for the port's
    ``tools/wan_file.py``, UMT5-XXL and the Wan VAE (the loaders read those
    two from the weights)."""
    import sdtpu.models.wan as jwan
    import sdtpu_torch.models.t5 as tt5
    import sdtpu_torch.models.wan as twan
    import sdtpu_torch.models.wan_vae as twv
    from sdtpu_torch.factory import wan_configs

    dit, t5, vae, _ = wan_configs(small=True)
    monkeypatch.setattr(twan, "WAN21_T2V_1_3B_CONFIG", dit)
    monkeypatch.setattr(jwan, "WAN21_T2V_1_3B_CONFIG", jwan.WanConfig(**dataclasses.asdict(dit)))
    monkeypatch.setattr(tt5, "UMT5_XXL_CONFIG", t5)
    monkeypatch.setattr(twv, "WAN21_VAE_CONFIG", vae)
