"""FLUX, SD1.x, SD2.x, SDXL (and their tiny distills), SD3, Wan2.1 T2V,
Z-Image and Qwen-Image checkpoint files → per-module param dicts (this
package's copy of those families' parts of ``sdtpu.io.model_loader``:
``load_model_bundle``, ``split_modules``, ``_split_in_proj``,
``read_checkpoint_file``, ``maybe_convert_diffusers_wan_vae``,
``_resolve_upsample_markers``, ``load_controlnet``, with the parts of
``sdtpu/io/detect.py`` they use; the name rules live in
``io.name_conversion``).

Read N GGUF, safetensors or torch ``.ckpt`` / ``.pt`` files (the last
through ``io.torch_ckpt``'s restricted unpickler) under their per-file
prefixes (a full
checkpoint, the diffusion model, CLIP-L, T5-XXL, the VAE), convert
diffusers FLUX and SD3 names to the internal double/single-block and
joint-block names (split q/k/v merged back into the fused weights),
canonicalize diffusers UNet names (a diffusers folder's
``UNet2DConditionModel``, its upsamplers placed after the block's
attention where it has one) and diffusers VAE names, convert a diffusers
Wan VAE (``AutoencoderKLWan``) to its original names, map llama.cpp GGUF
T5 names to HF ones, fingerprint the version and
split the names into the modules' own.  Only the diffusion file keeps its
GGUF blocks for the device (``keep_quant``); a quantized text-encoder or
VAE file's 2-D tensors come back as ``HostQuant`` too, but only so each is
dequantized on the host when it is staged, one at a time: by value they
are the float32 arrays the JAX loader returns.  A single-file SD1.x
checkpoint splits by its LDM prefixes (``model.diffusion_model.``,
``cond_stage_model.transformer.``, ``first_stage_model.``), an SD2.x one
likewise with its OpenCLIP-H text tower under ``cond_stage_model.model.``
(renamed to HF names as CLIP-G's below; all 24 layers are kept, the
23-layer config reads the first 23); a single-file
SDXL checkpoint by its SGM prefixes (``conditioner.embedders.0.transformer.``
→ CLIP-L, ``conditioner.embedders.1.model.`` → CLIP-G under OpenCLIP names,
renamed to HF ones, the fused ``in_proj`` split into q / k / v, the
``text_projection`` transposed).  An SD3 / SD3.5 file (``joint_blocks``)
splits by ``model.diffusion_model.``, ``first_stage_model.`` and
``text_encoders.{clip_l,clip_g,t5xxl}.transformer.``; CLIP-G's
``text_projection`` is transposed whichever file it came from, CLIP-L's
kept, as the JAX loader leaves them.  A Wan2.1 DiT (``blocks.N.cross_attn``,
``patch_embedding``) comes as ``--diffusion-model``, its VAE as ``--vae``
and UMT5-XXL as ``--t5xxl`` (HF or llama.cpp GGUF names, its per-layer
relative bias included).  The UNet families' inpainting (a 9-channel
stem) and instruct-pix2pix (8) variants load as SD1.x, SD2.x and SDXL do;
the tiny UNets (no middle block: SD1 tiny, SDXS-512-DS, SD2 tiny and
SDXS-0.9, told apart as the JAX fingerprint does) too.  ``load_controlnet``
reads a ControlNet file under CompVis or diffusers names.
A Z-Image DiT (``cap_embedder``, under its original or diffusers Lumina-2
names) comes as ``--diffusion-model``, its FLUX VAE as ``--vae`` and its
Qwen3 text encoder as ``--llm`` (``text_encoders.llm.``: HF names, or
llama.cpp GGUF names mapped to HF ones; a vision tower is refused).
A Qwen-Image DiT (``transformer_blocks.N.img_mod.1``) comes as
``--diffusion-model``, its Wan 2.1 VAE (encoder included) as ``--vae`` and
its Qwen2.5-VL text encoder as ``--llm`` (HF or llama.cpp GGUF names, the
q / k / v biases included); the LLM file's vision tower (``model.visual.``,
``visual.``, GGUF ``v.`` / ``mm.``) is counted in
``ModelBundle.vision_tensors`` and dropped for Qwen-Image (nothing in the
port runs it), and refused for any other family.  Mage-Flow (``img_in`` 128 wide) and the layered Qwen-Image
(``addition_t_embedding``) fingerprint as themselves and are refused.
Any family but FLUX, those in ``UNET_VERSIONS``, SD3, Wan2.1 T2V, Z-Image
and Qwen-Image raises ``NotImplementedError`` naming it (SDXL's SSD-1B
too, which the JAX package fingerprints but cannot run, Wan2.2 I2V and
TI2V, a Wan VACE or I2V DiT, a Wan DiT under diffusers names, and the
diffusers DiTs of families the port does not run).
"""
from __future__ import annotations

import dataclasses
import os
import re
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from sdtpu_torch.config import SDVersion
from sdtpu_torch.io.gguf import load_gguf
from sdtpu_torch.io.name_conversion import (  # noqa: F401 (convert_diffusers_vae_name: re-exported)
    canonicalize_name, convert_diffusers_controlnet_name, convert_diffusers_flux_name,
    convert_diffusers_lumina2_name, convert_diffusers_sd3_name, convert_diffusers_vae_name,
    convert_diffusers_wan_vae_name, convert_gguf_llm_name, convert_gguf_t5_name, convert_open_clip_name)
from sdtpu_torch.io.safetensors import load_safetensors
from sdtpu_torch.io.torch_ckpt import load_torch_checkpoint

DIFFUSION_PREFIX = "model.diffusion_model."


@dataclasses.dataclass
class ModelBundle:
    version: SDVersion
    diffusion: Dict[str, np.ndarray]
    clip_l: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    clip_g: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    t5: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    vae: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    llm: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    vision_tensors: int = 0  # an LLM file's vision tower, dropped (Qwen-Image-Edit's)


def read_checkpoint_file(path: str, keep_quant: bool = False) -> Dict[str, np.ndarray]:
    """A .gguf, .safetensors (or HF index.json) or torch .ckpt / .pt / .pth /
    .bin file → {name: array}; with ``keep_quant``, quantized 2-D GGUF
    tensors come back as ``HostQuant``.  Torch files go through the
    restricted unpickler of ``io.torch_ckpt``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".safetensors" or path.endswith(".index.json"):
        return load_safetensors(path)
    if ext == ".gguf":
        return load_gguf(path, keep_quant=keep_quant)
    if ext in (".ckpt", ".pt", ".pth", ".bin"):
        return load_torch_checkpoint(path)
    raise NotImplementedError(f"{path}: the port reads GGUF, safetensors and torch "
                              ".ckpt / .pt / .pth / .bin checkpoints")


def _merge_fused_markers(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Concatenate '<name>.weight.N' merge markers (diffusers split q/k/v →
    the internal fused qkv / linear1)."""
    marker = re.compile(r"^(.*\.(?:weight|bias))\.([123])$")
    groups: Dict[str, Dict[int, np.ndarray]] = {}
    for k in list(tensors):
        m = marker.match(k)
        if m:
            groups.setdefault(m.group(1), {})[int(m.group(2))] = tensors.pop(k)
    for base, parts in groups.items():
        if base in tensors:
            arrs = [np.asarray(tensors.pop(base))]
            arrs += [np.asarray(parts[i]) for i in sorted(parts)]
            tensors[base] = np.concatenate(arrs, axis=0)
        else:  # incomplete set — put the pieces back untouched
            for i, v in parts.items():
                tensors[f"{base}.{i}"] = v
    return tensors


def convert_diffusers_diffusion_names(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A diffusers-format FLUX, SD3 or Lumina-2 / Z-Image DiT → internal
    names (Z-Image's own names pass through the Lumina-2 rules unchanged),
    dispatched as the JAX loader does; a diffusers Wan transformer and the
    diffusers DiTs of families the port does not run raise, internal names
    (and a diffusers UNet's, which ``canonicalize_name`` maps) pass
    through."""
    def has_prefix(p):
        return any(k.startswith(p) for k in tensors)

    if has_prefix("condition_embedder."):
        raise NotImplementedError("a diffusers Wan transformer (WanTransformer3DModel names): the "
                                  "port loads Wan under its original names (blocks.N.self_attn)")
    if (any("img_attn_qkv" in k or "img_mod.linear." in k for k in tensors)
            or has_prefix("time_mod_proj.") or has_prefix("text_fusion.")):
        raise NotImplementedError("a diffusers DiT other than FLUX, SD3 and Z-Image: the port "
                                  "loads those three under diffusers names")
    conv = None
    if has_prefix("single_transformer_blocks."):
        conv = convert_diffusers_flux_name
    elif has_prefix("pos_embed.proj."):
        conv = convert_diffusers_sd3_name
    elif has_prefix("transformer_blocks.") and has_prefix("context_embedder."):
        conv = convert_diffusers_flux_name
    elif has_prefix("all_x_embedder.2-1.") or has_prefix("noise_refiner."):
        conv = convert_diffusers_lumina2_name
    if conv is None:
        return tensors
    out: Dict[str, np.ndarray] = {}
    for k, v in tensors.items():
        nk = conv(k)
        out[nk if nk is not None else k] = v
    return _merge_fused_markers(out)


def maybe_convert_diffusers_wan_vae(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A diffusers AutoencoderKLWan (flat ``encoder.down_blocks.0..10``) →
    the Wan VAE's original names; any other VAE passes through.  The
    layout is told by the encoder's down blocks holding no ``resnets`` (an
    SD VAE's do).  The JAX loader looks for ``resnets`` anywhere in the
    encoder, which also finds the Wan encoder's own middle block
    (``encoder.mid_block.resnets.N``), so it never converts such a file."""
    if any(k.startswith("encoder.down_blocks.4.") for k in tensors) and not any(
            k.startswith("encoder.down_blocks.") and ".resnets." in k for k in tensors):
        return {convert_diffusers_wan_vae_name(k): v for k, v in tensors.items()}
    return tensors


def _resolve_upsample_markers(diffusion: Dict[str, np.ndarray]) -> None:
    """diffusers UNet upsamplers land at ``.__up__.``; the CompVis sub-index
    is 1 where the output block has no attention, else 2."""
    for name in [n for n in diffusion if ".__up__." in n]:
        arr = diffusion.pop(name)
        blk = name.split(".__up__.")[0]  # e.g. output_blocks.2
        has_attn = any(k.startswith(blk + ".1.transformer_blocks") for k in diffusion)
        diffusion[name.replace(".__up__.", f".{2 if has_attn else 1}.")] = arr


def load_controlnet(path: str) -> Dict[str, np.ndarray]:
    """A ControlNet file (CompVis ``control_model.*`` names, their bare
    form, or diffusers ControlNetModel names) → the module-local dict
    ``models.controlnet`` reads, as the JAX ``load_controlnet`` builds it.
    A tensor no rule maps is dropped with a warning, as there."""
    out: Dict[str, np.ndarray] = {}
    for k, v in read_checkpoint_file(path).items():
        if k.startswith("control_model."):
            out[k[len("control_model."):]] = v
        elif k.startswith(("input_blocks.", "zero_convs.", "middle_block", "input_hint_block.",
                           "time_embed.", "label_emb.")):
            out[k] = v
        else:
            cv = convert_diffusers_controlnet_name(k)
            if cv is not None:
                out[cv] = v
            else:
                warnings.warn(f"controlnet: unmapped tensor {k}")
    return out


# the UNet versions the port runs: SD1.x, SD2.x and SDXL, their inpainting
# and instruct-pix2pix stems, and the tiny distills (SD1 / SD2 tiny, SDXS)
UNET_VERSIONS = (SDVersion.SD1, SDVersion.SD1_INPAINT, SDVersion.SD1_PIX2PIX, SDVersion.SD2,
                 SDVersion.SD2_INPAINT, SDVersion.SDXL, SDVersion.SDXL_INPAINT,
                 SDVersion.SDXL_PIX2PIX, SDVersion.SD1_TINY_UNET, SDVersion.SDXS_512_DS,
                 SDVersion.SD2_TINY_UNET, SDVersion.SDXS_09)
# the families the port runs (``load_model_bundle`` and ``create_pipeline``
# refuse every other by name)
PORTED_VERSIONS = (SDVersion.FLUX, *UNET_VERSIONS, SDVersion.SD3, SDVersion.WAN2,
                   SDVersion.Z_IMAGE, SDVersion.QWEN_IMAGE)
# the family each ported version belongs to, as messages name it
FAMILY_NAMES = {SDVersion.FLUX: "FLUX.1", SDVersion.SD1: "SD1.x", SDVersion.SD1_INPAINT: "SD1.x",
                SDVersion.SD1_PIX2PIX: "SD1.x", SDVersion.SD2: "SD2.x",
                SDVersion.SD2_INPAINT: "SD2.x", SDVersion.SDXL: "SDXL",
                SDVersion.SDXL_INPAINT: "SDXL", SDVersion.SDXL_PIX2PIX: "SDXL",
                SDVersion.SD1_TINY_UNET: "SD1.x", SDVersion.SDXS_512_DS: "SD1.x",
                SDVersion.SD2_TINY_UNET: "SD2.x", SDVersion.SDXS_09: "SD2.x",
                SDVersion.SD3: "SD3", SDVersion.WAN2: "Wan2.1", SDVersion.Z_IMAGE: "Z-Image",
                SDVersion.QWEN_IMAGE: "Qwen-Image"}


def image_families() -> str:
    """The image families of ``PORTED_VERSIONS`` (all but Wan2.1's video), in
    its order: "FLUX.1, SD1.x, ... and Qwen-Image", as messages name them."""
    names = list(dict.fromkeys(FAMILY_NAMES[v] for v in PORTED_VERSIONS
                               if v is not SDVersion.WAN2))
    return ", ".join(names[:-1]) + " and " + names[-1]


def _unet_version(names, shapes: Dict[str, Tuple[int, ...]]) -> SDVersion:
    """The JAX package's fingerprint of a UNet checkpoint (``detect_version``,
    its UNet branch: the ``input_blocks.0.0.weight`` stem's input channels,
    SDXL's label embedding or second text encoder, the cross-attention
    context width 768 / 1024, the middle block of the full-size UNets)."""
    def has_prefix(p):
        return any(n.startswith(p) for n in names)

    unet_key = next((c for c in (DIFFUSION_PREFIX + "input_blocks.0.0.weight",
                                 "input_blocks.0.0.weight") if c in names), None)
    if unet_key is None:
        return SDVersion.UNKNOWN
    if any("time_mixer.mix_factor" in n and "block" in n for n in names):
        return SDVersion.SVD
    in_channels = shapes.get(unet_key, (0, 4, 3, 3))[1]
    if (has_prefix("conditioner.embedders.1") or DIFFUSION_PREFIX + "label_emb.0.0.weight" in names
            or has_prefix("add_embedding")):
        if in_channels == 9:
            return SDVersion.SDXL_INPAINT
        if in_channels == 8:
            return SDVersion.SDXL_PIX2PIX
        mid = DIFFUSION_PREFIX + "middle_block.1.transformer_blocks.{}.attn1.to_q.weight"
        if mid.format(9) not in names and mid.format(0) not in names:
            return SDVersion.SDXL_SSD1B
        return SDVersion.SDXL
    ctx_key = next((c for c in (
        DIFFUSION_PREFIX + "input_blocks.4.1.transformer_blocks.0.attn2.to_k.weight",
        DIFFUSION_PREFIX + "input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight")
        if c in names), None)
    ctx_dim = shapes.get(ctx_key, (0, 768))[1] if ctx_key else None
    is_sd2 = ctx_dim == 1024 or has_prefix("cond_stage_model.model.")
    no_middle = (not has_prefix((DIFFUSION_PREFIX + "middle_block.1.", "middle_block.1."))
                 and has_prefix((DIFFUSION_PREFIX + "output_blocks.", "output_blocks.")))
    if is_sd2:
        if in_channels == 9:
            return SDVersion.SD2_INPAINT
        if no_middle:
            attn_k = None
            for cand in (DIFFUSION_PREFIX + "output_blocks.7.1.transformer_blocks.0.attn1.to_k.weight",
                         "output_blocks.7.1.transformer_blocks.0.attn1.to_k.weight"):
                if cand in names:
                    attn_k = shapes.get(cand, (0, 0))[-1]
            return SDVersion.SDXS_09 if attn_k == 1024 else SDVersion.SD2_TINY_UNET
        return SDVersion.SD2
    if in_channels == 9:
        return SDVersion.SD1_INPAINT
    if in_channels == 8:
        return SDVersion.SD1_PIX2PIX
    if no_middle:
        has_ob71 = has_prefix((DIFFUSION_PREFIX + "output_blocks.7.1", "output_blocks.7.1"))
        return SDVersion.SD1_TINY_UNET if has_ob71 else SDVersion.SDXS_512_DS
    return SDVersion.SD1


def _wan_version(names, shapes: Dict[str, Tuple[int, ...]]) -> Optional[SDVersion]:
    """The JAX package's fingerprint of a Wan DiT (``detect_version``, its Wan
    branch): VACE blocks, or the cross-attention of block 0 or a
    ``patch_embedding``, whose 5-D weight's input channels name Wan2.2's
    TI2V (48) and I2V (36); None where it is no Wan."""
    if any(".vace_blocks." in n for n in names):
        return SDVersion.WAN2
    patch = next((n for n in names if "patch_embedding.weight" in n), None)
    if patch is None and not any(n.startswith(DIFFUSION_PREFIX + "blocks.0.cross_attn")
                                 for n in names):
        return None
    sh = shapes.get(patch) if patch is not None else None
    if sh is not None and len(sh) == 5:
        return {48: SDVersion.WAN2_2_TI2V, 36: SDVersion.WAN2_2_I2V}.get(sh[1], SDVersion.WAN2)
    return SDVersion.WAN2


def detect_version(names, shapes: Dict[str, Tuple[int, ...]]) -> SDVersion:
    """The JAX package's fingerprint (``detect_version``) of a Z-Image DiT
    (``cap_embedder``), a Qwen-Image one (``transformer_blocks.0.img_mod.1``:
    Mage-Flow where ``img_in`` takes 128 features, the layered variant with
    ``addition_t_embedding``), an MMDiT (SD3: ``joint_blocks``), a double-block DiT (its ``double_blocks`` branch), a
    Wan DiT (its Wan branch) or a UNet (its UNet branch); UNKNOWN for
    anything else."""
    names = set(names)
    if any("cap_embedder.0.weight" in n for n in names):
        return SDVersion.Z_IMAGE
    if any("transformer_blocks.0.img_mod.1.weight" in n for n in names):
        img_in = next((n for n in names if n.endswith("img_in.weight")), None)
        if img_in is not None and shapes.get(img_in, (0, 0))[-1] == 128:
            return SDVersion.MAGE_FLOW
        if any("addition_t_embedding" in n for n in names):
            return SDVersion.QWEN_IMAGE_LAYERED
        return SDVersion.QWEN_IMAGE
    if any(n.startswith((DIFFUSION_PREFIX + "joint_blocks", "joint_blocks")) for n in names):
        return SDVersion.SD3
    if not any(n.startswith((DIFFUSION_PREFIX + "double_blocks", "double_blocks")) for n in names):
        return _wan_version(names, shapes) or _unet_version(names, shapes)
    if any("nerf_final_layer_conv." in n for n in names):
        return SDVersion.CHROMA_RADIANCE
    if any("distilled_guidance_layer" in n for n in names):
        return SDVersion.CHROMA
    if any("dual_time_embed.semantic_embedder" in n for n in names):
        return SDVersion.SEFI
    if any("double_blocks.0.img_mlp.gate_proj.weight" in n for n in names):
        return SDVersion.OVIS
    if any("double_stream_modulation_img" in n for n in names):
        if any("single_blocks.47." in n for n in names):
            return SDVersion.FLUX2
        return SDVersion.FLUX2_KLEIN
    if any("txt_in.individual_token_refiner" in n for n in names):
        return SDVersion.HUNYUAN_VIDEO
    for n in names:
        if n.endswith("txt_in.weight") and shapes.get(n, (0, 0))[-1] == 3584:
            return SDVersion.LONGCAT
    # FLUX.1 input width: 384 Fill, 128 Canny/Depth "Controls", 196 Flex.2, 64 base
    for n in names:
        if n.endswith("img_in.weight"):
            in_w = shapes.get(n, (0, 0))[-1]
            if in_w == 384:
                return SDVersion.FLUX_FILL
            if in_w == 128:
                return SDVersion.FLUX_CONTROLS
            if in_w == 196:
                return SDVersion.FLEX_2
            break
    return SDVersion.FLUX


# ------------------------------------------------------------ bundle

def _split_in_proj(params: Dict[str, np.ndarray]) -> None:
    """OpenCLIP's fused q/k/v (``__inproj__``) → separate q/k/v projections."""
    for name in [n for n in params if "__inproj__" in n]:
        arr = params.pop(name)
        c = arr.shape[0] // 3
        for i, which in enumerate(("q_proj", "k_proj", "v_proj")):
            params[name.replace("__inproj__", which)] = arr[i * c:(i + 1) * c]


# module dict ← full-name prefix (and the renaming of its local names)
MODULE_PREFIXES = (("diffusion", DIFFUSION_PREFIX), ("vae", "first_stage_model."),
                   ("clip_l", "cond_stage_model.transformer."),
                   ("clip_l", "cond_stage_model.model."),
                   ("clip_l", "conditioner.embedders.0.transformer."),
                   ("clip_g", "conditioner.embedders.1.model."),
                   ("clip_l", "text_encoders.clip_l.transformer."),
                   ("clip_g", "text_encoders.clip_g.transformer."),
                   ("t5", "text_encoders.t5xxl.transformer."),
                   ("llm", "text_encoders.llm."))


def split_modules(tensors: Dict[str, np.ndarray]) -> ModelBundle:
    """Canonicalize + fingerprint + split into module-local param dicts."""
    canon = {canonicalize_name(k): v for k, v in tensors.items()}
    version = detect_version(canon.keys(), {k: tuple(v.shape) for k, v in canon.items()})
    mods: Dict[str, Dict[str, np.ndarray]] = {"diffusion": {}, "clip_l": {}, "clip_g": {}, "t5": {},
                                              "vae": {}, "llm": {}, "extra": {}}
    vision = 0
    for name, arr in canon.items():
        for mod, prefix in MODULE_PREFIXES:
            if name.startswith(prefix):
                local = name[len(prefix):]
                if mod == "t5" and local.startswith(("enc.", "dec.", "token_embd.", "output_norm.")):
                    local = convert_gguf_t5_name(local)  # llama.cpp GGUF T5 export
                if mod == "llm":
                    if local.startswith(("model.visual.", "visual.", "v.", "mm.")):
                        if version != SDVersion.QWEN_IMAGE:
                            raise NotImplementedError(f"{local}: an LLM vision tower is not "
                                                      "ported; the port runs the LLM's text tower")
                        vision += 1  # Qwen-Image-Edit's: dropped, nothing runs it
                        break
                    if local.startswith(("blk.", "token_embd.", "output_norm.", "attn_sinks.")):
                        local = convert_gguf_llm_name(local)  # llama.cpp GGUF LLM export
                if prefix in ("conditioner.embedders.1.model.", "cond_stage_model.model."):
                    local = convert_open_clip_name(local)
                    if local is None:
                        break  # an OpenCLIP tensor the text tower does not use
                mods[mod][local] = arr
                break
        else:
            mods["extra"][name] = arr
    for tower in ("clip_l", "clip_g"):
        _split_in_proj(mods[tower])
    _resolve_upsample_markers(mods["diffusion"])
    # OpenCLIP's projection is [width, proj], applied as x @ W (the JAX
    # loader transposes CLIP-G's, whichever file it came from; SD2's square
    # one stays as it is, unused by the 23-layer text tower)
    tp = mods["clip_g"].get("text_projection.weight")
    if tp is not None:
        mods["clip_g"]["text_projection.weight"] = np.ascontiguousarray(np.asarray(tp).T)
    return ModelBundle(version=version, vision_tensors=vision, **mods)


def load_model_bundle(model_path: Optional[str] = None, diffusion_model_path: Optional[str] = None,
                      clip_l_path: Optional[str] = None, t5xxl_path: Optional[str] = None,
                      vae_path: Optional[str] = None, keep_quant: bool = False,
                      clip_g_path: Optional[str] = None, llm_path: Optional[str] = None) -> ModelBundle:
    """Checkpoint files of a ported family (``PORTED_VERSIONS``), each under
    its logical prefix, → ``ModelBundle`` (what the JAX package's
    ``load_model_bundle`` holds for them, by value).  Raises
    ``NotImplementedError`` for any other model."""
    tensors: Dict[str, np.ndarray] = {}
    if model_path:
        tensors.update(read_checkpoint_file(model_path, keep_quant=keep_quant))
    for path, prefix in ((diffusion_model_path, DIFFUSION_PREFIX),
                         (clip_l_path, "text_encoders.clip_l.transformer."),
                         (clip_g_path, "text_encoders.clip_g.transformer."),
                         (t5xxl_path, "text_encoders.t5xxl.transformer."),
                         (vae_path, "first_stage_model."),
                         (llm_path, "text_encoders.llm.")):
        if not path:
            continue
        diffusion = path == diffusion_model_path
        # another module's blocks are dequantized when staged, one at a time
        sub = read_checkpoint_file(path, keep_quant=keep_quant or not diffusion)
        if diffusion:
            sub = convert_diffusers_diffusion_names(sub)
        elif path == vae_path:
            sub = maybe_convert_diffusers_wan_vae(sub)
        for k, v in sub.items():
            kk = canonicalize_name(k)
            if not kk.startswith(prefix):
                kk = prefix + kk
            tensors[kk] = v
    bundle = split_modules(tensors)
    if bundle.version not in PORTED_VERSIONS:
        raise NotImplementedError(f"the files hold a {bundle.version.value} model; the port "
                                  f"loads {[v.value for v in PORTED_VERSIONS]}")
    if bundle.version == SDVersion.WAN2:
        refused = [what for what, key in (("VACE (vace_blocks)", "vace_blocks."),
                                          ("I2V (img_emb)", "img_emb."))
                   if any(key in k for k in bundle.diffusion)]
        if refused:
            raise NotImplementedError(f"a Wan {refused[0]} model: the port runs Wan2.1 T2V")
    return bundle
