"""FLUX, SD1.x, SD2.x, SDXL, SD3 and Wan2.1 T2V checkpoint files → per-module
param dicts (this package's copy of the FLUX, SD1, SD2, SDXL, SD3 and Wan
parts of ``sdtpu.io.model_loader``:
``load_model_bundle``, ``split_modules``, ``_split_in_proj``,
``read_checkpoint_file``, with the parts of ``sdtpu/io/detect.py`` and
``sdtpu/io/name_conversion.py`` they use).

Read N GGUF, safetensors or torch ``.ckpt`` / ``.pt`` files (the last
through ``io.torch_ckpt``'s restricted unpickler) under their per-file
prefixes (a full
checkpoint, the diffusion model, CLIP-L, T5-XXL, the VAE), convert
diffusers FLUX names to the internal double/single-block names (split
q/k/v merged back into the fused weights), canonicalize diffusers VAE
names, map llama.cpp GGUF T5 names to HF ones, fingerprint the version and
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
stem) and instruct-pix2pix (8) variants load as SD1.x, SD2.x and SDXL do.
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
and Qwen-Image raises ``NotImplementedError`` naming it (the tiny UNets, SDXS and
SDXL's SSD-1B too, an SD3 transformer under diffusers names, Wan2.2 I2V and
TI2V, a Wan VACE or I2V DiT, and a Wan DiT or VAE under diffusers names).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from sdtpu_torch.config import SDVersion
from sdtpu_torch.io.gguf import load_gguf
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


def convert_diffusers_flux_name(name: str) -> Optional[str]:
    """diffusers FluxTransformer2DModel → internal double/single_blocks layout."""
    fixed = {
        "time_embed.timestep_embedder.linear_1": "time_in.in_layer",
        "time_embed.timestep_embedder.linear_2": "time_in.out_layer",
        "time_text_embed.timestep_embedder.linear_1": "time_in.in_layer",
        "time_text_embed.timestep_embedder.linear_2": "time_in.out_layer",
        "time_text_embed.text_embedder.linear_1": "vector_in.in_layer",
        "time_text_embed.text_embedder.linear_2": "vector_in.out_layer",
        "time_text_embed.guidance_embedder.linear_1": "guidance_in.in_layer",
        "time_text_embed.guidance_embedder.linear_2": "guidance_in.out_layer",
        "context_embedder": "txt_in",
        "x_embedder": "img_in",
        "proj_out": "final_layer.linear",
        "norm_out.linear": "final_layer.adaLN_modulation.1",
    }
    for src, dst in fixed.items():
        if name.startswith(src + "."):
            return dst + name[len(src):]
    m = re.match(r"transformer_blocks\.(\d+)\.(.*)", name)
    if m:
        pre, rest = f"double_blocks.{m.group(1)}", m.group(2)
        mm = re.match(r"attn\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj)\.(weight|bias)$", rest)
        if mm:
            which, suff = mm.group(1), mm.group(2)
            side = "img_attn" if which.startswith("to_") else "txt_attn"
            part = {"to_q": "", "to_k": ".1", "to_v": ".2",
                    "add_q_proj": "", "add_k_proj": ".1", "add_v_proj": ".2"}[which]
            return f"{pre}.{side}.qkv.{suff}{part}"
        table = {
            "norm1.linear": f"{pre}.img_mod.lin",
            "norm1_context.linear": f"{pre}.txt_mod.lin",
            "ff.net.0.proj": f"{pre}.img_mlp.0",
            "ff.net.2": f"{pre}.img_mlp.2",
            "ff_context.net.0.proj": f"{pre}.txt_mlp.0",
            "ff_context.net.2": f"{pre}.txt_mlp.2",
            "attn.to_out.0": f"{pre}.img_attn.proj",
            "attn.to_add_out": f"{pre}.txt_attn.proj",
        }
        for src, dst in table.items():
            if rest.startswith(src + "."):
                return dst + rest[len(src):]
        exact = {
            "attn.norm_q.weight": f"{pre}.img_attn.norm.query_norm.scale",
            "attn.norm_k.weight": f"{pre}.img_attn.norm.key_norm.scale",
            "attn.norm_added_q.weight": f"{pre}.txt_attn.norm.query_norm.scale",
            "attn.norm_added_k.weight": f"{pre}.txt_attn.norm.key_norm.scale",
        }
        return exact.get(rest)
    m = re.match(r"single_transformer_blocks\.(\d+)\.(.*)", name)
    if m:
        pre, rest = f"single_blocks.{m.group(1)}", m.group(2)
        mm = re.match(r"(attn\.to_q|attn\.to_k|attn\.to_v|proj_mlp)\.(weight|bias)$", rest)
        if mm:
            part = {"attn.to_q": "", "attn.to_k": ".1",
                    "attn.to_v": ".2", "proj_mlp": ".3"}[mm.group(1)]
            return f"{pre}.linear1.{mm.group(2)}{part}"
        table = {
            "norm.linear": f"{pre}.modulation.lin",
            "proj_out": f"{pre}.linear2",
        }
        for src, dst in table.items():
            if rest.startswith(src + "."):
                return dst + rest[len(src):]
        exact = {
            "attn.norm_q.weight": f"{pre}.norm.query_norm.scale",
            "attn.norm_k.weight": f"{pre}.norm.key_norm.scale",
        }
        return exact.get(rest)
    # Comfy-Org re-exports: RMSNorm tensors already in internal names but
    # stored as *.weight instead of *.scale
    m = re.match(r"((?:double_blocks|single_blocks)\.\d+\..*norm)\.weight$", name)
    if m and ("query_norm" in name or "key_norm" in name):
        return m.group(1) + ".scale"
    return None


def convert_diffusers_lumina2_name(name: str) -> str:
    """Lumina-2 / Z-Image diffusers names → internal ones (split q/k/v under
    merge markers); a name no rule matches comes back as it is."""
    for src, dst in (("all_x_embedder.2-1.", "x_embedder."),
                     ("all_final_layer.2-1.", "final_layer.")):
        if name.startswith(src):
            name = dst + name[len(src):]
    m = re.match(r"((?:noise_refiner|context_refiner|layers)\.\d+\.)(.*)", name)
    if not m:
        return name
    pre, rest = m.group(1), m.group(2)
    mm = re.match(r"attention\.to_([qkv])\.(weight|bias)$", rest)
    if mm:
        part = {"q": "", "k": ".1", "v": ".2"}[mm.group(1)]
        return f"{pre}attention.qkv.{mm.group(2)}{part}"
    for src, dst in (("attention.norm_q.", "attention.q_norm."),
                     ("attention.norm_k.", "attention.k_norm."),
                     ("attention.to_out.0.", "attention.out.")):
        if rest.startswith(src):
            return pre + dst + rest[len(src):]
    return name


def convert_diffusers_diffusion_names(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A diffusers-format FLUX or Lumina-2 / Z-Image DiT → internal names
    (Z-Image's own names pass through the Lumina-2 rules unchanged); other
    diffusers DiT families raise, internal names pass through."""
    def has_prefix(p):
        return any(k.startswith(p) for k in tensors)

    if has_prefix("condition_embedder."):
        raise NotImplementedError("a diffusers Wan transformer (WanTransformer3DModel names): the "
                                  "port loads Wan under its original names (blocks.N.self_attn)")
    if has_prefix("pos_embed.proj.") and not has_prefix("single_transformer_blocks."):
        raise NotImplementedError("a diffusers SD3 transformer (SD3Transformer2DModel names): "
                                  "the port loads SD3 under its single-file names (joint_blocks)")
    if (any("img_attn_qkv" in k or "img_mod.linear." in k for k in tensors)
            or has_prefix("pos_embed.proj.") or has_prefix("time_mod_proj.")
            or has_prefix("text_fusion.")):
        raise NotImplementedError("a diffusers DiT other than FLUX and Z-Image: the port loads "
                                  "FLUX and Z-Image")
    if has_prefix("all_x_embedder.2-1.") or has_prefix("noise_refiner."):
        return _merge_fused_markers({convert_diffusers_lumina2_name(k): v
                                     for k, v in tensors.items()})
    if not (has_prefix("single_transformer_blocks.")
            or (has_prefix("transformer_blocks.") and has_prefix("context_embedder."))):
        return tensors
    out: Dict[str, np.ndarray] = {}
    for k, v in tensors.items():
        nk = convert_diffusers_flux_name(k)
        out[nk if nk is not None else k] = v
    return _merge_fused_markers(out)


# the UNet versions the port runs: SD1.x, SD2.x and SDXL, their inpainting
# and instruct-pix2pix stems
UNET_VERSIONS = (SDVersion.SD1, SDVersion.SD1_INPAINT, SDVersion.SD1_PIX2PIX, SDVersion.SD2,
                 SDVersion.SD2_INPAINT, SDVersion.SDXL, SDVersion.SDXL_INPAINT,
                 SDVersion.SDXL_PIX2PIX)
# the families the port runs (``load_model_bundle`` and ``create_pipeline``
# refuse every other by name)
PORTED_VERSIONS = (SDVersion.FLUX, *UNET_VERSIONS, SDVersion.SD3, SDVersion.WAN2,
                   SDVersion.Z_IMAGE, SDVersion.QWEN_IMAGE)
# the family each ported version belongs to, as messages name it
FAMILY_NAMES = {SDVersion.FLUX: "FLUX.1", SDVersion.SD1: "SD1.x", SDVersion.SD1_INPAINT: "SD1.x",
                SDVersion.SD1_PIX2PIX: "SD1.x", SDVersion.SD2: "SD2.x",
                SDVersion.SD2_INPAINT: "SD2.x", SDVersion.SDXL: "SDXL",
                SDVersion.SDXL_INPAINT: "SDXL", SDVersion.SDXL_PIX2PIX: "SDXL",
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


# ------------------------------------------------------------ name canon

def convert_diffusers_vae_name(name: str, num_levels: int = 4) -> Optional[str]:
    """diffusers AutoencoderKL names → CompVis ``first_stage_model`` names."""
    vae_res = {
        "norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
        "conv_shortcut": "nin_shortcut",
    }

    def res_inner(rest):
        for k, v in vae_res.items():
            if rest.startswith(k + "."):
                return v + rest[len(k):]
        return rest

    attn_map = {
        "group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out",
        # older diffusers naming
        "query": "q", "key": "k", "value": "v", "proj_attn": "proj_out",
    }

    def attn_inner(rest):
        for k, v in sorted(attn_map.items(), key=lambda kv: -len(kv[0])):
            if rest.startswith(k + "."):
                return v + rest[len(k):]
        return rest

    for enc in ("encoder", "decoder"):
        if not name.startswith(enc + "."):
            continue
        sub = name[len(enc) + 1:]
        if sub.startswith("conv_in.") or sub.startswith("conv_out."):
            return f"{enc}.{sub}"
        if sub.startswith("conv_norm_out."):
            return f"{enc}.norm_out.{sub[len('conv_norm_out.'):]}"
        m = re.match(r"mid_block\.resnets\.(\d)\.(.*)", sub)
        if m:
            return f"{enc}.mid.block_{int(m.group(1)) + 1}.{res_inner(m.group(2))}"
        m = re.match(r"mid_block\.attentions\.0\.(.*)", sub)
        if m:
            return f"{enc}.mid.attn_1.{attn_inner(m.group(1))}"
        m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", sub)
        if m:
            return f"encoder.down.{m.group(1)}.block.{m.group(2)}.{res_inner(m.group(3))}"
        m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)", sub)
        if m:
            return f"encoder.down.{m.group(1)}.downsample.conv.{m.group(2)}"
        m = re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", sub)
        if m:
            i = num_levels - 1 - int(m.group(1))
            return f"decoder.up.{i}.block.{m.group(2)}.{res_inner(m.group(3))}"
        m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)", sub)
        if m:
            i = num_levels - 1 - int(m.group(1))
            return f"decoder.up.{i}.upsample.conv.{m.group(2)}"
        return None
    if name.startswith("quant_conv.") or name.startswith("post_quant_conv."):
        return name
    return None


# the wrapper prefixes ``canonicalize_name`` leaves as they are
_CANON_PREFIXES = ("model.diffusion_model.", "first_stage_model.", "cond_stage_model.transformer.",
                   "cond_stage_model.model.", "conditioner.embedders.0.transformer.",
                   "conditioner.embedders.1.model.")


def canonicalize_name(name: str) -> str:
    """A full checkpoint key → its internal name: known wrapper prefixes
    pass through, diffusers VAE names go under ``first_stage_model.``.
    (The JAX package also maps diffusers UNet names here; the port loads no
    UNet, and such a name stays as it is, so the file is refused as not
    FLUX.)"""
    if name.startswith(_CANON_PREFIXES):
        return name
    cv = convert_diffusers_vae_name(name)
    if cv is not None:
        return "first_stage_model." + cv
    return name


def _replace_name_map(name: str, pairs) -> str:
    """First-substring-occurrence replacement per pair, applied in order."""
    for src, dst in pairs:
        idx = name.find(src)
        if idx >= 0:
            name = name[:idx] + dst + name[idx + len(src):]
    return name


_GGUF_T5_MAP = (
    ("enc.", "encoder."),
    ("blk.", "block."),
    ("output_norm.", "final_layer_norm."),
    ("attn_q.", "layer.0.SelfAttention.q."),
    ("attn_k.", "layer.0.SelfAttention.k."),
    ("attn_v.", "layer.0.SelfAttention.v."),
    ("attn_o.", "layer.0.SelfAttention.o."),
    ("attn_norm.", "layer.0.layer_norm."),
    ("ffn_norm.", "layer.1.layer_norm."),
    ("ffn_up.", "layer.1.DenseReluDense.wi_1."),
    ("ffn_down.", "layer.1.DenseReluDense.wo."),
    ("ffn_gate.", "layer.1.DenseReluDense.wi_0."),
    ("attn_rel_b.", "layer.0.SelfAttention.relative_attention_bias."),
    ("token_embd.", "shared."),
)


def convert_gguf_t5_name(name: str) -> str:
    """llama.cpp GGUF T5 names → HF T5EncoderModel names."""
    return _replace_name_map(name, _GGUF_T5_MAP)


# the Qwen2.5-VL and Qwen3 text towers' names (what llm.check_supported
# refuses has none here)
_GGUF_LLM_MAP = (
    ("token_embd.", "model.embed_tokens."),
    ("blk.", "model.layers."),
    ("attn_q.", "self_attn.q_proj."),
    ("attn_k.", "self_attn.k_proj."),
    ("attn_v.", "self_attn.v_proj."),
    ("attn_q_norm.", "self_attn.q_norm."),
    ("attn_k_norm.", "self_attn.k_norm."),
    ("attn_output.", "self_attn.o_proj."),
    ("attn_norm.", "input_layernorm."),
    ("ffn_down.", "mlp.down_proj."),
    ("ffn_gate.", "mlp.gate_proj."),
    ("ffn_up.", "mlp.up_proj."),
    ("ffn_norm.", "post_attention_layernorm."),
    ("output_norm.", "model.norm."),
)


def convert_gguf_llm_name(name: str) -> str:
    """llama.cpp GGUF decoder-LLM names → HF names."""
    return _replace_name_map(name, _GGUF_LLM_MAP)


# ------------------------------------------------------------ bundle

def convert_open_clip_name(name: str) -> Optional[str]:
    """OpenCLIP text-tower names (SD2's ``cond_stage_model.model.*``, SDXL's
    ``conditioner.embedders.1.model.*``) → HF CLIPText names; the fused ``in_proj`` comes back under an
    ``__inproj__`` marker that ``_split_in_proj`` splits."""
    if name.startswith("transformer."):
        name = name[len("transformer."):]
    if name == "token_embedding.weight":
        return "text_model.embeddings.token_embedding.weight"
    if name == "positional_embedding":
        return "text_model.embeddings.position_embedding.weight"
    if name.startswith("ln_final."):
        return "text_model.final_layer_norm." + name[len("ln_final."):]
    if name == "text_projection":
        return "text_projection.weight"  # split_modules transposes it
    m = re.match(r"resblocks\.(\d+)\.(.*)", name)
    if m:
        pre = f"text_model.encoder.layers.{m.group(1)}"
        table = {
            "ln_1.weight": f"{pre}.layer_norm1.weight", "ln_1.bias": f"{pre}.layer_norm1.bias",
            "ln_2.weight": f"{pre}.layer_norm2.weight", "ln_2.bias": f"{pre}.layer_norm2.bias",
            "mlp.c_fc.weight": f"{pre}.mlp.fc1.weight", "mlp.c_fc.bias": f"{pre}.mlp.fc1.bias",
            "mlp.c_proj.weight": f"{pre}.mlp.fc2.weight", "mlp.c_proj.bias": f"{pre}.mlp.fc2.bias",
            "attn.out_proj.weight": f"{pre}.self_attn.out_proj.weight",
            "attn.out_proj.bias": f"{pre}.self_attn.out_proj.bias",
            "attn.in_proj_weight": f"{pre}.self_attn.__inproj__.weight",
            "attn.in_proj_bias": f"{pre}.self_attn.__inproj__.bias",
        }
        return table.get(m.group(2))
    return None


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
        elif path == vae_path and any(k.startswith("encoder.down_blocks.4.") for k in sub) and not any(
                ".resnets." in k and k.startswith("encoder.") for k in sub):
            raise NotImplementedError(f"{path}: a diffusers Wan VAE (AutoencoderKLWan names); the "
                                      "port loads the Wan VAE under its original names")
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
