"""A FLUX diffusion-model checkpoint → its param dict (this package's copy of
what ``sdtpu.io.model_loader.load_model_bundle(diffusion_model_path=...,
keep_quant=...)`` does for a FLUX.1 file, with the parts of
``sdtpu/io/detect.py`` and ``sdtpu/io/name_conversion.py`` that call uses).

Read the GGUF or safetensors file (GGUF quant blocks kept as ``HostQuant``
when ``keep_quant``), convert diffusers FLUX names to the internal
double/single-block names (split q/k/v merged back into the fused
weights), put the names under ``model.diffusion_model.``, fingerprint the
version and strip the prefix again.  Any other family raises
``NotImplementedError``: the port runs FLUX.
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

DIFFUSION_PREFIX = "model.diffusion_model."


@dataclasses.dataclass
class ModelBundle:
    version: SDVersion
    diffusion: Dict[str, np.ndarray]


def read_checkpoint_file(path: str, keep_quant: bool = False) -> Dict[str, np.ndarray]:
    """A .gguf or .safetensors (or HF index.json) file → {name: array}; with
    ``keep_quant``, quantized 2-D GGUF tensors come back as ``HostQuant``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".safetensors" or path.endswith(".index.json"):
        return load_safetensors(path)
    if ext == ".gguf":
        return load_gguf(path, keep_quant=keep_quant)
    raise NotImplementedError(f"{path}: the port reads GGUF and safetensors checkpoints")


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


def convert_diffusers_diffusion_names(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A diffusers-format FLUX DiT → internal names; other diffusers DiT
    families raise, internal names pass through."""
    def has_prefix(p):
        return any(k.startswith(p) for k in tensors)

    if (any("img_attn_qkv" in k or "img_mod.linear." in k for k in tensors)
            or has_prefix("pos_embed.proj.") or has_prefix("all_x_embedder.2-1.")
            or has_prefix("noise_refiner.") or has_prefix("time_mod_proj.")
            or has_prefix("text_fusion.")):
        raise NotImplementedError("a diffusers DiT other than FLUX: the port loads FLUX")
    if not (has_prefix("single_transformer_blocks.")
            or (has_prefix("transformer_blocks.") and has_prefix("context_embedder."))):
        return tensors
    out: Dict[str, np.ndarray] = {}
    for k, v in tensors.items():
        nk = convert_diffusers_flux_name(k)
        out[nk if nk is not None else k] = v
    return _merge_fused_markers(out)


def detect_version(names, shapes: Dict[str, Tuple[int, ...]]) -> SDVersion:
    """The JAX package's fingerprint of a double-block DiT (``detect_version``,
    its ``double_blocks`` branch); UNKNOWN for anything without double blocks."""
    names = set(names)
    if not any(n.startswith((DIFFUSION_PREFIX + "double_blocks", "double_blocks")) for n in names):
        return SDVersion.UNKNOWN
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


def load_model_bundle(diffusion_model_path: str, keep_quant: bool = False) -> ModelBundle:
    """A FLUX.1 diffusion-model file → ``ModelBundle(version, diffusion)``, the
    diffusion dict under the DiT's own names (what the JAX package's
    ``load_model_bundle(diffusion_model_path=..., keep_quant=...).diffusion``
    holds).  Raises ``NotImplementedError`` for any other model."""
    sub = convert_diffusers_diffusion_names(read_checkpoint_file(diffusion_model_path, keep_quant))
    tensors = {(k if k.startswith(DIFFUSION_PREFIX) else DIFFUSION_PREFIX + k): v
               for k, v in sub.items()}
    version = detect_version(tensors.keys(), {k: tuple(v.shape) for k, v in tensors.items()})
    if version != SDVersion.FLUX:
        raise NotImplementedError(f"{diffusion_model_path} holds a {version.value} model; "
                                  "the port loads FLUX")
    return ModelBundle(version=version,
                       diffusion={k[len(DIFFUSION_PREFIX):]: v for k, v in tensors.items()})
