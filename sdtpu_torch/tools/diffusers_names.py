"""Internal (original checkpoint) names → diffusers names, for writing
synthetic diffusers-layout files: the inverses of ``io.name_conversion``'s
diffusers rules for the UNet (``UNet2DConditionModel``), the ControlNet
(``ControlNetModel``), SD3's MMDiT (``SD3Transformer2DModel``) and the Wan
VAE (``AutoencoderKLWan``).

Each function maps one internal name to a list of diffusers names: one, or
three where diffusers keeps q / k / v apart and the internal layout fuses
them (the tensor is then cut in three along dim 0, in q, k, v order).
``to_diffusers`` checks each result against the forward rule, so a name
these inverses miss raises instead of writing a file the loader would not
read back; ``write_pair`` writes a module's seeded tensors under both
namings (the file writers ``tools/sd15_file.py``, ``sdxl_file.py``,
``sd3_file.py``, ``wan_file.py`` and ``controlnet_file.py`` call it).
"""
from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Callable, List

import torch

from sdtpu_torch.io import name_conversion as nc

_RES_INNER_INV = {v: k for k, v in nc._RES_INNER.items()}


def _res_inner_inv(rest: str) -> str:
    for k, v in _RES_INNER_INV.items():
        if rest.startswith(k + "."):
            return v + rest[len(k):]
    return rest


def unet_name(name: str, num_res_blocks: int = 2) -> List[str]:
    """A CompVis UNet name (module-local: ``input_blocks.…``) → its
    diffusers name, for the full UNets' layout (``convert_diffusers_unet_name``
    numbers the blocks ``num_res_blocks + 1`` a level)."""
    per = num_res_blocks + 1
    for src, dst in (("time_embed.0.", "time_embedding.linear_1."),
                     ("time_embed.2.", "time_embedding.linear_2."),
                     ("label_emb.0.0.", "add_embedding.linear_1."),
                     ("label_emb.0.2.", "add_embedding.linear_2."),
                     ("input_blocks.0.0.", "conv_in."), ("out.0.", "conv_norm_out."),
                     ("out.2.", "conv_out.")):
        if name.startswith(src):
            return [dst + name[len(src):]]
    m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)", name)
    if m:
        idx, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        i, j = (idx - 1) // per, (idx - 1) % per
        if j == num_res_blocks:  # the level's downsampler
            return [f"down_blocks.{i}.downsamplers.0.conv.{rest[len('op.'):]}"]
        if sub == 0:
            return [f"down_blocks.{i}.resnets.{j}.{_res_inner_inv(rest)}"]
        return [f"down_blocks.{i}.attentions.{j}.{rest}"]
    m = re.match(r"middle_block\.(\d)\.(.*)", name)
    if m:
        which, rest = int(m.group(1)), m.group(2)
        if which == 1:
            return [f"mid_block.attentions.0.{rest}"]
        return [f"mid_block.resnets.{which // 2}.{_res_inner_inv(rest)}"]
    m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)", name)
    if m:
        idx, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        i, j = idx // per, idx % per
        if sub == 0:
            return [f"up_blocks.{i}.resnets.{j}.{_res_inner_inv(rest)}"]
        if rest.startswith("conv."):  # the upsampler, after the attention where there is one
            return [f"up_blocks.{i}.upsamplers.0.{rest}"]
        return [f"up_blocks.{i}.attentions.{j}.{rest}"]
    raise ValueError(f"no diffusers UNet name for {name}")


def controlnet_name(name: str) -> List[str]:
    """A ControlNet name (module-local) → its diffusers name."""
    m = re.match(r"input_hint_block\.(\d+)\.(.*)", name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        if idx == 0:
            return [f"controlnet_cond_embedding.conv_in.{rest}"]
        if idx == 14:
            return [f"controlnet_cond_embedding.conv_out.{rest}"]
        return [f"controlnet_cond_embedding.blocks.{idx // 2 - 1}.{rest}"]
    m = re.match(r"zero_convs\.(\d+)\.0\.(.*)", name)
    if m:
        return [f"controlnet_down_blocks.{m.group(1)}.{m.group(2)}"]
    if name.startswith("middle_block_out.0."):
        return ["controlnet_mid_block." + name[len("middle_block_out.0."):]]
    return unet_name(name)


def sd3_name(name: str) -> List[str]:
    """An MMDiT name (module-local: ``joint_blocks.…``) → its diffusers
    name(s)."""
    if name == "pos_embed":
        return ["pos_embed.pos_embed"]
    for src, dst in (("t_embedder.mlp.0.", "time_text_embed.timestep_embedder.linear_1."),
                     ("t_embedder.mlp.2.", "time_text_embed.timestep_embedder.linear_2."),
                     ("y_embedder.mlp.0.", "time_text_embed.text_embedder.linear_1."),
                     ("y_embedder.mlp.2.", "time_text_embed.text_embedder.linear_2."),
                     ("x_embedder.proj.", "pos_embed.proj."), ("final_layer.linear.", "proj_out."),
                     ("final_layer.adaLN_modulation.1.", "norm_out.linear."),
                     ("context_embedder.", "context_embedder.")):
        if name.startswith(src):
            return [dst + name[len(src):]]
    m = re.match(r"joint_blocks\.(\d+)\.(x_block|context_block)\.(.*)", name)
    if not m:
        raise ValueError(f"no diffusers SD3 name for {name}")
    pre, ctx, rest = f"transformer_blocks.{m.group(1)}", m.group(2) == "context_block", m.group(3)
    m2 = re.match(r"(attn2?)\.qkv\.(weight|bias)$", rest)
    if m2:
        a, suff = m2.group(1), m2.group(2)
        parts = ("add_q_proj", "add_k_proj", "add_v_proj") if ctx else ("to_q", "to_k", "to_v")
        return [f"{pre}.{a}.{p}.{suff}" for p in parts]
    m2 = re.match(r"(attn2?)\.(ln_q|ln_k|proj)\.(.*)", rest)
    if m2:
        a, what, suff = m2.groups()
        what = {"ln_q": "norm_added_q" if ctx else "norm_q", "ln_k": "norm_added_k" if ctx else "norm_k",
                "proj": "to_add_out" if ctx else "to_out.0"}[what]
        return [f"{pre}.{a}.{what}.{suff}"]
    for src, dst in (("adaLN_modulation.1.", "norm1_context.linear." if ctx else "norm1.linear."),
                     ("mlp.fc1.", "ff_context.net.0.proj." if ctx else "ff.net.0.proj."),
                     ("mlp.fc2.", "ff_context.net.2." if ctx else "ff.net.2.")):
        if rest.startswith(src):
            return [f"{pre}.{dst}{rest[len(src):]}"]
    raise ValueError(f"no diffusers SD3 name for {name}")


# the Wan VAE's original prefixes → diffusers', longest first
_WAN_PREFIX_INV = sorted(((dst, src) for src, dst in nc._WAN_VAE_PREFIX),
                         key=lambda p: -len(p[0]))
_WAN_INNER_INV = {"0": "norm1", "2": "conv1", "3": "norm2", "6": "conv2"}


def wan_vae_name(name: str) -> List[str]:
    """A Wan VAE name (module-local, original layout) → its diffusers name."""
    if name.startswith("conv1."):
        return ["quant_conv." + name[len("conv1."):]]
    if name.startswith("conv2."):
        return ["post_quant_conv." + name[len("conv2."):]]
    if ".residual." in name:
        head, tail = name.split(".residual.", 1)
        k, rest = tail.split(".", 1)
        name = f"{head}.residual.{_WAN_INNER_INV[k]}.{rest}"
    for enc in ("encoder", "decoder"):
        for src, dst in ((f"{enc}.conv1.", f"{enc}.conv_in."), (f"{enc}.head.0.", f"{enc}.norm_out."),
                         (f"{enc}.head.2.", f"{enc}.conv_out."),
                         (f"{enc}.middle.1.", f"{enc}.mid_block.attentions.0."),
                         (f"{enc}.middle.0.residual.", f"{enc}.mid_block.resnets.0."),
                         (f"{enc}.middle.2.residual.", f"{enc}.mid_block.resnets.1.")):
            if name.startswith(src):
                return [dst + name[len(src):]]
    for dst, src in _WAN_PREFIX_INV:
        if name.startswith(dst):
            return [src + name[len(dst):]]
    raise ValueError(f"no diffusers Wan VAE name for {name}")


def to_diffusers(specs: dict, rename: Callable[[str], List[str]], forward: Callable) -> dict:
    """{internal name: (shape, init)} → {internal name: [diffusers names]},
    each checked against ``forward`` (the loader's rule, which must map the
    diffusers name back: a fused tensor's parts to ``name``, ``name.1``,
    ``name.2``, an upsampler to its ``__up__`` marker)."""
    out = {}
    for name in specs:
        parts = rename(name)
        back = [forward(p) or p for p in parts]  # a name no rule maps loads as it is
        want = [name] + [f"{name}.{i}" for i in range(1, len(parts))]
        if ".__up__." in (back[0] or ""):
            want = [re.sub(r"\.[12]\.conv\.", ".__up__.conv.", name)]
        if back != want:
            raise ValueError(f"{name} → {parts} reads back as {back}")
        out[name] = parts
    return out


def write_pair(out_dir, stem: str, specs: dict, rename: Callable[[str], List[str]], forward: Callable,
               device, prefix: str = "", dtype=torch.float16, seed: int = 0) -> dict:
    """``specs`` drawn from ``seed`` (tensor by tensor on ``device``) and
    written twice: ``stem.safetensors`` under the internal names (after
    ``prefix``) and ``stem_diffusers.safetensors`` under the diffusers names
    ``rename`` gives, fused tensors cut apart; the values are the same →
    {"paths": {"original", "diffusers"}, "bytes", "write_s", "tensors"}."""
    from sdtpu_torch.tools.flux_files import _Draw, write_safetensors

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    diff = to_diffusers(specs, rename, forward)
    out = {"paths": {}, "bytes": {}, "write_s": {}, "tensors": {}}
    for key, names in (("original", {n: [prefix + n] for n in specs}), ("diffusers", diff)):
        path = out_dir / (stem + ("_diffusers" if key == "diffusers" else "") + ".safetensors")
        t0 = time.time()
        out["bytes"][key] = write_safetensors(path, specs, _Draw(seed, device), dtype, names=names)
        out["write_s"][key] = time.time() - t0
        out["paths"][key] = str(path)
        out["tensors"][key] = sum(len(v) for v in names.values())
    return out
