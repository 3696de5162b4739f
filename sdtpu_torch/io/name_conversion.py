"""Tensor-name canonicalization (counterpart of ``sdtpu/io/name_conversion.py``
for the families the port runs): diffusers, OpenCLIP and llama.cpp GGUF
names → the internal ones, which are the original single-file checkpoints'.

The internal scheme is the CompVis layout the port's param dicts use:
``model.diffusion_model.{input_blocks,middle_block,output_blocks,…}`` for
the UNets, ``joint_blocks`` for SD3's MMDiT, ``double_blocks`` /
``single_blocks`` for FLUX, Lumina-2's fused ``attention.qkv`` for
Z-Image, ``first_stage_model.{encoder,decoder,…}`` for the SD / FLUX VAE,
the original ``encoder.downsamples`` / ``decoder.upsamples`` names for the
Wan VAE, HF CLIPText / T5 / decoder-LLM names for the text encoders, and
``zero_convs`` / ``input_hint_block`` / ``middle_block_out`` for a
ControlNet.  Diffusers keeps q/k/v (and FLUX's single-stream MLP input)
apart where the internal layout fuses them: the converted names carry
``.1`` / ``.2`` / ``.3`` after ``.weight`` / ``.bias`` as merge markers,
which the loader concatenates along dim 0.  The JAX package's rules,
name for name.
"""
from __future__ import annotations

import re
from typing import Optional

# --------------------------------------------------------------- UNet (SD1/2/XL)

_RES_INNER = {
    "norm1": "in_layers.0",
    "conv1": "in_layers.2",
    "time_emb_proj": "emb_layers.1",
    "norm2": "out_layers.0",
    "conv2": "out_layers.3",
    "conv_shortcut": "skip_connection",
}


def convert_diffusers_unet_name(name: str, num_res_blocks: int = 2, num_levels: int = 4) -> Optional[str]:
    """diffusers UNet2DConditionModel names → CompVis input/middle/output_blocks."""
    per_level = num_res_blocks + 1

    m = re.match(r"time_embedding\.linear_(\d)\.(.*)", name)
    if m:
        return f"time_embed.{0 if m.group(1) == '1' else 2}.{m.group(2)}"
    m = re.match(r"add_embedding\.linear_(\d)\.(.*)", name)
    if m:
        return f"label_emb.0.{0 if m.group(1) == '1' else 2}.{m.group(2)}"
    if name.startswith("conv_in."):
        return "input_blocks.0.0." + name[len("conv_in.") :]
    if name.startswith("conv_norm_out."):
        return "out.0." + name[len("conv_norm_out.") :]
    if name.startswith("conv_out."):
        return "out.2." + name[len("conv_out.") :]

    m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        idx = 1 + i * per_level + j
        return f"input_blocks.{idx}.0.{_convert_res_inner(rest)}"
    m = re.match(r"down_blocks\.(\d+)\.attentions\.(\d+)\.(.*)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        idx = 1 + i * per_level + j
        return f"input_blocks.{idx}.1.{rest}"
    m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)", name)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        idx = 1 + (i + 1) * per_level - 1
        return f"input_blocks.{idx}.0.op.{rest}"

    m = re.match(r"mid_block\.resnets\.(\d)\.(.*)", name)
    if m:
        which = 0 if m.group(1) == "0" else 2
        return f"middle_block.{which}.{_convert_res_inner(m.group(2))}"
    m = re.match(r"mid_block\.attentions\.0\.(.*)", name)
    if m:
        return f"middle_block.1.{m.group(1)}"

    m = re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        idx = i * (num_res_blocks + 1) + j
        return f"output_blocks.{idx}.0.{_convert_res_inner(rest)}"
    m = re.match(r"up_blocks\.(\d+)\.attentions\.(\d+)\.(.*)", name)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        idx = i * (num_res_blocks + 1) + j
        return f"output_blocks.{idx}.1.{rest}"
    m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)", name)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        idx = i * (num_res_blocks + 1) + num_res_blocks
        # upsample is the last sub-layer: .2 when the block has attention, .1 otherwise
        return f"output_blocks.{idx}.__up__.conv.{rest}"
    return None


def _convert_res_inner(rest: str) -> str:
    for k, v in _RES_INNER.items():
        if rest.startswith(k + "."):
            return v + rest[len(k) :]
    return rest


# --------------------------------------------------------------- ControlNet

def convert_diffusers_controlnet_name(name: str) -> Optional[str]:
    """diffusers ControlNetModel names → CompVis control_model names.

    The encoder copy reuses the UNet mapping; the extra pieces are the hint
    stem (controlnet_cond_embedding → input_hint_block, even indices 0..14)
    and the zero convs (controlnet_down_blocks.N → zero_convs.N.0,
    controlnet_mid_block → middle_block_out.0)."""
    if name.startswith("controlnet_cond_embedding.conv_in."):
        return "input_hint_block.0." + name.split(".", 2)[2]
    m = re.match(r"controlnet_cond_embedding\.blocks\.(\d+)\.(.*)", name)
    if m:
        return f"input_hint_block.{2 + 2 * int(m.group(1))}.{m.group(2)}"
    if name.startswith("controlnet_cond_embedding.conv_out."):
        return "input_hint_block.14." + name.split(".", 2)[2]
    m = re.match(r"controlnet_down_blocks\.(\d+)\.(.*)", name)
    if m:
        return f"zero_convs.{m.group(1)}.0.{m.group(2)}"
    if name.startswith("controlnet_mid_block."):
        return "middle_block_out.0." + name.split(".", 1)[1]
    return convert_diffusers_unet_name(name)


# --------------------------------------------------------------------- VAE

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
    pass through, diffusers UNet names go under ``model.diffusion_model.``
    (upsamplers under a ``__up__`` marker the loader resolves), diffusers
    VAE names under ``first_stage_model.``."""
    if name.startswith(_CANON_PREFIXES):
        return name
    cv = convert_diffusers_unet_name(name)
    if cv is not None:
        return "model.diffusion_model." + cv
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


# ----------------------------------------------------------- DiTs (diffusers)

def convert_diffusers_sd3_name(name: str) -> Optional[str]:
    """diffusers SD3Transformer2DModel → internal MMDiT joint_blocks layout
    (split q/k/v under merge markers)."""
    fixed = {
        "time_text_embed.timestep_embedder.linear_1": "t_embedder.mlp.0",
        "time_text_embed.timestep_embedder.linear_2": "t_embedder.mlp.2",
        "time_text_embed.text_embedder.linear_1": "y_embedder.mlp.0",
        "time_text_embed.text_embedder.linear_2": "y_embedder.mlp.2",
        "pos_embed.proj": "x_embedder.proj",
        "proj_out": "final_layer.linear",
        "norm_out.linear": "final_layer.adaLN_modulation.1",
    }
    if name == "pos_embed.pos_embed":
        return "pos_embed"
    for src, dst in fixed.items():
        if name.startswith(src + "."):
            return dst + name[len(src):]
    m = re.match(r"transformer_blocks\.(\d+)\.(.*)", name)
    if not m:
        return None
    pre, rest = f"joint_blocks.{m.group(1)}", m.group(2)
    for a in ("attn", "attn2"):
        mm = re.match(rf"{a}\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj)\.(weight|bias)$", rest)
        if mm:
            which, suff = mm.group(1), mm.group(2)
            side = "x_block" if which.startswith("to_") else "context_block"
            part = {"to_q": "", "to_k": ".1", "to_v": ".2",
                    "add_q_proj": "", "add_k_proj": ".1", "add_v_proj": ".2"}[which]
            return f"{pre}.{side}.{a}.qkv.{suff}{part}"
        table = {
            f"{a}.norm_q.weight": f"{pre}.x_block.{a}.ln_q.weight",
            f"{a}.norm_k.weight": f"{pre}.x_block.{a}.ln_k.weight",
            f"{a}.norm_added_q.weight": f"{pre}.context_block.{a}.ln_q.weight",
            f"{a}.norm_added_k.weight": f"{pre}.context_block.{a}.ln_k.weight",
            f"{a}.to_out.0.weight": f"{pre}.x_block.{a}.proj.weight",
            f"{a}.to_out.0.bias": f"{pre}.x_block.{a}.proj.bias",
            f"{a}.to_add_out.weight": f"{pre}.context_block.{a}.proj.weight",
            f"{a}.to_add_out.bias": f"{pre}.context_block.{a}.proj.bias",
        }
        if rest in table:
            return table[rest]
    table = {
        "norm1.linear": f"{pre}.x_block.adaLN_modulation.1",
        "norm1_context.linear": f"{pre}.context_block.adaLN_modulation.1",
        "ff.net.0.proj": f"{pre}.x_block.mlp.fc1",
        "ff.net.2": f"{pre}.x_block.mlp.fc2",
        "ff_context.net.0.proj": f"{pre}.context_block.mlp.fc1",
        "ff_context.net.2": f"{pre}.context_block.mlp.fc2",
    }
    for src, dst in table.items():
        if rest.startswith(src + "."):
            return dst + rest[len(src):]
    return None


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


# -------------------------------------------------------------------- Wan VAE

_WAN_VAE_PREFIX = [
    ("quant_conv.", "conv1."),
    ("post_quant_conv.", "conv2."),
    ("decoder.up_blocks.0.resnets.0.", "decoder.upsamples.0.residual."),
    ("decoder.up_blocks.0.resnets.1.", "decoder.upsamples.1.residual."),
    ("decoder.up_blocks.0.resnets.2.", "decoder.upsamples.2.residual."),
    ("decoder.up_blocks.0.upsamplers.0.", "decoder.upsamples.3."),
    ("decoder.up_blocks.1.resnets.0.conv_shortcut.", "decoder.upsamples.4.shortcut."),
    ("decoder.up_blocks.1.resnets.0.", "decoder.upsamples.4.residual."),
    ("decoder.up_blocks.1.resnets.1.", "decoder.upsamples.5.residual."),
    ("decoder.up_blocks.1.resnets.2.", "decoder.upsamples.6.residual."),
    ("decoder.up_blocks.1.upsamplers.0.", "decoder.upsamples.7."),
    ("decoder.up_blocks.2.resnets.0.", "decoder.upsamples.8.residual."),
    ("decoder.up_blocks.2.resnets.1.", "decoder.upsamples.9.residual."),
    ("decoder.up_blocks.2.resnets.2.", "decoder.upsamples.10.residual."),
    ("decoder.up_blocks.2.upsamplers.0.", "decoder.upsamples.11."),
    ("decoder.up_blocks.3.resnets.0.", "decoder.upsamples.12.residual."),
    ("decoder.up_blocks.3.resnets.1.", "decoder.upsamples.13.residual."),
    ("decoder.up_blocks.3.resnets.2.", "decoder.upsamples.14.residual."),
    ("encoder.down_blocks.0.", "encoder.downsamples.0.residual."),
    ("encoder.down_blocks.1.", "encoder.downsamples.1.residual."),
    ("encoder.down_blocks.2.", "encoder.downsamples.2."),
    ("encoder.down_blocks.3.conv_shortcut.", "encoder.downsamples.3.shortcut."),
    ("encoder.down_blocks.3.", "encoder.downsamples.3.residual."),
    ("encoder.down_blocks.4.", "encoder.downsamples.4.residual."),
    ("encoder.down_blocks.5.", "encoder.downsamples.5."),
    ("encoder.down_blocks.6.conv_shortcut.", "encoder.downsamples.6.shortcut."),
    ("encoder.down_blocks.6.", "encoder.downsamples.6.residual."),
    ("encoder.down_blocks.7.", "encoder.downsamples.7.residual."),
    ("encoder.down_blocks.8.", "encoder.downsamples.8."),
    ("encoder.down_blocks.9.", "encoder.downsamples.9.residual."),
    ("encoder.down_blocks.10.", "encoder.downsamples.10.residual."),
]


def convert_diffusers_wan_vae_name(name: str) -> str:
    """diffusers AutoencoderKLWan → internal Wan VAE layout."""
    for src, dst in (
        (".conv_in.", ".conv1."),
        (".norm_out.", ".head.0."),
        (".conv_out.", ".head.2."),
        (".mid_block.attentions.0.", ".middle.1."),
        (".mid_block.resnets.0.", ".middle.0.residual."),
        (".mid_block.resnets.1.", ".middle.2.residual."),
    ):
        if src in name:
            name = name.replace(src, dst)
    for src, dst in _WAN_VAE_PREFIX:
        if name.startswith(src):
            name = dst + name[len(src):]
            break
    if ".residual." in name:
        for src, dst in ((".norm1.", ".0."), (".conv1.", ".2."),
                         (".norm2.", ".3."), (".conv2.", ".6.")):
            if src in name:
                name = name.replace(src, dst)
    return name


# --------------------------------------------------------------- OpenCLIP

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


