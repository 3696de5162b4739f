"""Prompt → conditioning tensors for FLUX, SD1.x, SD2.x, SDXL, SD3, Wan,
Z-Image and Qwen-Image (counterpart of ``sdtpu/conditioning/conditioner.py``:
``tokenize_with_weights``, ``apply_token_weights``, ``SDCondition``,
``SD1Conditioner`` with its SD2 form,
``sdxl_size_vector``, ``SDXLConditioner``, ``SD3Conditioner``,
``FluxConditioner``, ``WanConditioner``, ``ZImageConditioner``, the text
path of ``QwenImageConditioner``).

The tokenizers, the webui prompt parser and the encoders are this
package's own.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.conditioning.prompt_parser import parse_prompt_attention
from sdtpu_torch.models.clip import CLIPTextConfig, clip_text_forward
from sdtpu_torch.models.llm import CHAT_TEMPLATES, LLMConfig, llm_forward
from sdtpu_torch.models.t5 import T5Config, t5_encoder_forward
from sdtpu_torch.ops import timestep_embedding

CHUNK_LEN = 77
RAW_CHUNK = 75


def tokenize_with_weights(tokenizer, text: str, pad_token_id: int,
                          encode=None) -> Tuple[np.ndarray, np.ndarray]:
    """→ (tokens [n_chunks*77], weights [n_chunks*77]) int32/float32: chunks
    of 75 raw tokens wrapped in BOS/EOS and padded to 77; BREAK pads the raw
    stream to a chunk boundary."""
    encode = encode or tokenizer.encode
    raw_tokens: List[int] = []
    raw_weights: List[float] = []
    for span, weight in parse_prompt_attention(text):
        if span == "BREAK" and weight == -1.0:
            pad = (RAW_CHUNK - (len(raw_tokens) % RAW_CHUNK)) % RAW_CHUNK
            raw_tokens.extend([tokenizer.eos_token_id] * pad)
            raw_weights.extend([1.0] * pad)
            continue
        ids = encode(span)
        raw_tokens.extend(ids)
        raw_weights.extend([weight] * len(ids))

    tokens: List[int] = []
    weights: List[float] = []
    offset = 0
    while True:
        take = min(RAW_CHUNK, len(raw_tokens) - offset)
        chunk = [tokenizer.bos_token_id] + raw_tokens[offset:offset + take] + [tokenizer.eos_token_id]
        cw = [1.0] + raw_weights[offset:offset + take] + [1.0]
        pad = CHUNK_LEN - len(chunk)
        chunk += [pad_token_id] * pad
        cw += [1.0] * pad
        tokens.extend(chunk)
        weights.extend(cw)
        offset += take
        if offset >= len(raw_tokens):
            break
    return np.asarray(tokens, dtype=np.int32), np.asarray(weights, dtype=np.float32)


def apply_token_weights(hidden: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mean-preserving per-chunk scaling. hidden [n_chunks, 77, C],
    weights [n_chunks, 77]."""
    original_mean = hidden.mean(dim=(1, 2), keepdim=True)
    weighted = hidden * weights[:, :, None].to(hidden.dtype)
    new_mean = weighted.mean(dim=(1, 2), keepdim=True)
    scale = torch.where(new_mean != 0.0, original_mean / new_mean, torch.ones_like(new_mean))
    return weighted * scale


@dataclasses.dataclass
class SDCondition:
    c_crossattn: Optional[torch.Tensor] = None  # [B, L, C]
    c_vector: Optional[torch.Tensor] = None  # [B, adm]
    t5_ids: Optional[List[int]] = None  # the padded ids T5 was fed


class FluxConditioner:
    """FLUX: the CLIP-L pooled vector and the T5 token sequence."""

    def __init__(self, clip_tokenizer, t5_tokenizer, clip_l_params, clip_l_cfg: CLIPTextConfig,
                 t5_params, t5_cfg: T5Config, t5_seq_len: int = 256, device="cuda"):
        self.clip_tokenizer = clip_tokenizer
        self.t5_tokenizer = t5_tokenizer
        self.pl, self.cl = clip_l_params, clip_l_cfg
        self.pt, self.ct = t5_params, t5_cfg
        self.t5_seq_len = t5_seq_len
        self.device = torch.device(device)

    def get_learned_condition(self, text: str, clip_skip: int = -1, **kw) -> SDCondition:
        tokens, _ = tokenize_with_weights(self.clip_tokenizer, text, self.clip_tokenizer.eos_token_id)
        ids = torch.from_numpy(tokens[:CHUNK_LEN][None].astype(np.int64)).to(self.device)
        if self.t5_tokenizer is not None:
            t5_ids, _ = self.t5_tokenizer.pad(
                self.t5_tokenizer.encode(text, add_eos=True), self.t5_seq_len)
        else:
            t5_ids = [0] * self.t5_seq_len
        _, pooled = clip_text_forward(self.pl, ids, self.cl, clip_skip=-1, return_pooled=True)
        h_t5 = t5_encoder_forward(
            self.pt, torch.tensor([t5_ids], dtype=torch.int64, device=self.device), self.ct)
        return SDCondition(c_crossattn=h_t5, c_vector=pooled, t5_ids=list(t5_ids))


class SD1Conditioner:
    """SD1.x / SD2.x: one text encoder (CLIP-L, or SD2's OpenCLIP-H with
    ``is_sd2``); the prompt's 77-token chunks (padded with CLIP's EOS id,
    SD2's with id 0) are embedded in one batched call, weighted per chunk
    and concatenated.  ``clip_skip`` <= 0 means 1 (the final layer after the
    final layer norm), on SD2 2 (the penultimate layer, no final norm).
    Textual-inversion embeddings (the JAX package's ``EmbeddingMixin``) are
    not ported yet."""

    def __init__(self, tokenizer, clip_params, clip_cfg: CLIPTextConfig, is_sd2: bool = False,
                 device="cuda"):
        self.tokenizer = tokenizer
        self.params = clip_params
        self.cfg = clip_cfg
        self.is_sd2 = is_sd2
        self.pad_token_id = 0 if is_sd2 else tokenizer.eos_token_id
        self.device = torch.device(device)

    def get_learned_condition(self, text: str, clip_skip: int = -1, **kw) -> SDCondition:
        if clip_skip <= 0:
            clip_skip = 2 if self.is_sd2 else 1
        tokens, weights = tokenize_with_weights(self.tokenizer, text, self.pad_token_id)
        n_chunks = len(tokens) // CHUNK_LEN
        ids = torch.from_numpy(tokens.reshape(n_chunks, CHUNK_LEN).astype(np.int64)).to(self.device)
        w = torch.from_numpy(weights.reshape(n_chunks, CHUNK_LEN)).to(self.device)
        hidden, _ = clip_text_forward(self.params, ids, self.cfg, clip_skip=clip_skip)
        hidden = apply_token_weights(hidden, w)
        return SDCondition(c_crossattn=hidden.reshape(1, n_chunks * CHUNK_LEN, hidden.shape[-1]))


def sdxl_size_vector(pooled: torch.Tensor, width: int, height: int, crop_w: int = 0,
                     crop_h: int = 0, target_width: Optional[int] = None,
                     target_height: Optional[int] = None) -> torch.Tensor:
    """adm_in vector = pooled (1280) ++ emb256(h, w) ++ emb256(crop) ++
    emb256(target), [1, 2816] at full width, float32 (the JAX package's
    bf16 pooled output promotes to the embeddings' float32 too)."""
    target_width = target_width or width
    target_height = target_height or height
    vals = torch.tensor([height, width, crop_h, crop_w, target_height, target_width],
                        dtype=torch.float32, device=pooled.device)
    embs = timestep_embedding(vals, 256).reshape(1, 6 * 256)
    return torch.cat([pooled.reshape(1, -1).float(), embs], dim=-1)


class SDXLConditioner:
    """SDXL: CLIP-L and OpenCLIP-G on the same 77-token chunks (padded with
    id 0), their hidden states at ``clip_skip`` (2 by default: the
    penultimate layer, before the final norm) joined on the last axis, then
    weighted per chunk; CLIP-G's ids zeroed after each chunk's first EOS.
    The vector ``y`` is CLIP-G's projected pooled output of the first chunk
    followed by the size, crop and target embeddings."""

    def __init__(self, tokenizer, clip_l_params, clip_l_cfg: CLIPTextConfig, clip_g_params,
                 clip_g_cfg: CLIPTextConfig, device="cuda"):
        self.tokenizer = tokenizer
        self.pl, self.cl = clip_l_params, clip_l_cfg
        self.pg, self.cg = clip_g_params, clip_g_cfg
        self.device = torch.device(device)

    def get_learned_condition(self, text: str, clip_skip: int = -1, width: int = 1024,
                              height: int = 1024, **kw) -> SDCondition:
        if clip_skip <= 0:
            clip_skip = 2
        tokens, weights = tokenize_with_weights(self.tokenizer, text, 0)
        n_chunks = len(tokens) // CHUNK_LEN
        chunks = tokens.reshape(n_chunks, CHUNK_LEN)
        chunks_g = chunks.copy()
        eos = self.tokenizer.eos_token_id
        for row in chunks_g:
            eos_pos = np.argmax(row == eos)
            if row[eos_pos] == eos and eos_pos + 1 < CHUNK_LEN:
                row[eos_pos + 1:] = 0

        def ids(a):
            return torch.from_numpy(a.astype(np.int64)).to(self.device)

        h_l, _ = clip_text_forward(self.pl, ids(chunks), self.cl, clip_skip=clip_skip)
        h_g, pooled = clip_text_forward(self.pg, ids(chunks_g), self.cg, clip_skip=clip_skip,
                                        return_pooled=True)
        w = torch.from_numpy(weights.reshape(n_chunks, CHUNK_LEN)).to(self.device)
        hidden = apply_token_weights(torch.cat([h_l, h_g.to(h_l.dtype)], dim=-1), w)
        vec = sdxl_size_vector(pooled[:1], width, height, **{
            k: v for k, v in kw.items()
            if k in ("crop_w", "crop_h", "target_width", "target_height")})
        return SDCondition(c_crossattn=hidden.reshape(1, n_chunks * CHUNK_LEN, hidden.shape[-1]),
                           c_vector=vec)


class SD3Conditioner:
    """SD3: CLIP-L and CLIP-G on the prompt's first 77-token chunk (padded
    with id 0; CLIP-G gets CLIP-L's ids as they are), their hidden states at
    ``clip_skip`` (2 by default) joined on the last axis, weighted, and
    zero-padded to T5's width; then T5-XXL's output over ``t5_seq_len``
    tokens (all-zero ids without a T5 tokenizer) on the token axis.  The
    vector is CLIP-L's pooled projection followed by CLIP-G's.  T5's
    attention stays off flash (its relative-position bias), as in FLUX."""

    def __init__(self, clip_tokenizer, t5_tokenizer, clip_l_params, clip_l_cfg: CLIPTextConfig,
                 clip_g_params, clip_g_cfg: CLIPTextConfig, t5_params, t5_cfg: T5Config,
                 t5_seq_len: int = 77, device="cuda"):
        self.clip_tokenizer = clip_tokenizer
        self.t5_tokenizer = t5_tokenizer
        self.pl, self.cl = clip_l_params, clip_l_cfg
        self.pg, self.cg = clip_g_params, clip_g_cfg
        self.pt, self.ct = t5_params, t5_cfg
        self.t5_seq_len = t5_seq_len
        self.device = torch.device(device)

    def get_learned_condition(self, text: str, clip_skip: int = -1, **kw) -> SDCondition:
        if clip_skip <= 0:
            clip_skip = 2
        tokens, weights = tokenize_with_weights(self.clip_tokenizer, text, 0)
        ids = torch.from_numpy(tokens[:CHUNK_LEN][None].astype(np.int64)).to(self.device)
        w = torch.from_numpy(weights[:CHUNK_LEN][None]).to(self.device)
        if self.t5_tokenizer is not None:
            t5_ids, _ = self.t5_tokenizer.pad(
                self.t5_tokenizer.encode(text, add_eos=True), self.t5_seq_len)
        else:
            t5_ids = [0] * self.t5_seq_len
        h_l, pooled_l = clip_text_forward(self.pl, ids, self.cl, clip_skip=clip_skip,
                                          return_pooled=True)
        h_g, pooled_g = clip_text_forward(self.pg, ids, self.cg, clip_skip=clip_skip,
                                          return_pooled=True)
        hidden = apply_token_weights(torch.cat([h_l, h_g.to(h_l.dtype)], dim=-1), w)
        hidden = torch.nn.functional.pad(hidden, (0, self.ct.d_model - hidden.shape[-1]))
        h_t5 = t5_encoder_forward(
            self.pt, torch.tensor([t5_ids], dtype=torch.int64, device=self.device), self.ct)
        return SDCondition(c_crossattn=torch.cat([hidden, h_t5.to(hidden.dtype)], dim=1),
                           c_vector=torch.cat([pooled_l, pooled_g.to(pooled_l.dtype)], dim=-1),
                           t5_ids=list(t5_ids))


class WanConditioner:
    """Wan 2.1: UMT5-XXL alone over ``seq_len`` (512) tokens: the prompt's
    weighted spans tokenized one by one, then the end-of-sequence id,
    padded; encoded under the attention mask, weighted (mean-preserving over
    the whole sequence) and the masked states zeroed (``zero_out_masked``).
    Without a tokenizer the ids are all zero and the mask full.  T5's
    attention stays off flash (its relative-position bias)."""

    def __init__(self, t5_tokenizer, t5_params, t5_cfg: T5Config, seq_len: int = 512, device="cuda"):
        self.t5_tokenizer = t5_tokenizer
        self.pt, self.ct = t5_params, t5_cfg
        self.seq_len = seq_len
        self.device = torch.device(device)

    def get_learned_condition(self, text: str, clip_skip: int = -1, **kw) -> SDCondition:
        ids: List[int] = []
        w: List[float] = []
        if self.t5_tokenizer is not None:
            for span, weight in parse_prompt_attention(text):
                span_ids = self.t5_tokenizer.encode(span)
                ids.extend(span_ids)
                w.extend([weight] * len(span_ids))
            ids.append(self.t5_tokenizer.eos_token_id)
            w.append(1.0)
            ids, mask = self.t5_tokenizer.pad(ids, self.seq_len)
        else:
            ids, mask = [0] * self.seq_len, [1] * self.seq_len
        w = (w + [1.0] * self.seq_len)[:self.seq_len]
        dev = self.device
        m = torch.tensor([mask], dtype=torch.float32, device=dev)
        h = t5_encoder_forward(self.pt, torch.tensor([ids], dtype=torch.int64, device=dev), self.ct,
                               attention_mask=m)
        h = apply_token_weights(h, torch.tensor([w], dtype=torch.float32, device=dev))
        return SDCondition(c_crossattn=h * m[:, :, None].to(h.dtype), t5_ids=list(ids))


class ZImageConditioner:
    """Z-Image: the prompt in a plain chat wrap (``TEMPLATE``), tokenized
    (at most ``max_len`` ids) and run through the Qwen3 LLM's first
    ``num_layers - 1`` layers: the hidden states of the second-to-last
    layer, without the final norm, are the context.  Without a tokenizer
    (the small configs: ``create_pipeline`` gives a full-width one the
    byte-level tokenizer) the ids are 0..23.  The prompt's attention weights are not applied, as
    in the JAX package."""

    TEMPLATE = "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"

    def __init__(self, qwen_tokenizer, llm_params, llm_cfg: LLMConfig, max_len: int = 1024,
                 device="cuda"):
        self.tokenizer = qwen_tokenizer
        self.pl, self.cl = llm_params, llm_cfg
        self.max_len = max_len
        self.device = torch.device(device)

    def get_learned_condition(self, text: str, clip_skip: int = -1, **kw) -> SDCondition:
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(self.TEMPLATE.format(text))[:self.max_len]
        else:
            ids = list(range(24))
        h = llm_forward(self.pl, torch.tensor([ids], dtype=torch.int64, device=self.device),
                        self.cl, output_layer=self.cl.num_layers - 1)
        return SDCondition(c_crossattn=h)


class QwenImageConditioner:
    """Qwen-Image: the prompt in the ``qwen_image`` chat template, tokenized
    (at most ``max_len`` ids) and run through the whole Qwen2.5-VL text
    tower; the hidden states after the final norm, the template's first 34
    ids dropped, are the context.  Without a tokenizer (the small configs:
    ``create_pipeline`` gives a full-width one the byte-level tokenizer) the
    ids are 0..47 and 8 are dropped, as the JAX golden was made.  The edit
    path (``ref_images`` through the Qwen2.5-VL vision tower) is not ported
    and raises by name."""

    def __init__(self, qwen_tokenizer, llm_params, llm_cfg: LLMConfig, max_len: int = 1024,
                 device="cuda"):
        self.tokenizer = qwen_tokenizer
        self.pl, self.cl = llm_params, llm_cfg
        self.template, self.drop_idx = CHAT_TEMPLATES["qwen_image"]
        self.max_len = max_len
        self.device = torch.device(device)

    def get_learned_condition(self, text: str, clip_skip: int = -1, ref_images=None,
                              **kw) -> SDCondition:
        if ref_images:
            raise NotImplementedError("Qwen-Image-Edit (ref_images through the Qwen2.5-VL vision "
                                      "tower) is not ported")
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(self.template.format(text))[:self.max_len]
            drop = self.drop_idx
        else:
            ids, drop = list(range(48)), 8
        h = llm_forward(self.pl, torch.tensor([ids], dtype=torch.int64, device=self.device), self.cl)
        return SDCondition(c_crossattn=h[:, drop:])
