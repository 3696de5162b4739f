"""Guidance combiners (counterpart of ``sdtpu/diffusion/guidance.py``):
classifier-free guidance with pix2pix-style image guidance, Adaptive
Projected Guidance (``APGParams``, ``apg_combine`` with its momentum
buffer), Skip-Layer Guidance (``slg_active_steps``, ``slg_combine``) and
the per-step guidance schedule (``parse_guidance_schedule``).

Pure functions on tensors on the latents' device; the APG momentum buffer is
returned to the caller, which carries it across steps.  APG's norms and
projections reduce over the whole float32 tensor, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class APGParams:
    eta: float = 1.0
    momentum: float = 0.0
    norm_threshold: float = 0.0
    norm_threshold_smoothing: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.eta != 1.0 or self.momentum != 0.0 or self.norm_threshold > 0.0


def cfg_combine(pred_cond, pred_uncond, pred_img_uncond, guidance_scale, image_guidance_scale=1.0):
    """Classifier-free guidance incl. pix2pix-style separate image guidance."""
    if pred_uncond is not None:
        if pred_img_uncond is not None:
            return (pred_img_uncond
                    + image_guidance_scale * (pred_uncond - pred_img_uncond)
                    + guidance_scale * (pred_cond - pred_uncond))
        return pred_uncond + guidance_scale * (pred_cond - pred_uncond)
    if pred_img_uncond is not None:
        return pred_img_uncond + guidance_scale * (pred_cond - pred_img_uncond)
    return pred_cond


def _guidance_delta(pred_cond, pred_uncond, pred_img_uncond, guidance_scale, image_guidance_scale):
    if pred_img_uncond is not None:
        if pred_uncond is not None and guidance_scale == 1.0:
            return pred_uncond - pred_img_uncond
        if pred_uncond is not None:
            return pred_cond + (
                pred_uncond * (image_guidance_scale - guidance_scale)
                + pred_img_uncond * (1.0 - image_guidance_scale)
            ) / (guidance_scale - 1.0)
        return pred_cond - pred_img_uncond
    return pred_cond - pred_uncond


def apg_combine(pred_cond: torch.Tensor, pred_uncond: Optional[torch.Tensor],
                pred_img_uncond: Optional[torch.Tensor], guidance_scale, params: APGParams,
                momentum_buffer: Optional[torch.Tensor] = None,
                image_guidance_scale: float = 1.0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Adaptive Projected Guidance → (pred, new momentum buffer)."""
    if pred_uncond is None and pred_img_uncond is None:
        return pred_cond, momentum_buffer

    deltas = _guidance_delta(pred_cond, pred_uncond, pred_img_uncond, guidance_scale,
                             image_guidance_scale)
    new_buf = momentum_buffer
    if params.momentum != 0.0:
        buf = momentum_buffer if momentum_buffer is not None else torch.zeros_like(deltas)
        deltas = deltas + params.momentum * buf
        new_buf = deltas

    if params.norm_threshold > 0.0:
        standard_res = 2 * 1024 // 8
        diff_norm = (torch.sqrt(torch.sum(deltas * deltas)) * standard_res
                     / torch.sqrt(torch.tensor(float(deltas.numel()), device=deltas.device)))
        x = params.norm_threshold / torch.clamp(diff_norm, min=1e-20)
        if params.norm_threshold_smoothing <= 0.0:
            factor = torch.clamp(x, max=1.0)
        else:
            sm = params.norm_threshold_smoothing
            factor = x / (1.0 + x ** (1.0 / sm)) ** sm
        factor = torch.where(diff_norm > 0.0, factor, torch.ones_like(factor))
        deltas = deltas * factor

    if params.eta != 1.0:
        cond_norm_sq = torch.sum(pred_cond * pred_cond)
        proj = torch.sum(pred_cond * deltas) / torch.clamp(cond_norm_sq, min=1e-20)
        coef = torch.where(cond_norm_sq != 0.0, (params.eta - 1.0) * proj, torch.zeros_like(proj))
        deltas = deltas + coef * pred_cond

    pred = pred_cond
    if pred_uncond is not None:
        pred = pred_cond + (guidance_scale - 1.0) * deltas
        if pred_img_uncond is not None:
            pred = pred + (image_guidance_scale - 1.0) * deltas
    elif pred_img_uncond is not None:
        pred = pred_img_uncond + guidance_scale * deltas
    return pred, new_buf


def slg_active_steps(total_steps: int, start: float, stop: float) -> Tuple[int, int]:
    """SLG applies at steps i with i0 <= i < i1 (0-indexed)."""
    return int(start * total_steps), int(stop * total_steps)


def slg_combine(pred, pred_cond, pred_skip_layer, scale: float):
    return pred + (pred_cond - pred_skip_layer) * scale


def parse_guidance_schedule(spec: str) -> List[float]:
    """'7.5x10+5x10' → [7.5]*10 + [5.0]*10."""
    out: List[float] = []
    if not spec:
        return out
    for segment in spec.split("+"):
        m = re.fullmatch(r"([-+]?[\d.]+(?:e[-+]?\d+)?)x(\d+)", segment)
        if not m:
            raise ValueError(f"invalid guidance schedule segment {segment!r}")
        out.extend([float(m.group(1))] * int(m.group(2)))
    return out
