"""Classifier-free guidance (counterpart of ``sdtpu/diffusion/guidance.py``)."""
from __future__ import annotations


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
