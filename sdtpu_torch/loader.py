"""FLUX diffusion weights from a GGUF checkpoint, kept in its quantized blocks
(counterpart of ``sdtpu/cli.py``'s ``_diffusion_to_device`` around
``load_model_bundle(..., keep_quant=True)``, here this package's own
``sdtpu_torch.io.model_loader``).

    params = load_flux_diffusion("flux1-dev-q4_0.gguf")  # on the card
    pipe = create_pipeline(SDVersion.FLUX, params={"diffusion": params}, ...)

The promotion rule is the CLI's default: q8_0 blocks are re-quantized per
row onto the W8A8 path unless ``promote_q8=False``, which keeps them as
group-32 ``GroupQuantTensor``s; every other quantized type keeps its blocks
(``Q4Tensor`` for q4_0 / q3_k-class blocks with K >= 512, ``GroupQuantTensor``
otherwise); dense tensors are cast to ``dtype``.  ``module_to_device`` stages
a text encoder or the VAE tensor by tensor: a quantized GGUF's
``HostQuant`` moves to the device in its blocks and is dequantized there
(``host_quant_values``: the host's float32 values, bit for bit), any other
tensor is widened on the host and cast on its way, one at a time, so a
module's whole float32 dict is never held on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from sdtpu_torch.io.gguf import HostQuant, _parallel_map
from sdtpu_torch.io.model_loader import load_model_bundle
from sdtpu_torch.ops.quant import (GroupQuantTensor, Q4Tensor, QuantTensor, host_params_to_device,
                                   host_quant_values)


def diffusion_to_device(d: dict, dtype: torch.dtype = torch.bfloat16, device="cuda",
                        promote_q8: bool = True, min_size: int = 1 << 16) -> dict:
    """A diffusion param dict holding ``HostQuant`` blocks → this package's
    tensors on ``device``; 2-D weights under ``min_size`` elements go dense."""
    staged = host_params_to_device(d, device=device, min_size=min_size, rowwise=promote_q8)
    out = {}
    for name, v in staged.items():
        if isinstance(v, (GroupQuantTensor, Q4Tensor, QuantTensor)):
            out[name] = v
        else:
            out[name] = torch.tensor(np.asarray(v), dtype=dtype, device=device)
    return out


def module_to_device(d: dict, dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """A text-encoder or VAE param dict (numpy arrays or ``HostQuant``) →
    dense ``dtype`` tensors on ``device``, staged tensor by tensor."""
    def stage_one(item):
        name, v = item
        if isinstance(v, HostQuant):
            return name, host_quant_values(v, device).to(dtype)
        a = np.asarray(v, dtype=np.float32)
        return name, torch.from_numpy(a if a.flags.writeable else a.copy()).to(device, dtype)

    # a thread pool: dequantization and widening are numpy work that
    # releases the GIL; each thread holds one float32 tensor at a time
    return dict(_parallel_map(stage_one, list(d.items())))


def load_flux_diffusion(path: str, dtype: torch.dtype = torch.bfloat16, device="cuda",
                        promote_q8: bool = True) -> dict:
    """A FLUX diffusion-model checkpoint (GGUF or safetensors) → its params on
    ``device``, quantized GGUF blocks kept as they are; any other model
    raises ``NotImplementedError``."""
    bundle = load_model_bundle(diffusion_model_path=path, keep_quant=True)
    return diffusion_to_device(bundle.diffusion, dtype, device, promote_q8)
