"""sdtpu_torch — the PyTorch/CUDA port of sdtpu for NVIDIA Hopper GPUs.

The JAX package ``sdtpu`` stays the reference; this package mirrors its
layout (ops/, models/, conditioning/, diffusion/, pipeline.py, factory.py)
and is held against it by the tests.  The slice ported so far runs FLUX.1
txt2img.  Every TPU kernel on that path is a hand-written Hopper kernel in
``csrc/`` (flash attention, the W8A8 int8 matmul, the packed 4-bit matmul),
launched for CUDA tensors; CPU tensors run each kernel's plain PyTorch
version.

Host code that never touches JAX is shared with ``sdtpu`` rather than
copied: the config types, the Philox/MT19937 noise, the tokenizers and the
prompt parser.  This package never imports ``jax``.
"""
__version__ = "0.1.0"
