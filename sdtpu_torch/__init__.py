"""sdtpu_torch — the PyTorch/CUDA port of sdtpu for NVIDIA Hopper GPUs.

The JAX package ``sdtpu`` stays the reference; this package mirrors its
layout (ops/, models/, conditioning/, diffusion/, io/, tokenizers/,
pipeline.py, factory.py, cli.py, server.py) and is held against it by the
tests.  The slices ported so far run FLUX.1, SD1.x, SD2.x, SDXL, SD3 and
Z-Image txt2img, img2img and the latent hires fix (the UNets' inpainting
and instruct-pix2pix variants too) and Wan2.1 T2V txt2vid, from random weights
or checkpoint files, through
``create_pipeline`` (``generate``, ``generate_video``) or its own CLI
(``python -m sdtpu_torch.cli``; ``-M vid_gen`` for Wan) and HTTP server
(``python -m sdtpu_torch.server``, images only).  Every TPU kernel on that path is a hand-written Hopper
kernel in ``csrc/`` (flash attention; the W8A8, packed 4-bit, group-dequant
and W8A16 matmuls), launched for CUDA tensors; CPU tensors run each
kernel's plain PyTorch version.

The package stands alone: it imports nothing of ``sdtpu`` and never imports
``jax``.  Its host layer (config types, Philox / torch-CPU noise, CLIP
tokenizer, prompt parser, GGUF and safetensors readers, the model loader, T5 tokenizer, PNG metadata) is its own copy of the JAX package's,
under the same names.  Entry points run on the card (``device="cuda"``;
the CLI and server with no ``--backend``) unless the caller asks for the
CPU, as the tests do.
"""
__version__ = "0.1.0"
