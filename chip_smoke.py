#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sdtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile table.txt]

Phases, each of which raises on failure (exit code != 0, no result line):
  1. the card's name and power limit (nvidia-smi); no CUDA device → exit 2;
  2. build the hand-written kernels from ``sdtpu_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the FLUX.1-dev txt2img path (the group-dequant and W8A16
     kernels at the W8A8 shapes, the 4-bit kernel at T5-XXL's shapes at
     groups 64, 32 and 16 and at the q4_0 DiT's shapes at group 32, its
     M <= 8 GEMV also at groups 16 and 64; the float32 forms at their own
     cases, each also against the one-pass TF32 fault and a float64 answer),
     with a stated tolerance (at flash D 512 also two faults emulated on
     the same inputs, which must exceed it), and the time of both (CUDA events, after
     warm-up); beside them each case's bound (the larger of its operations
     over the card's peak for their type and its bytes over the memory
     rate) and, where one PyTorch call computes the same function
     (``scaled_dot_product_attention`` for flash, ``torch._int_mm`` for the
     W8A8 GEMM at M > 16, ``torch._weight_int4pack_mm`` for the 4-bit
     matmul at groups 32 and 64, ``torch._weight_int8pack_mm`` for W8A16),
     flash also at the SD1.5 UNet's shapes (D 40, 80 and 160: each level's
     self- and cross-attention at 512² under CFG, the middle block's, a
     ragged and a biased case; bf16 and float32, each with faults that must
     exceed its limit: the padded head dim's softmax scale and unmasked pad
     keys for bf16, the one-pass TF32 fault for float32 and, where the
     float32 call splits its keys (D 160 and 512: each case records its
     ``splits``), the split-keys combine without its rescale; and at the
     SDXL UNet's and CLIP-G's D 64 shapes at 1024² under CFG (10 heads over
     4096 tokens, 20 over 1024, each with its cross-attention over CLIP's
     77, CLIP-G's causal [1, 20, 77, 77]; bf16 with the last 128-key tile
     dropped and unmasked pad keys as faults, float32 with the one-pass TF32
     fault); at SD2.1-768-v's D 64 shapes at 768² under CFG (5 heads over
     9216 tokens with q around +1 and k around -1, its cross-attention over
     OpenCLIP-H's 77, 10 heads over 2304, 20 over 576) and OpenCLIP-H's
     causal call, both dtypes, the faults as SDXL's; at SD3.5-Medium's D 64
     shapes at 1024² under CFG (the joint
     attention over 154 + 4096 = 4250 tokens, ragged on every tile, and
     MMDiT-X's self-attention over 4096; both dtypes, the bf16 faults as
     SDXL's); at Wan2.1-1.3B's D 128 shapes at 832x480 over 9 latent frames
     under CFG (the self-attention over 14040 tokens, ragged on the last
     tile, and the cross-attention over UMT5's 512; bf16 with the unmasked
     pad keys as its fault, q drawn around +1 and k around -1 so the fault
     shows; float32 with the self-attention at B = 1; each also on the
     device clock beside SDPA); at Z-Image-Turbo's D 128 shapes at 1024²
     (the joint attention over 64 + 4096 = 4160 tokens at B = 1 and, under
     CFG, B = 2; the noise refiner's 4096; the context refiner's 64; in
     float32 the 512² joint 1088 and the 64; the ragged and short ones with
     q around +1 and k around -1); at Qwen-Image's D 128 shapes (the joint
     attention over 164 + 4096 = 4260 tokens under CFG, ragged, q around +1
     and k around -1; float32 the 512² joint 1188); the 4-bit matmul at
     Qwen2.5-VL-7B's four shapes over a Qwen-Image prompt's 198 byte-level
     ids (group 64, bf16 wgmma and float32) and at the q4_0 file DiT's six
     group-32 shapes at 1024² under CFG; the 4-bit matmul at Qwen3-4B's five
     shapes over a Z-Image prompt's 55 tokens (group 64, bf16 split-K and
     float32) and at UMT5-XXL's three shapes
     over Wan's 512 tokens (group 64, bf16 wgmma and float32) and at
     T5-XXL's three shapes over SD3's 77
     tokens (groups 64 and 32, bf16 in its split-K form and float32, each
     also on the device clock beside ``_weight_int4pack_mm``), and every bf16
     case of 9 to 128 rows on the device clock (the split-K form at 16, 64,
     77 and 100 rows and at the wgmma threshold's 127 against 128), each
     split-K case with its ``splits`` and, as a fault that must exceed the
     limit, the plain split-and-combine with its last K split dropped; flash's bound
     also counts its B·H·Lq·Lk exponentials at the special-function unit's
     rate, ``bound_by`` "exp" where they bound it; a flash case under 0.1 ms
     also records the kernel's and SDPA's device time a call,
     ``device_ms`` / ``library_device_ms``: the sum of the call's kernels in
     torch.profiler, a split call's combine included),
     that call's time, after its output was checked against the plain
     version (a call that is refused or disagrees records null and why);
     at M <= 8, where the CUDA-event time reads the Python wrapper's launch
     rate, also the kernel's mean device time a call (``device_ms``, from
     torch.profiler's record of its launches over the timed iterations);
  4. a small-input reference check: T5, CLIP, one DiT forward, a VAE
     decode, one SD1.5 UNet forward (its widths and heads, one res block
     a level, a 16x16 latent), one SDXL UNet forward with its vector ``y``
     (SDXL's widths and 64-channel heads, one res block a level, depth 1,
     a 16x16 latent under CFG), CLIP-G's hidden state at clip skip 2 and its
     pooled projection (full width, two layers), a TAESD-XL decode, three
     SD3.5-Medium MMDiT blocks (64-channel heads, qk RMS norms, MMDiT-X's
     attn2, the pre-only last block; a 32x32 latent beside 154 context
     tokens) and the SD3 conditioner (those CLIPs, a 4-bit T5 1536 wide),
     one Wan2.1 block (128-wide heads, a 3 x 8 x 12 latent beside 40 text
     tokens), a Wan VAE decode (32 wide, 16 latent channels, 3 latent
     frames) and the Wan conditioner on a 4-bit UMT5 over 512 tokens, an
     SD2 inpainting UNet (64-channel heads, linear proj, a 9-channel stem,
     one res block a level) and the SD2 conditioner on OpenCLIP-H (full
     width, three layers, pad id 0, clip skip 2), at
     kernel-shaped small widths, on the card (kernels, bf16 and float32)
     against the same weights on the CPU (plain versions, float32);
  5. the GGUF loader at full FLUX.1-dev width and cut depth: a DiT of one
     double and one single block written by ``save_gguf`` (q8_0, q4_0 and
     q4_1 tensors; q6_k and q4_k blocks added from random raw blocks),
     loaded with ``load_model_bundle(keep_quant=True)`` and staged by
     ``sdtpu_torch.loader.diffusion_to_device`` with and without q8_0
     promotion; DiT forwards of each staging at four inputs, the promoted
     one against the same forward on the blocks' dense dequantized values,
     the kept one against that forward in float32 (no further from it than
     the dense bf16 forward's noise allows), and the kept blocks once more
     with float32 x (the float32 forms) against the blocks' values in a
     float32 forward; then the file loaded again by
     ``sdtpu_torch.loader.load_flux_diffusion`` (blocks kept), built into a
     pipeline by ``create_pipeline(params=...)`` and answering one 512²
     request through ``generate``;
  6. main path 1: ``sdtpu_torch.factory.create_pipeline`` at full FLUX.1-dev
     width (int8 DiT, 4-bit T5-XXL, bf16 CLIP-L and VAE) with random weights
     drawn on the card, VAE tiling on, answering three txt2img requests
     through ``generate`` (one with CFG and a batch of two);
  7. two more requests on that pipeline (512² and 1024²) with
     ``SDTPU_QUANT_MODE=w8a16`` (the DiT's int8 linears through the W8A16
     kernel);
  8. main path 2: the same pipeline with the DiT in the ``q8_0_gguf`` class
     (group-32 int8 blocks drawn on the card, the footprint of a q8_0 GGUF
     kept in its blocks), answering a 512² and a 1024² request;
  9. main path 3: the same pipeline with the DiT in the ``q4_0`` class
     (packed 4-bit blocks on a q4_0 GGUF's group-32 grid, drawn on the card),
     answering a 512² and a 1024² request;
 10. main path 4, the default dtype: ``create_pipeline(SDVersion.FLUX,
     device="cuda", seed=0)`` with no dtype argument, so float32 throughout
     (int8 DiT through W8A8 with float32 x, 4-bit T5-XXL through the 4-bit
     kernel's float32 form, CLIP-L and the VAE in float32, every attention
     through the float32 flash kernel), answering a 512² and a 1024² request
     (path ``f32``), then a 512² request with ``SDTPU_QUANT_MODE=w8a16``
     (path ``f32_w8a16``: the W8A16 kernel's float32 form).
 10b. SD1.5 at full width (``create_pipeline(SDVersion.SD1, ...)``, dense
     random weights drawn on the card): path ``sd15`` in bf16 answers the
     JAX bench's request (``bench_sd15``: "a photograph of an astronaut
     riding a horse", 512², 20 steps, euler_a, discrete schedule, CFG 7,
     seed 42) once to warm up and once timed, then with dpm++2m; path
     ``sd15_f32`` (no dtype argument: float32) answers it at 4 steps.  On
     both, flash launches exactly the UNet's calls per forward at D 40 / 80
     / 160 (10 / 10 / 12) times its forwards, CLIP-L's 12 at D 64 a prompt
     encode and D 512 once a decode, and no attention runs in the plain
     version on the card (``_check_unet_family``, as in 10g).
 10c. SDXL at full width (``create_pipeline(SDVersion.SDXL, ...)``, dense
     random weights drawn on the card, a TAESD-XL decoder drawn from the
     JAX bench's seed attached with ``set_tae``): path ``sdxl`` in bf16
     answers ``bench_sdxl_lcm_taesd``'s request (bench.py:441: "a
     photograph of an astronaut riding a horse", 1024², 4 lcm steps,
     discrete, CFG 1, seed 42) once to warm up and once timed, one with a
     fresh prompt, then, after ``set_tae(None)``, a 1024² × 4-step euler
     request at CFG 5 with a negative prompt and VAE tiling (the vector's
     uncond half, the CFG batch of two, flash D 512); path ``sdxl_f32`` (no
     dtype argument: float32) answers the bench request at 2 steps.  On
     both, the flash launches at D 64 equal the UNet's 140 calls a forward
     times its forwards plus 43 a prompt encode (CLIP-L and CLIP-G), D 40 /
     80 / 160 do not launch, D 512 once a tile of the full-VAE request's
     decode, and no attention runs in the plain version on the card
     (``_check_unet_family``).
 10d. SD3.5-Medium at full width (``create_pipeline(SDVersion.SD3,
     params=...)``: the MMDiT-X, CLIP-L with its 768-wide projection, CLIP-G
     and the SD3 VAE dense, T5-XXL packed 4-bit, drawn on the card with the
     JAX bench's seeds, the MMDiT config fingerprinted from the weights):
     path ``sd3`` in bf16 answers ``bench_sd35_medium``'s request (bench.py:
     515: "a photograph of an astronaut riding a horse", negative "blurry",
     1024², 28 dpm++2m steps, discrete, CFG 4.5, seed 42) once to warm up,
     once timed and once with a fresh prompt; path ``sd3_f32``
     (``create_pipeline(SDVersion.SD3)`` with no params and no dtype:
     SD3-Medium in float32) answers it at 512² and 2 steps.  On both, flash
     at D 64 launches 37 a forward (24 for SD3-Medium) times the forwards
     plus 44 a prompt encode (CLIP-L and CLIP-G), D 512 once a decode, the
     4-bit matmul 168 a prompt encode in the path's form (bf16: the split-K
     form at T5's 77 rows, no wgmma or GEMV launch; float32: its float32
     form), and on the card no attention runs in the plain version but T5's
     24 a prompt encode (its relative-position bias, as in the JAX package).
 10e. Wan2.1-T2V-1.3B at full width (``create_pipeline(SDVersion.WAN2,
     params=...)``: the DiT and the Wan VAE dense, UMT5-XXL packed 4-bit,
     drawn on the card with the JAX bench's seeds, the DiT config
     fingerprinted from the weights; the bench's decode tiling: spatial
     tiles of 32 latent pixels, temporal windows of 5 latent frames with
     one of overlap): path ``wan`` in bf16 answers ``bench_wan21_t2v``'s
     request (bench.py:592: "a corgi running on a beach", negative
     "static", 832x480, 33 frames, 8 euler steps, CFG 6, seed 42) through
     ``generate_video`` once to warm up and twice timed, printing each
     request's sample and decode seconds, DiT steps/s and decode s/frame;
     then decodes the last request's latents once untiled (its seconds and
     peak memory) and holds one full-width DiT forward of the bench's
     latent (B = 1) against the same forward with every attention in the
     plain version (REF_REL_TOL); path ``wan_f32`` (no dtype argument:
     float32) answers the request at 2 steps on the DiT cut to
     ``WAN_F32_BLOCKS`` blocks.  On both, flash at D 128 launches 60 a
     forward (2 x 2 on the cut DiT), nothing else of flash, the 4-bit
     matmul 168 a prompt encode (bf16: its wgmma form at UMT5's 512 rows;
     float32: its float32 form), and on the card no attention runs in the
     plain version but UMT5's 24 a prompt encode; the frames are finite,
     of the asked size and not constant.
 10e'. Z-Image-Turbo at full width (``create_pipeline(SDVersion.Z_IMAGE,
     dtype=torch.bfloat16, qwen_tokenizer=Qwen2Tokenizer.byte_fallback())``:
     the DiT and the FLUX VAE dense, Qwen3-4B packed 4-bit, the factory's
     own draw on the card, the LLM held to be Qwen3-4B): path ``z_image``
     answers 1024² x 8 euler steps at CFG 1 to warm up, timed, and with a
     fresh prompt, then 1024² x 2 at CFG 4 with a shorter negative prompt
     (its context zero-padded for the CFG batch); then holds one full-width
     DiT forward against the same forward with every attention in the plain
     version (REF_REL_TOL); path ``z_image_f32`` (no dtype argument:
     float32) answers 512² x 2 on the DiT cut to ``Z_IMAGE_F32_LAYERS``
     main layers.  On both, flash at D 128 launches 34 a forward (6 on the
     cut DiT), D 512 once a decode, nothing else of flash, the 4-bit matmul
     245 a prompt encode (bf16: its split-K form at the prompt's 55 rows;
     float32: its float32 form), no W8A8 launch, and on the card no
     attention runs in the plain version but Qwen3's 35 a prompt encode.
 10e''. Qwen-Image at full width (``create_pipeline(SDVersion.QWEN_IMAGE,
     dtype=torch.bfloat16, qwen_tokenizer=Qwen2Tokenizer.byte_fallback())``:
     the DiT (20.4e9 parameters) and the Wan VAE dense, Qwen2.5-VL-7B packed
     4-bit, the LLM held to be Qwen2.5-VL-7B): path ``qwen_image`` answers
     1024² x 8 euler steps at CFG 2.5 with a shorter negative prompt (its
     context zero-padded for the CFG batch) to warm up, timed, and with a
     fresh prompt; then holds one full-width DiT forward against the same
     forward with every attention in the plain version (REF_REL_TOL); path
     ``qwen_image_img2img`` answers a 1024² init image through the Wan
     VAE's encoder (one frame), 3 of 4 steps at 0.6, then masked (the kept half
     of the final latent the init image's encode within MASK_KEEP_TOL);
     then, the DiT quantized per row in place (``--type q8_0``'s rule), one
     forward on the prompt's first 64 context rows through W8A8 against
     plain quantized linears at relative L2 0 with its GEMV / split-K /
     wgmma counts (``qwen_image_w8a8_forms``); path ``qwen_image_f32`` (no
     dtype argument: float32) answers 512² x 2 on the DiT cut to
     ``QWEN_IMAGE_F32_LAYERS`` blocks.  On each, flash at D 128 launches 60
     a forward (2 on the cut DiT), nothing else of flash (the Wan VAE's
     attention is plain float32), the 4-bit matmul 196 a prompt encode in
     the form its byte-level id count selects (wgmma; float32: its float32
     form), no W8A8 launch, and on the card no attention runs in the plain
     version but Qwen2.5-VL's 28 a prompt encode.
 10f. img2img, masked img2img and the latent hires fix, each in its launch
     window on a pipeline of the paths above, from a 1024² (512² on SD1.5)
     init image drawn from ``IMG2IMG_SEED`` and a mask whose right half
     regenerates: path ``img2img`` on the int8 FLUX.1-dev pipeline (the
     bench's VAE tiling) answers a 4-step request at strength 0.75 (its
     ``encode`` seconds printed beside cond / sample / decode), then encodes
     the image once untiled (one D 512 call over 16384 tokens); path
     ``img2img_mask`` answers the masked request at 0.6, whose kept half of
     the final latent must be the tiled encode of the init image within
     ``MASK_KEEP_TOL`` and whose regenerated half must move; path ``hires``
     on the bf16 SD1.5 pipeline answers ``txt2img_hires`` 512² → 1024² at
     0.7; paths ``sdxl_img2img`` (the full VAE, untiled, after
     ``set_tae(None)``) and ``sd3_img2img`` answer a 1024² request of 4 steps at 0.6.
     Flash D 512 launches exactly once a tile of each encode and decode
     through the full VAE, each family's UNet / DiT flash forms as in
     txt2img, the steps sampled are ``img2img_steps``'s, and no attention
     runs in the plain version on the card but T5's.
 10g. SD2.x and the inpainting and instruct-pix2pix UNets at full width,
     dense random weights drawn on the card (``create_pipeline(<version>,
     dtype=torch.bfloat16, v_prediction=...)``): path ``sd2`` (SD2.1-768-v:
     768², CFG 7 with a negative prompt, 20 euler_a steps to warm up and
     timed, then 6 heun steps) and ``sd2_f32`` (no dtype: float32, 2 heun
     steps); paths ``sd15_inpaint`` (512², a seeded init image with its right
     half masked, strength 1, 20 euler_a steps, CFG 7, then the same without
     the init image), ``sd2_inpaint`` (512² x 2), ``sdxl_inpaint`` (1024² x
     8 euler, CFG 5, the full VAE untiled), ``sd15_pix2pix`` (512² x 20
     euler_a, CFG 7.5, image guidance 1.5: three UNet calls a step) and
     ``sdxl_pix2pix`` (1024² x 2 from a reference image).  On each, flash
     launches exactly its family's calls a UNet call (SD2's 32 and SDXL's 140
     at D 64, SD1's 10 / 10 / 12 at D 40 / 80 / 160) times the calls (heun
     two a step but the last's one), plus its text encoders' a prompt encode
     (OpenCLIP-H's 22, CLIP-L's 12, CLIP-L and CLIP-G's 43), D 512 once a
     VAE call (a decode, the init image's encode, the masked or edit image's
     encode), nothing else, and no attention in the plain version on the
     card (``_check_unet_family``).
 10j. the sampling layer, inside 10b, 10d, 10e and Z-Image's paths on their
     bf16 pipelines (each request in its own launch window, counted under
     ``sampling_sd15`` / ``_sd3`` / ``_wan`` / ``_z_image``; one ``sampling``
     line a request with its forwards, launch check and times beside the
     card): on SD1.5 the 13 methods the sampling slice ported (512², CFG 7,
     6 karras steps; each replayed on the CPU in float32 from the card's
     recorded denoised estimates, the final latent within
     ``SAMPLING_REPLAY_LIMIT`` relative L2; dpm2 and res_2s two forwards a
     step but the last), the 11 new eps schedules (4 euler steps) and APG;
     on SD3.5-Medium skip-layer guidance (layers 7-9, the CLI's window) at
     1024² x 10 beside the same request without it (37 flash calls a
     forward, 31 a skip-layer forward); on Wan2.1 SLG on a 9-frame x 2-step
     clip (60 and 58); on Z-Image-Turbo 1024² x 8 uncached and under each
     of the five step caches (34 calls a computed forward), the flow
     schedules and the flow dpm++2s_a.  ``elapsed sampling`` sums the parts.
 11. main path 5, the entry points, on files: a full FLUX.1-dev checkpoint
     set written by ``sdtpu_torch.tools.flux_files`` into a temporary
     directory under ``build/chip_smoke/`` (removed after; the free disk
     space is checked first): the DiT at full width and depth as a q8_0
     GGUF, T5-XXL as a q8_0 GGUF under llama.cpp names with a synthetic
     32128-piece vocab embedded, CLIP-L as bf16 safetensors and the FLUX VAE
     (encoder included) as safetensors.  ``sdtpu_torch.cli.main`` answers one
     1024² 2-step euler request with VAE tiling from them (path ``cli``: the
     T5 tokenizer found in the GGUF, q8_0 promoted to W8A8), and the PNG is
     read back in metadata mode, then ``-i`` / ``--mask`` / ``--strength 0.6``
     over 4 steps (path ``cli_img2img``: the init image and the mask as PNG
     files, the PNG read back in metadata mode); then
     ``sdtpu_torch.server.main``, loaded
     from the same files with ``--no-promote-q8`` (the DiT in its group-32
     blocks), serves on 127.0.0.1 three 512² requests of at most 4 steps
     (``/sdapi/v1/txt2img`` with no sampler named, so euler_a;
     ``/v1/images/generations``; an ``/sdcpp/v1/img_gen`` job polled to
     completion with its progress seen) and cancels one queued job (path
     ``server``).  Then SD1.5 on a file: ``sdtpu_torch.tools.sd15_file``
     writes a full-width float16 single-file checkpoint under the LDM names
     (2.13e9 bytes), ``cli.main -m`` answers one 512² × 20-step request to
     a PNG (path ``sd15_cli``) and then ``--hires`` 512² → 1024² (path
     ``sd15_cli_hires``), and the server, loaded from the same file, one
     A1111 ``/sdapi/v1/txt2img`` request (path ``sd15_server``), one
     ``/sdapi/v1/img2img`` request with a 1024² Paeth-filtered PNG in
     ``init_images`` and a ``mask`` (path ``sd15_server_img2img``; the
     PNG's host decode seconds beside the request's) and one ``enable_hr`` txt2img request (path
     ``sd15_server_hires``), each with the launch checks of 10b (and 10f's
     D 512 count).  Then SDXL on files:
     ``sdtpu_torch.tools.sdxl_file`` writes a full-width float16 single-file
     SDXL checkpoint under the SGM names (CLIP-G under OpenCLIP's, 6.94e9
     bytes) and a TAESD-XL decoder file; ``cli.main -m ... --taesd ...``
     answers the bench's 1024² × 4-step lcm request to a PNG, read back in
     metadata mode (path ``sdxl_cli``), and the server, loaded from the
     same files, one A1111 request with ``sampler_name`` lcm (path
     ``sdxl_server``), each with the launch checks of 10c.  Then SD3.5 on
     files: ``sdtpu_torch.tools.sd3_file`` writes the published SD3.5-Medium
     layout (the MMDiT-X and the SD3 VAE in one float16 file, CLIP-L and
     CLIP-G float16 files, T5-XXL as a q8_0 GGUF with its vocab);
     ``cli.main -m ... --clip_l ... --clip_g ... --t5xxl ...`` answers the
     bench's request to a PNG, read back in metadata mode (path ``sd3_cli``),
     and the server, loaded from the same files, one A1111 request with
     ``sampler_name`` dpm++2m (path ``sd3_server``), each with the launch
     checks of 10d (T5 dequantized when staged, as the JAX CLI does: no
     4-bit call).  Then Wan2.1 on files: ``sdtpu_torch.tools.wan_file``
     writes the DiT and the VAE's decoder as float16 safetensors and
     UMT5-XXL as a q8_0 GGUF with its vocab; ``cli.main -M vid_gen`` answers
     a 832x480 clip of 9 frames at 2 steps with the bench's tiling (path
     ``wan_cli``): 9 PNG frames of 832x480, not constant, with the launch
     checks of 10e (UMT5 dequantized: no 4-bit call).  Then Z-Image on
     files: ``sdtpu_torch.tools.z_image_file`` writes the DiT as a q8_0
     GGUF, Qwen3-4B as a q4_0 GGUF under llama.cpp names with a "gpt2"
     vocab and the FLUX VAE; ``cli.main --diffusion-model ... --llm ...
     --vae ...`` answers 1024² x 4 euler steps at CFG 1 to a PNG, read back
     in metadata mode (path ``z_image_cli``: the tokenizer from the GGUF's
     vocab), and the server, loaded from the same files, the A1111 request
     (path ``z_image_server``), each with the launch checks of 10e' but
     Qwen3 dequantized (no 4-bit call) and the DiT's q8_0 promoted onto
     W8A8: ``Z_IMAGE_W8A8_PER_FORWARD`` a forward in the GEMV, split-K and
     wgmma forms.  Then Qwen-Image on files: ``sdtpu_torch.tools.
     qwen_image_file`` writes the DiT as a q4_0 GGUF, Qwen2.5-VL-7B as a
     q4_0 GGUF under llama.cpp names with a "gpt2" vocab and the Wan VAE with
     its encoder; ``cli.main --diffusion-model ... --llm ... --vae ... -i
     init.png --strength 0.6`` answers 1024² x 4 euler steps (the last 3
     sampled) at CFG 2.5 with a negative prompt to a PNG, read back in
     metadata mode (path ``qwen_image_cli``), and the server, loaded from
     the same files, the A1111 txt2img request (``qwen_image_server``) and
     an img2img one at 0.6 under another prompt
     (``qwen_image_server_img2img``): one load for each entry point; each
     with the launch checks of 10e''
     but Qwen2.5-VL dequantized (no 4-bit call from it) and the DiT in its
     q4_0 blocks: ``qwen_image_file_forms`` a forward (the 4-bit GEMV at the
     modulation's two rows, wgmma at both streams, ``img_in`` through
     ``gq_matmul_ws``).  Then SD2.1 on a file
     (``tools/sd2_file.py``: OpenCLIP-H under ``cond_stage_model.model.``,
     24 resblocks): ``cli.main -m ... --prediction v --sampling-method heun``
     answers 768² x 8 steps (path ``sd2_cli``); the SD1.5-inpainting file
     (``tools/sd15_file.py`` with 9 input channels) through the CLI and the
     A1111 txt2img route with no init image (``sd15_inpaint_cli``,
     ``sd15_inpaint_server``), then with ``-i`` / ``--mask``
     (``sd15_inpaint_cli_img2img``) and the A1111 route's masked img2img
     (``sd15_inpaint_server_img2img``); the instruct-pix2pix file (8 channels)
     through ``-r`` and ``--img-cfg-scale 1.5`` (``sd15_pix2pix_cli``), each
     512² x 8 steps with the launch checks of 10g.
 12. LoRA (``sdtpu_torch/models/lora.py``), inside the paths above, with
     rank-16 kohya LoRAs drawn by ``tools/lora_file.py`` over every linear:
     on the int8 FLUX.1-dev pipeline (full width and depth) the LoRA is
     written as a torch ``.ckpt`` and read back through the restricted
     unpickler, then ``LORA_REQUEST`` (1024² x 4) runs without it
     (``lora_none``), with ``set_loras(auto)``'s runtime factors
     (``lora_auto``; ``lora_auto_w8a16`` under SDTPU_QUANT_MODE=w8a16), the
     DiT cut to 1 + 1 blocks held in bf16 against a float32 forward on the
     dense merge (REF_REL_TOL; the base without factors and the factors at
     0.9 above it; read, not held, at 2 + 2) and five linears' factors
     against float32 x·ΔWᵀ on the same W8A8 product (2 % of the LoRA's
     contribution; the factors at 0.95 above it), with
     ``immediately``'s requantized int8 (``lora_immediately``; three
     weights' integers held to the CPU's) and after ``set_loras([])``
     (``lora_restored``: latents bit-equal to ``lora_none``'s), W8A8
     launching as often each time; on the ``q8_0_gguf`` and ``q4_0`` DiTs,
     cut to 1 + 1 blocks at full width, a merge requantized on its grid
     (4-bit at group 64, GGUF blocks symmetric; integers held to the CPU's)
     and one 1024² forward through the kernels against their plain versions
     (``lora_q8_0_gguf``, ``lora_q4_0``); on the dense SDXL pipeline each
     mode's ``set_loras`` epoch timed; in phase 11 ``cli.main`` on the SDXL
     files with ``<lora:sdxl_style:0.8>`` from a ``.ckpt`` over the UNet,
     CLIP-L and CLIP-G (``sdxl_lora_cli``), and a server on the SD1.5 file
     with ``--lora-model-dir`` and ``--embd-dir`` answering a ``lora``
     field and the embedding's trigger word, listing ``/sdapi/v1/loras``
     and restoring on ``"lora": []`` (``sd15_lora_server``).
 13. the tiny UNets, ControlNet and diffusers names (after phase 11's
     entry points): SDXS-0.9 at full width, random dense weights on the
     card, one 512² step at CFG 1 (path ``sdxs09``), 4 at CFG 7 (the CFG
     batch, ``sdxs09_cfg``) and one step in the default float32
     (``sdxs09_f32``); SD1 tiny, SD2 tiny and SDXS-512-DS at 512² x 4, CFG
     7 (``sd1_tiny``, ``sd2_tiny``, ``sdxs512``); flash held to each UNet's
     calls (TINY_ATTENTION_CALLS: SDXS-0.9's one head of 320 six times a
     forward, in ``flash_attention_d320``); flash's D 320 cases in phase 3
     (bf16 with its faults: the second warpgroup's last output block
     dropped, the scores over the first warpgroup's half, a key tile
     dropped and the split combine unscaled; float32 with the one-pass TF32
     fault and the unscaled combine).  Then ControlNet with a canny hint at
     strength 0.9: SD1.5's bench request (512² x 20 euler_a, CFG 7; path
     ``sd15_controlnet``) and SDXL at 1024² x 4, CFG 1, the full VAE
     (``sdxl_controlnet``), the ControlNet drawn on the card with its taps
     non-zero; flash held to the UNet's and the ControlNet's calls
     (CONTROLNET_ATTENTION_CALLS) a step; one controlled forward each held
     to the same forward with plain attention (REF_REL_TOL; the forward
     without the ControlNet above it).  Then files under diffusers names
     (the SD1.5 UNet, the SD1.5 ControlNet, SD3.5-Medium's MMDiT cut to
     SD3_FILE_DEPTH blocks, the Wan 2.1 VAE with its encoder), each loaded
     to the same tensors as the same module under its original names, and
     ``cli.main --diffusion-model <diffusers UNet> --clip_l --vae
     --control-net <diffusers ControlNet> --control-image --canny`` at 512²
     x 4 (``sd15_controlnet_cli``).
Every path of phases 5-13 sets the kernels' launch counts to 0 before it runs
and reads them after: each kernel that path runs must have launched.  The
4-bit kernel's TMA + wgmma form (M >= 128) and its weight-streaming GEMV
(M <= 8) are counted apart as well, as ``q4_matmul_wgmma`` and
``q4_matmul_gemv``, and its split-K form (8 < M < 128) as
``q4_matmul_splitk``; the ``q4_0`` path must run its M = 1 linears through
the GEMV and no call through the split-K form.
The W8A8, group-dequant and W8A16 wrappers count their weight-streaming
GEMV (M <= 8), their split-K form (8 < M < 128) and their wgmma form apart
(``w8a8_matmul_gemv``, ``w8a8_matmul_splitk``, ``w8a8_matmul_wgmma``, and
the same for ``gq_matmul`` and ``w8a16_matmul``; the affine matmul's
``mma.sync`` form, the one left below 128 rows, as ``gq_zero_matmul_mma``):
the ``int8``, ``w8a16`` and ``q8_0_gguf`` paths, like ``q4_0``, must run
every DiT linear of M <= 8 (M = 1, or 4 under CFG with a batch of two)
through the GEMV and no call through the split-K form.  The W8A8 GEMV
quantizes x in its one launch, so its cases' ``device_ms`` (one kernel a
call) also shows that no row-quantize launch runs in front of it.
The int8 SDXL paths (``sdxl_q8``: the UNet per-row int8 on W8A8;
``sdxl_q8_w8a16``: the same weights under SDTPU_QUANT_MODE=w8a16;
``sdxl_q8_gguf``: group-32 int8 blocks; ``sdxl_q8_cli`` / ``sdxl_q8_server``:
``cli.main`` / ``server.main`` with ``--type q8_0`` on the SDXL file)
answer the bench's SDXL request (1024², 4 lcm
steps, CFG 1, TAESD-XL) and must run their class's split-K form exactly 140
times a UNet forward (the context projections at 77 rows), every launch of
their wrapper in a form that is not ``mma.sync`` (the wrapper's count equal
to its forms' sum), flash as ``_check_unet_family`` holds it; the first
three also hold one full-width UNet forward against the same forward with
every quantized linear in its plain version on the card (REF_REL_TOL).
The float32 forms of flash, the 4-bit, group-dequant, affine and W8A16
matmuls are counted apart (``flash_attention_f32``, ``q4_matmul_f32``,
``gq_matmul_f32``, ``gq_zero_matmul_f32``, ``w8a16_matmul_f32``): the
float32 paths run every launch of the flash, 4-bit and W8A16 wrappers in
them and no bf16 form, the bf16 request paths none of them; the loader's
float32 forward runs the 4-bit, group-dequant and affine ones.
The ``cli`` path must run flash at D 64 (CLIP-L), 128 (the DiT) and 512 (the
VAE), the W8A8 GEMV and wgmma forms and no form for 8 < M < 128; the
``server`` path the group-dequant GEMV and wgmma forms, flash, and no W8A8.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

DEVICE = "cuda"
ROOT = Path(__file__).resolve().parent

W8A8_SRC = "sdtpu_torch/csrc/w8a8_matmul.cu"
GQ_SRC = "sdtpu_torch/csrc/gq_matmul.cu"
FLASH_SRC = "sdtpu_torch/csrc/flash_attention.cu"
Q4_SRC = "sdtpu_torch/csrc/q4_matmul.cu"
KERNEL_INFO = {
    "flash_attention": (FLASH_SRC, "sdtpu/ops/flash_attention.py:51"),
    "flash_attention_d512": (FLASH_SRC, "sdtpu/ops/flash_attention.py:51"),
    "flash_attention_f32": (FLASH_SRC, "sdtpu/ops/flash_attention.py:51"),
    # bf16 D 64: CLIP-L, CLIP-G and the SDXL UNet (counted apart)
    "flash_attention_d64": (FLASH_SRC, "sdtpu/ops/flash_attention.py:51"),
    # the SD1.5 UNet's head dims, bf16 and float32 forms (counted per D)
    "flash_attention_d40": (FLASH_SRC, "sdtpu/ops/flash_attention.py:51"),
    "flash_attention_d80": (FLASH_SRC, "sdtpu/ops/flash_attention.py:51"),
    "flash_attention_d160": (FLASH_SRC, "sdtpu/ops/flash_attention.py:51"),
    # SDXS-0.9's one head of 320, bf16 and float32 forms (counted together)
    "flash_attention_d320": (FLASH_SRC, "sdtpu/ops/flash_attention.py:51"),
    "w8a8_matmul": (W8A8_SRC, "sdtpu/ops/quant.py:416"),
    "w8a8_matmul_gemv": (W8A8_SRC, "sdtpu/ops/quant.py:416"),
    "q4_matmul": (Q4_SRC, "sdtpu/ops/quant.py:845"),
    "q4_matmul_wgmma": (Q4_SRC, "sdtpu/ops/quant.py:845"),
    "q4_matmul_gemv": (Q4_SRC, "sdtpu/ops/quant.py:845"),
    "q4_matmul_f32": (Q4_SRC, "sdtpu/ops/quant.py:845"),
    # the bf16 split-K form (M 9-127): T5-XXL over SD3's 77 tokens
    "q4_matmul_splitk": (Q4_SRC, "sdtpu/ops/quant.py:845"),
    "gq_matmul": (GQ_SRC, "sdtpu/ops/quant.py:616"),
    "gq_matmul_ws": (GQ_SRC, "sdtpu/ops/quant.py:652"),
    "gq_zero_matmul": (GQ_SRC, "sdtpu/ops/quant.py:687"),
    "gq_matmul_f32": (GQ_SRC, "sdtpu/ops/quant.py:616"),
    "gq_zero_matmul_f32": (GQ_SRC, "sdtpu/ops/quant.py:687"),
    "w8a16_matmul": (GQ_SRC, "sdtpu/ops/quant.py:525"),
    "gq_matmul_gemv": (GQ_SRC, "sdtpu/ops/quant.py:616"),
    "w8a16_matmul_gemv": (GQ_SRC, "sdtpu/ops/quant.py:525"),
    "w8a16_matmul_f32": (GQ_SRC, "sdtpu/ops/quant.py:525"),
    # the int8 split-K forms (M 9-127): an int8 SDXL UNet's context
    # projections at CFG 1
    "w8a8_matmul_splitk": (W8A8_SRC, "sdtpu/ops/quant.py:416"),
    "gq_matmul_splitk": (GQ_SRC, "sdtpu/ops/quant.py:616"),
    "w8a16_matmul_splitk": (GQ_SRC, "sdtpu/ops/quant.py:525"),
}

# W8A8 at FLUX.1-dev shapes (M tokens, K in, N out): 4352 = 4096 img + 256 txt
# tokens at 1024², M = 1 for the modulation linears, the embedders and head;
# M = 127, 128 and 129 at the wgmma kernels' threshold (127 takes the
# mma.sync forms), M = 1024 the 512² request's image tokens; the double
# block's modulation at M = 2, 4 and 8 (batch, CFG: the GEMVs' rows) and M =
# 9 (the first mma.sync row).
W8A8_CASES = [
    (4352, 3072, 9216), (4352, 3072, 3072), (4352, 3072, 12288), (4352, 12288, 3072),
    (4352, 3072, 21504), (4352, 15360, 3072), (1280, 3072, 21504), (1, 3072, 18432),
    (1, 3072, 9216), (1, 256, 3072), (1, 768, 3072), (256, 4096, 3072), (4096, 64, 3072),
    (4096, 3072, 64), (127, 3072, 12288), (128, 3072, 12288), (129, 3072, 12288),
    (1024, 3072, 12288), (2, 3072, 18432), (4, 3072, 18432), (8, 3072, 18432),
    (9, 3072, 18432),
]
# W8A8 with float32 x (the default pipeline's int8 DiT) at the DiT's M >= 128
# shapes: the 1024² request's 4352 tokens, the 512² request's 1280 and 1024
W8A8_F32_CASES = [(4352, 3072, 9216), (4352, 3072, 3072), (4352, 3072, 12288), (4352, 12288, 3072),
                  (4352, 3072, 21504), (4352, 15360, 3072), (1280, 3072, 21504), (1024, 3072, 12288)]
# group 16 (q3_k / q6_k blocks) at two of them
GQ16_CASES = [(4352, 3072, 12288), (1, 3072, 18432)]
# (M, K, N, group) of the group-dequant and affine float32 form (a q8_0 / q4_1
# GGUF DiT kept in its blocks at the default dtype): the 512² request's
# linear2-sized 1280 tokens at groups 32 and 16, a modulation linear (M = 1)
# and the 1024² request's MLP width
GQ_F32_CASES = [(1280, 3072, 3072, 32), (1280, 3072, 3072, 16), (1, 3072, 18432, 32),
                (4352, 3072, 12288, 32)]
# (B, H, Lq, Lk, D, dtype, bias) — FLUX joint attention at 1024² and 512²,
# CLIP-L with its causal mask, the VAE mid-block per 64-latent tile, in bf16
# and in float32 (the default pipeline's dtype), and a biased D 512 case.
FLASH_CASES = [
    (1, 24, 4352, 4352, 128, "bf16", None), (1, 24, 1280, 1280, 128, "bf16", None),
    (2, 12, 77, 77, 64, "bf16", "causal"), (1, 1, 4096, 4096, 512, "bf16", None),
    (1, 2, 300, 200, 512, "bf16", "random"),
    (1, 24, 1280, 1280, 128, "f32", None), (1, 24, 4352, 4352, 128, "f32", None),
    (2, 12, 77, 77, 64, "f32", "causal"), (1, 1, 1024, 1024, 512, "f32", "random"),
    (1, 1, 4096, 4096, 512, "f32", None),
]
# float32 D 160 split four ways at a ragged key count (the last split one
# 16-key tile, itself ragged), with the dense bias
FLASH_CASES.append((2, 8, 256, 200, 160, "f32", "random"))
# The SD1.5 UNet at 512² under CFG (B = 2, 8 heads over 320, 640 and 1280
# channels, so D 40, 80 and 160): each level's self-attention over its
# latent tokens and cross-attention over CLIP's 77, the middle block's 64
# tokens, a ragged case and a biased one, in bf16 and in float32.
UNET_FLASH_SHAPES = [
    (2, 8, 4096, 4096, 40, None), (2, 8, 4096, 77, 40, None), (2, 8, 1024, 1024, 80, None),
    (2, 8, 1024, 77, 80, None), (2, 8, 256, 256, 160, None), (2, 8, 256, 77, 160, None),
    (2, 8, 64, 64, 160, None), (1, 8, 1000, 77, 40, None), (1, 8, 300, 200, 160, "random"),
]
FLASH_CASES += [(b, h, lq, lk, d, dt, bias) for dt in ("bf16", "f32")
                for b, h, lq, lk, d, bias in UNET_FLASH_SHAPES]
# The SDXL UNet at 1024² under CFG (B = 2, 64-channel heads: 10 over 640
# channels, 20 over 1280): each attention level's self-attention over its
# latent tokens and cross-attention over CLIP's 77; CLIP-G's causal call
# (20 heads of 64), in bf16 and in float32.
SDXL_FLASH_SHAPES = [
    (2, 10, 4096, 4096, 64, None), (2, 10, 4096, 77, 64, None), (2, 20, 1024, 1024, 64, None),
    (2, 20, 1024, 77, 64, None), (1, 20, 77, 77, 64, "causal"),
]
FLASH_CASES += [(b, h, lq, lk, d, dt, bias) for dt in ("bf16", "f32")
                for b, h, lq, lk, d, bias in SDXL_FLASH_SHAPES]
# SD3.5-Medium at 1024² under CFG (B = 2, 24 heads of 64): the joint
# attention over 154 context + 4096 image tokens (4250 = 33 x 128 + 26:
# ragged on every query and key tile) and MMDiT-X's second self-attention
# over the image's 4096, in bf16 and in float32.
# The joint case draws its scores negative ("neg_scores", flash_inputs): over
# 4250 random keys the 102 zero pad keys of the last tile, left unmasked,
# would move an output by less than the bf16 limit.
SD3_FLASH_SHAPES = [(2, 24, 4250, 4250, 64, "neg_scores"), (2, 24, 4096, 4096, 64, None)]
FLASH_CASES += [(b, h, lq, lk, d, dt, bias) for dt in ("bf16", "f32")
                for b, h, lq, lk, d, bias in SD3_FLASH_SHAPES]
# SD2.1-768-v at 768² under CFG (B = 2, 64-channel heads: 5 over 320
# channels, 10 over 640, 20 over 1280): the first level's self-attention
# over its 96 x 96 = 9216 latent tokens and cross-attention over OpenCLIP-H's
# 77, the second and third levels' self-attentions over 2304 and 576; and
# OpenCLIP-H's causal call (16 heads of 64), in bf16 and in float32.  The
# 9216-token cases draw q around +1 and k around -1 ("neg_scores"), so a
# dropped key tile or unmasked pad keys would outweigh the limit there.
SD2_FLASH_SHAPES = [(2, 5, 9216, 9216, 64, "neg_scores"), (2, 5, 9216, 77, 64, "neg_scores"),
                    (2, 10, 2304, 2304, 64, None), (2, 20, 576, 576, 64, None),
                    (2, 16, 77, 77, 64, "causal")]
FLASH_CASES += [(b, h, lq, lk, d, dt, bias) for dt in ("bf16", "f32")
                for b, h, lq, lk, d, bias in SD2_FLASH_SHAPES]
# The SD3 VAE's mid-block attention over the untiled 1024² decode's whole
# 128 x 128 latent (the sd3 path's one D 512 call a decode): 256 Q tiles of
# 64 rows, so the key split the D 512 launcher picks is not the 4096 case's.
SD3_VAE_FLASH_SHAPE = (1, 1, 16384, 16384, 512)
FLASH_CASES.append((*SD3_VAE_FLASH_SHAPE, "bf16", None))
# The SD VAE's mid-block attention over the untiled 768² decode's whole 96 x
# 96 latent (the sd2 paths' one D 512 call a decode, bf16 and float32): 144
# Q tiles of 64 rows, more than the SMs but short of two waves, so the
# launcher splits the keys many ways, the last split ragged.  q is drawn
# around +1 and k around -1 ("neg_scores"), so a dropped key tile or a
# split merged without its rescale would outweigh the limit.
SD2_VAE_FLASH_SHAPE = (1, 1, 9216, 9216, 512)
FLASH_CASES += [(*SD2_VAE_FLASH_SHAPE, dt, "neg_scores") for dt in ("bf16", "f32")]
# SDXS-0.9 at 512² (its 320-channel level as one head of 320 over the 64 x
# 64 = 4096 latent tokens): the self-attention at CFG 1 (B = 1; 64 Q tiles,
# so the keys split) and under CFG (B = 2), the cross-attention over
# OpenCLIP-H's 77 under CFG, a ragged case (Lq off the 64-row Q tile, Lk off
# the 32-key tile) and a biased one, in bf16 and in float32.
D320_FLASH_SHAPES = [(1, 1, 4096, 4096, 320, None), (2, 1, 4096, 4096, 320, None),
                     (2, 1, 4096, 77, 320, None), (1, 1, 1000, 300, 320, None),
                     (1, 2, 300, 200, 320, "random")]
FLASH_CASES += [(b, h, lq, lk, d, dt, bias) for dt in ("bf16", "f32")
                for b, h, lq, lk, d, bias in D320_FLASH_SHAPES]
# Wan2.1-T2V-1.3B at 832x480 over 33 frames (9 latent frames) under CFG
# (B = 2, 12 heads of 128): the self-attention over 9 x 30 x 52 = 14040
# tokens (109 x 128 + 88: ragged on the last query and key tile) and the
# cross-attention over UMT5's 512, in bf16 and in float32.  Both draw q
# around +1 and k around -1 ("neg_scores"), so zero pad keys left unmasked
# in the last key tile would outweigh the real ones.
# (The float32 self-attention runs at B = 1: the plain version and the
# one-pass TF32 fault hold four float32 [B, 12, 14040, 14040] temporaries,
# 76 GB at B = 2.)
WAN_FLASH_SHAPES = [(2, 12, 14040, 14040, 128, "neg_scores"), (2, 12, 14040, 512, 128, "neg_scores")]
WAN_FLASH_CASES = ([(*s_[:5], "bf16", s_[5]) for s_ in WAN_FLASH_SHAPES]
                   + [(1, 12, 14040, 14040, 128, "f32", "neg_scores"),
                      (2, 12, 14040, 512, 128, "f32", "neg_scores")])
FLASH_CASES += WAN_FLASH_CASES
# attention calls of one Wan2.1 forward: a self- and a cross-attention in
# each of its 30 blocks, all at D 128
WAN_ATTENTION_CALLS = 2 * 30
# Z-Image-Turbo at 1024² (30 heads of 128): the 30 main layers' joint
# attention over the prompt's tokens padded to 64 and the image's 4096
# (4160 = 32 x 128 + 64: ragged on the last query and key tile), the noise
# refiner's over the image's 4096 and the context refiner's over the
# prompt's 64, at CFG 1 (B = 1, the way Turbo runs) and the joint one under
# CFG (B = 2); at 512² in float32 (the f32 path: 1024 image tokens, 1088
# joint).  The ragged and the short cases draw their scores negative
# ("neg_scores"), so zero pad keys left unmasked would outweigh the real
# ones.
Z_IMAGE_FLASH_SHAPES = [(1, 30, 4160, 4160, 128, "neg_scores"), (2, 30, 4160, 4160, 128, "neg_scores"),
                        (1, 30, 4096, 4096, 128, None), (1, 30, 64, 64, 128, "neg_scores")]
Z_IMAGE_FLASH_CASES = ([(*s_[:5], "bf16", s_[5]) for s_ in Z_IMAGE_FLASH_SHAPES]
                       + [(1, 30, 1088, 1088, 128, "f32", "neg_scores"),
                          (1, 30, 64, 64, 128, "f32", "neg_scores")])
FLASH_CASES += Z_IMAGE_FLASH_CASES
# attention calls of one Z-Image forward, all at D 128: 2 context-refiner
# layers, 2 noise-refiner layers, 30 main layers
Z_IMAGE_ATTENTION_CALLS = 2 + 2 + 30
# Qwen3-4B's layers a Z-Image prompt encode runs (the states after layer 35
# of 36), each one causal attention on the plain path (``flash=False``, as
# the JAX package runs it) and 7 linears (q, k, v, o, gate, up, down) at the
# prompt's rows: the 4-bit matmul's split-K form
Z_IMAGE_LLM_LAYERS = 35
Z_IMAGE_LLM_LINEARS = 7 * Z_IMAGE_LLM_LAYERS
# Qwen-Image at 1024² (24 heads of 128): the 60 blocks' joint attention over
# the context and the image's 4096 tokens under CFG (B = 2).  With
# byte-level ids the chat template's system prefix is about 150 ids, so
# after the template's 34-id drop QWEN_IMAGE_REQUEST's prompt leaves 164
# context rows: 4260 = 33 x 128 + 36, ragged on the last tile; the float32
# path's 512² joint 164 + 1024 = 1188.
QWEN_IMAGE_FLASH_CASES = [(2, 24, 4260, 4260, 128, "bf16", "neg_scores"),
                          (2, 24, 1188, 1188, 128, "f32", "neg_scores")]
FLASH_CASES += QWEN_IMAGE_FLASH_CASES
QWEN_IMAGE_ATTENTION_CALLS = 60
# Qwen2.5-VL-7B's 28 layers a Qwen-Image prompt encode runs (to the final
# norm), each one causal attention on the plain path, as the JAX package
# runs it, and 7 linears at the prompt's ids
QWEN_IMAGE_LLM_LAYERS = 28
QWEN_IMAGE_LLM_LINEARS = 7 * QWEN_IMAGE_LLM_LAYERS
# UMT5-XXL linears of one Wan prompt encode (q, k, v, o, wi_0, wi_1, wo in
# each of 24 blocks, over 512 tokens: the 4-bit matmul's wgmma form)
WAN_T5_LINEARS = 7 * 24
UNET_HEAD_DIMS = (40, 80, 160)
# head dim -> attention calls of one full-width SD1.5 UNet forward: a self-
# and a cross-attention in each of its 16 transformer blocks (two at each
# of the three attention levels on the way down, three on the way up, and
# the middle block's one at D 160)
UNET_ATTENTION_CALLS = {40: 10, 80: 10, 160: 12}
# head dim -> attention calls of one full-width SDXL UNet forward: a self-
# and a cross-attention in each of its 70 transformer blocks (2 x 2 at the
# 640-wide level and 2 x 10 at the 1280-wide one on the way down, the
# middle block's 10, 3 x 10 and 3 x 2 on the way up), all at D 64
SDXL_UNET_ATTENTION_CALLS = {64: 140}
# attention calls of one full-width SD2.x UNet forward, its inpainting UNet's
# too: SD1's layout with every head 64 wide (5, 10 and 20 heads over 320,
# 640 and 1280 channels)
SD2_UNET_ATTENTION_CALLS = 32
# attention calls of one SD2 prompt encode: OpenCLIP-H's 23 layers at clip
# skip 2, so 22 (no pooled output)
SD2_CLIP_ATTENTION_CALLS = 22
# attention calls of one SDXL prompt encode (every chunk of a prompt in one
# batched call a layer): CLIP-L's 11 layers at clip skip 2, CLIP-G's 31 and
# its top layer, run for the pooled output
SDXL_CLIP_ATTENTION_CALLS = 11 + 31 + 1
# head dim -> attention calls of one full-width SD3.5-Medium MMDiT forward:
# the joint attention of each of its 24 blocks (154 context + the image's
# tokens) and MMDiT-X's second self-attention in the first 13 (the image's
# tokens), all at D 64
SD3_MMDIT_ATTENTION_CALLS = {64: 24 + 13}
# attention calls of one SD3 prompt encode (the first 77-token chunk):
# CLIP-L's 11 layers at clip skip 2 and its top layer, run for the pooled
# output, CLIP-G's 31 and its top one
SD3_CLIP_ATTENTION_CALLS = 11 + 1 + 31 + 1
# T5-XXL linears of one SD3 prompt encode (q, k, v, o, wi_0, wi_1, wo in each
# of 24 blocks, over 77 tokens: the 4-bit matmul's M = 77 split-K form)
SD3_T5_LINEARS = 7 * 24
# (M, K, N, group) of the 4-bit kernel.  T5-XXL (M = 256 tokens per prompt:
# q/k/v/o, wi_0/wi_1, wo) and one ragged case at groups 64, 32 and 16; the
# q4_0 DiT at group 32 (a q4_0 GGUF's blocks): its MLP and linear2 widths at
# the 1024² request's 4352 tokens (the double blocks run the image's 4096 and
# the text's 256 apart), linear1 at the 512² request's 1280, img_in (K = 64),
# the wgmma threshold's edges (127 takes the split-K form); the GEMV's M = 1
# linears (double-block and single-block modulation, the embedders' 256- and
# 768-wide inputs and their 3072-wide second layers), the double block's
# modulation at M = 2, 4 and 8 (batch, CFG) and at M = 9 (the first
# split-K row); groups 16 and 64 at one large-M and one M = 1 shape; the
# split-K form at each of its x tiles (M = 16, 64, 100; 77 below) on a
# 4096-wide T5 linear at group 64, and T5's 77 rows at group 16.
Q4_T5_SHAPES = [(256, 4096, 4096), (256, 4096, 10240), (256, 10240, 4096), (77, 640, 1001)]
Q4_DIT_SHAPES = [(4352, 3072, 12288), (4352, 12288, 3072), (4352, 15360, 3072),
                 (1280, 3072, 21504), (4096, 64, 3072), (127, 3072, 12288), (128, 3072, 12288),
                 (129, 3072, 12288), (1, 3072, 18432), (1, 3072, 9216), (1, 3072, 3072),
                 (1, 256, 3072), (1, 768, 3072), (2, 3072, 18432), (4, 3072, 18432),
                 (8, 3072, 18432), (9, 3072, 18432)]
# T5-XXL over SD3's 77 tokens (q/k/v/o, wi_0/wi_1, wo): the bf16 split-K
# form and the float32 form, at the synthesized T5's group 64 and at 32
Q4_SD3_T5_SHAPES = [(77, 4096, 4096), (77, 4096, 10240), (77, 10240, 4096)]
Q4_SD3_CASES = [(*s, g) for g in (64, 32) for s in Q4_SD3_T5_SHAPES]
# UMT5-XXL over Wan's 512 tokens (q/k/v/o, wi_0/wi_1, wo) at the
# synthesized UMT5's group 64: the bf16 wgmma form and the float32 form
Q4_WAN_T5_SHAPES = [(512, 4096, 4096), (512, 4096, 10240), (512, 10240, 4096)]
# Qwen3-4B over a Z-Image prompt's 55 tokens (the chat template's 19 and a
# 36-byte prompt, byte-level ids): q, k / v, o, gate / up, down at the
# synthesized LLM's group 64: the bf16 split-K form and the float32 form
Q4_Z_IMAGE_LLM_SHAPES = [(55, 2560, 4096), (55, 2560, 1024), (55, 4096, 2560), (55, 2560, 9728),
                         (55, 9728, 2560)]
# Qwen2.5-VL-7B over a Qwen-Image prompt's 198 byte-level ids (the chat
# template around a 36-byte prompt): q / o, k / v, gate / up, down at the
# synthesized LLM's group 64: the bf16 wgmma form and the float32 form; and
# the q4_0 file DiT's group-32 linears at 1024² under CFG: the image
# stream's 8192 rows (attention 3072->3072, MLP 3072->12288, 12288->3072),
# proj_out 3072->64), the text stream's 328 (2 x 164; txt_in 3584->3072)
Q4_QWEN_LLM_SHAPES = [(198, 3584, 3584), (198, 3584, 512), (198, 3584, 18944), (198, 18944, 3584)]
Q4_QWEN_DIT_SHAPES = [(8192, 3072, 3072), (8192, 3072, 12288), (8192, 12288, 3072),
                      (8192, 3072, 64), (328, 3584, 3072), (328, 3072, 12288)]
Q4_CASES = ([(*s, g) for g in (64, 32, 16) for s in Q4_T5_SHAPES] + [(*s, 32) for s in Q4_DIT_SHAPES]
            + [(s, 3072, n, g) for g in (16, 64) for s, n in ((4352, 12288), (1, 18432))]
            + Q4_SD3_CASES + [(m, 4096, 4096, 64) for m in (16, 64, 100)] + [(77, 4096, 4096, 16)]
            + [(*s, 64) for s in Q4_WAN_T5_SHAPES] + [(*s, 64) for s in Q4_Z_IMAGE_LLM_SHAPES]
            + [(*s, 64) for s in Q4_QWEN_LLM_SHAPES] + [(*s, 32) for s in Q4_QWEN_DIT_SHAPES])
# the float32 form (the default pipeline's T5-XXL): T5's shapes at groups 64,
# 32 and 16, a 4096-wide T5 linear at M = 1, 9 and 128 (the bf16 forms'
# rows: GEMV, split-K, wgmma), and a q4_0 DiT linear at 1024² kept at the
# default dtype, at groups 32 and 16 (the 128-row tile)
Q4_F32_CASES = ([(*s, g) for g in (64, 32, 16) for s in Q4_T5_SHAPES]
                + [(m, 4096, 4096, 64) for m in (1, 9, 128)]
                + [(4352, 3072, 12288, g) for g in (32, 16)] + Q4_SD3_CASES
                + [(*s, 64) for s in Q4_WAN_T5_SHAPES]
                + [(*s, 64) for s in Q4_Z_IMAGE_LLM_SHAPES]
                + [(*s, 64) for s in Q4_QWEN_LLM_SHAPES])
# W8A16's float32 form (the default pipeline under SDTPU_QUANT_MODE=w8a16):
# a modulation linear (M = 1), the bf16 forms' first mma.sync and wgmma rows,
# the 1024² request's 4352 tokens, its long-K widths (MLP out, linear2: where
# a truncating MMA chain would show), and a ragged shape
W8A16_F32_CASES = [(1, 3072, 18432), (9, 3072, 18432), (128, 3072, 12288), (4352, 3072, 12288),
                   (4352, 12288, 3072), (4352, 15360, 3072), (300, 1040, 130)]
# The int8 split-K forms (W8A8 with bf16 and float32 x, group-dequant at
# groups 32 and 16, W8A16) at the first path that runs them, an int8 SDXL
# UNet at CFG 1, whose 140 context projections a forward (attn2.to_k / to_v
# over CLIP's 77 tokens) are 77x2048->640 and ->1280; a DiT-wide
# 3072->12288 at each of the forms' x tiles (9, 16, 64, 100, 127 rows) and
# 9x3072->18432; and W8A8 at 4x20480->3072, where M <= 8 but x would not fit
# the GEMV's shared memory.  Each case records its K splits and is read on
# the device clock; W8A8 is held bit-equal with an all-zero x row, the
# others within GQ_REL_TOL with the plain split-and-sum without its last
# split (``drop_k_split``) as a fault that must exceed it; a second call is
# bit-identical.
SDXL_CONTEXT_SHAPES = [(77, 2048, 640), (77, 2048, 1280)]
INT8_SPLITK_SHAPES = SDXL_CONTEXT_SHAPES + [(m, 3072, 12288) for m in (9, 16, 64, 100, 127)] + [
    (9, 3072, 18432)]
W8A8_LONG_K_SHAPES = [(4, 20480, 3072)]
# W8A8 at the Z-Image DiT's shapes (the file paths' q8_0 GGUF promoted per
# row): the wgmma form at the noise refiner's 4096 image rows and the joint
# 4160 (4096 + a 64-token context: its last 128-row tile ragged) over qkv
# 3840->11520, out 3840->3840, w1 / w3 3840->10240 and w2 10240->3840, and
# the final 3840->64 at 4160; the GEMV at the one-row adaLN 256->15360 and
# the final layer's 256->3840, each held as W8A8_CASES are; the split-K
# form at the context refiner's 64 rows, held in check_int8_splitk
Z_IMAGE_W8A8_CASES = [(m, k, n) for m in (4096, 4160) for k, n in (
    (3840, 11520), (3840, 3840), (3840, 10240), (10240, 3840))] + [
    (4160, 3840, 64), (1, 256, 15360), (1, 256, 3840)]
Z_IMAGE_SPLITK_SHAPES = [(64, 3840, 11520), (64, 3840, 3840), (64, 3840, 10240), (64, 10240, 3840)]
Q4_FORMS = ("gemv", "splitk", "wgmma", "f32")  # sdtpu_q4_form's codes
GQ_FORMS = ("gemv", "mma", "wgmma", "f32", "splitk")  # sdtpu_gq_form's codes
W8A8_FORMS = ("gemv", "splitk", "wgmma")  # sdtpu_w8a8_form's codes
Q4_DIT_GROUP = 32

# Why each tolerance:
#   W8A8: both sides quantize x with the same arithmetic, accumulate exactly
#     and share the epilogue order → bit-equal (tolerance 0).
#   flash bf16: P is rounded to bf16 before P.V in both, but the kernel
#     normalises after the product and the plain version before it; each
#     rounds its output to bf16 once, so the two differ by about one bf16
#     ulp of the largest |out| (at most 2^-7 of it) → 2e-2 of the largest
#     |out|.  At D 512 each case also reads two faults emulated on its
#     inputs (FLASH_FAULTS), and each must exceed the limit.
#   flash f32: the kernel runs both products in 3xTF32 (each operand split
#     into two tf32 terms, three products, float32 sums: ~2^-21 of each
#     product), the plain version in float32 (TF32 off); summation order and
#     exp2 against exp differ too → FLASH_TOL["f32"] of the largest |out|.
#     Each f32 case also reads the one-pass TF32 fault (q, k, v and the
#     probabilities rounded to tf32 in plain PyTorch), which must exceed it.
#   q4, group-dequant, W8A16: identical bf16 weights (the group forms and the
#     4-bit kernel round q·s (− z) once, in float32, as the plain version
#     does; W8A16 widens q exactly and scales the float32 sum, the plain
#     version scales the weight before its bf16 rounding, 2^-9 apart);
#     float32 sums in another order can move the final bf16 rounding by an
#     ulp → 2^-6 of the largest |output|.  The float32 forms (group-dequant,
#     affine, 4-bit, W8A16) split x into two tf32 terms (|rest| <= 2^-23 |x|)
#     against integer weights exact in tf32, the scales applied to float32
#     sums; the plain version multiplies the float32 weights (q·s rounded
#     once) in float32: sums in another order, ~2^-23 of each product → 1e-5
#     of the largest |output|.  Each float32 case also reads the one-pass
#     TF32 fault (x rounded to tf32, the same weights, in plain PyTorch; about
#     2^-12 of each product), which must exceed it.
FLASH_TOL = {"bf16": 2e-2, "f32": 2e-5}
#   the D 512 faults, in plain PyTorch on the case's inputs: the last 32-key
#     tile of the first key split dropped, and the split-keys combine without
#     its 2^(m_s - M) rescale (where the launcher splits the keys).  At the
#     UNet's D 40, 80 and 160 the bf16 kernel computes on the head dim padded
#     to 64, 128 and 192 columns: the softmax scale of the padded width
#     (``padded_scale``), and where Lk is off the key tile (128, 64 at D 160)
#     the zero keys past it left unmasked (``unmasked_pad_keys``).  At bf16
#     D 64 (CLIP's, the SDXL UNet's) the kernel's last 128-key tile dropped
#     (``drop_key_tile``, where the keys span more than one) and the zero
#     keys past Lk left unmasked (where Lk is off the 128-key tile).  At bf16
#     D 320 (the wide-head kernel, its head dim split between two
#     warpgroups) the second warpgroup's last output block, columns
#     256-319, dropped (``drop_out_block``), the scores contracted over the
#     first warpgroup's 160 columns alone (``half_scores``), and the D 512
#     faults at this shape's key splits.
FLASH_FAULTS = ("drop_key_tile", "combine_unscaled", "padded_scale", "unmasked_pad_keys",
                "drop_out_block", "half_scores")
Q4_REL_TOL = 2.0 ** -6
GQ_REL_TOL = {"bf16": 2.0 ** -6, "f32": 1e-5}
#   library yardsticks (``_weight_int4pack_mm``, ``_weight_int8pack_mm``): they
#     take their scales in bf16, 2^-9 relative off the float32 ones per group
#     or row, so their output is checked at 2^-5 of the largest |output|
#     before it is timed; a wrong nibble order or scale layout errs by O(1).
LIBRARY_REL_TOL = 2.0 ** -5
GQ_NO_LIBRARY = "no one-call PyTorch equivalent: no call takes int8 weights with per-group scales"
#   reference check (relative L2 of each output): the card runs bf16, the
#     CPU float32, so this is no precision check; it catches errors of order
#     one.  Sound readings: 4.5e-3 to 1.5e-2 on the card, 5e-3 to 2e-2 for
#     the plain versions in bf16 against float32 on the CPU.  Faults planted
#     in the bf16 plain versions on the CPU read: nibbles swapped 1.3 (T5),
#     causal bias ignored 0.53 (CLIP), the last 128-wide head-dim slice of the
#     VAE's D = 512 attention zeroed 0.082.  Subtler faults (a key tile or a
#     K tile dropped, a wrong softmax scale) read 0.014-0.025 and a shifted
#     scale index reads nothing (synthesized scales are constant); the kernel
#     checks above, with random scales at the slice's shapes, catch those.
REF_REL_TOL = 0.04
#   the same check with the card in float32 (TF32 off, flash in 3xTF32): a
#     precision check.  Both sides compute in float32 and differ in
#     summation order and, in the DiT, in W8A8's activation quantization
#     (an input that lands on the other side of a rounding tie moves one
#     int8 step).  Sound readings on an H100: CLIP 4.1e-7, T5 1.5e-6, the
#     DiT 1.2e-5, the VAE 6.3e-6; the limit is 8x the largest.
REF_F32_REL_TOL = 1e-4
#   loader check, at each of LOADER_SEEDS' inputs.  The kept blocks give the
#     kernels the dense forward's bf16 weights, so their forward differs from
#     the dense bf16 one only in how each sum is ordered and rounded; the
#     GEMVs sum K in another order than the plain matmul (split among warps),
#     so a modulation output may round to the other bf16 neighbour, which
#     rescales its whole channel.  So both bf16 forwards are held to the
#     exact answer, the same bf16 weights in a float32 forward (TF32 off): the
#     kept blocks' relative L2 from it may be at most LOADER_KEEP_RATIO times
#     the dense bf16 forward's, the bf16 noise of this forward.  Read at the
#     four seeds on an H100: dense 6.2e-3 to 7.5e-3, kept 0.992 to 1.007
#     times that (and 2.6e-3 to 2.8e-3 from the dense bf16 forward), so the
#     limit lets through an added error independent of the noise of at most
#     sqrt(1.1^2 - 1) = 0.46 times it, about 3e-3.  The promoted staging
#     also re-quantizes the q8_0 weights per row and the activations per
#     token (W8A8), so it is held to the dense bf16 forward by relative L2
#     (LOADER_REL_TOL; read 2.8e-2 to 3.2e-2).  A wrong scale, zero or nibble
#     in any linear is an error of order one in its output.  The kept blocks
#     also run the forward at the default dtype (float32 x: the float32 forms
#     of the 4-bit, group-dequant and affine matmuls, flash in 3xTF32),
#     against the blocks' own values in a float32 forward (TF32 off): a
#     precision check at REF_F32_REL_TOL, as the reference check's.
LOADER_SEEDS = (6, 7, 8, 9)
LOADER_KEEP_RATIO = 1.1
LOADER_REL_TOL = {"promote_q8": 0.06}

# The GGUF written by the loader phase: q8_0 by default; the txt stream of
# the double block in q4_0 (→ 4-bit, group 32) and its img MLP in q4_1
# (→ affine group 32); two single-block weights replaced after loading by
# k-quant blocks built from random raw blocks (q6_k → symmetric group 16,
# q4_k → affine group 32).
LOADER_TYPE_RULES = [(r"^double_blocks\.0\.txt_", "q4_0"), (r"^double_blocks\.0\.img_mlp\.", "q4_1")]
LOADER_KQUANT = {"single_blocks.0.linear1.weight": "q6_k", "single_blocks.0.linear2.weight": "q4_k"}

# The kernels each path runs; its window must launch every one of them.
# (The loader's forward decodes no image, so it runs no D 512 attention.)
# (Every path makes 4-bit calls of M >= 128 rows, T5's 256 tokens at least.
# A GEMV runs where a DiT linear of M = 1 is in its class: the 4-bit one for
# the q4_0 DiT and the loader file's q4_0 txt_mod, the group-dequant one for
# the q8_0_gguf DiT and the loader's kept q8_0 blocks, the W8A16 one for the
# int8 DiT under SDTPU_QUANT_MODE=w8a16.  Elsewhere T5, at 256 rows a
# prompt, is the only 4-bit model.)
Q4 = ("q4_matmul", "q4_matmul_wgmma")
PATH_KERNELS = {
    # (its kept blocks also run one forward at the default dtype, float32)
    "gguf_loader": ("flash_attention", "w8a8_matmul", "w8a8_matmul_gemv", *Q4, "q4_matmul_gemv",
                    "gq_matmul", "gq_matmul_gemv", "gq_matmul_ws", "gq_zero_matmul",
                    "flash_attention_f32", "q4_matmul_f32", "gq_matmul_f32", "gq_zero_matmul_f32"),
    "gguf_file": ("flash_attention", "flash_attention_d512", *Q4, "q4_matmul_gemv", "gq_matmul",
                  "gq_matmul_gemv", "gq_matmul_ws", "gq_zero_matmul"),
    "int8": ("flash_attention", "flash_attention_d512", "w8a8_matmul", "w8a8_matmul_gemv", *Q4),
    "w8a16": ("flash_attention", "flash_attention_d512", "w8a16_matmul", "w8a16_matmul_gemv", *Q4),
    "q8_0_gguf": ("flash_attention", "flash_attention_d512", "gq_matmul", "gq_matmul_gemv",
                  "gq_matmul_ws", *Q4),
    "q4_0": ("flash_attention", "flash_attention_d512", *Q4, "q4_matmul_gemv"),
    # the default dtype, float32: W8A8 takes float32 x in its own forms (its
    # GEMV at M = 1), the 4-bit, W8A16 and flash kernels their float32 forms
    "f32": ("flash_attention", "flash_attention_f32", "w8a8_matmul", "w8a8_matmul_gemv",
            "q4_matmul", "q4_matmul_f32"),
    "f32_w8a16": ("flash_attention", "flash_attention_f32", "w8a16_matmul", "w8a16_matmul_f32",
                  "q4_matmul", "q4_matmul_f32"),
    # the entry points on files: T5 dequantized (dense bf16), the DiT's q8_0
    # promoted to W8A8 (cli) or kept in its blocks (server); the D 128 and
    # wgmma forms are checked by ENTRY_FORMS
    "cli": ("flash_attention", "flash_attention_d64", "flash_attention_d512", "w8a8_matmul",
            "w8a8_matmul_gemv"),
    "server": ("flash_attention", "flash_attention_d64", "flash_attention_d512", "gq_matmul",
               "gq_matmul_gemv", "gq_matmul_ws"),
}
# ... and none of these (the mode switch, the memory class and the dtype
# hold: the bf16 paths run no float32 form, the float32 paths no bf16 one;
# F32_PATHS also check that every launch of the flash, 4-bit and W8A16
# wrappers was a float32 one)
F32_FORMS = ("flash_attention_f32", "q4_matmul_f32", "w8a16_matmul_f32", "gq_matmul_f32",
             "gq_zero_matmul_f32")
F32_IDLE = ("flash_attention_d512", "q4_matmul_wgmma", "q4_matmul_gemv", "w8a16_matmul_gemv",
              "w8a16_matmul_splitk", "gq_matmul", "gq_matmul_ws", "gq_zero_matmul")
PATH_IDLE = {"int8": ("q4_matmul_gemv", "gq_matmul_gemv", "w8a16_matmul_gemv", *F32_FORMS),
             "w8a16": ("w8a8_matmul", "w8a8_matmul_gemv", "q4_matmul_gemv", "gq_matmul_gemv",
                       *F32_FORMS),
             "q8_0_gguf": ("w8a8_matmul", "w8a8_matmul_gemv", "w8a16_matmul", "q4_matmul_gemv",
                           *F32_FORMS),
             "gguf_loader": ("w8a16_matmul_f32",),
             "gguf_file": ("w8a8_matmul", "w8a16_matmul", *F32_FORMS),
             "q4_0": ("w8a8_matmul", "w8a8_matmul_gemv", "w8a16_matmul", "gq_matmul",
                      "gq_matmul_ws", "gq_zero_matmul", *F32_FORMS),
             "f32": ("w8a16_matmul", *F32_IDLE),
             "f32_w8a16": ("w8a8_matmul", "w8a8_matmul_gemv", *F32_IDLE),
             "cli": ("w8a8_matmul_splitk", "gq_matmul", "gq_zero_matmul", "q4_matmul",
                     "w8a16_matmul", *F32_FORMS),
             "server": ("w8a8_matmul", "w8a8_matmul_gemv", "q4_matmul", "w8a16_matmul",
                        "gq_zero_matmul", *F32_FORMS)}
# SD1.5 (dense, bf16 unless the default dtype): the UNet's flash forms at D
# 40 / 80 / 160, CLIP-L's D 64 and the VAE's D 512, no quantized matmul
QUANT_KERNELS = ("w8a8_matmul", "w8a8_matmul_gemv", "q4_matmul", "gq_matmul", "gq_matmul_ws",
                 "gq_zero_matmul", "w8a16_matmul")
UNET_FLASH = ("flash_attention_d40", "flash_attention_d80", "flash_attention_d160")
for _path in ("sd15", "sd15_cli", "sd15_server"):
    PATH_KERNELS[_path] = ("flash_attention", *UNET_FLASH, "flash_attention_d64",
                           "flash_attention_d512")
    PATH_IDLE[_path] = (*QUANT_KERNELS, *F32_FORMS)
# SDXL (dense): flash at D 64 (the UNet, CLIP-L and CLIP-G), D 512 on the
# full-VAE request only (the TAESD decode has no attention)
for _path in ("sdxl", "sdxl_cli", "sdxl_server"):
    PATH_KERNELS[_path] = ("flash_attention", "flash_attention_d64")
    PATH_IDLE[_path] = (*QUANT_KERNELS, *F32_FORMS, *UNET_FLASH)
PATH_KERNELS["sdxl"] += ("flash_attention_d512",)
PATH_IDLE["sdxl_cli"] += ("flash_attention_d512",)
PATH_IDLE["sdxl_server"] += ("flash_attention_d512",)
# the int8 SDXL paths: flash at D 64 (the UNet and both CLIPs), their
# class's wrapper in its GEMV (M = 1: the time and label embedders, each
# ResBlock's emb_layers), split-K (the 77-row context projections) and wgmma
# (the latent tokens: gq_matmul_ws at M >= GQ_WS_MIN_M) forms, no other
# quantized matmul, no float32 form
SDXL_QUANT_WRAPPER = {"sdxl_q8": "w8a8_matmul", "sdxl_q8_w8a16": "w8a16_matmul",
                      "sdxl_q8_gguf": "gq_matmul", "sdxl_q8_cli": "w8a8_matmul",
                      "sdxl_q8_server": "w8a8_matmul"}
INT8_KERNELS = {"w8a8_matmul": ("w8a8_matmul", "w8a8_matmul_gemv", "w8a8_matmul_splitk",
                                "w8a8_matmul_wgmma"),
                "w8a16_matmul": ("w8a16_matmul", "w8a16_matmul_gemv", "w8a16_matmul_splitk",
                                 "w8a16_matmul_wgmma"),
                "gq_matmul": ("gq_matmul", "gq_matmul_gemv", "gq_matmul_splitk", "gq_matmul_ws")}
for _path, _w in SDXL_QUANT_WRAPPER.items():
    PATH_KERNELS[_path] = ("flash_attention", "flash_attention_d64", *INT8_KERNELS[_w])
    PATH_IDLE[_path] = (*(k for ks in INT8_KERNELS.values() for k in ks if k not in INT8_KERNELS[_w]),
                        "q4_matmul", "gq_zero_matmul", "gq_zero_matmul_mma", *F32_FORMS, *UNET_FLASH,
                        "flash_attention_d512")
PATH_KERNELS["sdxl_f32"] = ("flash_attention", "flash_attention_f32")
PATH_IDLE["sdxl_f32"] = (*QUANT_KERNELS, *UNET_FLASH, "flash_attention_d64", "flash_attention_d512",
                         "q4_matmul_f32", "w8a16_matmul_f32", "gq_matmul_f32", "gq_zero_matmul_f32")
PATH_KERNELS["sd15_f32"] = ("flash_attention", "flash_attention_f32", *UNET_FLASH)
PATH_IDLE["sd15_f32"] = (*QUANT_KERNELS, "flash_attention_d64", "flash_attention_d512",
                         "q4_matmul_f32", "w8a16_matmul_f32", "gq_matmul_f32", "gq_zero_matmul_f32")
# SD3 (a dense MMDiT, CLIP-L and CLIP-G, a 4-bit T5-XXL): flash at D 64 (the
# MMDiT and both CLIPs) and D 512 (the VAE), the 4-bit matmul in its split-K
# form only (77 T5 rows); on the entry paths T5 is dequantized (no 4-bit
# call), as the JAX CLI stages it
Q4_BF16_FORMS = ("q4_matmul_wgmma", "q4_matmul_gemv", "q4_matmul_splitk")
OTHER_QUANT = tuple(k for k in QUANT_KERNELS if k != "q4_matmul")
PATH_KERNELS["sd3"] = ("flash_attention", "flash_attention_d64", "flash_attention_d512", "q4_matmul",
                       "q4_matmul_splitk")
PATH_IDLE["sd3"] = (*OTHER_QUANT, "q4_matmul_wgmma", "q4_matmul_gemv", *F32_FORMS, *UNET_FLASH)
for _path in ("sd3_cli", "sd3_server"):
    PATH_KERNELS[_path] = ("flash_attention", "flash_attention_d64", "flash_attention_d512")
    PATH_IDLE[_path] = (*QUANT_KERNELS, *Q4_BF16_FORMS, *F32_FORMS, *UNET_FLASH)
PATH_KERNELS["sd3_f32"] = ("flash_attention", "flash_attention_f32", "q4_matmul", "q4_matmul_f32")
PATH_IDLE["sd3_f32"] = (*OTHER_QUANT, *Q4_BF16_FORMS, *UNET_FLASH, "flash_attention_d64",
                        "flash_attention_d512", "w8a16_matmul_f32", "gq_matmul_f32",
                        "gq_zero_matmul_f32")
# Wan2.1 T2V (a dense DiT, a 4-bit UMT5-XXL, the dense VAE): flash at D 128
# only (the VAE's per-frame attention is plain float32, as the reference
# writes it), the 4-bit matmul in its wgmma form (512 UMT5 rows); on the
# CLI path UMT5 is dequantized (no 4-bit call)
PATH_KERNELS["wan"] = ("flash_attention", "q4_matmul", "q4_matmul_wgmma")
PATH_IDLE["wan"] = (*OTHER_QUANT, "q4_matmul_gemv", "q4_matmul_splitk", *F32_FORMS, *UNET_FLASH,
                    "flash_attention_d64", "flash_attention_d512")
PATH_KERNELS["wan_cli"] = ("flash_attention",)
PATH_IDLE["wan_cli"] = (*QUANT_KERNELS, *Q4_BF16_FORMS, *F32_FORMS, *UNET_FLASH,
                        "flash_attention_d64", "flash_attention_d512")
PATH_KERNELS["wan_f32"] = ("flash_attention", "flash_attention_f32", "q4_matmul", "q4_matmul_f32")
# Z-Image (a dense DiT, a 4-bit Qwen3-4B, the FLUX VAE): flash at D 128 (the
# DiT) and D 512 (the VAE), the 4-bit matmul in its split-K form (the
# prompt's rows); on the entry paths the DiT's q8_0 blocks promoted onto
# W8A8 (its GEMV at the modulation linears' one row, its split-K form at
# the context refiner's 64, its wgmma form at the image's 4096 and the
# joint 4160) and Qwen3 dequantized (no 4-bit call)
PATH_KERNELS["z_image"] = ("flash_attention", "flash_attention_d512", "q4_matmul", "q4_matmul_splitk")
PATH_IDLE["z_image"] = (*OTHER_QUANT, "q4_matmul_wgmma", "q4_matmul_gemv", *F32_FORMS, *UNET_FLASH,
                        "flash_attention_d64")
for _path in ("z_image_cli", "z_image_server"):
    PATH_KERNELS[_path] = ("flash_attention", "flash_attention_d512", *INT8_KERNELS["w8a8_matmul"])
    PATH_IDLE[_path] = (*(k for k in QUANT_KERNELS if k not in INT8_KERNELS["w8a8_matmul"]),
                        *Q4_BF16_FORMS, *F32_FORMS, *UNET_FLASH, "flash_attention_d64")
PATH_KERNELS["z_image_f32"] = ("flash_attention", "flash_attention_f32", "q4_matmul", "q4_matmul_f32")
# Qwen-Image (a dense DiT, a 4-bit Qwen2.5-VL-7B, the Wan VAE, whose
# attention is plain float32): flash at D 128, the 4-bit matmul in its wgmma
# form (the prompts' 150-odd byte-level ids); on the entry paths Qwen2.5-VL
# dequantized and the DiT a q4_0 file in its blocks: the 4-bit GEMV at the
# modulation's two rows, wgmma at both streams, ``img_in`` (K 64) in
# group-32 int8 blocks through ``gq_matmul_ws``
for _path in ("qwen_image", "qwen_image_img2img"):
    PATH_KERNELS[_path] = ("flash_attention", "q4_matmul", "q4_matmul_wgmma")
    PATH_IDLE[_path] = (*OTHER_QUANT, "q4_matmul_gemv", "q4_matmul_splitk", *F32_FORMS, *UNET_FLASH,
                        "flash_attention_d64", "flash_attention_d512")
for _path in ("qwen_image_cli", "qwen_image_server", "qwen_image_server_img2img"):
    PATH_KERNELS[_path] = ("flash_attention", "q4_matmul", "q4_matmul_gemv", "q4_matmul_wgmma",
                           "gq_matmul_ws")
    PATH_IDLE[_path] = (*INT8_KERNELS["w8a8_matmul"], "gq_matmul", "gq_zero_matmul", "w8a16_matmul",
                        "q4_matmul_splitk", *F32_FORMS, *UNET_FLASH, "flash_attention_d64",
                        "flash_attention_d512")
PATH_KERNELS["qwen_image_f32"] = PATH_KERNELS["z_image_f32"]
PATH_IDLE["wan_f32"] = (*OTHER_QUANT, *Q4_BF16_FORMS, *UNET_FLASH, "flash_attention_d64",
                        "flash_attention_d512", "w8a16_matmul_f32", "gq_matmul_f32",
                        "gq_zero_matmul_f32")
PATH_IDLE["z_image_f32"] = PATH_IDLE["qwen_image_f32"] = PATH_IDLE["wan_f32"]
# img2img, masked img2img and the hires fix run each family's kernels as its
# txt2img path does; the encoder's mid-block attention is flash D 512, as the
# decoder's
for _path, _as in (("img2img", "int8"), ("img2img_mask", "int8"), ("hires", "sd15"),
                   ("sd3_img2img", "sd3"), ("cli_img2img", "cli"), ("sd15_cli_hires", "sd15"),
                   ("sd15_server_img2img", "sd15"), ("sd15_server_hires", "sd15")):
    PATH_KERNELS[_path], PATH_IDLE[_path] = PATH_KERNELS[_as], PATH_IDLE[_as]
PATH_KERNELS["sdxl_img2img"] = ("flash_attention", "flash_attention_d64", "flash_attention_d512")
PATH_IDLE["sdxl_img2img"] = (*QUANT_KERNELS, *F32_FORMS, *UNET_FLASH)
# SD2.x (dense): flash at D 64 (the UNet, OpenCLIP-H) and D 512 (the VAE);
# its inpainting UNet and the SD1.5 inpainting and pix2pix UNets as their
# families' txt2img paths, the SDXL ones as the full-VAE SDXL path
for _path in ("sd2", "sd2_cli", "sd2_inpaint"):
    PATH_KERNELS[_path] = ("flash_attention", "flash_attention_d64", "flash_attention_d512")
    PATH_IDLE[_path] = (*QUANT_KERNELS, *F32_FORMS, *UNET_FLASH)
for _path in ("sd15_inpaint", "sd15_pix2pix", "sd15_inpaint_cli", "sd15_inpaint_server",
              "sd15_inpaint_cli_img2img", "sd15_inpaint_server_img2img", "sd15_pix2pix_cli"):
    PATH_KERNELS[_path], PATH_IDLE[_path] = PATH_KERNELS["sd15"], PATH_IDLE["sd15"]
for _path in ("sdxl_inpaint", "sdxl_pix2pix"):
    PATH_KERNELS[_path], PATH_IDLE[_path] = PATH_KERNELS["sdxl_img2img"], PATH_IDLE["sdxl_img2img"]
PATH_KERNELS["sd2_f32"] = ("flash_attention", "flash_attention_f32")
PATH_IDLE["sd2_f32"] = PATH_IDLE["sdxl_f32"]
F32_PATHS = {"sd2_f32": (("flash_attention", "flash_attention_f32"),),
             "z_image_f32": (("flash_attention", "flash_attention_f32"),
                             ("q4_matmul", "q4_matmul_f32")),
             "qwen_image_f32": (("flash_attention", "flash_attention_f32"),
                                ("q4_matmul", "q4_matmul_f32")),
             "wan_f32": (("flash_attention", "flash_attention_f32"),
                         ("q4_matmul", "q4_matmul_f32")),
             "sd3_f32": (("flash_attention", "flash_attention_f32"), ("q4_matmul", "q4_matmul_f32")),
             "sd15_f32": (("flash_attention", "flash_attention_f32"),),
             "sdxl_f32": (("flash_attention", "flash_attention_f32"),),
             "f32": (("flash_attention", "flash_attention_f32"), ("q4_matmul", "q4_matmul_f32")),
             "f32_w8a16": (("flash_attention", "flash_attention_f32"),
                           ("q4_matmul", "q4_matmul_f32"), ("w8a16_matmul", "w8a16_matmul_f32"))}
# phase 12, LoRA: the FLUX int8 request without a LoRA, with runtime factors,
# requantized and restored runs the int8 path's kernels each time (and W8A8
# as often: ``flux_lora_paths``); the block DiTs' cut forward after a merge
# its class's forms; the SDXL CLI and the SD1.5 server with a LoRA their
# family's entry paths' kernels
LORA_FLUX_PATHS = ("lora_none", "lora_auto", "lora_immediately", "lora_restored")
for _path in LORA_FLUX_PATHS:
    PATH_KERNELS[_path], PATH_IDLE[_path] = PATH_KERNELS["int8"], PATH_IDLE["int8"]
PATH_KERNELS["lora_auto_w8a16"] = PATH_KERNELS["w8a16"]
PATH_IDLE["lora_auto_w8a16"] = PATH_IDLE["w8a16"]
PATH_KERNELS["lora_q4_0"] = ("flash_attention", "q4_matmul", "q4_matmul_wgmma", "q4_matmul_gemv")
PATH_IDLE["lora_q4_0"] = ("w8a8_matmul", "w8a16_matmul", "gq_matmul", "gq_matmul_ws",
                          "gq_zero_matmul", "q4_matmul_splitk", *F32_FORMS)
PATH_KERNELS["lora_q8_0_gguf"] = ("flash_attention", "gq_matmul", "gq_matmul_gemv", "gq_matmul_ws")
PATH_IDLE["lora_q8_0_gguf"] = ("w8a8_matmul", "w8a16_matmul", "q4_matmul", "gq_zero_matmul",
                               *F32_FORMS)
PATH_KERNELS["sdxl_lora_cli"] = PATH_KERNELS["sdxl_cli"]
PATH_IDLE["sdxl_lora_cli"] = PATH_IDLE["sdxl_cli"]
PATH_KERNELS["sd15_lora_server"] = PATH_KERNELS["sd15_server"]
PATH_IDLE["sd15_lora_server"] = PATH_IDLE["sd15_server"]
# phase 13, the tiny UNets and SDXS (dense, bf16; SDXS-0.9 also in the
# default float32): flash at their UNet's head dims (SD1 tiny D 40 / 80 /
# 160, SDXS-512-DS D 80 / 160 with no attention at its first level, SD2
# tiny D 64, SDXS-0.9 D 320 at its first level and D 64 below), their text
# encoder's D 64 and the VAE's D 512; then ControlNet on SD1.5 and SDXL
# (their UNets' forms, the ControlNet's run at the same head dims) and the
# SD1.5 CLI on diffusers-named files
D320 = "flash_attention_d320"
TINY_PATHS = {"sd1_tiny": ("flash_attention", *UNET_FLASH, "flash_attention_d64", "flash_attention_d512"),
              "sdxs512": ("flash_attention", "flash_attention_d80", "flash_attention_d160",
                          "flash_attention_d64", "flash_attention_d512"),
              "sd2_tiny": ("flash_attention", "flash_attention_d64", "flash_attention_d512"),
              "sdxs09": ("flash_attention", D320, "flash_attention_d64", "flash_attention_d512")}
TINY_PATHS["sdxs09_cfg"] = TINY_PATHS["sdxs09"]
TINY_PATHS["sd15_controlnet"] = TINY_PATHS["sd15_controlnet_cli"] = TINY_PATHS["sd1_tiny"]
TINY_PATHS["sdxl_controlnet"] = TINY_PATHS["sd2_tiny"]
for _path, _kernels in TINY_PATHS.items():
    PATH_KERNELS[_path] = _kernels
    PATH_IDLE[_path] = (*QUANT_KERNELS, *F32_FORMS, *(k for k in (*UNET_FLASH, D320) if k not in _kernels))
PATH_KERNELS["sdxs09_f32"] = ("flash_attention", "flash_attention_f32", D320)
PATH_IDLE["sdxs09_f32"] = (*QUANT_KERNELS, *UNET_FLASH, "flash_attention_d64", "flash_attention_d512",
                           "q4_matmul_f32", "w8a16_matmul_f32", "gq_matmul_f32", "gq_zero_matmul_f32")
F32_PATHS["sdxs09_f32"] = (("flash_attention", "flash_attention_f32"),)
# head dim -> attention calls of one full-width tiny UNet forward: a self-
# and a cross-attention in each of its transformers, one a level on the way
# down and two on the way up, no middle block (SDXS-512-DS has none at its
# first level; SDXS-0.9 runs its first level's 5 x 64 as one head of 320)
TINY_ATTENTION_CALLS = {"SD1_TINY_UNET": {40: 6, 80: 6, 160: 6}, "SDXS_512_DS": {80: 6, 160: 6},
                        "SD2_TINY_UNET": {64: 18}, "SDXS_09": {320: 6, 64: 12}}
# head dim -> attention calls of one full-width ControlNet forward (the
# UNet's encoder and middle block): SD1.5's two transformers at each of
# three levels and the middle one; SDXL's 2 x 2 blocks at 640 channels, 2 x
# 10 at 1280 and the middle block's 10, all at D 64
CONTROLNET_ATTENTION_CALLS = {"SD1": {40: 4, 80: 4, 160: 6}, "SDXL": {64: 68}}
# The FLUX.1-dev DiT's M = 1 linears per forward: 2 x 19 double-block and 38
# single-block modulations, the final adaLN and the three embedders' two
# layers each; one forward a denoise step (under CFG one forward of the
# doubled batch: M = 4 for the int8 path's batch of two).  The int8, q4_0,
# q8_0_gguf and w8a16 paths run each of them through their class's GEMV.
DIT_M1_PER_STEP = 2 * 19 + 38 + 1 + 3 * 2

INT8_REQUESTS = [
    dict(prompt="a photograph of an astronaut riding a horse", width=512, height=512,
         sample_steps=4, cfg_scale=1.0, guidance=3.5, seed=42),
    dict(prompt="a red fox in fresh snow, golden hour", negative_prompt="blurry", width=512,
         height=512, sample_steps=4, cfg_scale=3.0, guidance=3.5, seed=7, batch_count=2),
    dict(prompt="a lighthouse on a cliff above a stormy sea", width=1024, height=1024,
         sample_steps=2, cfg_scale=1.0, guidance=3.5, seed=3),
]
W8A16_REQUESTS = [
    dict(prompt="a paper boat on a puddle after rain", width=512, height=512, sample_steps=2,
         cfg_scale=1.0, guidance=3.5, seed=21),
    dict(prompt="a lighthouse on a cliff above a stormy sea", width=1024, height=1024,
         sample_steps=2, cfg_scale=1.0, guidance=3.5, seed=3),
]
# the 1+1-block DiT loaded from the loader phase's file
GGUF_FILE_REQUESTS = [dict(prompt="a lantern on a wooden table", width=512, height=512,
                           sample_steps=2, cfg_scale=1.0, guidance=3.5, seed=11)]
# the default-dtype (float32) pipeline: a 512² and a 1024² request, then a
# 512² one under SDTPU_QUANT_MODE=w8a16 (W8A16's float32 form: roughly a
# second or more a step at FFMA rates)
F32_REQUESTS = [
    dict(prompt="a paper boat on a puddle after rain", width=512, height=512, sample_steps=2,
         cfg_scale=1.0, guidance=3.5, seed=21),
    dict(prompt="a lighthouse on a cliff above a stormy sea", width=1024, height=1024,
         sample_steps=2, cfg_scale=1.0, guidance=3.5, seed=3),
]
F32_W8A16_REQUESTS = [F32_REQUESTS[0]]
GGUF_REQUESTS = [
    dict(prompt="a photograph of an astronaut riding a horse", width=512, height=512,
         sample_steps=4, cfg_scale=1.0, guidance=3.5, seed=42),
    dict(prompt="a lighthouse on a cliff above a stormy sea", width=1024, height=1024,
         sample_steps=2, cfg_scale=1.0, guidance=3.5, seed=3),
]
# SD1.5: the JAX bench's request (``bench_sd15``, bench.py:151), answered
# once to warm up and once timed, then the same with dpm++2m; the default
# dtype (float32) answers it at 4 steps.  Each denoise step is one UNet
# forward of the doubled (CFG) batch.
SD15_REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="",
                    width=512, height=512, sample_steps=20, cfg_scale=7.0, seed=42,
                    sample_method="euler_a", schedule="discrete")
SD15_REQUESTS = [SD15_REQUEST, SD15_REQUEST, dict(SD15_REQUEST, sample_method="dpm++2m")]
SD15_F32_REQUESTS = [dict(SD15_REQUEST, sample_steps=4)]
# SD1.5's hires fix: the base at 512² x 8 euler_a steps (CFG 7), its
# latents resized to 128 x 128, then int(8 x 0.7) + 1 = 6 steps at 1024²
SD15_HIRES_REQUEST = dict(SD15_REQUEST, prompt="a lighthouse at night, long exposure",
                          sample_steps=8)
SD15_HIRES = dict(hires_scale=2.0, hires_strength=0.7)
# Phase 13: SDXS-0.9 as it runs, one step at CFG 1 (and in the default
# float32), then 4 steps at CFG 7 (the CFG batch of two); SD1 tiny, SD2
# tiny and SDXS-512-DS at 4 steps, CFG 7; ControlNet with a canny hint at
# strength 0.9 on SD1.5 (the bench request: 512² x 20 euler_a, CFG 7) and
# on SDXL (1024² x 4 euler, CFG 1); the CLI on the diffusers-named SD1.5
# files at 512² x 4
SDXS09_REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="",
                      width=512, height=512, sample_steps=1, cfg_scale=1.0, seed=42,
                      sample_method="euler", schedule="discrete")
SDXS09_CFG_REQUEST = dict(SDXS09_REQUEST, sample_steps=4, cfg_scale=7.0, negative_prompt="blurry")
TINY_REQUEST = dict(SDXS09_CFG_REQUEST, negative_prompt="")
CONTROL_STRENGTH = 0.9
SD15_CN_REQUEST = dict(SD15_REQUEST, prompt="a lighthouse on a cliff, oil painting")
SDXL_CN_REQUEST = dict(prompt="a lighthouse on a cliff, oil painting", negative_prompt="",
                       width=1024, height=1024, sample_steps=4, cfg_scale=1.0, seed=42,
                       sample_method="euler", schedule="discrete")
SD15_CN_CLI_REQUEST = dict(SD15_CN_REQUEST, sample_steps=4)
SD15_CN_CLI_ARGV = ["-p", SD15_CN_REQUEST["prompt"], "-W", "512", "-H", "512", "--steps", "4",
                    "--cfg-scale", "7.0", "-s", "42", "--control-strength", str(CONTROL_STRENGTH)]
CONTROLNET_SEED = 7
# the MMDiT's depth in the diffusers-named SD3 file (its names repeat a block)
SD3_FILE_DEPTH = 2


# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): tensor-core bf16, int8 and tf32, float32 outside the tensor cores;
# HBM3.  A float32 product's bound takes the tf32 peak, the fastest rate the
# card has that can compute it (a kernel that splits an operand into tf32
# terms, as the float32 forms do, runs faster than the f32 peak allows).
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
OPS_KIND = {"bf16": "bf16", "f32": "tf32"}  # activation dtype -> PEAK_OPS key of its products


def bound(ops: float, nbytes: float, kind: str) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak for their type and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# ex2 on each SM's special-function unit (MUFU): 16 a clock (the figure of
# the FlashAttention-3 paper, Shah et al. 2024, for the H100)
EX2_PER_CLOCK_PER_SM = 16


def ex2_per_s() -> float:
    """The card's ex2 rate: EX2_PER_CLOCK_PER_SM at its SM count and its
    maximum SM clock, both read from the device."""
    import torch

    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(res.stdout.strip().splitlines()[0])
    return EX2_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def flash_bound(b: int, h: int, lq: int, lk: int, d: int, nb: int, dt: str, ex2_rate: float) -> dict:
    """Flash's bound: the larger of its 4·B·H·Lq·Lk·D product operations at
    the peak for their type (tf32 for float32), its B·H·Lq·Lk exponentials
    at ``ex2_rate`` (``exp_ms``; ``bound_by`` "exp" where they are the
    larger) and its bytes."""
    out = bound(4.0 * b * h * lq * lk * d, nb, OPS_KIND[dt])
    out["exp_ms"] = b * h * lq * lk / ex2_rate * 1e3
    if out["exp_ms"] > out["bound_ms"]:
        out.update(bound_ms=out["exp_ms"], bound_by="exp")
    return out


def quant_bound(m: int, k: int, n: int, nb: int, dt: str) -> dict:
    """A quantized matmul's bound: its 2*M*N*K operations at the peak for
    x's type (bf16, or tf32 for float32 x), or its bytes.  Float32 x also
    records two figures that are no bound: ``split_x_floor_ms``, the float32
    forms' own floor (two tf32 products a weight and row, 4*M*N*K at the tf32
    peak), and ``f32_bound_ms``, 2*M*N*K at the f32 peak (the bound of the
    FFMA form they replaced)."""
    out = bound(2.0 * m * n * k, nb, OPS_KIND[dt])
    if dt == "f32":
        out["split_x_floor_ms"] = bound(4.0 * m * n * k, nb, "tf32")["bound_ms"]
        out["f32_bound_ms"] = bound(2.0 * m * n * k, nb, "f32")["bound_ms"]
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, iters: int) -> list:
    """(name, µs) of each device kernel that ``iters`` calls of ``fn``
    launched, from torch.profiler, after one warm-up call.  It may drop some
    of a short run's launches, and now and then returns no kernel at all (2
    of ~170 traces of 50 calls on an H100 in the GEMV sweep of
    sdtpu_torch/tools/time_dequant.py): an empty trace is taken again, at
    most twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    return kernels


def device_ms(fn, iters: int) -> float:
    """The mean device time of the one kernel ``fn`` launches, over the
    launches ``device_kernels`` recorded of ``iters`` calls (at most
    ``iters``, all of one kernel)."""
    kernels = device_kernels(fn, iters)
    names = {n for n, _ in kernels}
    if not kernels or len(kernels) > iters or len(names) != 1:
        raise RuntimeError(f"device_ms: {len(kernels)} device kernels traced in {iters} calls: "
                           f"{sorted(n[:60] for n in names)}")
    return sum(us for _, us in kernels) / len(kernels) / 1e3


def device_ms_sum(fn, iters: int) -> float:
    """The device time of one call of ``fn``, summed over the kernels it
    launches: each kernel's mean over the launches ``device_kernels``
    recorded of ``iters`` calls, times its launches a call (its count over
    ``iters``, rounded, at least one: a library call may launch one kernel
    twice)."""
    by_name = {}
    for name, us in device_kernels(fn, iters):
        by_name.setdefault(name, []).append(us)
    if not by_name:
        raise RuntimeError(f"device_ms_sum: no device kernel traced in {iters} calls")
    return sum(sum(v) / len(v) * max(1, round(len(v) / iters)) for v in by_name.values()) / 1e3


def iters_for(flops: float) -> int:
    return int(max(3, min(50, 2e12 / max(flops, 1.0))))


def _record(results, case) -> None:
    results.append(case)
    print("kernel " + json.dumps(case), flush=True)


def _refused(e: Exception) -> str:
    return "refused: " + (str(e).strip().splitlines() or ["?"])[0][:200]


def _yardstick(call, want):
    """A one-call library equivalent, run once and held to the plain
    version's output ``want`` at LIBRARY_REL_TOL before it may be timed:
    (call, None), or (None, why) where the call is refused or disagrees."""
    import torch

    try:
        got = call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, _refused(e)
    if got.shape != want.shape:
        return None, f"refused: output shape {list(got.shape)}, not {list(want.shape)}"
    err = (got.float() - want.float()).abs().max().item()
    tol = LIBRARY_REL_TOL * want.float().abs().max().item()
    if not err <= tol:
        print(f"yardstick disagrees with the plain version: max |err| {err:.4g} > {tol:.4g}",
              flush=True)
        return None, f"disagrees with the plain version: max |err| {err:.4g} > {tol:.4g}"
    return call, None


def _compare(results, name, shape, got, want, tol_rel, fn, plain, it, bnd, library=None,
             library_note=None, faults=None, device_clock=False, **extra):
    """Record one kernel case (``shape`` [M, K, N]): max |error| against the
    plain version, within ``tol_rel`` of the largest |output|, both times,
    at the GEMVs' M (at most ``quant.GQ_GEMV_MAX_M`` rows, where the
    CUDA-event time reads the wrapper's launch rate) also the kernel's
    device time (``device_ms``: one kernel a call), the bound ``bnd`` and,
    where ``library`` is a one-call equivalent, its time (else null and
    ``library_note`` says why); each of ``faults`` (max |error| of an
    emulated fault) must exceed the limit.  With ``device_clock``, the case
    also records both sides' device time a call (``device_ms``,
    ``library_device_ms``: a call's kernels summed)."""
    import torch

    from sdtpu_torch.ops import quant

    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = tol_rel * want.float().abs().max().item()
    ms = time_ms(fn, it)
    if shape[0] <= quant.GQ_GEMV_MAX_M and extra.get("form") != "splitk":  # one kernel a call
        extra["device_ms"] = device_ms(fn, it)
    elif device_clock:
        extra["device_ms"] = device_ms_sum(fn, it)
        if library is not None:
            extra["library_device_ms"] = device_ms_sum(library, it)
    plain_ms = time_ms(plain, max(3, it // 4))
    library_ms = time_ms(library, it) if library is not None else None
    note = {} if library_note is None else {"library_note": library_note}
    if faults:
        note["faults"] = faults
    caught = all(f > tol for f in (faults or {}).values())
    _record(results, dict(kernel=name, shape=list(shape), **extra, max_abs_err=err, tol=tol,
                          ok=bool(err <= tol and caught and torch.isfinite(got).all()), ms=ms,
                          plain_ms=plain_ms, **bnd, library_ms=library_ms, **note))


def check_w8a8(results):
    """Each W8A8_CASES and Z_IMAGE_W8A8_CASES shape (bf16 x) and
    W8A8_F32_CASES shape (float32 x), bit-equal to the plain version, with an
    all-zero x row (at M = 1 a second call on an all-zero x); ``form`` is the
    form the library ran (``W8A8_FORMS``).  The yardstick ``torch._int_mm``
    runs the GEMM alone on the same int8 operands, unchecked (no row
    quantize, no epilogue); it refuses M <= 16, and its refusal is the
    case's ``library_note``."""
    import torch

    from sdtpu_torch.ops import _build, quant

    g = torch.Generator(device=DEVICE).manual_seed(1)
    plan = [(c, "bf16") for c in W8A8_CASES + Z_IMAGE_W8A8_CASES]
    plan += [(c, "f32") for c in W8A8_F32_CASES]
    for (m, k, n), dt in plan:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((m, k), generator=g, device=DEVICE, dtype=dtype)
        qt = quant.QuantTensor(
            q=torch.randint(-127, 127, (n, k), generator=g, device=DEVICE, dtype=torch.int8),
            scale=torch.rand((n,), generator=g, device=DEVICE) * 4e-4 + 1e-5)
        if m == 1:
            xs = (x, torch.zeros_like(x))  # the amax = 0 row: a call of its own
        else:
            x[0] = 0  # the amax = 0 row
            xs = (x,)
        got = torch.cat([quant.quant_matmul_w8a8(v, qt) for v in xs])
        want = torch.cat([quant.quant_matmul_w8a8_plain(v, qt) for v in xs])
        xq, _ = quant.quantize_activations(x)
        wt = qt.q.t()
        library, note = lambda: torch._int_mm(xq, wt), None
        try:
            library()
        except RuntimeError as e:
            library, note = None, _refused(e)
        _compare(results, "w8a8_matmul", (m, k, n), got, want, 0.0,
                 lambda: quant.quant_matmul_w8a8(x, qt), lambda: quant.quant_matmul_w8a8_plain(x, qt),
                 iters_for(2.0 * m * n * k),
                 bound(2.0 * m * n * k, nbytes(x, qt.q, qt.scale, got[:m]), "int8"),
                 library=library, library_note=note, dtype=dt,
                 form=W8A8_FORMS[_build.query("sdtpu_w8a8_form", m, k)],
                 splits=_build.query("sdtpu_w8a8_splits", m, n, k))
        del x, xs, xq, qt, got, want, library


def _d512_faults(q, k, v, mask, want) -> dict:
    """max |error| against ``want`` of the FLASH_FAULTS, computed in plain
    PyTorch (float32 scores, P rounded to bf16 as the kernel does) with the
    key splits and 32-key tiles the D 512 launcher uses for this shape."""
    import torch

    from sdtpu_torch.ops import _build

    b, h, lq, d = q.shape
    lk = k.shape[2]
    splits = _build.query("sdtpu_flash_splits", 0, b * h, lq, lk, d)
    ntiles = -(-lk // 32)
    keys = -(-ntiles // splits) * 32  # keys of each split but the last
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if mask is not None:
        s = s + mask.float()
    drop = s.clone()
    drop[..., keys - 32:keys] = float("-inf")
    p = torch.softmax(drop, dim=-1).to(q.dtype)
    out = {"splits": splits, "drop_key_tile": (torch.matmul(p, v).float() - want.float()).abs().max().item()}
    if splits > 1:
        o = l = 0
        for i in range(0, lk, keys):
            si = s[..., i:i + keys]
            pi = torch.exp(si - si.amax(dim=-1, keepdim=True))
            o = o + torch.matmul(pi.to(q.dtype), v[..., i:i + keys, :]).float()
            l = l + pi.sum(dim=-1, keepdim=True)
        out["combine_unscaled"] = (o / l - want.float()).abs().max().item()
    return out


def _d320_faults(q, k, v, mask, want) -> dict:
    """max |error| against ``want`` of the bf16 D 320 kernel's faults
    (FLASH_FAULTS), in plain PyTorch on the case's inputs: the second
    warpgroup's last output block dropped (columns 256-319 zero), the scores
    over the first warpgroup's 160 columns alone, and ``_d512_faults`` (the
    same 32-key tiles and key splits)."""
    from sdtpu_torch.ops.flash_attention import plain_attention

    out = _d512_faults(q, k, v, mask, want)
    dropped = plain_attention(q, k, v, mask=mask)
    dropped[..., 256:] = 0
    out["drop_out_block"] = (dropped.float() - want.float()).abs().max().item()
    half = plain_attention(q[..., :160], k[..., :160], v, mask=mask, scale=q.shape[-1] ** -0.5)
    out["half_scores"] = (half.float() - want.float()).abs().max().item()
    return out


def _padded_faults(q, k, v, mask, want) -> dict:
    """max |error| against ``want`` of the padded bf16 kernel's two faults
    (FLASH_FAULTS), in plain PyTorch on the case's inputs."""
    import torch

    from sdtpu_torch.ops.flash_attention import plain_attention

    d, lk = q.shape[-1], k.shape[2]
    dp = -(-d // 64) * 64
    tile = 64 if dp > 128 else 128
    out = {"padded_scale": (plain_attention(q, k, v, mask=mask, scale=dp ** -0.5).float()
                            - want.float()).abs().max().item()}
    if lk % tile:
        pad = tile - lk % tile
        kz, vz = (torch.cat([t, t.new_zeros(t.shape[:2] + (pad, d))], dim=2) for t in (k, v))
        mz = None if mask is None else torch.nn.functional.pad(mask, (0, pad))
        out["unmasked_pad_keys"] = (plain_attention(q, kz, vz, mask=mz).float()
                                    - want.float()).abs().max().item()
    return out


def _d64_faults(q, k, v, mask, want) -> dict:
    """max |error| against ``want`` of the bf16 D 64 kernel's faults
    (FLASH_FAULTS), in plain PyTorch on the case's inputs: its last 128-key
    tile dropped (where the keys span more than one), and the zero keys past
    Lk left unmasked (where Lk is off the tile)."""
    from sdtpu_torch.ops.flash_attention import plain_attention

    lk = k.shape[2]
    out = {k_: v_ for k_, v_ in _padded_faults(q, k, v, mask, want).items() if k_ != "padded_scale"}
    if lk > 128:
        keep = (lk - 1) // 128 * 128
        out["drop_key_tile"] = (plain_attention(q, k[:, :, :keep], v[:, :, :keep],
                                                mask=None if mask is None else mask[..., :keep])
                                .float() - want.float()).abs().max().item()
    return out


def _ragged_faults(q, k, v, mask, want) -> dict:
    """max |error| against ``want`` of the bf16 D 128 kernel's fault at a
    key count off its 128-key tile (``unmasked_pad_keys``, FLASH_FAULTS), in
    plain PyTorch on the case's inputs; none where Lk is on the tile."""
    return {k_: v_ for k_, v_ in _padded_faults(q, k, v, mask, want).items() if k_ != "padded_scale"}


def _split_fault(q, k, v, mask, want, splits: int) -> dict:
    """A float32 split call's fault (FLASH_FAULTS): its splits' partial
    outputs and sums (``key_split_partials``, the f32 kernel's 16-key tiles)
    merged without the combine's 2^(m_s - M) rescale."""
    from sdtpu_torch.ops.flash_attention import key_split_partials

    parts = key_split_partials(q, k, v, mask, splits=splits, tile=16)
    unscaled = sum(o for o, _, _ in parts) / sum(l for _, _, l in parts)
    return {"combine_unscaled": (unscaled - want.float()).abs().max().item()}


def _tf32_round(t):
    """float32 → the nearest tf32 (10 explicit mantissa bits, ties away from
    zero), as cvt.rna.tf32.f32 rounds."""
    import torch

    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _one_pass_tf32_fault(q, k, v, mask, want) -> dict:
    """max |error| against ``want`` of flash in one TF32 pass, emulated in
    plain PyTorch: q, k, v and the probabilities rounded to tf32, the sums in
    float32."""
    import torch

    qr, kr, vr = (_tf32_round(t) for t in (q, k, v))
    s = torch.matmul(qr, kr.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s + mask
    p = _tf32_round(torch.softmax(s, dim=-1))
    return {"one_pass_tf32": (torch.matmul(p, vr) - want).abs().max().item()}


def _one_pass_tf32_matmul_fault(x, w, want) -> dict:
    """max |error| against ``want`` of x·wᵀ in one TF32 pass, emulated in
    plain PyTorch: x rounded to tf32, the same float32 weights ``w`` [N, K],
    the sums in float32 (TF32 off)."""
    import torch

    return {"one_pass_tf32": (torch.matmul(_tf32_round(x), w.T) - want).abs().max().item()}


def _f32_matmul_checks(x, w, got, want):
    """A float32 matmul case's fault and its distances from the exact
    answer: (faults, extra), faults the one-pass TF32 fault (which must
    exceed the case's limit), extra the kernel's and the plain version's
    max |error| against x·wᵀ in float64 (how much of their difference is the
    plain version's own float32 rounding)."""
    import torch

    exact = torch.matmul(x.double(), w.double().T)
    extra = {"err_f64": (got.double() - exact).abs().max().item(),
             "plain_err_f64": (want.double() - exact).abs().max().item()}
    del exact
    return _one_pass_tf32_matmul_fault(x, w, want), extra


def split_x_matmul(x, q, scale, zero=None, group=None):
    """The float32 quantized forms' arithmetic, emulated in plain PyTorch on
    float32 tensors: x [M, K] split into big = tf32(x) and small = tf32(x -
    big); q [N, Kp] the weight's integers (exact); with ``group``, scale (and
    zero) [N, Kp / group]: each group's two products summed in float32, then
    folded into the float32 master as master + s·acc (− z · the group's sum
    of x); without, scale [N]: each 64-k stage's sums added to the master,
    the total times scale[n].  The tensor cores sum a product in another
    order, with truncating adds: this is the arithmetic, not the bits."""
    import torch

    m, k = x.shape
    n, kp = q.shape
    x = torch.nn.functional.pad(x, (0, kp - k))
    big = _tf32_round(x)
    small = _tf32_round(x - big)
    step = group or 64
    parts = -(-kp // step)
    pad = parts * step - kp
    xb, xs, xp, qq = (torch.nn.functional.pad(t, (0, pad)).reshape(t.shape[0], parts, step)
                      for t in (big, small, x, q))
    acc = torch.einsum("mgk,ngk->gmn", xb, qq) + torch.einsum("mgk,ngk->gmn", xs, qq)
    master = torch.zeros((m, n), dtype=torch.float32)
    for gi in range(parts):
        if group is None:
            master = master + acc[gi]
            continue
        master = master + scale[:, gi] * acc[gi]
        if zero is not None:
            master = master - xp[:, gi].sum(dim=1, keepdim=True) * zero[:, gi]
    return master if group else master * scale


def flash_inputs(g, b: int, h: int, lq: int, lk: int, d: int, dtype, bias):
    """A flash case's q, k, v ([B, H, L, D], standard normal) and mask on the
    card.  bias: None; "causal"; "random" (a dense [Lq, Lk] bias); or
    "neg_scores": no mask, q drawn around +1 and k around -1, so every score
    lies near -sqrt(D) (std sqrt(3)) and a zero pad key, scoring 0, would
    outweigh the real ones where the kernel left it unmasked."""
    import torch

    q, k, v = (torch.randn((b, h, l, d), generator=g, device=DEVICE, dtype=dtype)
               for l in (lq, lk, lk))
    mask = None
    if bias == "causal":
        mask = torch.full((lq, lk), -1e30, device=DEVICE).triu(1)
    elif bias == "random":
        mask = torch.randn((lq, lk), generator=g, device=DEVICE)
    elif bias == "neg_scores":
        q, k = q + 1, k - 1
    return q, k, v, mask


def check_flash(results):
    import torch
    import torch.nn.functional as F

    from sdtpu_torch.ops import _build
    from sdtpu_torch.ops import flash_attention as fa

    ex2_rate = ex2_per_s()
    g = torch.Generator(device=DEVICE).manual_seed(2)
    for b, h, lq, lk, d, dt, bias in FLASH_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v, mask = flash_inputs(g, b, h, lq, lk, d, dtype, bias)
        got = fa.flash_attention(q, k, v, mask=mask)
        want = fa.plain_attention(q, k, v, mask=mask)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = FLASH_TOL[dt] * want.float().abs().max().item()
        if d in UNET_HEAD_DIMS:
            name = f"flash_attention_d{d}"
            faults = (_one_pass_tf32_fault(q, k, v, mask, want) if dt == "f32"
                      else _padded_faults(q, k, v, mask, want))
        elif d == 320:
            name = D320
            faults = (_one_pass_tf32_fault(q, k, v, mask, want) if dt == "f32"
                      else _d320_faults(q, k, v, mask, want))
        elif dt == "f32":
            name, faults = "flash_attention_f32", _one_pass_tf32_fault(q, k, v, mask, want)
        elif d == 64:
            name, faults = "flash_attention_d64", _d64_faults(q, k, v, mask, want)
        elif d == 512:
            name, faults = "flash_attention_d512", _d512_faults(q, k, v, mask, want)
        else:
            name, faults = "flash_attention", _ragged_faults(q, k, v, mask, want)
        splits = _build.query("sdtpu_flash_splits", _build.DTYPE_CODES[dtype], b * h, lq, lk, d)
        if dt == "f32" and splits > 1:
            faults.update(_split_fault(q, k, v, mask, want, splits))
        caught = all(faults[f] > tol for f in (*FLASH_FAULTS, "one_pass_tf32") if f in faults)
        it = iters_for(4.0 * b * h * lq * lk * d)
        lib_mask = None if mask is None else mask.to(dtype)

        def kernel():
            return fa.flash_attention(q, k, v, mask=mask)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask)

        ms = time_ms(kernel, it)
        plain_ms = time_ms(lambda: fa.plain_attention(q, k, v, mask=mask), it)
        library_ms = time_ms(library, it)
        extra = {"faults": faults} if faults else {}
        # under 0.1 ms the CUDA-event time reads the wrapper: the device clock
        # too; and at Wan's shapes, whose request time this case predicts
        if ms < 0.1 or (b, h, lq, lk, d, dt, bias) in WAN_FLASH_CASES:
            extra.update(device_ms=device_ms_sum(kernel, it), library_device_ms=device_ms_sum(library, it))
        if d == 320:  # past SDPA's flash backend: the kernels name the backend it took
            extra["library_kernels"] = sorted({n[:90] for n, _ in device_kernels(library, 2)})
        _record(results, dict(kernel=name, shape=[b, h, lq, lk, d], dtype=dt,
                            bias=bias, splits=splits, max_abs_err=err, tol=tol, **extra,
                            ok=bool(err <= tol and caught and torch.isfinite(got).all()),
                            ms=ms, plain_ms=plain_ms,
                            **flash_bound(b, h, lq, lk, d, nbytes(q, k, v, mask, got), dt, ex2_rate),
                            library_ms=library_ms))
        del q, k, v, got, want


def _int4pack_library(x, qt, want):
    """``torch._weight_int4pack_mm`` on the same nibbles and scales, checked:
    tinygemm computes (nibble - 8) * scale + zero, so the zeros are 0; it
    packs the even k in the high nibble, the port in the low one."""
    import torch

    if qt.group not in (32, 64):
        return None, f"group {qt.group}: _weight_int4pack_mm takes groups 32 to 256"
    p = qt.packed
    try:
        w = torch._convert_weight_to_int4pack(((p & 0x0F) << 4) | (p >> 4), 8)
    except RuntimeError as e:
        return None, _refused(e)
    s = qt.scale.t()
    sz = torch.stack([s, torch.zeros_like(s)], dim=-1).to(torch.bfloat16).contiguous()
    return _yardstick(lambda: torch._weight_int4pack_mm(x, w, qt.group, sz), want)


def _drop_split_fault(x, qt, want, splits: int, w8a8: bool = False) -> dict:
    """A split-K form's fault, in plain PyTorch on the case's inputs: the
    ``splits`` K splits summed without the last one (with one split, the
    whole sum dropped)."""
    from sdtpu_torch.ops import quant

    got = quant.split_k_matmul(x, qt, splits, w8a8=w8a8, keep=-1)
    return {"drop_k_split": (got.float() - want.float()).abs().max().item()}


def check_q4(results):
    """Each Q4_CASES shape in bf16 and each Q4_F32_CASES shape in float32,
    with random packed bytes and random scales (a wrong nibble or group index
    shows); ``form`` is the form the library ran (``Q4_FORMS``),
    ``tile_rows`` the x-row tile the launcher gave the wgmma form (0: another
    form) and ``splits`` the K splits of the split-K form (0: another form),
    whose cases also read the last split dropped as a fault.  bf16 cases of
    at most ``Q4_WGMMA_MIN_M`` rows and T5's 77-row shapes in float32 are
    read on the device clock too."""
    import torch

    from sdtpu_torch.ops import _build, quant
    from sdtpu_torch.weights import Q4_SCALE

    g = torch.Generator(device=DEVICE).manual_seed(3)
    plan = [(*c, "bf16") for c in Q4_CASES] + [(*c, "f32") for c in Q4_F32_CASES]
    for m, k, n, group, dt in plan:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((m, k), generator=g, device=DEVICE, dtype=dtype)
        kp = -(-k // quant.Q4_K_MULTIPLE) * quant.Q4_K_MULTIPLE
        qt = quant.Q4Tensor(
            packed=torch.randint(0, 256, (n, kp // 2), generator=g, device=DEVICE,
                                 dtype=torch.uint8),
            scale=torch.rand((n, kp // group), generator=g, device=DEVICE) * Q4_SCALE
            + Q4_SCALE / 2,
            k=k, group=group)
        got = quant.q4_matmul(x, qt)
        want = quant.q4_matmul_plain(x, qt)
        library, note = _int4pack_library(x, qt, want)
        form = Q4_FORMS[_build.query("sdtpu_q4_form", _build.DTYPE_CODES[dtype], m)]
        splits = _build.query("sdtpu_q4_splits", m, n, k) if form == "splitk" else 0
        faults, f64 = (None, {}) if dt == "bf16" else _f32_matmul_checks(
            x, quant.dequantize_q4(qt, torch.float32), got, want)
        if splits:  # the reduction's order is fixed: a second call is bit-identical
            faults = _drop_split_fault(x, qt, want, splits)
            if not torch.equal(quant.q4_matmul(x, qt), got):
                raise RuntimeError(f"q4_matmul {m}x{k}->{n} g{group}: two calls differ")
        _compare(results, "q4_matmul", (m, k, n), got, want,
                 Q4_REL_TOL if dt == "bf16" else GQ_REL_TOL["f32"],
                 lambda: quant.q4_matmul(x, qt), lambda: quant.q4_matmul_plain(x, qt),
                 iters_for(2.0 * m * n * k),
                 quant_bound(m, k, n, nbytes(x, qt.packed, qt.scale, got), dt),
                 library=library, library_note=note, faults=faults, **f64, group=group, dtype=dt,
                 form=form, tile_rows=_tile_rows(dt, m, n), splits=splits,
                 device_clock=(m, k, n) in Q4_SD3_T5_SHAPES or (
                     dt == "bf16" and m <= quant.Q4_WGMMA_MIN_M))
        del x, qt, got, want, library


def _tile_rows(dt: str, m: int, n: int) -> int:
    """The x rows per block the library gives a call: the 4-bit wgmma
    kernel's for bf16 (0: another bf16 form), the float32 form's for float32."""
    from sdtpu_torch.ops import _build

    if dt == "f32":
        return _build.query("sdtpu_f32_tile_rows", m, n)
    return _build.query("sdtpu_q4_tile_rows", m, n)


def _random_group_weight(g, n, k, group, affine):
    import torch

    from sdtpu_torch.ops import quant

    kp = -(-k // group) * group
    return quant.GroupQuantTensor(
        q=torch.randint(-127, 128, (n, kp), generator=g, device=DEVICE, dtype=torch.int8),
        scale=torch.rand((n, kp // group), generator=g, device=DEVICE) * 4e-4 + 1e-5,
        zero=torch.rand((n, kp // group), generator=g, device=DEVICE) * 1e-2 if affine else None,
        k=k, group=group)


def check_group_quant(results):
    """gq and gq_ws at the W8A8 shapes (group 32) and two shapes at group 16;
    gq_zero at the W8A8 shapes; gq and gq_zero in float32 at GQ_F32_CASES;
    all with random scales (and zeros), so a wrong group index shows."""
    import torch

    from sdtpu_torch.ops import _build, quant

    g = torch.Generator(device=DEVICE).manual_seed(4)
    plan = [(s, 32, "bf16", form) for s in W8A8_CASES for form in ("gq_matmul", "gq_matmul_ws")]
    plan += [(s, 16, "bf16", form) for s in GQ16_CASES for form in ("gq_matmul", "gq_matmul_ws")]
    plan += [(s, 32, "bf16", "gq_zero_matmul") for s in W8A8_CASES]
    plan += [(s[:3], s[3], "f32", form) for s in GQ_F32_CASES for form in ("gq_matmul", "gq_zero_matmul")]
    for (m, k, n), group, dt, form in plan:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((m, k), generator=g, device=DEVICE, dtype=dtype)
        affine = form == "gq_zero_matmul"
        qt = _random_group_weight(g, n, k, group, affine=affine)
        fn = getattr(quant, form)
        got = fn(x, qt)
        want = quant.group_quant_matmul_plain(x, qt)
        faults, f64 = (None, {}) if dt == "bf16" else _f32_matmul_checks(
            x, quant.dequantize_group(qt, torch.float32), got, want)
        mode = quant.GQ_MODE_AFFINE if affine else quant.GQ_MODE_GROUP
        code = GQ_FORMS[_build.query("sdtpu_gq_form", _build.DTYPE_CODES[dtype], mode, m)]
        _compare(results, form, (m, k, n), got, want,
                 GQ_REL_TOL[dt], lambda: fn(x, qt), lambda: quant.group_quant_matmul_plain(x, qt),
                 iters_for(2.0 * m * n * k),
                 quant_bound(m, k, n, nbytes(x, qt.q, qt.scale, qt.zero, got), dt),
                 library_note=GQ_NO_LIBRARY, faults=faults, **f64, group=group, dtype=dt,
                 form=code, splits=_build.query("sdtpu_gq_splits", m, n, k) if code == "splitk" else 0,
                 tile_rows=_build.query("sdtpu_f32_tile_rows", m, n) if dt == "f32" else 0)
        del x, qt, got, want


def check_w8a16(results):
    """W8A16 at the W8A8 shapes in bf16 and at W8A16_F32_CASES in float32;
    the yardstick ``torch._weight_int8pack_mm`` takes x as it is (a refusal
    is the case's ``library_note``)."""
    import torch

    from sdtpu_torch.ops import _build, quant

    g = torch.Generator(device=DEVICE).manual_seed(5)
    plan = [(c, "bf16") for c in W8A8_CASES] + [(c, "f32") for c in W8A16_F32_CASES]
    for (m, k, n), dt in plan:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((m, k), generator=g, device=DEVICE, dtype=dtype)
        qt = quant.QuantTensor(
            q=torch.randint(-127, 128, (n, k), generator=g, device=DEVICE, dtype=torch.int8),
            scale=torch.rand((n,), generator=g, device=DEVICE) * 4e-4 + 1e-5)
        got = quant.w8a16_matmul(x, qt)
        want = quant.w8a16_matmul_plain(x, qt)
        s_lib = qt.scale.to(dtype)
        library, note = _yardstick(lambda: torch._weight_int8pack_mm(x, qt.q, s_lib), want)
        faults, f64 = (None, {}) if dt == "bf16" else _f32_matmul_checks(
            x, quant.dequantize(qt, torch.float32), got, want)
        code = GQ_FORMS[_build.query("sdtpu_gq_form", _build.DTYPE_CODES[dtype],
                                     quant.GQ_MODE_ROW_SCALE, m)]
        _compare(results, "w8a16_matmul", (m, k, n), got, want, GQ_REL_TOL[dt],
                 lambda: quant.w8a16_matmul(x, qt), lambda: quant.w8a16_matmul_plain(x, qt),
                 iters_for(2.0 * m * n * k),
                 quant_bound(m, k, n, nbytes(x, qt.q, qt.scale, got), dt),
                 library=library, library_note=note, faults=faults, **f64, dtype=dt, form=code,
                 splits=_build.query("sdtpu_gq_splits", m, n, k) if code == "splitk" else 0,
                 tile_rows=_build.query("sdtpu_f32_tile_rows", m, n) if dt == "f32" else 0)
        del x, qt, got, want, library


def check_int8_splitk(results):
    """The int8 split-K cases (INT8_SPLITK_SHAPES, W8A8_LONG_K_SHAPES; W8A8
    in bf16 also at Z_IMAGE_SPLITK_SHAPES): each
    form the library ran (``form`` splitk), its ``splits``, a second call
    bit-identical, the device clock.  Yardsticks: ``torch._int_mm`` on the
    same int8 operands for W8A8's GEMM alone (it refuses M <= 16: the
    refusal is the case's ``library_note``), ``torch._weight_int8pack_mm``
    for W8A16; the group-dequant form has none."""
    import torch

    from sdtpu_torch.ops import _build, quant

    g = torch.Generator(device=DEVICE).manual_seed(22)
    plan = [(s, "w8a8", dt) for s in INT8_SPLITK_SHAPES + W8A8_LONG_K_SHAPES for dt in ("bf16", "f32")]
    plan += [(s, "w8a8", "bf16") for s in Z_IMAGE_SPLITK_SHAPES]
    plan += [(s, kind, "bf16") for s in INT8_SPLITK_SHAPES for kind in ("gq32", "gq16", "w8a16")]
    for (m, k, n), kind, dt in plan:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((m, k), generator=g, device=DEVICE, dtype=dtype)
        if kind.startswith("gq"):
            qt = _random_group_weight(g, n, k, int(kind[2:]), affine=False)
            fn, plain, name = quant.gq_matmul, quant.group_quant_matmul_plain, "gq_matmul"
            mode, tol, nb = quant.GQ_MODE_GROUP, GQ_REL_TOL["bf16"], nbytes(x, qt.q, qt.scale)
        else:
            qt = quant.QuantTensor(
                q=torch.randint(-127, 128, (n, k), generator=g, device=DEVICE, dtype=torch.int8),
                scale=torch.rand((n,), generator=g, device=DEVICE) * 4e-4 + 1e-5)
            nb = nbytes(x, qt.q, qt.scale)
            if kind == "w8a8":
                x[m // 2] = 0  # the amax = 0 row
                fn, plain, name, tol = quant.quant_matmul_w8a8, quant.quant_matmul_w8a8_plain, \
                    "w8a8_matmul", 0.0
            else:
                fn, plain, name = quant.w8a16_matmul, quant.w8a16_matmul_plain, "w8a16_matmul"
                mode, tol = quant.GQ_MODE_ROW_SCALE, GQ_REL_TOL["bf16"]
        got, want = fn(x, qt), plain(x, qt)
        if kind == "w8a8":
            form = W8A8_FORMS[_build.query("sdtpu_w8a8_form", m, k)]
            splits = _build.query("sdtpu_w8a8_splits", m, n, k)
            xq, _ = quant.quantize_activations(x)
            wt = qt.q.t()
            library, note = lambda: torch._int_mm(xq, wt), None
            try:
                library()
            except RuntimeError as e:
                library, note = None, _refused(e)
        else:
            form = GQ_FORMS[_build.query("sdtpu_gq_form", 0, mode, m)]
            splits = _build.query("sdtpu_gq_splits", m, n, k)
            library, note = (None, GQ_NO_LIBRARY) if kind != "w8a16" else _yardstick(
                lambda: torch._weight_int8pack_mm(x, qt.q, qt.scale.to(dtype)), want)
        if form != "splitk" or splits < 1:
            raise RuntimeError(f"{name} {m}x{k}->{n}: form {form}, {splits} splits: not split-K")
        if not torch.equal(fn(x, qt), got):
            raise RuntimeError(f"{name} {m}x{k}->{n} {kind}: two calls differ")
        faults = _drop_split_fault(x, qt, want, splits, w8a8=kind == "w8a8")
        bnd = (bound(2.0 * m * n * k, nb + nbytes(got), "int8") if kind == "w8a8"
               else quant_bound(m, k, n, nb + nbytes(got), dt))
        extra = {"group": int(kind[2:])} if kind.startswith("gq") else {}
        _compare(results, name, (m, k, n), got, want, tol, lambda: fn(x, qt), lambda: plain(x, qt),
                 iters_for(2.0 * m * n * k), bnd, library=library, library_note=note,
                 faults=faults, dtype=dt, form=form, splits=splits, device_clock=True, **extra)
        del x, qt, got, want, library


def _check_m1_linears(path: str, gemv: int, mid: int, requests) -> None:
    """A path's GEMV ran every M = 1 linear of the DiT (DIT_M1_PER_STEP a
    step, M = 4 under CFG with a batch of two) and its split-K form for 8 <
    M < 128 ran nothing."""
    want = DIT_M1_PER_STEP * sum(r["sample_steps"] for r in requests)
    if gemv != want or mid:
        raise RuntimeError(f"path {path}: {gemv} GEMV launches, not the {want} M = 1 linears, "
                           f"and {mid} launches of the 8 < M < 128 form, not 0")


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def _f32_params(params, device):
    """The same weights on ``device``, the dense ones widened to float32
    (exact from bf16), the quantized ones as they are."""
    import torch

    from sdtpu_torch.ops.quant import Q4Tensor, QuantTensor

    out = {}
    for k, v in params.items():
        if isinstance(v, QuantTensor):
            out[k] = QuantTensor(v.q.to(device), v.scale.to(device))
        elif isinstance(v, Q4Tensor):
            out[k] = dataclasses.replace(v, packed=v.packed.to(device), scale=v.scale.to(device))
        else:
            out[k] = v.to(device, torch.float32)
    return out


def reference_check():
    """Small kernel-shaped configs: every kernel on the card against the
    plain versions on the CPU (float32), same weights and inputs, with the
    card in bf16 (held at REF_REL_TOL) and in float32 (REF_F32_REL_TOL)."""
    import torch

    from sdtpu_torch.conditioning.conditioner import SD1Conditioner, SD3Conditioner, WanConditioner
    from sdtpu_torch.models import clip as clip_mod
    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.models import mmdit as mmdit_mod
    from sdtpu_torch.models import t5 as t5_mod
    from sdtpu_torch.models import tae as tae_mod
    from sdtpu_torch.models import unet as unet_mod
    from sdtpu_torch.models import vae as vae_mod
    from sdtpu_torch.models import wan as wan_mod
    from sdtpu_torch.models import wan_vae as wan_vae_mod
    from sdtpu_torch.tokenizers.clip import CLIPTokenizer
    from sdtpu_torch.weights import synthesize

    dit_cfg = flux_mod.FluxConfig(hidden_size=256, num_heads=2, depth=1, depth_single=1,
                                  context_in_dim=512, vec_in_dim=128)
    clip_cfg = dataclasses.replace(clip_mod.CLIP_L_CONFIG, hidden_size=128, intermediate_size=256,
                                   num_layers=2, num_heads=2)
    t5_cfg = t5_mod.T5Config(d_model=512, d_kv=64, d_ff=1024, num_layers=1, num_heads=8)
    vae_cfg = vae_mod.FLUX_VAE_CONFIG
    # the SD1.5 UNet's widths and heads (D 40, 80, 160) at one res block a
    # level, on a 16x16 latent under CFG
    unet_cfg = dataclasses.replace(unet_mod.SD1_UNET_CONFIG, num_res_blocks=1,
                                   channel_mult=(1, 2, 4), transformer_depth=(1, 1, 1))
    # SDXL's widths, 64-channel heads and vector at one res block a level and
    # depth 1; CLIP-G at full width and two layers; TAESD-XL whole
    sdxl_cfg = dataclasses.replace(unet_mod.SDXL_UNET_CONFIG, num_res_blocks=1,
                                   transformer_depth=(0, 1, 1))
    clip_g_cfg = dataclasses.replace(clip_mod.CLIP_G_CONFIG, num_layers=2)
    tae_cfg = tae_mod.TAESD_XL_CONFIG
    # SD3.5-Medium's blocks cut to three, 64-channel heads (3 of them): qk
    # RMS norms, MMDiT-X's attn2 in the first two, the pre-only last block;
    # a 32x32 latent beside 154 context tokens (410: ragged on the tiles);
    # and the SD3 conditioner on the CLIPs above with a 4-bit T5 1536 wide
    # (CLIP-L ++ CLIP-G is 1408)
    mmdit_cfg = dataclasses.replace(mmdit_mod.SD35_MEDIUM_CONFIG, depth=3, num_x_self_attn_layers=2,
                                    pos_embed_max_size=32, context_size=512, adm_in_channels=256)
    sd3_t5_cfg = t5_mod.T5Config(d_model=1536, d_kv=64, d_ff=1024, num_layers=1, num_heads=8)
    # Wan2.1: the DiT at 128-wide heads (2 of them), one block, over a 3 x 8
    # x 12 latent (72 tokens) beside 40 text tokens; the Wan VAE 32 wide at
    # 16 latent channels over 3 latent frames (9 frames of 64 x 64: the
    # temporal upsample, the per-frame float32 attention); and the Wan
    # conditioner on a 4-bit UMT5 (per-layer bias) over 512 tokens (the
    # 4-bit matmul's wgmma form)
    wan_cfg = dataclasses.replace(wan_mod.WAN21_T2V_1_3B_CONFIG, dim=256, ffn_dim=512, num_heads=2,
                                  num_layers=1, text_dim=512)
    wan_vae_cfg = wan_vae_mod.WanVAEConfig(dim=32, z_dim=16, num_res_blocks=1)
    umt5_cfg = t5_mod.T5Config(d_model=512, d_kv=64, d_ff=1024, num_layers=2, num_heads=8,
                               is_umt5=True)
    # SD2's inpainting UNet (64-channel heads, linear proj in / out, a
    # 9-channel stem) at one res block a level over three levels, on a
    # 16x16 latent under CFG; the SD2 conditioner (pad id 0, clip skip 2) on
    # OpenCLIP-H at full width cut to three layers
    sd2_cfg = dataclasses.replace(unet_mod.SD2_INPAINT_UNET_CONFIG, num_res_blocks=1,
                                  channel_mult=(1, 2, 4), transformer_depth=(1, 1, 1))
    clip_h_cfg = dataclasses.replace(clip_mod.CLIP_H_CONFIG, num_layers=3)
    mods = {
        "dit": (flux_mod.param_specs(dit_cfg), "q8_0"), "clip": (clip_mod.param_specs(clip_cfg), None),
        "t5": (t5_mod.param_specs(t5_cfg), "q4_0"), "vae": (vae_mod.param_specs(vae_cfg), None),
        "unet": (unet_mod.param_specs(unet_cfg), None),
        "sdxl_unet": (unet_mod.param_specs(sdxl_cfg), None),
        "clip_g": (clip_mod.param_specs(clip_g_cfg), None), "tae": (tae_mod.param_specs(tae_cfg), None),
        "mmdit": (mmdit_mod.param_specs(mmdit_cfg), None),
        "sd3_t5": (t5_mod.param_specs(sd3_t5_cfg), "q4_0"),
        "wan": (wan_mod.param_specs(wan_cfg), None),
        "wan_vae": (wan_vae_mod.param_specs(wan_vae_cfg), None),
        "umt5": (t5_mod.param_specs(umt5_cfg), "q4_0"),
        "sd2_unet": (unet_mod.param_specs(sd2_cfg), None),
        "clip_h": (clip_mod.param_specs(clip_h_cfg), None),
    }
    gpu = {n: synthesize(s, quant=q, seed=i, device=DEVICE, dtype=torch.bfloat16)
           for i, (n, (s, q)) in enumerate(mods.items())}
    cpu = {n: _f32_params(p, "cpu") for n, p in gpu.items()}
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 1000, (1, 77), generator=gen)
    ids[0, 20] = clip_cfg.eos_token_id
    t5_ids = torch.randint(0, 32000, (1, 256), generator=gen)
    x = torch.randn((1, 32, 32, 16), generator=gen)
    z = torch.randn((1, 16, 16, 16), generator=gen)
    t = torch.tensor([0.7])
    gd = torch.tensor([3.5])
    xu = torch.randn((2, 16, 16, 4), generator=gen)
    tu = torch.tensor([999.0, 411.5])
    ctx_u = torch.randn((2, 77, 768), generator=gen)
    ctx_xl = torch.randn((2, 77, sdxl_cfg.context_dim), generator=gen)
    y_xl = torch.randn((2, sdxl_cfg.adm_in_channels), generator=gen)
    z_tae = torch.randn((1, 16, 16, 4), generator=gen)
    x_sd3 = torch.randn((2, 32, 32, 16), generator=gen)
    t_sd3 = torch.tensor([1000.0, 411.5])
    ctx_sd3 = torch.randn((2, 154, mmdit_cfg.context_size), generator=gen)
    y_sd3 = torch.randn((2, mmdit_cfg.adm_in_channels), generator=gen)
    x_wan = torch.randn((2, 3, 8, 12, 16), generator=gen)
    t_wan = torch.tensor([999.0, 411.5])
    ctx_wan = torch.randn((2, 40, wan_cfg.text_dim), generator=gen)
    z_wan = torch.randn((1, 3, 8, 8, 16), generator=gen)
    x_sd2 = torch.randn((2, 16, 16, 9), generator=gen)
    ctx_sd2 = torch.randn((2, 77, sd2_cfg.context_dim), generator=gen)

    def run(p, dev, dtype):
        with torch.inference_mode():
            _, pooled = clip_mod.clip_text_forward(p["clip"], ids.to(dev), clip_cfg,
                                                   return_pooled=True)
            ctx = t5_mod.t5_encoder_forward(p["t5"], t5_ids.to(dev), t5_cfg)
            vel = flux_mod.flux_forward(p["dit"], x.to(dev, dtype), t.to(dev), ctx, pooled,
                                        guidance=gd.to(dev), cfg=dit_cfg)
            img = vae_mod.vae_decode(p["vae"], z.to(dev, dtype), vae_cfg)
            eps = unet_mod.unet_forward(p["unet"], xu.to(dev, dtype), tu.to(dev),
                                        ctx_u.to(dev, dtype), cfg=unet_cfg)
            eps_xl = unet_mod.unet_forward(p["sdxl_unet"], xu.to(dev, dtype), tu.to(dev),
                                           ctx_xl.to(dev, dtype), y=y_xl.to(dev), cfg=sdxl_cfg)
            h_g, pooled_g = clip_mod.clip_text_forward(p["clip_g"], ids.to(dev), clip_g_cfg,
                                                       clip_skip=2, return_pooled=True)
            tae_img = tae_mod.tae_decode(p["tae"], z_tae.to(dev, dtype), tae_cfg)
            vel_sd3 = mmdit_mod.mmdit_forward(p["mmdit"], x_sd3.to(dev, dtype), t_sd3.to(dev),
                                              ctx_sd3.to(dev, dtype), y_sd3.to(dev), cfg=mmdit_cfg)
            cond = SD3Conditioner(CLIPTokenizer(), None, p["clip"], clip_cfg, p["clip_g"], clip_g_cfg,
                                  p["sd3_t5"], sd3_t5_cfg, device=dev).get_learned_condition(
                                      "a photograph of an astronaut riding a horse")
            vel_wan = wan_mod.wan_forward(p["wan"], x_wan.to(dev, dtype), t_wan.to(dev),
                                          ctx_wan.to(dev, dtype), cfg=wan_cfg)
            vid_wan = wan_vae_mod.wan_vae_decode(p["wan_vae"], z_wan.to(dev, dtype), wan_vae_cfg)
            cond_wan = WanConditioner(None, p["umt5"], umt5_cfg, device=dev).get_learned_condition(
                "a corgi running on a beach")
            v_sd2 = unet_mod.unet_forward(p["sd2_unet"], x_sd2.to(dev, dtype), tu.to(dev),
                                          ctx_sd2.to(dev, dtype), cfg=sd2_cfg)
            cond_sd2 = SD1Conditioner(CLIPTokenizer(), p["clip_h"], clip_h_cfg, is_sd2=True,
                                      device=dev).get_learned_condition(
                                          "a lighthouse at dusk, oil on canvas")
        return {"sd2_inpaint_unet_forward": v_sd2, "sd2_cond_crossattn": cond_sd2.c_crossattn,
                "wan_forward": vel_wan, "wan_vae_decode": vid_wan,
                "wan_cond_crossattn": cond_wan.c_crossattn,
                "clip_pooled": pooled, "t5": ctx, "flux_forward": vel, "vae_decode": img,
                "unet_forward": eps, "sdxl_unet_forward": eps_xl, "clip_g_hidden": h_g,
                "clip_g_pooled": pooled_g, "tae_decode": tae_img, "mmdit_forward": vel_sd3,
                "sd3_cond_crossattn": cond.c_crossattn, "sd3_cond_vector": cond.c_vector}

    want = run(cpu, "cpu", torch.float32)
    out = {}
    for dt, dtype, tol in (("bf16", torch.bfloat16, REF_REL_TOL),
                           ("f32", torch.float32, REF_F32_REL_TOL)):
        params = gpu if dt == "bf16" else {n: _f32_params(p, DEVICE) for n, p in gpu.items()}
        got = run(params, DEVICE, dtype)
        out[dt] = {}
        for name in got:
            ok = bool(torch.isfinite(got[name]).all())
            rel = _rel(got[name], want[name])
            out[dt][name] = dict(rel_l2=rel, tol=tol, ok=ok and rel <= tol)
    return out


def _windowed(wrappers, path, run, echo: bool = True):
    """Run one path with every launch count set to 0 first; each kernel the
    path runs must have launched, and none it must not (``echo``: print the
    counts)."""
    for fn, attr in wrappers.values():
        setattr(fn, attr, 0)
    out = run()
    counts = {name: getattr(fn, attr) for name, (fn, attr) in wrappers.items()}
    if echo:
        print(f"launches {path} " + json.dumps(counts), flush=True)
    idle = [n for n in PATH_KERNELS[path] if counts[n] == 0]
    stray = [n for n in PATH_IDLE.get(path, ()) if counts[n] != 0]
    stray += [n for n, n32 in F32_PATHS.get(path, ()) if counts[n] != counts[n32]]
    if idle or stray:
        raise RuntimeError(f"path {path}: kernels not launched {idle}, launched in error {stray}")
    return out, counts


def _kquant_blocks(type_name: str, shape, seed: int):
    """A HostQuant of random raw k-quant blocks: integer payload random,
    f16 block scales small enough that the values look like weights."""
    import numpy as np

    from sdtpu_torch.io import gguf

    ggml_type = {"q6_k": gguf.GGML_Q6_K, "q4_k": gguf.GGML_Q4_K}[type_name]
    f16_spans = {"q6_k": [(208, 210)], "q4_k": [(0, 2), (2, 4)]}[type_name]
    block_elems, block_bytes = gguf.BLOCK_INFO[ggml_type]
    n_elems = shape[0] * shape[1]
    nb = n_elems // block_elems
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(nb, block_bytes), dtype=np.uint8)
    for lo, hi in f16_spans:
        d = (np.abs(rng.standard_normal(nb)) * 2e-5).astype(np.float16)
        raw[:, lo:hi] = d.view(np.uint8).reshape(nb, 2)
    return gguf.extract_blocks(raw.reshape(-1), ggml_type, n_elems, tuple(shape))


def loader_check(wrappers, card: str):
    """Phase 5: the GGUF keep-quant loader at full width, depth cut to one
    double and one single block."""
    import numpy as np
    import torch

    from sdtpu_torch.io.gguf import save_gguf
    from sdtpu_torch.io.model_loader import load_model_bundle
    from sdtpu_torch.loader import diffusion_to_device, load_flux_diffusion
    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.ops.quant import GroupQuantTensor, Q4Tensor, QuantTensor
    from sdtpu_torch.weights import WEIGHT_STD

    cfg = dataclasses.replace(flux_mod.FLUX_DEV_CONFIG, depth=1, depth_single=1)
    specs = flux_mod.param_specs(cfg)
    n_params = sum(int(np.prod(s)) for s, _ in specs.values())
    print(f"loader: FLUX.1-dev width, depth cut from 19 + 38 to 1 + 1 blocks ({n_params / 1e9:.3f} B "
          "params): the GGUF is written from a float32 source, which at full depth would take "
          "48 GB of host memory", flush=True)
    t0 = time.time()
    rng = np.random.default_rng(0)
    src = {}
    for name, (shape, init) in specs.items():
        if init == "normal":
            src[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(WEIGHT_STD)
        else:
            src[name] = (np.ones if init == "ones" else np.zeros)(shape, dtype=np.float32)
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "flux_dev_1+1.gguf"
    save_gguf(str(path), src, out_type="q8_0", type_rules=LOADER_TYPE_RULES)
    del src
    write_s = time.time() - t0
    t0 = time.time()
    d = load_model_bundle(diffusion_model_path=str(path), keep_quant=True).diffusion
    for i, (name, type_name) in enumerate(LOADER_KQUANT.items()):
        d[name] = _kquant_blocks(type_name, specs[name][0], seed=10 + i)
    types = {}
    for v in d.values():
        tn = getattr(v, "type_name", "dense")
        types[tn] = types.get(tn, 0) + 1
    load_s = time.time() - t0

    def inputs(seed):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        return [torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.bfloat16)
                for shape in ((1, 64, 64, 16), (1, 256, cfg.context_in_dim), (1, cfg.vec_in_dim))]

    inps = [inputs(seed) for seed in LOADER_SEEDS]
    t = torch.tensor([0.7], device=DEVICE)
    gd = torch.tensor([3.5], device=DEVICE)

    def forward(p, inp, dtype=torch.bfloat16):
        x, ctx, y = (v.to(dtype) for v in inp)
        with torch.inference_mode():
            out = flux_mod.flux_forward(p, x, t, ctx, y, guidance=gd, cfg=cfg)
        torch.cuda.synchronize()
        return out

    dense = {k: torch.tensor(np.asarray(v), dtype=torch.bfloat16, device=DEVICE)
             for k, v in d.items()}
    want = [forward(dense, inp) for inp in inps]
    # the exact answer: the same bf16 weights, the forward in float32
    dense = {k: v.float() for k, v in dense.items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        exact = [forward(dense, inp, torch.float32) for inp in inps]
        # the default dtype's exact answer: the blocks' own values in float32
        dense = {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=DEVICE)
                 for k, v in d.items()}
        exact32 = [forward(dense, inp, torch.float32) for inp in inps]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del dense
    stagings = {}
    t0 = time.time()
    for label, promote, dtype in (("promote_q8", True, torch.bfloat16),
                                  ("keep_blocks", False, torch.bfloat16),
                                  ("keep_blocks_f32", False, torch.float32)):
        stagings[label] = diffusion_to_device(d, dtype, DEVICE, promote_q8=promote)
    torch.cuda.synchronize()
    stage_s = time.time() - t0

    def kind(v):
        if isinstance(v, QuantTensor):
            return "QuantTensor"
        if isinstance(v, Q4Tensor):
            return f"Q4Tensor g{v.group}"
        if isinstance(v, GroupQuantTensor):
            return f"GroupQuantTensor {'affine' if v.zero is not None else 'symmetric'} g{v.group}"
        return "dense"

    classes = {label: {} for label in stagings}
    for label, p in stagings.items():
        for v in p.values():
            classes[label][kind(v)] = classes[label].get(kind(v), 0) + 1
    seen = {c for cl in classes.values() for c in cl}
    needed = {"QuantTensor", "Q4Tensor g32", "GroupQuantTensor symmetric g32",
              "GroupQuantTensor symmetric g16", "GroupQuantTensor affine g32"}
    if not needed <= seen:
        raise RuntimeError(f"loader: classes {sorted(needed - seen)} missing from {classes}")

    outs, counts = _windowed(wrappers, "gguf_loader", lambda: {
        label: [forward(p, inp, torch.float32 if label.endswith("_f32") else torch.bfloat16)
                for inp in inps] for label, p in stagings.items()})
    report = {"card": card, "params": n_params, "file_bytes": path.stat().st_size,
              "gguf_types": types, "classes": classes, "write_s": write_s, "load_s": load_s,
              "stage_s": stage_s, "checks": {label: [] for label in outs}}
    for label, gots in outs.items():
        for seed, got, dense_out, exact_out, exact32_out in zip(LOADER_SEEDS, gots, want, exact,
                                                                exact32):
            ok = bool(torch.isfinite(got).all()) and got.shape == dense_out.shape
            check = dict(seed=seed, rel_l2_dense=_rel(got, dense_out))
            if label == "keep_blocks_f32":
                # the float32 kernels against the blocks' values in a float32 forward
                check.update(rel_l2=_rel(got, exact32_out), tol=REF_F32_REL_TOL)
            elif label == "keep_blocks":
                # rel_l2 and tol are distances from the exact answer
                dense_rel = _rel(dense_out, exact_out)
                check.update(rel_l2=_rel(got, exact_out), dense_rel_l2=dense_rel,
                             tol=LOADER_KEEP_RATIO * dense_rel)
            else:
                check.update(rel_l2=check["rel_l2_dense"], tol=LOADER_REL_TOL[label])
            check["ok"] = ok and check["rel_l2"] <= check["tol"]
            report["checks"][label].append(check)
    print("loader " + json.dumps(report), flush=True)
    if not all(c["ok"] for cs in report["checks"].values() for c in cs):
        raise RuntimeError(f"loader check failed: {report['checks']}")
    del stagings, outs, want, exact, exact32, d
    gc.collect()

    t0 = time.time()
    params = load_flux_diffusion(str(path), dtype=torch.bfloat16, device=DEVICE, promote_q8=False)
    torch.cuda.synchronize()
    report["load_flux_diffusion_s"] = time.time() - t0
    path.unlink()
    pipe, _ = build_pipeline(card, params, "gguf_file 1+1 blocks, kept")
    report["requests"], request_counts = _windowed(
        wrappers, "gguf_file", lambda: answer(pipe, GGUF_FILE_REQUESTS, card, "gguf_file"))
    del pipe, params
    gc.collect()
    torch.cuda.empty_cache()
    return report, counts, request_counts


# Phase 11, the entry points on files (the DiT at FLUX.1-dev's full depth):
# the CLI's 1024² request and the server's 512² ones (at most 4 steps each)
ENTRY_PROMPT = "a lighthouse on a cliff above a stormy sea"
CLI_REQUEST = dict(prompt=ENTRY_PROMPT, width=1024, height=1024, sample_steps=2, cfg_scale=1.0,
                   guidance=3.5, seed=3)
CLI_ARGV = ["-p", ENTRY_PROMPT, "-W", "1024", "-H", "1024", "--steps", "2", "--sampling-method",
            "euler", "--cfg-scale", "1.0", "--guidance", "3.5", "-s", "3", "--vae-tiling"]
# the CLI's img2img on the FLUX files: -i / --mask / --strength 0.6 over 4
# steps (3 sample) with the bench's VAE tiling
CLI_IMG2IMG_REQUEST = dict(prompt="a harbour at dawn, oil on canvas", width=1024, height=1024,
                           sample_steps=4, cfg_scale=1.0, guidance=3.5, seed=3, strength=0.6)
CLI_IMG2IMG_ARGV = ["-p", CLI_IMG2IMG_REQUEST["prompt"], "-W", "1024", "-H", "1024", "--steps", "4",
                    "--sampling-method", "euler", "--cfg-scale", "1.0", "--guidance", "3.5", "-s",
                    "3", "--vae-tiling", "--strength", "0.6"]
# (route, body, the sampler the image's parameters must name)
SERVER_SYNC = [
    ("/sdapi/v1/txt2img", {"prompt": "a photograph of an astronaut riding a horse", "width": 512,
                           "height": 512, "steps": 4, "cfg_scale": 1.0, "seed": 7}, "euler_a"),
    ("/v1/images/generations",
     {"prompt": "a paper boat on a puddle after rain <sd_cpp_extra_args>{\"sample_params\": "
                "{\"sample_steps\": 4, \"sample_method\": \"euler\"}, \"cfg_scale\": 1.0, "
                "\"seed\": 8}</sd_cpp_extra_args>", "size": "512x512"}, "euler"),
]
SERVER_JOB = {"prompt": "a red fox in fresh snow, golden hour", "width": 512, "height": 512,
              "seed": 9, "sample_params": {"sample_steps": 4, "sample_method": "euler_a", "eta": 1.0,
                                           "guidance": {"txt_cfg": 1.0}}}


def _http(base: str, path: str, body=None):
    """→ (status, parsed json) of one request to the server under test."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _check_png(blob: bytes, width: int, height: int, sampler: str) -> dict:
    """An answer's PNG: its size, not constant, the sampler named in its
    parameters text."""
    from sdtpu_torch.utils.image import decode_png, parse_parameters_text

    img, params = decode_png(blob)
    if img.shape != (height, width, 3) or img.std() == 0:
        raise RuntimeError(f"image {img.shape}, std {img.std()}: not a {width}x{height} picture")
    named = parse_parameters_text(params or "").get("sampler")
    if named != sampler:
        raise RuntimeError(f"the image's parameters name sampler {named!r}, not {sampler!r}")
    return {"image_std": float(img.std()), "parameters": params}


def _entry_forms(path: str, counts: dict) -> dict:
    """The forms the entry paths must run: flash at D 128 (bf16, neither D 64
    nor D 512: no counter holds it alone), and the W8A8 (cli) or
    group-dequant (server) wgmma form."""
    forms = {"flash_attention_d128": counts["flash_attention"] - counts["flash_attention_d64"]
             - counts["flash_attention_d512"] - counts["flash_attention_f32"]}
    if path == "cli":
        forms["w8a8_matmul_wgmma"] = counts["w8a8_matmul_wgmma"]
    else:
        forms["gq_matmul_wgmma"] = counts["gq_matmul_wgmma"]
    if not all(v > 0 for v in forms.values()):
        raise RuntimeError(f"path {path}: forms not launched {forms}")
    return forms


def _ask_server(base: str, pipe) -> list:
    """The server's requests: the two synchronous routes, one native job
    polled to completion with its progress seen, one queued job cancelled."""
    import torch

    out = []
    for route, body, sampler in SERVER_SYNC:
        torch.cuda.reset_peak_memory_stats()
        code, resp = _http(base, route, body)
        if code != 200:
            raise RuntimeError(f"{route}: {code} {resp}")
        b64 = resp["images"][0] if route.startswith("/sdapi") else resp["data"][0]["b64_json"]
        out.append({"route": route, "timings_s": dict(pipe.last_timings),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    **_check_png(base64.b64decode(b64), 512, 512, sampler)})
        print("entry request " + json.dumps(out[-1]), flush=True)
    torch.cuda.reset_peak_memory_stats()
    jobs = [_http(base, "/sdcpp/v1/img_gen", SERVER_JOB) for _ in range(2)]
    if any(code != 202 for code, _ in jobs):
        raise RuntimeError(f"/sdcpp/v1/img_gen: {jobs}")
    job_id, queued_id = (resp["id"] for _, resp in jobs)
    cancel = _http(base, f"/sdcpp/v1/jobs/{queued_id}/cancel", {})
    seen, t0 = [], time.time()
    while True:
        _, st = _http(base, f"/sdcpp/v1/jobs/{job_id}")
        seen.append(st["progress"])
        if st["status"] in ("completed", "failed", "cancelled"):
            break
        if time.time() - t0 > 600:
            raise RuntimeError(f"job {job_id} still {st['status']} after 600 s")
        time.sleep(0.025)  # a step takes ~0.1 s; a tighter loop slows the job
    queued = _http(base, f"/sdcpp/v1/jobs/{queued_id}")[1]
    if st["status"] != "completed":
        raise RuntimeError(f"job {job_id} {st['status']}: {st['error']}")
    if not any(0 < p < 1 for p in seen) or st["step"] != st["steps"]:
        raise RuntimeError(f"job {job_id}: no progress seen while it ran ({sorted(set(seen))})")
    if cancel != (200, {"cancelled": True}) or queued["status"] != "cancelled":
        raise RuntimeError(f"queued job {queued_id}: cancel {cancel}, status {queued['status']}")
    out.append({"route": "/sdcpp/v1/img_gen", "timings_s": dict(pipe.last_timings),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "progress_seen": sorted(set(seen)), "cancelled_queued_job": True,
                **_check_png(base64.b64decode(st["images"][0]), 512, 512, "euler_a")})
    print("entry request " + json.dumps(out[-1]), flush=True)
    return out


def entry_points_check(wrappers, card: str, profile=None):
    """Phase 11: write the FLUX file set, answer from it through the CLI
    (txt2img, then img2img with a mask: path ``cli_img2img``) and the
    server, each in its own launch window."""
    import contextlib
    import io
    import queue
    import tempfile
    import threading

    import torch

    import numpy as np

    from sdtpu_torch import cli, server
    from sdtpu_torch.config import GenerationParams
    from sdtpu_torch.models.flux import FLUX_DEV_CONFIG
    from sdtpu_torch.tools.flux_files import write_flux_files
    from sdtpu_torch.utils.image import build_parameters_text, parse_parameters_text, write_image

    root = ROOT / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="entry_points_", dir=root))
    report = {"card": card, "dit_depth": [FLUX_DEV_CONFIG.depth, FLUX_DEV_CONFIG.depth_single]}
    try:
        t0 = time.time()
        files = write_flux_files(tmp, device=DEVICE)
        report["files"] = {"bytes": files["bytes"], "write_s": files["write_s"],
                           "total_bytes": sum(files["bytes"].values()),
                           "total_write_s": time.time() - t0}
        print(f"entry files on {card}: " + json.dumps(report["files"]), flush=True)
        paths = files["paths"]
        file_args = ["--diffusion-model", paths["diffusion_model"], "--clip_l", paths["clip_l"],
                     "--t5xxl", paths["t5xxl"], "--vae", paths["vae"]]

        png = tmp / "cli.png"
        cli_rep = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rc, counts_cli = _windowed(wrappers, "cli", lambda: cli.main(
            file_args + CLI_ARGV + ["-o", str(png)], report=cli_rep))
        wall_s = time.time() - t0
        if rc != 0:
            raise RuntimeError(f"sdtpu_torch.cli.main exited {rc}")
        forms = _entry_forms("cli", counts_cli)
        mid = sum(counts_cli[n] for n in ("w8a8_matmul_splitk", "gq_matmul_splitk",
                                          "w8a16_matmul_splitk", "gq_zero_matmul_mma"))
        if mid:
            raise RuntimeError(f"path cli: {mid} launches of a form for 8 < M < 128")
        load, ids = cli_rep["load"], cli_rep["t5_ids"]
        if not str(load["t5_tokenizer"]).startswith("gguf:"):
            raise RuntimeError(f"the T5 tokenizer was not found in the GGUF: {load['t5_tokenizer']}")
        if sum(1 for i in ids if i) < 2:  # more than the end-of-sequence id
            raise RuntimeError(f"T5 was fed no token of the prompt: {ids}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["metadata", "--image", str(png), "--metadata-format", "json"])
        want = build_parameters_text(GenerationParams(sample_method="euler", **CLI_REQUEST))
        meta = json.loads(buf.getvalue())
        if rc != 0 or meta.get("parameters") != parse_parameters_text(want):
            raise RuntimeError(f"metadata mode read {meta.get('parameters')}, not {want!r}")
        report["cli"] = {"load": load, "wall_s": wall_s, "timings_s": cli_rep["timings"],
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "t5_ids": len(ids), "t5_ids_nonzero": sum(1 for i in ids if i),
                         "forms": forms, "launches": counts_cli,
                         **_check_png(png.read_bytes(), 1024, 1024, "euler")}
        print("entry cli " + json.dumps(report["cli"]), flush=True)
        if profile:
            report["profile"] = profile_request(cli_rep["pipeline"], CLI_REQUEST, profile, "cli",
                                                card)
        del cli_rep
        gc.collect()
        torch.cuda.empty_cache()

        # img2img through the CLI: an init image and a mask as PNG files
        init_png, mask_png, png = tmp / "init.png", tmp / "mask.png", tmp / "cli_img2img.png"
        img, mask = init_image_and_mask(1024)
        write_image(str(init_png), img)
        write_image(str(mask_png), np.repeat(mask[..., None], 3, axis=-1))
        cli_rep = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with plain_attention_on_card() as plain:
            rc, counts_i2i = _windowed(wrappers, "cli_img2img", lambda: cli.main(
                file_args + CLI_IMG2IMG_ARGV + ["-i", str(init_png), "--mask", str(mask_png), "-o",
                                                str(png)], report=cli_rep))
        wall_s = time.time() - t0
        if rc != 0:
            raise RuntimeError(f"sdtpu_torch.cli.main -i ... --mask ... exited {rc}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["metadata", "--image", str(png), "--metadata-format", "json"])
        want = build_parameters_text(GenerationParams(sample_method="euler", **CLI_IMG2IMG_REQUEST))
        meta = json.loads(buf.getvalue())
        if rc != 0 or meta.get("parameters") != parse_parameters_text(want):
            raise RuntimeError(f"metadata mode read {meta.get('parameters')}, not {want!r}")
        enc, dec = _tiles(cli_rep["pipeline"], 1024)
        steps = img2img_steps(4, CLI_IMG2IMG_REQUEST["strength"])
        if cli_rep["timings"]["steps"] != steps:
            raise RuntimeError(f"path cli_img2img: {cli_rep['timings']['steps']} steps, not {steps}")
        report["cli_img2img"] = {
            "load": cli_rep["load"], "wall_s": wall_s, "timings_s": cli_rep["timings"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "forms": _entry_forms("cli", counts_i2i), "launches": counts_i2i,
            **_check_d512("cli_img2img", counts_i2i, enc + dec, plain, SD3_T5_LAYERS),
            **_check_png(png.read_bytes(), 1024, 1024, "euler")}
        print("entry cli_img2img " + json.dumps(report["cli_img2img"]), flush=True)
        del cli_rep
        gc.collect()
        torch.cuda.empty_cache()

        box, srv_rep = queue.Queue(), {}

        def run():
            try:
                server.main(file_args + ["--no-promote-q8", "--port", "0"], report=srv_rep,
                            ready=box.put)
            except BaseException as e:  # handed to the waiting thread, then raised here
                box.put(e)
                raise

        thread = threading.Thread(target=run, daemon=True)
        t0 = time.time()
        thread.start()
        httpd = box.get(timeout=900)
        if isinstance(httpd, BaseException):
            raise RuntimeError("the server did not start") from httpd
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            report["server"] = {"load": srv_rep["load"], "start_s": time.time() - t0}
            report["server"]["requests"], counts_srv = _windowed(
                wrappers, "server", lambda: _ask_server(base, httpd.manager.pipeline))
        finally:
            httpd.shutdown()
            thread.join(timeout=300)
        report["server"].update(forms=_entry_forms("server", counts_srv), launches=counts_srv)
        del httpd, srv_rep
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("entry " + json.dumps({k: report[k] for k in ("card", "dit_depth", "files")}), flush=True)
    return report, counts_cli, counts_srv, counts_i2i


@contextlib.contextmanager
def plain_attention_on_card():
    """Count the calls that ``ops.attention`` routes to the plain attention
    with CUDA tensors while the block runs (→ {"calls": n}): a path whose
    attention all goes through the kernels counts 0."""
    import importlib

    # the module (``sdtpu_torch.ops.attention`` names the function it exports)
    att = importlib.import_module("sdtpu_torch.ops.attention")
    box = {"calls": 0}
    plain = att.plain_attention

    def counted(q, *a, **kw):
        box["calls"] += q.is_cuda
        return plain(q, *a, **kw)

    att.plain_attention = counted
    try:
        yield box
    finally:
        att.plain_attention = plain


# flash launches a UNet call and a prompt encode, per family (d40 / d80 /
# d160 count both dtypes, d64 and d512 bf16 only): SD1.x's UNet at D 40 /
# 80 / 160 and CLIP-L's 12 layers at clip skip 1; SD2's UNet and
# OpenCLIP-H's 22 layers at clip skip 2, all D 64; SDXL's UNet and CLIP-L
# and CLIP-G's 43, all D 64
UNET_FAMILY_FLASH = {
    "sd1": ({f"flash_attention_d{d}": n for d, n in UNET_ATTENTION_CALLS.items()},
            {"flash_attention_d64": 12}),
    "sd2": ({"flash_attention_d64": SD2_UNET_ATTENTION_CALLS},
            {"flash_attention_d64": SD2_CLIP_ATTENTION_CALLS}),
    "sdxl": ({"flash_attention_d64": SDXL_UNET_ATTENTION_CALLS[64]},
             {"flash_attention_d64": SDXL_CLIP_ATTENTION_CALLS}),
}
# the tiny UNets (SD1.x's or SD2.x's text encoder) and the UNets with their
# ControlNet run in each UNet call (the same batch)
for _version, _calls in TINY_ATTENTION_CALLS.items():
    UNET_FAMILY_FLASH[_version.lower()] = (
        {f"flash_attention_d{d}": n for d, n in _calls.items()},
        UNET_FAMILY_FLASH["sd2" if 64 in _calls else "sd1"][1])
for _version, _family in (("SD1", "sd1"), ("SDXL", "sdxl")):
    _unet, _text = UNET_FAMILY_FLASH[_family]
    _cn = {f"flash_attention_d{d}": n for d, n in CONTROLNET_ATTENTION_CALLS[_version].items()}
    UNET_FAMILY_FLASH[f"{_family}_controlnet"] = (
        {k: _unet.get(k, 0) + _cn.get(k, 0) for k in {**_unet, **_cn}}, _text)
# TAESD-XL's seed (the JAX bench's, bench.py:470)
TAE_SEED = 5


def unet_calls(request: dict, inpaint: bool = False, edit: bool = False, decode: int = 1) -> tuple:
    """(UNet calls, prompt encodes, VAE calls) of one request: a call a
    sampled step (the CFG batch of two is one call; heun, dpm2, dpm++2s_a
    and res_2s make two but on their last step), a third a step under image guidance (``img_cfg_scale``
    set apart from ``cfg_scale`` under CFG, on the concat UNets); an encode
    a prompt and one more for the negative one under CFG; ``decode`` VAE
    calls a decode (0 through TAESD-XL, a tile count under VAE tiling), one
    an init image's encode, and on an inpainting UNet the masked image's,
    on a pix2pix one the edit image's (a reference image, else the init
    image)."""
    init = "init_image" in request
    steps = (img2img_steps(request["sample_steps"], request.get("strength", 0.75)) if init
             else request["sample_steps"])
    calls = 2 * steps - 1 if request.get("sample_method") in TWO_FORWARD_METHODS else steps
    cfg = request.get("cfg_scale", 7.0)
    img_cfg = request.get("img_cfg_scale")
    if (inpaint or edit) and cfg != 1.0 and img_cfg is not None and img_cfg != cfg:
        calls *= 2
    vae = decode + init + (inpaint and init) + (edit and (init or "ref_images" in request))
    return calls, 1 + (cfg != 1.0), vae


# the methods that make two forwards a step but on the last (on an eps or v
# schedule; the flow dpm++2s_a makes one on a step from sigma 1 too)
TWO_FORWARD_METHODS = ("heun", "dpm2", "dpm++2s_a", "res_2s")


def _totals(requests, **kind) -> tuple:
    """``unet_calls`` summed over ``requests``."""
    return tuple(sum(t) for t in zip(*(unet_calls(r, **kind) for r in requests)))


def _check_unet_family(path: str, counts: dict, family: str, totals: tuple, plain: dict,
                       f32: bool = False) -> dict:
    """Flash launched exactly ``family``'s calls (UNET_FAMILY_FLASH) for
    ``totals`` = (UNet calls, prompt encodes, VAE calls), D 512 once a VAE
    call, nothing else (float32: every launch in ``launches_f32``); no
    attention ran in the plain version on the card."""
    calls, encodes, vae = totals
    unet, text = UNET_FAMILY_FLASH[family]
    want = {k: 0 for k in (*UNET_FLASH, D320, "flash_attention_d64")}
    for k, n in unet.items():
        want[k] += n * calls
    for k, n in text.items():
        want[k] += n * encodes
    want["flash_attention_d512"] = vae
    total = sum(want.values())
    if f32:  # d40 / d80 / d160 / d320 count both dtypes
        want = {**{k: v for k, v in want.items() if k in (*UNET_FLASH, D320)}, "flash_attention_d64": 0,
                "flash_attention_d512": 0, "flash_attention_f32": total}
    else:
        want["flash_attention_f32"] = 0
    want["flash_attention"] = total
    got = {k: counts[k] for k in want}
    if got != want or plain["calls"]:
        raise RuntimeError(f"path {path}: flash launches {got}, not {want} ({calls} UNet calls, "
                           f"{encodes} prompt encodes, {vae} VAE calls); {plain['calls']} plain "
                           "attention calls on the card")
    return {"flash": got, "unet_calls": calls, "prompt_encodes": encodes, "vae_calls": vae,
            "plain_attention_on_card": plain["calls"]}


def unet_check(family: str, totals: tuple):
    """``_check_unet_family`` at ``totals`` as ``_file_entry_check``'s launch
    check."""
    return lambda path, counts, plain: _check_unet_family(path, counts, family, totals, plain)


def build_unet_pipeline(card: str, version_name: str, default_dtype: bool = False,
                        v_prediction: bool = False, tae: bool = False):
    """A full-width UNet pipeline of ``version_name`` (``SDVersion``), dense
    random weights drawn on the card: ``create_pipeline(version,
    dtype=torch.bfloat16, v_prediction=..., device="cuda", seed=0)``, or with
    ``default_dtype`` no dtype argument (float32, held here); ``tae``:
    TAESD-XL drawn from ``TAE_SEED`` and attached with ``set_tae``."""
    import torch

    from sdtpu_torch.config import SDVersion
    from sdtpu_torch.factory import create_pipeline
    from sdtpu_torch.models import tae as tae_mod
    from sdtpu_torch.weights import synthesize, weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    kw = {} if default_dtype else {"dtype": torch.bfloat16}
    pipe = create_pipeline(getattr(SDVersion, version_name), device=DEVICE, seed=0,
                           v_prediction=v_prediction, **kw)
    if default_dtype and pipe.compute_dtype != torch.float32:
        raise RuntimeError(f"create_pipeline's default dtype is {pipe.compute_dtype}, not float32")
    wb = {"diffusion": weight_bytes(pipe.diffusion_params),
          "text": sum(weight_bytes(v) for v in vars(pipe.conditioner).values() if isinstance(v, dict)),
          "vae": weight_bytes(pipe.vae_params)}
    if tae:
        params = synthesize(tae_mod.param_specs(tae_mod.TAESD_XL_CONFIG), seed=TAE_SEED,
                            device=DEVICE, dtype=pipe.compute_dtype)
        wb["tae"] = weight_bytes(params)
        pipe.set_tae(params, tae_mod.TAESD_XL_CONFIG)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    stem = pipe.diffusion_params["input_blocks.0.0.weight"].shape[1]
    print(f"pipeline: full-width {version_name}{' + TAESD-XL' if tae else ''} (a {stem}-channel "
          f"stem, {type(pipe.denoiser).__name__}), {pipe.compute_dtype}, built in {build_s:.2f} s "
          f"on {card}; weight bytes " + json.dumps(wb), flush=True)
    return pipe, {"diffusion": f"{version_name.lower()} dense", "dtype": str(pipe.compute_dtype),
                  "denoiser": type(pipe.denoiser).__name__, "stem_channels": stem,
                  "build_s": build_s, "weight_bytes": wb}


def sd15_paths(wrappers, card: str, launches: dict, profile=None):
    """The SD1.5 paths: ``sd15`` (bf16, SD15_REQUESTS), then ``hires`` on the
    same pipeline, and ``sd15_f32`` (the default dtype, SD15_F32_REQUESTS),
    each in its launch window, flash held to ``_check_unet_family``."""
    import torch

    pipes, reports, prof = [], [], {}
    for label, f32, requests in (("sd15", False, SD15_REQUESTS), ("sd15_f32", True, SD15_F32_REQUESTS)):
        pipe, info = build_unet_pipeline(card, "SD1", default_dtype=f32)
        pipes.append(info)
        with plain_attention_on_card() as plain:
            rep, launches[label] = _windowed(wrappers, label,
                                             lambda: answer(pipe, requests, card, label))
        info.update(_check_unet_family(label, launches[label], "sd1", _totals(requests), plain,
                                       f32=f32))
        reports += rep
        if profile and not f32:
            prof[label] = profile_request(pipe, SD15_REQUEST, profile, label, card)
        if not f32:
            rep, info["hires"] = sd15_hires_path(pipe, wrappers, card, launches)
            reports += rep
            _sampling_part("sd15", sampling_sd15(pipe, wrappers, card, launches))
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports, prof


# Phase 11, SD1.5 on a file: the CLI's and the A1111 route's 512² × 20-step
# request (euler_a, the default sampler; CFG 7)
SD15_CLI_ARGV = ["-p", SD15_REQUEST["prompt"], "-W", "512", "-H", "512", "--steps", "20",
                 "--cfg-scale", "7.0", "-s", "42"]
SD15_SERVER_BODY = {"prompt": SD15_REQUEST["prompt"], "width": 512, "height": 512, "steps": 20,
                    "cfg_scale": 7.0, "seed": 42}


@contextlib.contextmanager
def _serving(argv: list):
    """``sdtpu_torch.server.main(argv)`` on a free port of 127.0.0.1 in a
    thread of its own → (its base URL, the server, its load report); shut
    down when the block ends."""
    import queue
    import threading

    from sdtpu_torch import server

    box, rep = queue.Queue(), {}

    def run():
        try:
            server.main(argv + ["--port", "0"], report=rep, ready=box.put)
        except BaseException as e:  # handed to the waiting thread, then raised here
            box.put(e)
            raise

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    httpd = box.get(timeout=900)
    if isinstance(httpd, BaseException):
        raise RuntimeError("the server did not start") from httpd
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd, rep
    finally:
        httpd.shutdown()
        thread.join(timeout=300)


def _file_entry_check(wrappers, card: str, label: str, write_files, file_args, cli_argv: list,
                      server_body, check_launches, sampler: str, size: tuple, load_check,
                      request: dict = None, more_cli=(), more_server=(), more_servers=()):
    """Phase 11 for one family: ``write_files(tmp)`` writes its full-width
    files into a fresh directory under the build directory and returns their
    report; ``file_args(files)`` names them on the CLI and the server. One
    request through ``cli.main`` (``load_check(cli_report)`` raises where it
    loaded the wrong model; with ``request`` the PNG is read back in
    metadata mode and its parameters held against the request's) and,
    unless ``server_body`` is None, one through the server's A1111 txt2img
    route, each in its own launch window, held by ``check_launches(path,
    counts, plain)`` and ``_check_png``.
    ``more_cli`` / ``more_server``: further requests after each, dicts of
    ``path``, ``argv`` or ``route`` and ``body`` (and ``files(tmp)`` → more
    body fields), ``check``, ``size``, ``sampler`` (and for the CLI
    ``load_check(cli_report)``), each in its own window.  ``more_servers``:
    servers of their own, each started with its ``argv`` added to the
    files' and asked its ``body`` on the A1111 txt2img route once, dicts of
    ``path``, ``argv``, ``body``, ``load_check(server_report)``, ``check``,
    ``size``, ``sampler`` (and ``after(base, server)`` → more report
    fields, run once the request is answered).  An ``argv`` may be a
    function of the files' directory."""
    import io
    import tempfile

    import torch

    from sdtpu_torch import cli
    from sdtpu_torch.config import GenerationParams
    from sdtpu_torch.utils.image import build_parameters_text, parse_parameters_text

    root = ROOT / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{label}_files_", dir=root))
    report = {"card": card}
    launches = {}
    try:
        report["files"] = write_files(tmp)
        print(f"entry {label} files on {card}: " + json.dumps(report["files"]), flush=True)
        args = file_args(report["files"])
        png, cli_rep = tmp / f"{label}.png", {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with plain_attention_on_card() as plain:
            rc, launches[f"{label}_cli"] = _windowed(wrappers, f"{label}_cli", lambda: cli.main(
                args + cli_argv + ["-o", str(png)], report=cli_rep))
        wall_s = time.time() - t0
        if rc != 0:
            raise RuntimeError(f"sdtpu_torch.cli.main on the {label} files exited {rc}")
        load_check(cli_rep)
        if request is not None:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["metadata", "--image", str(png), "--metadata-format", "json"])
            want = build_parameters_text(GenerationParams(**request))
            meta = json.loads(buf.getvalue())
            if rc != 0 or meta.get("parameters") != parse_parameters_text(want):
                raise RuntimeError(f"metadata mode read {meta.get('parameters')}, not {want!r}")
        report["cli"] = {"load": cli_rep["load"], "wall_s": wall_s, "timings_s": cli_rep["timings"],
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         **check_launches(f"{label}_cli", launches[f"{label}_cli"], plain),
                         **_check_png(png.read_bytes(), *size, sampler)}
        print(f"entry {label} cli " + json.dumps(report["cli"]), flush=True)
        del cli_rep
        gc.collect()
        torch.cuda.empty_cache()
        for more in more_cli:
            path, png, cli_rep = more["path"], tmp / f"{more['path']}.png", {}
            argv = more["argv"](tmp) if callable(more["argv"]) else more["argv"]
            torch.cuda.reset_peak_memory_stats()
            with plain_attention_on_card() as plain:
                rc, launches[path] = _windowed(wrappers, path, lambda: cli.main(
                    args + argv + ["-o", str(png)], report=cli_rep))
            if rc != 0:
                raise RuntimeError(f"sdtpu_torch.cli.main ({path}) exited {rc}")
            if "load_check" in more:
                more["load_check"](cli_rep)
            report[path] = {"load": cli_rep["load"], "timings_s": cli_rep["timings"],
                            **({"loras": cli_rep["loras"]} if cli_rep.get("loras") else {}),
                            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                            **more["check"](path, launches[path], plain),
                            **_check_png(png.read_bytes(), *more["size"], more["sampler"])}
            print(f"entry {path} " + json.dumps(report[path]), flush=True)
            del cli_rep
            gc.collect()
            torch.cuda.empty_cache()

        if server_body is not None:
            t0 = time.time()
            with _serving(args) as (base, httpd, srv_rep):
                report["server"] = {"load": srv_rep["load"], "start_s": time.time() - t0}
                torch.cuda.reset_peak_memory_stats()
                with plain_attention_on_card() as plain:
                    (code, resp), launches[f"{label}_server"] = _windowed(
                        wrappers, f"{label}_server", lambda: _http(base, "/sdapi/v1/txt2img", server_body))
                if code != 200:
                    raise RuntimeError(f"/sdapi/v1/txt2img: {code} {resp}")
                report["server"].update(
                    timings_s=dict(httpd.manager.pipeline.last_timings),
                    peak_mem_bytes=torch.cuda.max_memory_allocated(),
                    **check_launches(f"{label}_server", launches[f"{label}_server"], plain),
                    **_check_png(base64.b64decode(resp["images"][0]), *size, sampler))
                for more in more_server:
                    path = more["path"]
                    body = {**more["body"], **(more["files"](tmp) if "files" in more else {})}
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.time()
                    with plain_attention_on_card() as plain:
                        (code, resp), launches[path] = _windowed(
                            wrappers, path, lambda: _http(base, more["route"], body))
                    request_s = time.time() - t0
                    if code != 200:
                        raise RuntimeError(f"{more['route']} ({path}): {code} {resp}")
                    report[path] = {"timings_s": dict(httpd.manager.pipeline.last_timings),
                                    "request_s": request_s,
                                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                                    **more["check"](path, launches[path], plain),
                                    **_check_png(base64.b64decode(resp["images"][0]), *more["size"],
                                                 more["sampler"])}
                    print(f"entry {path} " + json.dumps(report[path]), flush=True)
            print(f"entry {label} server " + json.dumps(report["server"]), flush=True)
            del httpd, srv_rep
            gc.collect()
            torch.cuda.empty_cache()
        for more in more_servers:  # a server of its own, started with more["argv"] added
            path = more["path"]
            argv = more["argv"](tmp) if callable(more["argv"]) else more["argv"]
            with _serving(args + argv) as (base, httpd, srv_rep):
                more["load_check"](srv_rep)
                torch.cuda.reset_peak_memory_stats()
                with plain_attention_on_card() as plain:
                    (code, resp), launches[path] = _windowed(
                        wrappers, path, lambda: _http(base, "/sdapi/v1/txt2img", more["body"]))
                if code != 200:
                    raise RuntimeError(f"/sdapi/v1/txt2img ({path}): {code} {resp}")
                report[path] = {"load": srv_rep["load"],
                                "timings_s": dict(httpd.manager.pipeline.last_timings),
                                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                                **more["check"](path, launches[path], plain),
                                **_check_png(base64.b64decode(resp["images"][0]), *more["size"],
                                             more["sampler"])}
                if "after" in more:
                    report[path].update(more["after"](base, httpd))
            print(f"entry {path} " + json.dumps(report[path]), flush=True)
            del httpd, srv_rep
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report, launches


# the hires fix through the CLI and the A1111 route: 512² x 8 steps, then
# 1024² at 0.7 (6 steps); img2img through the A1111 route: a 1024² init
# image, every row Paeth-filtered as an editor's PNG, and the mask at 0.75
# over 20 steps (16 sample)
SD15_CLI_HIRES_ARGV = ["-p", SD15_HIRES_REQUEST["prompt"], "-W", "512", "-H", "512", "--steps", "8",
                       "--cfg-scale", "7.0", "-s", "42", "--hires", "--hires-scale", "2",
                       "--hires-denoising-strength", "0.7"]
SD15_SERVER_HIRES_BODY = {"prompt": SD15_HIRES_REQUEST["prompt"], "width": 512, "height": 512,
                          "steps": 8, "cfg_scale": 7.0, "seed": 42, "enable_hr": True,
                          "hr_scale": 2.0, "hr_upscaler": "Latent", "denoising_strength": 0.7}
SD15_SERVER_IMG2IMG_BODY = {"prompt": "a harbour at dawn, oil on canvas", "width": 1024,
                            "height": 1024, "steps": 20, "cfg_scale": 7.0, "seed": 42,
                            "denoising_strength": 0.75}


def paeth_png(img) -> bytes:
    """[H, W, 3] uint8 → PNG bytes with every row Paeth-filtered, as an image
    editor's adaptive filtering writes most rows of a photo (the port's own
    ``encode_png`` writes filter 0, which decodes row-wise)."""
    import numpy as np

    from sdtpu_torch.utils.image import PNG_SIGNATURE, _png_chunk

    h, w, _ = img.shape
    x = np.pad(img.astype(np.int16), ((1, 0), (1, 0), (0, 0)))
    a, b, c = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]  # left, above, above-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x[1:, 1:] - pred) & 255).astype(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.full((h, 1), 4, dtype=np.uint8), rows], axis=1).tobytes()
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def _init_and_mask_b64(size: int, timing: dict) -> dict:
    """The init image (``paeth_png``) and the mask as the A1111 route's
    base64 PNGs; ``timing["init_png_decode_s"]`` gets the host seconds of
    ``base64_png_to_image`` (what the server runs on it) on the init image,
    whose pixels must come back."""
    import numpy as np

    from sdtpu_torch.utils.image import base64_png_to_image, image_to_base64_png

    img, mask = init_image_and_mask(size)
    init = base64.b64encode(paeth_png(img)).decode("ascii")
    t0 = time.time()
    back = base64_png_to_image(init)
    timing["init_png_decode_s"] = time.time() - t0
    if not np.array_equal(back, img):
        raise RuntimeError("the Paeth-filtered init image did not decode to its pixels")
    return {"init_images": [init],
            "mask": image_to_base64_png(np.repeat(mask[..., None], 3, axis=-1))}


SD15_LORA, SD15_TOKEN = "sd15_style", "sd15token"
SD15_LORA_BODY = dict(SD15_SERVER_BODY, prompt=f"{SD15_TOKEN} {SD15_REQUEST['prompt']}",
                      lora=[{"name": SD15_LORA, "multiplier": 0.8}])


def sd15_lora_files(tmp) -> list:
    """A rank-``LORA_RANK`` kohya LoRA over the SD1.5 UNet's linears
    (safetensors, ``loras/``) and a two-vector embedding for ``SD15_TOKEN``
    (``embd/``) → the server's arguments naming both directories."""
    import numpy as np

    from sdtpu_torch.models import unet as unet_mod
    from sdtpu_torch.tools.lora_file import lora_tensors, write_safetensors

    loras, embd = tmp / "loras", tmp / "embd"
    loras.mkdir()
    embd.mkdir()
    specs = unet_mod.param_specs(unet_mod.SD1_UNET_CONFIG)
    write_safetensors(str(loras / f"{SD15_LORA}.safetensors"), lora_tensors(
        {"diffusion": {n: shape for n, (shape, _) in specs.items()}}, rank=LORA_RANK, seed=47))
    rng = np.random.default_rng(53)
    write_safetensors(str(embd / f"{SD15_TOKEN}.safetensors"),
                      {"emb_params": (rng.standard_normal((2, 768)) * 0.02).astype(np.float32)})
    return ["--lora-model-dir", str(loras), "--embd-dir", str(embd)]


def sd15_lora_after(base: str, httpd) -> dict:
    """After the ``lora`` request: ``/sdapi/v1/loras`` lists the LoRA, the
    epoch patched every UNet linear, one merged weight is its plain merge on
    the CPU (bf16 steps apart), and a request with ``"lora": []`` puts the
    pristine weight back (bit for bit, from its host copy)."""
    import torch

    from sdtpu_torch.io.model_loader import read_checkpoint_file
    from sdtpu_torch.models.lora import group_lora_tensors, lora_delta

    pipe = httpd.manager.pipeline
    code, listing = _http(base, "/sdapi/v1/loras")
    if code != 200 or [e["name"] for e in listing] != [SD15_LORA]:
        raise RuntimeError(f"/sdapi/v1/loras: {code} {listing}")
    tensors = read_checkpoint_file(httpd.manager.lora_dir + f"/{SD15_LORA}.safetensors")
    groups = len(group_lora_tensors(tensors))
    fresh = [n for n, v in pipe.diffusion_params.items() if v is not pipe._lora_base.get(n, v)]
    if len(fresh) != groups:
        raise RuntimeError(f"the lora field patched {len(fresh)} of {groups} UNet weights")
    name = next(n for n in sorted(pipe.diffusion_params) if n.endswith("attn1.to_q.weight"))
    want = (pipe._lora_base[name].cpu().float()
            + lora_delta(_lora_group(tensors, "lora_unet_", name), 0.8, "cpu")).to(torch.bfloat16)
    share = _steps_apart(pipe.diffusion_params[name].view(torch.int16), want.view(torch.int16), name)
    pristine = pipe._lora_base[name]
    body = dict(SD15_SERVER_BODY, steps=2, lora=[])
    code, resp = _http(base, "/sdapi/v1/txt2img", body)
    if code != 200 or pipe._lora_base or not torch.equal(pipe.diffusion_params[name].cpu(),
                                                         pristine.cpu()):
        raise RuntimeError(f"a request with lora [] did not restore the weights ({code})")
    return {"listed": [e["name"] for e in listing], "patched": len(fresh), "steps_apart": share}


def sd15_entry_check(wrappers, card: str) -> dict:
    """Phase 11, SD1.5: the full-width single-file checkpoint of
    ``tools/sd15_file.py`` through ``cli.main -m`` (txt2img, then ``--hires``:
    path ``sd15_cli_hires``) and the A1111 routes (txt2img, then img2img
    with a mask: ``sd15_server_img2img``, then ``enable_hr``:
    ``sd15_server_hires``); then a server of its own with
    ``--lora-model-dir`` and ``--embd-dir`` (``sd15_lora_files``) answers
    ``SD15_LORA_BODY``, the ``lora`` field and the embedding's trigger word
    (path ``sd15_lora_server``, held by ``sd15_lora_after``)."""
    from sdtpu_torch.tools.sd15_file import write_sd15_file

    def load_check(rep):
        if rep["load"]["version"] != "sd1":
            raise RuntimeError(f"the CLI loaded a {rep['load']['version']} model, not sd1")

    def lora_load_check(rep):
        load_check(rep)
        if rep["load"]["embeddings"] != [SD15_TOKEN]:
            raise RuntimeError(f"--embd-dir loaded {rep['load']['embeddings']}")

    hires = unet_check("sd1", sd15_hires_totals(8, 0.7))
    i2i = unet_calls(dict(SD15_REQUEST, init_image=None,
                          strength=SD15_SERVER_IMG2IMG_BODY["denoising_strength"]))
    i2i_size, png_timing = SD15_SERVER_IMG2IMG_BODY["width"], {}
    return _file_entry_check(
        wrappers, card, "sd15", lambda tmp: write_sd15_file(tmp / "sd15.safetensors", device=DEVICE),
        lambda files: ["-m", files["path"]], SD15_CLI_ARGV, SD15_SERVER_BODY,
        unet_check("sd1", unet_calls(SD15_REQUEST)), "euler_a", (512, 512), load_check,
        more_cli=[dict(path="sd15_cli_hires", argv=SD15_CLI_HIRES_ARGV, check=hires,
                       size=(1024, 1024), sampler="euler_a")],
        more_server=[dict(path="sd15_server_img2img", route="/sdapi/v1/img2img",
                          body=SD15_SERVER_IMG2IMG_BODY,
                          files=lambda tmp: _init_and_mask_b64(i2i_size, png_timing),
                          check=lambda *a: {**unet_check("sd1", i2i)(*a), **png_timing},
                          size=(i2i_size, i2i_size), sampler="euler_a"),
                     dict(path="sd15_server_hires", route="/sdapi/v1/txt2img",
                          body=SD15_SERVER_HIRES_BODY, check=hires, size=(1024, 1024),
                          sampler="euler_a")],
        more_servers=[dict(path="sd15_lora_server", argv=sd15_lora_files, body=SD15_LORA_BODY,
                           load_check=lora_load_check, after=sd15_lora_after,
                           check=unet_check("sd1", unet_calls(SD15_REQUEST)), size=(512, 512),
                           sampler="euler_a")])


# SDXL: the JAX bench's request (``bench_sdxl_lcm_taesd``, bench.py:441),
# answered through TAESD-XL once to warm up, once timed and once with a
# fresh prompt (CLIP-L and CLIP-G encode inside the window, as the bench's
# cold-prompt metric); then, with the full VAE, a 1024² × 4-step euler
# request at CFG 5 with a negative prompt and VAE tiling.  The default dtype
# (float32) answers the bench request at 2 steps.
SDXL_REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="",
                    width=1024, height=1024, sample_steps=4, cfg_scale=1.0, seed=42,
                    sample_method="lcm", schedule="discrete")
SDXL_TAE_REQUESTS = [SDXL_REQUEST, SDXL_REQUEST,
                     dict(SDXL_REQUEST, prompt=SDXL_REQUEST["prompt"] + ", take 0")]
SDXL_VAE_REQUEST = dict(SDXL_REQUEST, prompt="a red fox in fresh snow, golden hour",
                        negative_prompt="blurry, low quality", sample_method="euler", cfg_scale=5.0,
                        seed=7)
SDXL_F32_REQUESTS = [dict(SDXL_REQUEST, sample_steps=2)]


def _forwards_and_encodes(requests) -> tuple:
    """(UNet forwards, prompt encodes) of ``requests``: one forward a step
    (the CFG batch of two is one forward), one encode a prompt and one more
    for the negative prompt under CFG."""
    return (sum(r["sample_steps"] for r in requests),
            sum(1 + (r.get("cfg_scale", 7.0) != 1.0) for r in requests))


def sdxl_paths(wrappers, card: str, launches: dict, profile=None):
    """The SDXL paths: ``sdxl`` (bf16: SDXL_TAE_REQUESTS through TAESD-XL,
    then SDXL_VAE_REQUEST through the full VAE, tiled), ``sdxl_img2img`` on
    the same pipeline (SDXL_IMG2IMG_REQUEST after ``set_tae(None)``: the full
    VAE encodes and decodes untiled) and ``sdxl_f32`` (the default dtype,
    SDXL_F32_REQUESTS through TAESD-XL), each in its launch window, flash
    held to ``_check_unet_family``."""
    import torch

    from sdtpu_torch.models import tae as tae_mod

    pipes, reports, prof = [], [], {}
    pipe, info = build_unet_pipeline(card, "SDXL", tae=True)
    pipes.append(info)
    tae = pipe.vae_params  # TAESD-XL's, while it is attached
    size = SDXL_VAE_REQUEST["width"]

    def run():
        rep = answer(pipe, SDXL_TAE_REQUESTS, card, "sdxl")
        pipe.set_tae(None)
        pipe.set_vae_tiling(True)
        try:
            info["decode_tiles"] = _tiles(pipe, size)[1]
            return rep + answer(pipe, [SDXL_VAE_REQUEST], card, "sdxl")
        finally:
            pipe.set_vae_tiling(False)
            pipe.set_tae(tae, tae_mod.TAESD_XL_CONFIG)

    with plain_attention_on_card() as plain:
        rep, launches["sdxl"] = _windowed(wrappers, "sdxl", run)
    totals = [a + b for a, b in zip(_totals(SDXL_TAE_REQUESTS, decode=0),
                                    unet_calls(SDXL_VAE_REQUEST, decode=info["decode_tiles"]))]
    info.update(_check_unet_family("sdxl", launches["sdxl"], "sdxl", totals, plain))
    reports += rep
    if profile:
        prof["sdxl"] = profile_request(pipe, SDXL_REQUEST, profile, "sdxl", card)
    img, _ = init_image_and_mask(SDXL_IMG2IMG_REQUEST["width"])
    pipe.set_tae(None)
    i2i = dict(SDXL_IMG2IMG_REQUEST, init_image=img)
    with plain_attention_on_card() as plain:
        rep, launches["sdxl_img2img"] = _windowed(wrappers, "sdxl_img2img", lambda: answer(
            pipe, [i2i], card, "sdxl_img2img"))
    steps = img2img_steps(SDXL_IMG2IMG_REQUEST["sample_steps"], SDXL_IMG2IMG_REQUEST["strength"])
    _check_steps("sdxl_img2img", rep[0], steps)
    info["img2img"] = _check_unet_family("sdxl_img2img", launches["sdxl_img2img"], "sdxl",
                                         unet_calls(i2i), plain)
    reports += rep
    info["lora"] = sdxl_lora_epochs(pipe, card)
    del pipe, tae
    gc.collect()
    torch.cuda.empty_cache()

    pipe, info = build_unet_pipeline(card, "SDXL", default_dtype=True, tae=True)
    pipes.append(info)
    with plain_attention_on_card() as plain:
        rep, launches["sdxl_f32"] = _windowed(wrappers, "sdxl_f32",
                                              lambda: answer(pipe, SDXL_F32_REQUESTS, card, "sdxl_f32"))
    info.update(_check_unet_family("sdxl_f32", launches["sdxl_f32"], "sdxl",
                                   _totals(SDXL_F32_REQUESTS, decode=0), plain, f32=True))
    reports += rep
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return pipes, reports, prof


# The int8 SDXL UNet at CFG 1, the first path of the int8 split-K forms:
# the bench's SDXL request through TAESD-XL (SDXL_TAE_REQUESTS: warm, timed,
# a fresh prompt) on build_unet_pipeline's dense draw with its UNet
# quantized on the card: per row by quantize_params (the --type q8_0 rule)
# on W8A8 (``sdxl_q8``) and, the same weights, under SDTPU_QUANT_MODE=w8a16
# (``sdxl_q8_w8a16``); and into group-32 int8 blocks (a q8_0 GGUF kept as
# --no-promote-q8 keeps it: ``sdxl_q8_gguf``).  CLIP-L, CLIP-G and the TAE
# stay dense.
SDXL_QUANT_PATHS = {"sdxl_q8": ("q8_0", "w8a8"), "sdxl_q8_w8a16": ("q8_0", "w8a16"),
                    "sdxl_q8_gguf": ("q8_0_gguf", "w8a8")}
# the split-K form's calls in one SDXL UNet forward at CFG 1: attn2.to_k and
# to_v over CLIP's 77 tokens in each of its 70 transformer blocks
SDXL_CONTEXT_LINEARS = 2 * 70


def _check_int8_unet(path: str, counts: dict, forwards: int) -> dict:
    """The path's wrapper ran its split-K form exactly SDXL_CONTEXT_LINEARS
    times a UNet forward, and every launch of the wrapper in one of its
    counted forms (GEMV, split-K, wgmma, float32: none in ``mma.sync``)."""
    w = SDXL_QUANT_WRAPPER[path]
    forms = {f: counts.get(f"{w}_{f}", 0) for f in ("gemv", "splitk", "wgmma", "f32")}
    want = SDXL_CONTEXT_LINEARS * forwards
    if forms["splitk"] != want or sum(forms.values()) != counts[w]:
        raise RuntimeError(f"path {path}: {w} launched {counts[w]} times, its forms {forms}; "
                           f"the split-K form must run {want} ({SDXL_CONTEXT_LINEARS} x "
                           f"{forwards} UNet forwards)")
    return {"int8_forms": {w: forms}, "splitk_per_forward": forms["splitk"] / forwards}


def quantize_unet(params: dict, kind: str) -> dict:
    """A dense UNet param dict quantized on its device: "q8_0" per row
    (``quantize_params``, as ``--type q8_0``), "q8_0_gguf" into group-32
    int8 blocks under the same rule (2-D ``.weight`` of at least 2**16
    elements)."""
    import torch

    from sdtpu_torch.ops import quant

    if kind == "q8_0":
        return quant.quantize_params(params, bits=8)
    return {k: (quant.quantize_group(v, 32) if isinstance(v, torch.Tensor) and v.ndim == 2
                and v.numel() >= quant.QUANTIZE_MIN_SIZE and k.endswith(".weight") else v)
            for k, v in params.items()}


@contextlib.contextmanager
def plain_quant_linears(drop_k_split: bool = False):
    """Every quantized linear of ``ops.basic.linear`` in its plain version
    while the block runs (per-row int8 as W8A8 or W8A16, as
    ``quant_matmul`` reads SDTPU_QUANT_MODE).  ``drop_k_split``: the calls
    the int8 split-K forms take (bf16, 8 < M < 128: SDXL's context
    projections at CFG 1) sum their plain split without its last split, at
    the split count the kernel takes (``_drop_split_fault``'s fault)."""
    import torch

    from sdtpu_torch.ops import _build, basic, quant

    real = basic.quant_matmul, basic.group_quant_matmul, basic.q4_matmul

    def per_row(x, qt):
        w8a8 = os.environ.get("SDTPU_QUANT_MODE", "w8a8") == "w8a8"
        return (quant.quant_matmul_w8a8_plain if w8a8 else quant.w8a16_matmul_plain)(x, qt)

    def dropped(plain, int8):
        def run(x, qt):
            m, n, k = x.numel() // x.shape[-1], qt.shape[0], x.shape[-1]
            if not (drop_k_split and x.dtype == torch.bfloat16 and 8 < m < 128):
                return plain(x, qt)
            w8a8 = int8 and os.environ.get("SDTPU_QUANT_MODE", "w8a8") == "w8a8"
            splits = _build.query("sdtpu_w8a8_splits" if w8a8 else "sdtpu_gq_splits", m, n, k)
            out = quant.split_k_matmul(x.reshape(m, k), qt, splits, w8a8=w8a8, keep=-1)
            return out.reshape(*x.shape[:-1], n)
        return run

    basic.quant_matmul = dropped(per_row, True)
    basic.group_quant_matmul = dropped(quant.group_quant_matmul_plain, False)
    basic.q4_matmul = quant.q4_matmul_plain
    try:
        yield
    finally:
        basic.quant_matmul, basic.group_quant_matmul, basic.q4_matmul = real


def unet_forward_plain_check(pipe, label: str) -> dict:
    """One full-width SDXL UNet forward at the request's shapes (CFG 1: a
    batch of one, the 1024² latent, CLIP's 77-token context) through the
    kernels, against the same forward on the same int8 weights with every
    quantized linear in its plain version on the card (plain_quant_linears):
    W8A8 (its linears bit-equal) at relative L2 0, W8A16 and group int8 at
    REF_REL_TOL; both finite.  The fault, the plain side with the last K
    split dropped in the context projections, must read above the limit."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(23)
    dt = pipe.compute_dtype
    x = torch.randn((1, 128, 128, 4), generator=g, device=DEVICE, dtype=dt)
    t = torch.tensor([499.0], device=DEVICE)
    ctx = torch.randn((1, 77, 2048), generator=g, device=DEVICE, dtype=dt)
    y = torch.randn((1, 2816), generator=g, device=DEVICE, dtype=dt)
    with torch.inference_mode():
        got = pipe.diffusion_fn(pipe.diffusion_params, x, t, ctx, y)
        with plain_quant_linears():
            want = pipe.diffusion_fn(pipe.diffusion_params, x, t, ctx, y)
        with plain_quant_linears(drop_k_split=True):
            fault = _rel(pipe.diffusion_fn(pipe.diffusion_params, x, t, ctx, y), want)
    tol = 0.0 if SDXL_QUANT_WRAPPER[label] == "w8a8_matmul" else REF_REL_TOL
    rel = _rel(got, want)
    ok = bool(torch.isfinite(got).all() and torch.isfinite(want).all() and rel <= tol < fault)
    out = {"rel_l2": rel, "tol": tol, "drop_k_split": fault, "ok": ok, "shape": list(got.shape)}
    print(f"{label}_forward_plain " + json.dumps(out), flush=True)
    if not ok:
        raise RuntimeError(f"path {label}: the full-width UNet forward is {rel:.4g} from the one "
                           f"with plain quantized linears (limit {tol:.4g}; the dropped split "
                           f"reads {fault:.4g})")
    return out


def sdxl_quant_paths(wrappers, card: str, launches: dict):
    """The int8 SDXL paths (SDXL_QUANT_PATHS), each in its launch window,
    flash held to ``_check_unet_family``, the split-K form to
    ``_check_int8_unet``, and one full-width forward to
    ``unet_forward_plain_check``."""
    import torch

    from sdtpu_torch.weights import weight_bytes

    pipes, reports = [], []
    pipe, base = build_unet_pipeline(card, "SDXL", tae=True)
    dense = pipe.diffusion_params
    totals = _totals(SDXL_TAE_REQUESTS, decode=0)
    previous = os.environ.get("SDTPU_QUANT_MODE")
    for label, (kind, mode) in SDXL_QUANT_PATHS.items():
        if label == "sdxl_q8_w8a16":  # the same int8 weights as sdxl_q8
            info = dict(pipes[-1], path=label)
        else:
            t0 = time.time()
            pipe.diffusion_params = quantize_unet(dense, kind)
            torch.cuda.synchronize()
            info = dict(base, path=label, diffusion=f"sdxl {kind}", quantize_s=time.time() - t0,
                        weight_bytes=dict(base["weight_bytes"],
                                          diffusion=weight_bytes(pipe.diffusion_params)))
        os.environ["SDTPU_QUANT_MODE"] = mode
        try:
            with plain_attention_on_card() as plain:
                rep, launches[label] = _windowed(
                    wrappers, label, lambda: answer(pipe, SDXL_TAE_REQUESTS, card, label))
            info.update(_check_unet_family(label, launches[label], "sdxl", totals, plain))
            info.update(_check_int8_unet(label, launches[label], totals[0]))
            info["forward_plain"] = unet_forward_plain_check(pipe, label)
        finally:
            if previous is None:
                del os.environ["SDTPU_QUANT_MODE"]
            else:
                os.environ["SDTPU_QUANT_MODE"] = previous
        pipes.append(info)
        reports += rep
    del pipe, dense
    gc.collect()
    torch.cuda.empty_cache()
    return pipes, reports


# Phase 11, SDXL on files: the bench's request through the CLI (``--taesd``)
# and the A1111 route (``sampler_name`` lcm)
SDXL_CLI_ARGV = ["-p", SDXL_REQUEST["prompt"], "-W", "1024", "-H", "1024", "--steps", "4",
                 "--sampling-method", "lcm", "--cfg-scale", "1", "-s", "42"]
SDXL_SERVER_BODY = {"prompt": SDXL_REQUEST["prompt"], "width": 1024, "height": 1024, "steps": 4,
                    "cfg_scale": 1.0, "seed": 42, "sampler_name": "lcm"}


SDXL_LORA = "sdxl_style"


def sdxl_lora_argv(tmp) -> list:
    """A rank-``LORA_RANK`` kohya LoRA over the SDXL UNet's, CLIP-L's
    (``lora_te1_``) and CLIP-G's (``lora_te2_``) linears as a torch ZIP
    ``.ckpt`` in ``loras/`` → the CLI's arguments: the bench's request with
    ``<lora:sdxl_style:0.8>`` in the prompt."""
    from sdtpu_torch.models import clip as clip_mod
    from sdtpu_torch.models import unet as unet_mod
    from sdtpu_torch.tools.lora_file import lora_tensors, write_ckpt

    loras = tmp / "loras"
    loras.mkdir()
    specs = {"diffusion": unet_mod.param_specs(unet_mod.SDXL_UNET_CONFIG),
             "clip_l": clip_mod.param_specs(clip_mod.CLIP_L_CONFIG),
             "clip_g": clip_mod.param_specs(clip_mod.CLIP_G_CONFIG)}
    write_ckpt(str(loras / f"{SDXL_LORA}.ckpt"), lora_tensors(
        {m: {n: shape for n, (shape, _) in sp.items()} for m, sp in specs.items()},
        rank=LORA_RANK, seed=59))
    argv = list(SDXL_CLI_ARGV)
    argv[1] = f"{SDXL_REQUEST['prompt']} <lora:{SDXL_LORA}:0.8>"
    return argv + ["--lora-model-dir", str(loras)]


def sdxl_entry_check(wrappers, card: str) -> dict:
    """Phase 11, SDXL: the full-width SDXL and TAESD-XL files of
    ``tools/sdxl_file.py`` through ``cli.main -m ... --taesd ...`` (its PNG
    read back in metadata mode), the A1111 route, and both again with
    ``--type q8_0`` (paths ``sdxl_q8_cli`` and ``sdxl_q8_server``: the UNet
    quantized per row at load, its context projections in the W8A8 split-K
    form), and the CLI with ``<lora:sdxl_style:0.8>`` from a ``.ckpt``
    (``sdxl_lora_argv``; path ``sdxl_lora_cli``: every group of the UNet,
    CLIP-L and CLIP-G applied, merged, flash as often as without it)."""
    from sdtpu_torch.tools.sdxl_file import write_sdxl_files

    def load_check(rep):
        load = rep["load"]
        if load["version"] != "sdxl" or not load["tae"]:
            raise RuntimeError(f"the CLI loaded {load['version']} (TAE {load['tae']}), not sdxl + TAE")

    def typed_load_check(load):
        if load["wtype"] != "q8_0" or load["typed_weights"] <= 0:
            raise RuntimeError(f"--type q8_0: the load line reads wtype {load['wtype']}, "
                               f"{load['typed_weights']} weights quantized")

    totals = unet_calls(SDXL_REQUEST, decode=0)
    size = (SDXL_REQUEST["width"], SDXL_REQUEST["height"])
    def typed_check(path, counts, plain):
        return {**_check_unet_family(path, counts, "sdxl", totals, plain),
                **_check_int8_unet(path, counts, totals[0])}

    typed = {"size": size, "sampler": "lcm", "check": typed_check}

    def lora_load_check(rep):
        load_check(rep)
        (lora,) = rep["loras"]
        if lora["name"] != SDXL_LORA or lora["applied"] != lora["total"] or lora["total"] < 700:
            raise RuntimeError(f"<lora:{SDXL_LORA}:0.8>: {lora}")

    return _file_entry_check(
        wrappers, card, "sdxl", lambda tmp: write_sdxl_files(tmp, device=DEVICE),
        lambda files: ["-m", files["paths"]["model"], "--taesd", files["paths"]["taesd"]],
        SDXL_CLI_ARGV, SDXL_SERVER_BODY, unet_check("sdxl", totals), "lcm", size, load_check,
        request=SDXL_REQUEST,
        more_cli=[dict(typed, path="sdxl_q8_cli", argv=SDXL_CLI_ARGV + ["--type", "q8_0"],
                       load_check=lambda rep: typed_load_check(rep["load"])),
                  dict(path="sdxl_lora_cli", argv=sdxl_lora_argv, load_check=lora_load_check,
                       check=unet_check("sdxl", totals), size=size, sampler="lcm")],
        more_servers=[dict(typed, path="sdxl_q8_server", argv=["--type", "q8_0"],
                           body=SDXL_SERVER_BODY, load_check=lambda rep: typed_load_check(rep["load"]))])


# SD3.5-Medium: the JAX bench's request (``bench_sd35_medium``, bench.py:515:
# 1024², 28 dpm++2m steps, discrete, CFG 4.5 with the negative prompt
# "blurry", seed 42), answered once to warm up, once timed and once with a
# fresh prompt (CLIP-L, CLIP-G and the 4-bit T5 encode inside the window, as
# the bench's fresh-prompt leg).  The default dtype (float32) answers it at
# 512² and 2 steps.
SD3_REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
                   width=1024, height=1024, sample_steps=28, cfg_scale=4.5, seed=42,
                   sample_method="dpm++2m", schedule="discrete")
SD3_REQUESTS = [SD3_REQUEST, SD3_REQUEST, dict(SD3_REQUEST, prompt=SD3_REQUEST["prompt"] + ", take 0")]
SD3_F32_REQUESTS = [dict(SD3_REQUEST, width=512, height=512, sample_steps=2)]
# the JAX bench's seeds (bench.py:529-543): the MMDiT 1, CLIP-L 2, CLIP-G 3,
# T5-XXL 4, the VAE 5
SD3_BENCH_SEEDS = {"diffusion": 1, "clip_l": 2, "clip_g": 3, "t5": 4, "vae": 5}
# T5's attentions a prompt encode: its relative-position bias keeps them on
# the plain path, as the JAX package runs them (``sdtpu/models/t5.py``)
SD3_T5_LAYERS = 24


def _check_sd3_launches(path: str, counts: dict, forwards: int, encodes: int, decodes: int,
                        plain: dict, mmdit_calls: int, f32: bool = False, t5_q4: bool = True,
                        extra_calls: int = 0) -> dict:
    """Flash at D 64 (bf16, or float32) launched exactly ``mmdit_calls`` a
    MMDiT forward times the forwards plus ``extra_calls`` (skip-layer
    forwards) plus ``SD3_CLIP_ATTENTION_CALLS`` a prompt encode; the VAE's D 512 once a decode; the 4-bit matmul
    ``SD3_T5_LINEARS`` times a prompt encode, all in the path's form (bf16
    split-K at 77 rows, or float32), none where T5 was dequantized
    (``t5_q4`` False: the entry points); and on the card no attention ran in
    the plain version but T5's ``SD3_T5_LAYERS`` a prompt encode."""
    d64 = mmdit_calls * forwards + extra_calls + SD3_CLIP_ATTENTION_CALLS * encodes
    q4 = SD3_T5_LINEARS * encodes if t5_q4 else 0
    if f32:  # every flash launch float32, the VAE's D 512 among them
        got = {"flash_f32": counts["flash_attention_f32"],
               "flash_bf16": counts["flash_attention"] - counts["flash_attention_f32"]}
        want = {"flash_f32": d64 + decodes, "flash_bf16": 0}
    else:
        got = {"flash_d64": counts["flash_attention_d64"], "flash_d512": counts["flash_attention_d512"],
               "flash_other": counts["flash_attention"] - counts["flash_attention_d64"]
               - counts["flash_attention_d512"]}
        want = {"flash_d64": d64, "flash_d512": decodes, "flash_other": 0}
    got.update(q4_t5=counts["q4_matmul_f32" if f32 else "q4_matmul_splitk"], q4_all=counts["q4_matmul"],
               plain_attention_on_card_besides_t5=plain["calls"] - SD3_T5_LAYERS * encodes)
    want.update(q4_t5=q4, q4_all=q4, plain_attention_on_card_besides_t5=0)
    if got != want:
        raise RuntimeError(f"path {path}: launches {got}, not {want} ({forwards} MMDiT forwards of "
                           f"{mmdit_calls} attentions, {encodes} prompt encodes, {decodes} decodes)")
    return {**got, "mmdit_forwards": forwards, "prompt_encodes": encodes,
            "t5_plain_attention": plain["calls"]}


def build_sd3_pipeline(card: str, default_dtype: bool = False):
    """A full-width SD3.5-Medium pipeline (the MMDiT-X, CLIP-L with its
    768-wide projection, CLIP-G and the SD3 VAE dense, T5-XXL 4-bit), random
    weights drawn on the card with the JAX bench's seeds and passed as
    ``params``, so the MMDiT config is fingerprinted: ``create_pipeline(
    SDVersion.SD3, params=..., dtype=torch.bfloat16)``; or with
    ``default_dtype`` no params and no dtype argument (float32, the
    factory's own SD3-Medium draw; held here)."""
    import torch

    from sdtpu_torch.config import SDVersion
    from sdtpu_torch.factory import create_pipeline, sd3_configs
    from sdtpu_torch.models import clip as clip_mod
    from sdtpu_torch.models import mmdit as mmdit_mod
    from sdtpu_torch.models import t5 as t5_mod
    from sdtpu_torch.models import vae as vae_mod
    from sdtpu_torch.weights import synthesize, weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if default_dtype:
        pipe = create_pipeline(SDVersion.SD3, device=DEVICE, seed=0)
        if pipe.compute_dtype != torch.float32:
            raise RuntimeError(f"create_pipeline's default dtype is {pipe.compute_dtype}, not float32")
        label = "sd3_medium dense"
    else:
        _, clip_l_cfg, clip_g_cfg, t5_cfg, vae_cfg = sd3_configs(small=False)
        specs = {"diffusion": mmdit_mod.param_specs(mmdit_mod.SD35_MEDIUM_CONFIG),
                 "clip_l": clip_mod.param_specs(clip_l_cfg), "clip_g": clip_mod.param_specs(clip_g_cfg),
                 "t5": t5_mod.param_specs(t5_cfg), "vae": vae_mod.vae_specs(vae_cfg)}
        params = {m: synthesize(sp, quant="q4_0" if m == "t5" else None, seed=SD3_BENCH_SEEDS[m],
                                device=DEVICE, dtype=torch.bfloat16) for m, sp in specs.items()}
        cfg = mmdit_mod.detect_mmdit_config(params["diffusion"].keys(), {
            k: tuple(v.shape) for k, v in params["diffusion"].items()})
        if cfg != mmdit_mod.SD35_MEDIUM_CONFIG:
            raise RuntimeError(f"the MMDiT fingerprints as {cfg}, not SD3.5-Medium's")
        pipe = create_pipeline(SDVersion.SD3, params=params, dtype=torch.bfloat16, device=DEVICE)
        del params
        label = "sd35_medium dense"
    c = pipe.conditioner
    wb = {"diffusion": weight_bytes(pipe.diffusion_params), "clip_l": weight_bytes(c.pl),
          "clip_g": weight_bytes(c.pg), "t5": weight_bytes(c.pt), "vae": weight_bytes(pipe.vae_params)}
    torch.cuda.synchronize()
    build_s = time.time() - t0
    print(f"pipeline: full-width {label}, T5-XXL q4_0, {pipe.compute_dtype}, built in {build_s:.2f} s "
          f"on {card}; weight bytes " + json.dumps(wb), flush=True)
    return pipe, {"diffusion": label, "dtype": str(pipe.compute_dtype), "build_s": build_s,
                  "weight_bytes": wb}


def sd3_paths(wrappers, card: str, launches: dict, profile=None):
    """The SD3 paths: ``sd3`` (bf16 SD3.5-Medium, SD3_REQUESTS), then
    ``sd3_img2img`` on the same pipeline (SD3_IMG2IMG_REQUEST), and
    ``sd3_f32`` (the default dtype, SD3-Medium, SD3_F32_REQUESTS), each in
    its launch window."""
    import torch

    pipes, reports, prof = [], [], {}
    for label, f32, requests, calls in (("sd3", False, SD3_REQUESTS, SD3_MMDIT_ATTENTION_CALLS[64]),
                                        ("sd3_f32", True, SD3_F32_REQUESTS, 24)):
        pipe, info = build_sd3_pipeline(card, default_dtype=f32)
        pipes.append(info)
        with plain_attention_on_card() as plain:
            rep, launches[label] = _windowed(wrappers, label,
                                             lambda: answer(pipe, requests, card, label))
        info.update(_check_sd3_launches(label, launches[label], *_forwards_and_encodes(requests),
                                        len(requests), plain, calls, f32=f32))
        reports += rep
        if profile and not f32:
            prof[label] = profile_request(pipe, SD3_REQUEST, profile, label, card)
        if not f32:
            img, _ = init_image_and_mask(SD3_IMG2IMG_REQUEST["width"])
            with plain_attention_on_card() as plain:
                rep, launches["sd3_img2img"] = _windowed(wrappers, "sd3_img2img", lambda: answer(
                    pipe, [dict(SD3_IMG2IMG_REQUEST, init_image=img)], card, "sd3_img2img"))
            steps = img2img_steps(SD3_IMG2IMG_REQUEST["sample_steps"], SD3_IMG2IMG_REQUEST["strength"])
            _check_steps("sd3_img2img", rep[0], steps)
            # D 512: the untiled encode and the decode
            info["img2img"] = _check_sd3_launches(
                "sd3_img2img", launches["sd3_img2img"], steps,
                _forwards_and_encodes([SD3_IMG2IMG_REQUEST])[1], 2, plain, calls)
            reports += rep
            _sampling_part("sd3", sampling_sd3(pipe, wrappers, card, launches))
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports, prof


# Phase 11, SD3.5-Medium on files: the bench's request through the CLI and
# the A1111 route (``sampler_name`` dpm++2m; A1111's display name "DPM++ 2M"
# maps to ``dpm++_2m`` in both packages' servers, a method neither runs)
SD3_CLI_ARGV = ["-p", SD3_REQUEST["prompt"], "-n", "blurry", "-W", "1024", "-H", "1024", "--steps",
                "28", "--sampling-method", "dpm++2m", "--cfg-scale", "4.5", "-s", "42"]
SD3_SERVER_BODY = {"prompt": SD3_REQUEST["prompt"], "negative_prompt": "blurry", "width": 1024,
                   "height": 1024, "steps": 28, "cfg_scale": 4.5, "seed": 42, "sampler_name": "dpm++2m"}


def sd3_entry_check(wrappers, card: str) -> dict:
    """Phase 11, SD3: the full-width SD3.5-Medium set of
    ``tools/sd3_file.py`` through ``cli.main -m ... --clip_l ... --clip_g ...
    --t5xxl ...`` (its PNG read back in metadata mode) and the A1111 route."""
    from sdtpu_torch.tools.sd3_file import write_sd3_files

    def load_check(rep):
        load, ids = rep["load"], rep["t5_ids"]
        if load["version"] != "sd3" or not str(load["t5_tokenizer"]).startswith("gguf:"):
            raise RuntimeError(f"the CLI loaded {load['version']} (T5 tokenizer "
                               f"{load['t5_tokenizer']}), not sd3 with the GGUF's vocab")
        if sum(1 for i in ids if i) < 2:  # more than the end-of-sequence id
            raise RuntimeError(f"T5 was fed no token of the prompt: {ids}")

    def file_args(files):
        paths = files["paths"]
        return ["-m", paths["model"], "--clip_l", paths["clip_l"], "--clip_g", paths["clip_g"],
                "--t5xxl", paths["t5xxl"]]

    counts_of = (*_forwards_and_encodes([SD3_REQUEST]), 1)
    return _file_entry_check(
        wrappers, card, "sd3", lambda tmp: write_sd3_files(tmp, device=DEVICE), file_args,
        SD3_CLI_ARGV, SD3_SERVER_BODY,
        lambda path, counts, plain: _check_sd3_launches(path, counts, *counts_of, plain,
                                                        SD3_MMDIT_ATTENTION_CALLS[64], t5_q4=False),
        "dpm++2m", (SD3_REQUEST["width"], SD3_REQUEST["height"]), load_check, request=SD3_REQUEST)


# Wan2.1-T2V-1.3B: the JAX bench's request (``bench_wan21_t2v``, bench.py:
# 592: "a corgi running on a beach", negative "static", 832x480, 33 frames =
# 9 latent frames, 8 euler steps, CFG 6, seed 42), answered once to warm up
# and twice timed with the bench's decode tiling (spatial tiles of 32 latent
# pixels, temporal windows of 5 latent frames with 1 of overlap).  Each step
# is one DiT forward of the CFG batch of two; each request encodes two
# prompts (UMT5 over 512 tokens).  The default dtype (float32) answers it at
# 2 steps on the DiT cut to WAN_F32_BLOCKS blocks (every width full): its
# float32 self-attention over 14040 tokens takes ~47 ms a call under CFG,
# ~1.4 s a step at full depth, beside a float32 decode of ~20 s.
WAN_REQUEST = dict(prompt="a corgi running on a beach", negative_prompt="static", width=832,
                   height=480, sample_steps=8, cfg_scale=6.0, seed=42, sample_method="euler",
                   frames=33)
WAN_REQUESTS = [WAN_REQUEST, WAN_REQUEST, WAN_REQUEST]
WAN_F32_REQUESTS = [dict(WAN_REQUEST, sample_steps=2)]
WAN_F32_BLOCKS = 2
WAN_TILING = dict(tile_size=32, temporal=True,
                  extra_tiling_args="temporal_tile_frames=5,temporal_tile_overlap=1")
# the JAX bench's seeds (bench.py:602-613): the DiT 1, UMT5-XXL 2, the VAE 3
WAN_BENCH_SEEDS = {"diffusion": 1, "t5": 2, "vae": 3}
# UMT5's attentions a prompt encode: its relative-position bias keeps them on
# the plain path, as the JAX package runs them
WAN_T5_LAYERS = 24


def _check_wan_launches(path: str, counts: dict, forwards: int, encodes: int, plain: dict,
                        f32: bool = False, t5_q4: bool = True, calls: int = WAN_ATTENTION_CALLS,
                        extra_calls: int = 0) -> dict:
    """Flash at D 128 (bf16, or float32) launched exactly ``calls`` a DiT
    forward times the forwards plus ``extra_calls`` (skip-layer forwards),
    and nothing else of flash; the 4-bit matmul
    ``WAN_T5_LINEARS`` times a prompt encode in the path's form (bf16 wgmma
    at 512 rows, or float32), none where UMT5 was dequantized (``t5_q4``
    False: the CLI); and on the card no attention ran in the plain version
    but UMT5's ``WAN_T5_LAYERS`` a prompt encode."""
    other = ("flash_attention_d64", "flash_attention_d512", *UNET_FLASH)
    q4 = WAN_T5_LINEARS * encodes if t5_q4 else 0
    got = {"flash_d128": counts["flash_attention"] - sum(counts[k] for k in other),
           "flash_other": sum(counts[k] for k in other),
           "flash_f32": counts["flash_attention_f32"],
           "q4_t5": counts["q4_matmul_f32" if f32 else "q4_matmul_wgmma"], "q4_all": counts["q4_matmul"],
           "plain_attention_on_card_besides_t5": plain["calls"] - WAN_T5_LAYERS * encodes}
    want = {"flash_d128": calls * forwards + extra_calls, "flash_other": 0,
            "flash_f32": calls * forwards + extra_calls if f32 else 0, "q4_t5": q4, "q4_all": q4,
            "plain_attention_on_card_besides_t5": 0}
    if got != want:
        raise RuntimeError(f"path {path}: launches {got}, not {want} ({forwards} DiT forwards of "
                           f"{calls} attentions, {encodes} prompt encodes)")
    return {**got, "dit_forwards": forwards, "prompt_encodes": encodes,
            "t5_plain_attention": plain["calls"]}


def build_wan_pipeline(card: str, default_dtype: bool = False):
    """A full-width Wan2.1-T2V-1.3B pipeline (the DiT and the Wan VAE dense,
    UMT5-XXL 4-bit), random weights drawn on the card with the JAX bench's
    seeds and passed as ``params``, so the DiT config is fingerprinted:
    ``create_pipeline(SDVersion.WAN2, params=..., dtype=torch.bfloat16)``;
    or with ``default_dtype`` no dtype argument (float32, held here) and the
    DiT cut to ``WAN_F32_BLOCKS`` blocks.  The bench's decode tiling is
    set."""
    import torch

    from sdtpu_torch.config import SDVersion
    from sdtpu_torch.factory import create_pipeline, wan_configs
    from sdtpu_torch.models import t5 as t5_mod
    from sdtpu_torch.models import wan as wan_mod
    from sdtpu_torch.models import wan_vae as wan_vae_mod
    from sdtpu_torch.weights import synthesize, weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    dit_cfg, t5_cfg, vae_cfg, _ = wan_configs(small=False)
    if default_dtype:
        dit_cfg = dataclasses.replace(dit_cfg, num_layers=WAN_F32_BLOCKS)
    dtype = torch.float32 if default_dtype else torch.bfloat16
    specs = {"diffusion": wan_mod.param_specs(dit_cfg), "t5": t5_mod.param_specs(t5_cfg),
             "vae": wan_vae_mod.param_specs(vae_cfg)}
    params = {m: synthesize(sp, quant="q4_0" if m == "t5" else None, seed=WAN_BENCH_SEEDS[m],
                            device=DEVICE, dtype=dtype) for m, sp in specs.items()}
    cfg = wan_mod.detect_wan_config(params["diffusion"].keys(), {
        k: tuple(v.shape) for k, v in params["diffusion"].items()})
    if cfg != dit_cfg:
        raise RuntimeError(f"the DiT fingerprints as {cfg}, not {dit_cfg}")
    if default_dtype:
        pipe = create_pipeline(SDVersion.WAN2, params=params, device=DEVICE)
        if pipe.compute_dtype != torch.float32:
            raise RuntimeError(f"create_pipeline's default dtype is {pipe.compute_dtype}, not float32")
    else:
        pipe = create_pipeline(SDVersion.WAN2, params=params, dtype=torch.bfloat16, device=DEVICE)
    del params
    pipe.set_vae_tiling(True, **WAN_TILING)
    label = f"wan21_t2v_1_3b dense, {dit_cfg.num_layers} blocks"
    wb = {"diffusion": weight_bytes(pipe.diffusion_params), "t5": weight_bytes(pipe.conditioner.pt),
          "vae": weight_bytes(pipe.vae_params)}
    torch.cuda.synchronize()
    build_s = time.time() - t0
    print(f"pipeline: full-width {label}, UMT5-XXL q4_0, {pipe.compute_dtype}, built in "
          f"{build_s:.2f} s on {card}; weight bytes " + json.dumps(wb), flush=True)
    return pipe, {"diffusion": label, "dtype": str(pipe.compute_dtype), "build_s": build_s,
                  "weight_bytes": wb}


def answer_video(pipe, requests, card: str, label: str):
    """Each request through ``generate_video`` (the prompt cache emptied
    first, as in ``answer``): 1 + 4k frames of the asked size, uint8, not constant; finite latents [1, Tl, h, w, 16].  Reports the
    sample and decode seconds, DiT steps/s and decode s/frame."""
    import numpy as np
    import torch

    from sdtpu_torch.config import GenerationParams

    reports = []
    for kw in requests:
        kw = dict(kw)
        frames = kw.pop("frames")
        gp = GenerationParams(**kw)
        pipe._cond_cache.clear()  # every request encodes its prompts
        torch.cuda.reset_peak_memory_stats()
        res = pipe.generate_video(gp, frames=frames)
        peak = torch.cuda.max_memory_allocated()
        vid, lat = res.frames, res.latents
        tl = (frames - 1) // 4 + 1
        if vid.shape != (1, frames, gp.height, gp.width, 3) or vid.dtype != np.uint8:
            raise RuntimeError(f"frames {vid.shape} {vid.dtype} for {frames} x {gp.width}x{gp.height}")
        if lat.shape != (1, tl, gp.height // 8, gp.width // 8, pipe.latent_channels) or not np.isfinite(lat).all():
            raise RuntimeError(f"latents {lat.shape} not finite or of the wrong shape")
        if vid.std() == 0 or lat.std() == 0 or vid[0, -1].std() == 0:
            raise RuntimeError("constant frames or latents")
        tm = pipe.last_timings
        rep = {"path": label, "size": [gp.width, gp.height], "frames": tm["frames"],
               "cfg_scale": gp.cfg_scale, "sampler": gp.sample_method, "steps": tm["steps"],
               "seed": gp.seed, "timings_s": {k: tm[k] for k in ("cond", "sample", "decode", "total")},
               "dit_steps_per_s": tm["steps"] / tm["sample"],
               "decode_s_per_frame": tm["decode"] / tm["frames"], "peak_mem_bytes": peak,
               "frame_std": float(vid.std()), "card": card}
        print("request " + json.dumps(rep), flush=True)
        reports.append(rep)
    return reports, res


def wan_forward_plain_check(pipe, cond) -> dict:
    """One full-width DiT forward of the bench's latent (9 x 60 x 104, the
    cond half: B = 1) through the kernels, against the same forward with
    every attention in the plain version (``flash_supported`` refused),
    held at REF_REL_TOL (relative L2: both sides bf16, flash against the
    plain softmax); both finite."""
    import importlib

    import torch

    att = importlib.import_module("sdtpu_torch.ops.attention")
    g = torch.Generator(device=DEVICE).manual_seed(12)
    x = torch.randn((1, 9, 60, 104, pipe.latent_channels), generator=g, device=DEVICE,
                    dtype=pipe.compute_dtype)
    t = torch.tensor([700.0], device=DEVICE)
    with torch.inference_mode():
        got = pipe.diffusion_fn(pipe.diffusion_params, x, t, cond, None)
        real = att.flash_supported
        att.flash_supported = lambda *a: False
        try:
            want = pipe.diffusion_fn(pipe.diffusion_params, x, t, cond, None)
        finally:
            att.flash_supported = real
    rel = _rel(got, want)
    ok = bool(torch.isfinite(got).all() and torch.isfinite(want).all() and rel <= REF_REL_TOL)
    out = {"rel_l2": rel, "tol": REF_REL_TOL, "ok": ok, "shape": list(got.shape)}
    print("wan_forward_plain " + json.dumps(out), flush=True)
    if not ok:
        raise RuntimeError(f"the full-width Wan forward with flash is {rel:.4g} from the plain one")
    return out


def wan_paths(wrappers, card: str, launches: dict, profile=None):
    """The Wan paths: ``wan`` (bf16 Wan2.1-T2V-1.3B, WAN_REQUESTS), then an
    untiled decode of its last latents for comparison and the full-width
    forward against plain attention; ``wan_f32`` (the default dtype, the
    DiT cut to WAN_F32_BLOCKS blocks, WAN_F32_REQUESTS), each in its launch
    window."""
    import torch

    pipes, reports, prof, extra = [], [], {}, {}
    for label, f32, requests in (("wan", False, WAN_REQUESTS), ("wan_f32", True, WAN_F32_REQUESTS)):
        pipe, info = build_wan_pipeline(card, default_dtype=f32)
        pipes.append(info)
        with plain_attention_on_card() as plain:
            (rep, res), launches[label] = _windowed(wrappers, label,
                                                    lambda: answer_video(pipe, requests, card, label))
        info.update(_check_wan_launches(label, launches[label], *_forwards_and_encodes(requests),
                                        plain, f32=f32,
                                        calls=2 * WAN_F32_BLOCKS if f32 else WAN_ATTENTION_CALLS))
        reports += rep
        if not f32:
            # the bench's tiling against one untiled decode of the same latents
            lat = torch.from_numpy(res.latents).to(DEVICE)
            pipe.set_vae_tiling(False)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.time()
            with torch.inference_mode():
                full = pipe.decode(lat)
            torch.cuda.synchronize()
            extra["untiled_decode"] = {
                "decode_s": time.time() - t0, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "frames": full.shape[1], "finite": bool(torch.isfinite(full).all()),
                "tiled_rel_l2": _rel(torch.from_numpy(res.frames[0]).float(),
                                     ((full[0].clamp(-1, 1) + 1) * 127.5).round().cpu())}
            print("untiled_decode " + json.dumps(extra["untiled_decode"]), flush=True)
            if not extra["untiled_decode"]["finite"] or full.shape[1] != res.frames.shape[1]:
                raise RuntimeError("the untiled Wan decode is not finite or has the wrong frames")
            pipe.set_vae_tiling(True, **WAN_TILING)
            del full, lat
            with torch.inference_mode():
                cond = pipe.conditioner.get_learned_condition(WAN_REQUEST["prompt"]).c_crossattn
            extra["forward_plain"] = wan_forward_plain_check(pipe, cond)
            del cond
            _sampling_part("wan", sampling_wan(pipe, wrappers, card, launches))
            if profile:
                prof[label] = profile_request(pipe, WAN_REQUEST, profile, label, card)
        del pipe, res
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports, prof, extra


# Phase 11, Wan2.1 on files: ``vid_gen`` through the CLI on
# ``tools/wan_file.py``'s set at full width, a short clip (9 frames: 3
# latent frames) at 2 steps with the bench's tiling (UMT5 dequantized when
# staged, as the JAX CLI does: no 4-bit call)
WAN_CLI_FRAMES = 9
WAN_CLI_REQUEST = dict(WAN_REQUEST, sample_steps=2, frames=WAN_CLI_FRAMES)
WAN_CLI_ARGV = ["-M", "vid_gen", "-p", WAN_REQUEST["prompt"], "-n", "static", "-W", "832", "-H", "480",
                "--video-frames", str(WAN_CLI_FRAMES), "--steps", "2", "--cfg-scale", "6",
                "--sampling-method", "euler", "-s", "42", "--vae-tiling", "--vae-tile-size", "32",
                "--vae-temporal-tiling", "--extra-tiling-args",
                "temporal_tile_frames=5,temporal_tile_overlap=1"]


def wan_entry_check(wrappers, card: str):
    """Phase 11, Wan: ``tools/wan_file.py``'s full-width set (the DiT and the
    VAE float16, UMT5-XXL a q8_0 GGUF with its vocab) written into a fresh
    directory under the build directory, then ``cli.main -M vid_gen`` on it:
    WAN_CLI_FRAMES PNG frames of 832x480, not constant, in its launch window
    (path ``wan_cli``)."""
    import tempfile

    import numpy as np
    import torch

    from sdtpu_torch import cli
    from sdtpu_torch.tools.wan_file import write_wan_files
    from sdtpu_torch.utils.image import decode_png

    root = ROOT / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="wan_files_", dir=root))
    report, launches = {"card": card}, {}
    try:
        report["files"] = write_wan_files(tmp, device=DEVICE)
        print("entry wan files on " + card + ": " + json.dumps(report["files"]), flush=True)
        paths = report["files"]["paths"]
        args = ["--diffusion-model", paths["diffusion_model"], "--vae", paths["vae"], "--t5xxl",
                paths["t5xxl"]]
        out, rep = tmp / "wan.png", {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with plain_attention_on_card() as plain:
            rc, launches["wan_cli"] = _windowed(wrappers, "wan_cli", lambda: cli.main(
                args + WAN_CLI_ARGV + ["-o", str(out)], report=rep))
        wall_s = time.time() - t0
        if rc != 0:
            raise RuntimeError(f"sdtpu_torch.cli.main -M vid_gen on the Wan files exited {rc}")
        load = rep["load"]
        if load["version"] != "wan2" or not str(load["t5_tokenizer"]).startswith("gguf:"):
            raise RuntimeError(f"the CLI loaded {load['version']} (UMT5 tokenizer "
                               f"{load['t5_tokenizer']}), not wan2 with the GGUF's vocab")
        if sum(1 for i in rep["t5_ids"] if i) < 2:
            raise RuntimeError(f"UMT5 was fed no token of the prompt: {rep['t5_ids'][:16]}")
        want = [str(tmp / f"wan_{i:04d}.png") for i in range(WAN_CLI_FRAMES)]
        if rep["outputs"] != want or (tmp / f"wan_{WAN_CLI_FRAMES:04d}.png").exists():
            raise RuntimeError(f"vid_gen wrote {rep['outputs']}, not {want}")
        stds = []
        for p_ in want:
            img, _ = decode_png(Path(p_).read_bytes())
            if img.shape != (480, 832, 3):
                raise RuntimeError(f"{p_}: {img.shape}, not (480, 832, 3)")
            stds.append(float(img.std()))
        if min(stds) == 0:
            raise RuntimeError(f"constant frames: {stds}")
        report["cli"] = {"load": load, "wall_s": wall_s, "timings_s": rep["timings"],
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "frames": len(want), "frame_std": float(np.mean(stds)),
                         **_check_wan_launches("wan_cli", launches["wan_cli"],
                                               *_forwards_and_encodes([WAN_CLI_REQUEST]), plain,
                                               t5_q4=False)}
        print("entry wan cli " + json.dumps(report["cli"]), flush=True)
        del rep
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report, launches


# Z-Image-Turbo at 1024², the way Turbo runs: 8 euler steps at CFG 1 (one
# DiT forward a step, B = 1), answered to warm up, timed, then with a fresh
# prompt; then 2 steps at CFG 4 with a negative prompt, whose context is
# shorter than the prompt's (38 byte-level ids against 55) and is
# zero-padded to it for the CFG batch of two.  The default dtype (float32)
# answers 512² x 2 on the DiT cut to Z_IMAGE_F32_LAYERS main layers (every
# width full).  Prompts are tokenized with Qwen's byte-level ids
# (``Qwen2Tokenizer.byte_fallback``), as the CLI does for a bare text
# encoder.
Z_IMAGE_REQUEST = dict(prompt="a red fox in fresh snow, golden hour", negative_prompt="", width=1024,
                       height=1024, sample_steps=8, cfg_scale=1.0, seed=42, sample_method="euler")
Z_IMAGE_REQUESTS = [Z_IMAGE_REQUEST, Z_IMAGE_REQUEST,
                    dict(Z_IMAGE_REQUEST, prompt="a lighthouse on a cliff above a stormy sea", seed=7),
                    dict(Z_IMAGE_REQUEST, negative_prompt="blurry, low quality", cfg_scale=4.0,
                         sample_steps=2, seed=3)]
Z_IMAGE_F32_REQUESTS = [dict(Z_IMAGE_REQUEST, width=512, height=512, sample_steps=2)]
Z_IMAGE_F32_LAYERS = 2
# W8A8 launches of one forward of a q8_0 GGUF DiT promoted onto W8A8, at CFG
# 1 over a prompt of at most 64 tokens, by form: the GEMV at the one-row
# adaLN linears (2 noise-refiner, 30 main layers, the final layer's), the
# split-K form at the context refiner's 64 rows (qkv, out, w1, w3, w2 in
# each of 2 layers), the wgmma form at the image's 4096 rows and the joint
# 4160 (the noise refiner's and the main layers' 5 each, the final
# linear).  The embedders (``*_embedder``) stay dense: the loader keeps
# names with "embed" out of the quantized classes, as the JAX loader does.
Z_IMAGE_W8A8_PER_FORWARD = {"w8a8_matmul_gemv": 2 + 30 + 1, "w8a8_matmul_splitk": 2 * 5,
                            "w8a8_matmul_wgmma": 2 * 5 + 30 * 5 + 1}


def _check_dit_launches(path: str, counts: dict, plain: dict, forwards: int, calls: int,
                        encodes: int, llm_layers: int, forms: dict, decodes: int = 0,
                        f32: bool = False) -> dict:
    """A DiT path's launches (Z-Image's and Qwen-Image's): flash at D 128
    (bf16, or float32) exactly ``calls`` a DiT forward times the forwards,
    and once a decode where the VAE's attention runs through
    ``ops.attention`` (the FLUX VAE's D 512; the Wan VAE's is plain float32
    outside it, so ``decodes`` 0), no other flash; each quantized-matmul
    counter of ``forms`` exactly its count over the path, and the 4-bit and
    W8A8 totals the sums of their forms there (0 where ``forms`` names
    none); on the card no attention in the plain version but the LLM's
    ``llm_layers`` a prompt encode."""
    d128 = calls * forwards
    if f32:  # every flash launch float32, a VAE's D 512 among them
        got = {"flash_f32": counts["flash_attention_f32"],
               "flash_bf16": counts["flash_attention"] - counts["flash_attention_f32"]}
        want = {"flash_f32": d128 + decodes, "flash_bf16": 0}
    else:
        other = ("flash_attention_d64", *UNET_FLASH)
        got = {"flash_d128": counts["flash_attention"] - counts["flash_attention_d512"]
               - sum(counts[k] for k in other),
               "flash_d512": counts["flash_attention_d512"], "flash_other": sum(counts[k] for k in other)}
        want = {"flash_d128": d128, "flash_d512": decodes, "flash_other": 0}
    got.update({n: counts[n] for n in forms}, q4_all=counts["q4_matmul"],
               w8a8_all=counts["w8a8_matmul"],
               plain_attention_on_card_besides_llm=plain["calls"] - llm_layers * encodes)
    want.update(forms, q4_all=sum(c for n, c in forms.items() if n.startswith("q4_")),
                w8a8_all=sum(c for n, c in forms.items() if n.startswith("w8a8_")),
                plain_attention_on_card_besides_llm=0)
    if got != want:
        raise RuntimeError(f"path {path}: launches {got}, not {want} ({forwards} DiT forwards of "
                           f"{calls} attentions, {encodes} prompt encodes, {decodes} decodes)")
    return {**got, "dit_forwards": forwards, "prompt_encodes": encodes,
            "llm_plain_attention": plain["calls"]}


def build_z_image_pipeline(card: str, default_dtype: bool = False):
    """A full-width Z-Image-Turbo pipeline from the factory's own draw on the
    card (the DiT and the FLUX VAE dense, Qwen3-4B 4-bit):
    ``create_pipeline(SDVersion.Z_IMAGE, dtype=torch.bfloat16,
    qwen_tokenizer=Qwen2Tokenizer.byte_fallback())``, its LLM held to be
    Qwen3-4B; or with ``default_dtype`` no dtype argument (float32, held
    here) and a dense DiT cut to ``Z_IMAGE_F32_LAYERS`` main layers passed
    as ``params``, so its config is fingerprinted."""
    import torch

    from sdtpu_torch.config import SDVersion
    from sdtpu_torch.factory import create_pipeline
    from sdtpu_torch.models import llm as llm_mod
    from sdtpu_torch.models import z_image as zi_mod
    from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer
    from sdtpu_torch.weights import synthesize, weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tok = Qwen2Tokenizer.byte_fallback()
    if default_dtype:
        dit_cfg = dataclasses.replace(zi_mod.Z_IMAGE_CONFIG, num_layers=Z_IMAGE_F32_LAYERS)
        params = {"diffusion": synthesize(zi_mod.param_specs(dit_cfg), seed=1, device=DEVICE,
                                          dtype=torch.float32)}
        pipe = create_pipeline(SDVersion.Z_IMAGE, params=params, device=DEVICE, qwen_tokenizer=tok)
        del params
        if pipe.compute_dtype != torch.float32:
            raise RuntimeError(f"create_pipeline's default dtype is {pipe.compute_dtype}, not float32")
    else:
        dit_cfg = zi_mod.Z_IMAGE_CONFIG
        pipe = create_pipeline(SDVersion.Z_IMAGE, dtype=torch.bfloat16, device=DEVICE, seed=0,
                               qwen_tokenizer=tok)
    if pipe.conditioner.cl != llm_mod.QWEN3_4B_CONFIG:
        raise RuntimeError(f"the LLM is {pipe.conditioner.cl}, not Qwen3-4B")
    got = zi_mod.detect_z_image_config(pipe.diffusion_params.keys(), {
        k: tuple(v.shape) for k, v in pipe.diffusion_params.items()})
    if got != dit_cfg:
        raise RuntimeError(f"the DiT fingerprints as {got}, not {dit_cfg}")
    label = f"z_image_turbo dense, {dit_cfg.num_layers} layers"
    wb = {"diffusion": weight_bytes(pipe.diffusion_params), "llm": weight_bytes(pipe.conditioner.pl),
          "vae": weight_bytes(pipe.vae_params)}
    torch.cuda.synchronize()
    build_s = time.time() - t0
    print(f"pipeline: full-width {label}, Qwen3-4B q4_0, {pipe.compute_dtype}, built in "
          f"{build_s:.2f} s on {card}; weight bytes " + json.dumps(wb), flush=True)
    return pipe, {"diffusion": label, "dtype": str(pipe.compute_dtype), "build_s": build_s,
                  "weight_bytes": wb}


def dit_forward_plain_check(pipe, cond, label: str) -> dict:
    """One full-width DiT forward of a 1024² latent (B = 1) on the prompt's
    context through the kernels, against the same forward with every
    attention in the plain version (``flash_supported`` refused), held at
    REF_REL_TOL (relative L2: both sides bf16, flash against the plain
    softmax); both finite.  (Z-Image's and Qwen-Image's.)"""
    import importlib

    import torch

    att = importlib.import_module("sdtpu_torch.ops.attention")
    g = torch.Generator(device=DEVICE).manual_seed(13)
    x = torch.randn((1, 128, 128, pipe.latent_channels), generator=g, device=DEVICE,
                    dtype=pipe.compute_dtype)
    t = torch.tensor([700.0], device=DEVICE)
    with torch.inference_mode():
        got = pipe.diffusion_fn(pipe.diffusion_params, x, t, cond, None)
        real = att.flash_supported
        att.flash_supported = lambda *a: False
        try:
            want = pipe.diffusion_fn(pipe.diffusion_params, x, t, cond, None)
        finally:
            att.flash_supported = real
    rel = _rel(got, want)
    ok = bool(torch.isfinite(got).all() and torch.isfinite(want).all() and rel <= REF_REL_TOL)
    out = {"rel_l2": rel, "tol": REF_REL_TOL, "ok": ok, "shape": list(got.shape),
           "context_tokens": cond.shape[1]}
    print(f"{label}_forward_plain " + json.dumps(out), flush=True)
    if not ok:
        raise RuntimeError(f"the full-width {label} forward with flash is {rel:.4g} from the plain one")
    return out


# The W8A8 launches one forward adds when ``quantize_params`` (the --type
# q8_0 rule) also takes the embedders the loader keeps dense: t_embedder's
# two one-row linears (the GEMV), cap_embedder's over the prompt's rows
# (split-K) and x_embedder's over the 4096 image rows (wgmma)
Z_IMAGE_EMBEDDER_W8A8 = {"w8a8_matmul_gemv": 2, "w8a8_matmul_splitk": 1, "w8a8_matmul_wgmma": 1}


def dit_w8a8_forward_check(wrappers, pipe, cond, label: str, want_launches: dict) -> dict:
    """The DiT's weights quantized per row on the card (``quantize_params``,
    as ``--type q8_0`` does; weights already quantized in place, as
    Qwen-Image's are, pass through it as they are), then one
    full-width forward of a 1024² latent (B = 1) on the context ``cond``
    through the W8A8 kernels, against the same forward with every quantized
    linear in its plain version (``plain_quant_linears``): relative L2
    exactly 0 (each W8A8 call bit-equal), both finite, the W8A8 forms
    launched exactly ``want_launches`` times.  The fault, the plain side
    with the last K split dropped in the split-K calls (the context's rows),
    must read above the limit.  (Z-Image's and Qwen-Image's.)"""
    import torch

    from sdtpu_torch.ops import quant

    def counts():
        return {n: getattr(*wrappers[n]) for n in want_launches}

    g = torch.Generator(device=DEVICE).manual_seed(29)
    x = torch.randn((1, 128, 128, pipe.latent_channels), generator=g, device=DEVICE,
                    dtype=pipe.compute_dtype)
    t = torch.tensor([700.0], device=DEVICE)
    previous = os.environ.pop("SDTPU_QUANT_MODE", None)
    try:
        q = quant.quantize_params(pipe.diffusion_params, bits=8)
        with torch.inference_mode():
            before = counts()
            got = pipe.diffusion_fn(q, x, t, cond, None)
            torch.cuda.synchronize()
            ran = {n: c - before[n] for n, c in counts().items()}
            with plain_quant_linears():
                want = pipe.diffusion_fn(q, x, t, cond, None)
            with plain_quant_linears(drop_k_split=True):
                fault = _rel(pipe.diffusion_fn(q, x, t, cond, None), want)
    finally:
        if previous is not None:
            os.environ["SDTPU_QUANT_MODE"] = previous
    del q
    rel = _rel(got, want)
    ok = bool(torch.isfinite(got).all() and torch.isfinite(want).all() and rel == 0.0 < fault
              and ran == want_launches)
    out = {"rel_l2": rel, "tol": 0.0, "drop_k_split": fault, "w8a8_launches": ran, "ok": ok,
           "shape": list(got.shape), "context_tokens": cond.shape[1]}
    print(f"{label}_w8a8_forward_plain " + json.dumps(out), flush=True)
    if not ok:
        raise RuntimeError(f"the full-width {label} forward through W8A8 is {rel:.4g} from the one "
                           f"with plain quantized linears (limit 0; the dropped split reads "
                           f"{fault:.4g}); W8A8 launches {ran}, not {want_launches}")
    return out


def z_image_paths(wrappers, card: str, launches: dict, profile=None):
    """The Z-Image paths: ``z_image`` (bf16 Z-Image-Turbo, Z_IMAGE_REQUESTS),
    then the full-width forward against plain attention and, quantized per
    row, against plain W8A8 linears; ``z_image_f32``
    (the default dtype, Z_IMAGE_F32_LAYERS main layers,
    Z_IMAGE_F32_REQUESTS), each in its launch window."""
    import torch

    pipes, reports, prof, extra = [], [], {}, {}
    for label, f32, requests in (("z_image", False, Z_IMAGE_REQUESTS),
                                 ("z_image_f32", True, Z_IMAGE_F32_REQUESTS)):
        pipe, info = build_z_image_pipeline(card, default_dtype=f32)
        pipes.append(info)
        with plain_attention_on_card() as plain:
            rep, launches[label] = _windowed(wrappers, label,
                                             lambda: answer(pipe, requests, card, label))
        forwards, encodes = _forwards_and_encodes(requests)
        info.update(_check_dit_launches(
            label, launches[label], plain, forwards,
            4 + Z_IMAGE_F32_LAYERS if f32 else Z_IMAGE_ATTENTION_CALLS, encodes, Z_IMAGE_LLM_LAYERS,
            {"q4_matmul_f32" if f32 else "q4_matmul_splitk": Z_IMAGE_LLM_LINEARS * encodes},
            decodes=len(requests), f32=f32))
        reports += rep
        if not f32:
            with torch.inference_mode():
                cond = pipe.conditioner.get_learned_condition(Z_IMAGE_REQUEST["prompt"]).c_crossattn
            extra["forward_plain"] = dit_forward_plain_check(pipe, cond, "z_image")
            extra["w8a8_forward_plain"] = dit_w8a8_forward_check(
                wrappers, pipe, cond, "z_image",
                {n: c + Z_IMAGE_EMBEDDER_W8A8[n] for n, c in Z_IMAGE_W8A8_PER_FORWARD.items()})
            del cond
            _sampling_part("z_image", sampling_z_image(pipe, wrappers, card, launches))
            if profile:
                prof[label] = profile_request(pipe, Z_IMAGE_REQUEST, profile, label, card)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports, prof, extra


# Phase 11, Z-Image on files: ``tools/z_image_file.py``'s full-width set (a
# q8_0 GGUF DiT, promoted onto W8A8; Qwen3-4B a q4_0 GGUF with its "gpt2"
# vocab, dequantized when staged, as the JAX CLI does; the FLUX VAE), one
# 1024² x 4 request at CFG 1 through the CLI and the A1111 route
Z_IMAGE_CLI_REQUEST = dict(Z_IMAGE_REQUEST, sample_steps=4)
Z_IMAGE_CLI_ARGV = ["-p", Z_IMAGE_REQUEST["prompt"], "-W", "1024", "-H", "1024", "--steps", "4",
                    "--cfg-scale", "1", "--sampling-method", "euler", "-s", "42"]
Z_IMAGE_SERVER_BODY = {"prompt": Z_IMAGE_REQUEST["prompt"], "width": 1024, "height": 1024, "steps": 4,
                       "cfg_scale": 1.0, "seed": 42, "sampler_name": "euler"}


def z_image_entry_check(wrappers, card: str) -> tuple:
    """Phase 11, Z-Image: ``tools/z_image_file.py``'s set through ``cli.main
    --diffusion-model ... --llm ... --vae ...`` (the tokenizer from the
    GGUF's vocab; its PNG read back in metadata mode) and the A1111 route."""
    from sdtpu_torch.tools.z_image_file import write_z_image_files

    def load_check(rep):
        load = rep["load"]
        if load["version"] != "z_image" or not str(load["llm_tokenizer"]).startswith("gguf:"):
            raise RuntimeError(f"the CLI loaded {load['version']} (LLM tokenizer "
                               f"{load['llm_tokenizer']}), not z_image with the GGUF's vocab")

    def file_args(files):
        paths = files["paths"]
        return ["--diffusion-model", paths["diffusion_model"], "--llm", paths["llm"], "--vae",
                paths["vae"]]

    # Qwen3 dequantized (no 4-bit call), the DiT promoted onto W8A8
    forwards, encodes = _forwards_and_encodes([Z_IMAGE_CLI_REQUEST])
    w8a8 = {n: c * forwards for n, c in Z_IMAGE_W8A8_PER_FORWARD.items()}
    return _file_entry_check(
        wrappers, card, "z_image", lambda tmp: write_z_image_files(tmp, device=DEVICE), file_args,
        Z_IMAGE_CLI_ARGV, Z_IMAGE_SERVER_BODY,
        lambda path, counts, plain: _check_dit_launches(
            path, counts, plain, forwards, Z_IMAGE_ATTENTION_CALLS, encodes, Z_IMAGE_LLM_LAYERS,
            w8a8, decodes=1),
        "euler", (1024, 1024), load_check, request=Z_IMAGE_CLI_REQUEST)


# Qwen-Image at 1024², as stable-diffusion.cpp's docs run it (euler, CFG
# 2.5, flow shift 3), its 20 steps cut to 8, with a negative prompt whose
# context is shorter than the prompt's (147 rows against 164) and is
# zero-padded to it for the CFG batch of two: warm-up, timed, then a fresh
# prompt.  The default dtype (float32) answers 512² x 2 on the DiT cut to
# QWEN_IMAGE_F32_LAYERS blocks (every width full; 60 float32 blocks would
# be 81.7e9 bytes).  img2img: a 1024² init image drawn from IMG2IMG_SEED, 4
# steps at QWEN_IMAGE_STRENGTH, then with a mask whose right half
# regenerates.  img2img runs at strength 0.6 (the last 3 of 4 steps): at
# 0.75 the reference keeps every step, and the flow schedule's first sigma,
# 1, leaves nothing of the init image but through a mask.
QWEN_IMAGE_REQUEST = dict(prompt="a red fox in fresh snow, golden hour",
                          negative_prompt="blurry, low quality", width=1024, height=1024,
                          sample_steps=8, cfg_scale=2.5, seed=42, sample_method="euler")
QWEN_IMAGE_REQUESTS = [QWEN_IMAGE_REQUEST, QWEN_IMAGE_REQUEST,
                       dict(QWEN_IMAGE_REQUEST, prompt="a lighthouse on a cliff above a stormy sea",
                            seed=7)]
QWEN_IMAGE_F32_REQUESTS = [dict(QWEN_IMAGE_REQUEST, width=512, height=512, sample_steps=2)]
QWEN_IMAGE_F32_LAYERS = 2
QWEN_IMAGE_STRENGTH = 0.6
QWEN_IMAGE_IMG2IMG_REQUEST = dict(QWEN_IMAGE_REQUEST, prompt="a harbour at dawn, oil on canvas",
                                  sample_steps=4, strength=QWEN_IMAGE_STRENGTH, seed=5)
# the W8A8 forward check's context: the prompt's first 64 rows, so the text
# stream's linears run the split-K form (9-127 rows) beside the GEMV (the
# modulation's one row) and the wgmma form (the image's 4096)
QWEN_IMAGE_W8A8_CONTEXT = 64


def qwen_image_linear_rows(name: str, batch: int, lt: int, n_img: int = 4096) -> int:
    """The rows x has at a Qwen-Image DiT linear named ``name`` in one
    forward of ``batch`` latents of ``n_img`` patches over ``lt`` context
    rows: the modulation (``img_mod``, ``txt_mod``, ``norm_out``) and the
    timestep embedder take one row a latent, the text stream (``txt_in``,
    ``add_*``, ``to_add_out``, ``txt_mlp``) ``lt``, the image stream (the
    rest) ``n_img``."""
    if any(s in name for s in ("img_mod", "txt_mod", "norm_out", "time_text_embed")):
        return batch
    if any(s in name for s in ("txt_in", ".add_", "to_add_out", "txt_mlp")):
        return batch * lt
    return batch * n_img


def qwen_image_file_weight(name: str, shape) -> str:
    """What a weight of ``tools/qwen_image_file.py``'s DiT is on the card:
    "q4" (``Q4Tensor``: a q4_0 tensor, K >= ``Q4_MIN_K``), "gq"
    (``GroupQuantTensor``: q4_0 at a smaller K, ``img_in``'s 64) or "dense"
    (under 2**16 elements, K not a multiple of 32, a bias or norm, or named
    "embed" or "norm": the loader keeps those dense, as the JAX loader)."""
    from sdtpu_torch.ops.quant import Q4_MIN_K
    from sdtpu_torch.weights import MIN_QUANT_ELEMS

    if (len(shape) != 2 or shape[0] * shape[1] < MIN_QUANT_ELEMS or shape[1] % 32
            or not name.endswith(".weight") or "embed" in name or "norm" in name):
        return "dense"
    return "q4" if shape[1] >= Q4_MIN_K else "gq"


def _form(m: int) -> str:
    """The bf16 form a quantized matmul of ``m`` rows runs."""
    return "gemv" if m <= 8 else "splitk" if m < 128 else "wgmma"


def qwen_image_file_forms(batch: int, lt: int, n_img: int = 4096) -> dict:
    """Launches of one forward of the q4_0 file DiT, by counter: the 4-bit
    matmul's GEMV, split-K and wgmma forms at the rows
    ``qwen_image_linear_rows`` gives, and ``img_in``'s group-dequant call
    (``gq_matmul_ws`` at 512 rows or more)."""
    from sdtpu_torch.models import qwen_image as qi_mod

    out = dict.fromkeys(("q4_matmul_gemv", "q4_matmul_splitk", "q4_matmul_wgmma", "gq_matmul",
                         "gq_matmul_ws"), 0)
    for name, (shape, _) in qi_mod.param_specs(qi_mod.QWEN_IMAGE_CONFIG).items():
        kind, m = qwen_image_file_weight(name, shape), qwen_image_linear_rows(name, batch, lt, n_img)
        if kind == "q4":
            out[f"q4_matmul_{_form(m)}"] += 1
        elif kind == "gq":
            out["gq_matmul_ws" if m >= 512 else "gq_matmul"] += 1
    return out


def qwen_image_w8a8_forms(batch: int, lt: int, n_img: int = 4096) -> dict:
    """W8A8 launches of one forward of the DiT quantized per row by
    ``quantize_params`` (every 2-D weight of 2**16 elements or more, the
    embedders too), by form."""
    from sdtpu_torch.models import qwen_image as qi_mod
    from sdtpu_torch.ops.quant import QUANTIZE_MIN_SIZE

    out = dict.fromkeys(("w8a8_matmul_gemv", "w8a8_matmul_splitk", "w8a8_matmul_wgmma"), 0)
    for name, (shape, _) in qi_mod.param_specs(qi_mod.QWEN_IMAGE_CONFIG).items():
        if len(shape) == 2 and shape[0] * shape[1] >= QUANTIZE_MIN_SIZE:
            out[f"w8a8_matmul_{_form(qwen_image_linear_rows(name, batch, lt, n_img))}"] += 1
    return out


def _q4_forms_of(rows) -> dict:
    """The 4-bit bf16 forms of QWEN_IMAGE_LLM_LINEARS calls at each prompt
    encode's id count in ``rows``."""
    out = dict.fromkeys(("q4_matmul_gemv", "q4_matmul_splitk", "q4_matmul_wgmma"), 0)
    for m in rows:
        out[f"q4_matmul_{_form(m)}"] += QWEN_IMAGE_LLM_LINEARS
    return out


def qwen_image_encode_rows(requests) -> list:
    """The ids of each prompt encode of ``requests`` (the chat template
    around the prompt, then the negative prompt under CFG; byte-level ids):
    the rows the LLM's linears take."""
    from sdtpu_torch.models.llm import CHAT_TEMPLATES
    from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer

    tok, (template, _) = Qwen2Tokenizer.byte_fallback(), CHAT_TEMPLATES["qwen_image"]
    rows = []
    for r in requests:
        prompts = [r["prompt"]] + ([r.get("negative_prompt", "")] if r.get("cfg_scale", 7.0) != 1.0
                                   else [])
        rows += [len(tok.encode(template.format(p))) for p in prompts]
    return rows


def build_qwen_image_pipeline(card: str, default_dtype: bool = False):
    """A full-width Qwen-Image pipeline from the factory's own draw on the
    card (the DiT and the Wan VAE dense, Qwen2.5-VL-7B 4-bit):
    ``create_pipeline(SDVersion.QWEN_IMAGE, dtype=torch.bfloat16,
    qwen_tokenizer=Qwen2Tokenizer.byte_fallback())``, its LLM held to be
    Qwen2.5-VL-7B; or with ``default_dtype`` no dtype argument (float32,
    held here) and a dense DiT cut to ``QWEN_IMAGE_F32_LAYERS`` blocks
    passed as ``params``, so its config is fingerprinted."""
    import torch

    from sdtpu_torch.config import SDVersion
    from sdtpu_torch.factory import create_pipeline
    from sdtpu_torch.models import llm as llm_mod
    from sdtpu_torch.models import qwen_image as qi_mod
    from sdtpu_torch.tokenizers.qwen2 import Qwen2Tokenizer
    from sdtpu_torch.weights import synthesize, weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tok = Qwen2Tokenizer.byte_fallback()
    if default_dtype:
        dit_cfg = dataclasses.replace(qi_mod.QWEN_IMAGE_CONFIG, num_layers=QWEN_IMAGE_F32_LAYERS)
        params = {"diffusion": synthesize(qi_mod.param_specs(dit_cfg), seed=1, device=DEVICE,
                                          dtype=torch.float32)}
        pipe = create_pipeline(SDVersion.QWEN_IMAGE, params=params, device=DEVICE, qwen_tokenizer=tok)
        del params
        if pipe.compute_dtype != torch.float32:
            raise RuntimeError(f"create_pipeline's default dtype is {pipe.compute_dtype}, not float32")
    else:
        dit_cfg = qi_mod.QWEN_IMAGE_CONFIG
        pipe = create_pipeline(SDVersion.QWEN_IMAGE, dtype=torch.bfloat16, device=DEVICE, seed=0,
                               qwen_tokenizer=tok)
    if pipe.conditioner.cl != llm_mod.QWEN25_VL_7B_CONFIG:
        raise RuntimeError(f"the LLM is {pipe.conditioner.cl}, not Qwen2.5-VL-7B")
    got = qi_mod.detect_qwen_image_config(pipe.diffusion_params.keys())
    if got != dit_cfg:
        raise RuntimeError(f"the DiT fingerprints as {got}, not {dit_cfg}")
    label = f"qwen_image dense, {dit_cfg.num_layers} blocks"
    wb = {"diffusion": weight_bytes(pipe.diffusion_params), "llm": weight_bytes(pipe.conditioner.pl),
          "vae": weight_bytes(pipe.vae_params)}
    torch.cuda.synchronize()
    build_s = time.time() - t0
    print(f"pipeline: full-width {label}, Qwen2.5-VL-7B q4_0, {pipe.compute_dtype}, built in "
          f"{build_s:.2f} s on {card}; weight bytes " + json.dumps(wb) + "; peak "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    return pipe, {"diffusion": label, "dtype": str(pipe.compute_dtype), "build_s": build_s,
                  "weight_bytes": wb, "build_peak_mem_bytes": torch.cuda.max_memory_allocated()}


def quantize_in_place(params: dict) -> int:
    """``quantize_params(..., bits=8)`` (the --type q8_0 rule) one weight at a
    time, each dense weight dropped as its int8 one replaces it, so the
    dense and the int8 DiT are never both held → the weights quantized."""
    from sdtpu_torch.ops import quant

    n = 0
    for name in list(params):
        q = quant.quantize_params({name: params[name]}, bits=8)[name]
        if q is not params[name]:
            params[name] = q
            n += 1
    return n


def qwen_image_img2img_path(pipe, wrappers, card: str, launches: dict) -> tuple:
    """Path ``qwen_image_img2img`` on the bf16 pipeline: QWEN_IMAGE_IMG2IMG_REQUEST
    from a 1024² init image through the Wan VAE's encoder (one frame), then
    the same with a mask whose right half regenerates; the kept half of the
    masked request's final latent must be the init image's encode within
    MASK_KEEP_TOL and the other half must move.  Launches as txt2img, and
    the steps sampled ``img2img_steps``'s."""
    import numpy as np

    size = QWEN_IMAGE_IMG2IMG_REQUEST["width"]
    img, mask = init_image_and_mask(size)
    requests = [dict(QWEN_IMAGE_IMG2IMG_REQUEST, init_image=img),
                dict(QWEN_IMAGE_IMG2IMG_REQUEST, init_image=img, mask_image=mask)]
    results = []
    with plain_attention_on_card() as plain:
        rep, launches["qwen_image_img2img"] = _windowed(
            wrappers, "qwen_image_img2img",
            lambda: answer(pipe, requests, card, "qwen_image_img2img", results))
    steps = img2img_steps(QWEN_IMAGE_IMG2IMG_REQUEST["sample_steps"],
                          QWEN_IMAGE_IMG2IMG_REQUEST["strength"])
    for r in rep:
        _check_steps("qwen_image_img2img", r, steps)
    rows = qwen_image_encode_rows(requests)
    info = _check_dit_launches("qwen_image_img2img", launches["qwen_image_img2img"], plain,
                               2 * steps, QWEN_IMAGE_ATTENTION_CALLS, len(rows),
                               QWEN_IMAGE_LLM_LAYERS, _q4_forms_of(rows))
    init = pipe.encode_image(img)  # outside the window
    lat = results[1].latents
    half = lat.shape[2] // 2
    info["mask"] = {"kept_max_abs": float(np.abs(lat[:, :, :half] - init[:, :, :half]).max()),
                    "tol": MASK_KEEP_TOL,
                    "moved_mean_abs": float(np.abs(lat[:, :, half:] - init[:, :, half:]).mean()),
                    "moved_min": MASK_MOVED_MIN, "encode_shape": list(init.shape)}
    print("qwen_image_img2img_mask " + json.dumps(info["mask"]), flush=True)
    if (info["mask"]["kept_max_abs"] > MASK_KEEP_TOL or info["mask"]["moved_mean_abs"] < MASK_MOVED_MIN
            or list(init.shape) != [1, size // 8, size // 8, 16]):
        raise RuntimeError(f"Qwen-Image masked img2img: {info['mask']}")
    return rep, info


def qwen_image_paths(wrappers, card: str, launches: dict, profile=None):
    """The Qwen-Image paths: ``qwen_image`` (bf16, QWEN_IMAGE_REQUESTS), then
    the full-width forward against plain attention, ``qwen_image_img2img``,
    the profiled request and, the DiT quantized per row in place, one
    forward through W8A8 against plain quantized linears;
    ``qwen_image_f32`` (the default dtype, QWEN_IMAGE_F32_LAYERS blocks,
    QWEN_IMAGE_F32_REQUESTS), each in its launch window."""
    import torch

    pipes, reports, prof, extra = [], [], {}, {}
    for label, f32, requests in (("qwen_image", False, QWEN_IMAGE_REQUESTS),
                                 ("qwen_image_f32", True, QWEN_IMAGE_F32_REQUESTS)):
        pipe, info = build_qwen_image_pipeline(card, default_dtype=f32)
        pipes.append(info)
        with plain_attention_on_card() as plain:
            rep, launches[label] = _windowed(wrappers, label,
                                             lambda: answer(pipe, requests, card, label))
        rows = qwen_image_encode_rows(requests)
        info.update(_check_dit_launches(
            label, launches[label], plain, _forwards_and_encodes(requests)[0],
            QWEN_IMAGE_F32_LAYERS if f32 else QWEN_IMAGE_ATTENTION_CALLS, len(rows),
            QWEN_IMAGE_LLM_LAYERS,
            {"q4_matmul_f32": QWEN_IMAGE_LLM_LINEARS * len(rows)} if f32 else _q4_forms_of(rows),
            f32=f32), prompt_encode_ids=rows)
        reports += rep
        if not f32:
            with torch.inference_mode():
                cond = pipe.conditioner.get_learned_condition(
                    QWEN_IMAGE_REQUEST["prompt"]).c_crossattn
            extra["forward_plain"] = dit_forward_plain_check(pipe, cond, "qwen_image")
            rep, extra["img2img"] = qwen_image_img2img_path(pipe, wrappers, card, launches)
            reports += rep
            if profile:
                prof[label] = profile_request(pipe, QWEN_IMAGE_REQUEST, profile, label, card)
            extra["quantized_in_place"] = quantize_in_place(pipe.diffusion_params)
            extra["w8a8_forward_plain"] = dit_w8a8_forward_check(
                wrappers, pipe, cond[:, :QWEN_IMAGE_W8A8_CONTEXT], "qwen_image",
                qwen_image_w8a8_forms(1, QWEN_IMAGE_W8A8_CONTEXT))
            del cond
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports, prof, extra


# Phase 11, Qwen-Image on files: ``tools/qwen_image_file.py``'s full-width
# set (the DiT a q4_0 GGUF kept in its blocks, 11.5e9 bytes; Qwen2.5-VL-7B a
# q4_0 GGUF with its "gpt2" vocab, dequantized when staged, as the JAX CLI
# does; the Wan VAE with its encoder), loaded once by each entry point:
# the CLI answers a 1024² x 4 request at CFG 2.5 with a negative prompt as
# ``-i`` img2img, the A1111 routes the same as txt2img and then as img2img
# under another prompt, img2img at QWEN_IMAGE_STRENGTH.
QWEN_IMAGE_CLI_REQUEST = dict(QWEN_IMAGE_REQUEST, sample_steps=4,
                              strength=QWEN_IMAGE_STRENGTH)
QWEN_IMAGE_CLI_ARGV = ["-p", QWEN_IMAGE_REQUEST["prompt"], "-n", QWEN_IMAGE_REQUEST["negative_prompt"],
                       "-W", "1024", "-H", "1024", "--steps", "4", "--cfg-scale", "2.5",
                       "--sampling-method", "euler", "-s", "42", "--strength",
                       str(QWEN_IMAGE_STRENGTH)]
QWEN_IMAGE_SERVER_BODY = {"prompt": QWEN_IMAGE_REQUEST["prompt"],
                          "negative_prompt": QWEN_IMAGE_REQUEST["negative_prompt"], "width": 1024,
                          "height": 1024, "steps": 4, "cfg_scale": 2.5, "seed": 42,
                          "sampler_name": "euler"}
QWEN_IMAGE_SERVER_IMG2IMG_BODY = dict(QWEN_IMAGE_SERVER_BODY, prompt="a harbour at dawn, oil on canvas",
                                      denoising_strength=QWEN_IMAGE_STRENGTH)


def qwen_image_entry_check(wrappers, card: str) -> tuple:
    """Phase 11, Qwen-Image: ``tools/qwen_image_file.py``'s set through
    ``cli.main --diffusion-model ... --llm ... --vae ... -i init.png`` (path
    ``qwen_image_cli``: the tokenizer from the GGUF's vocab; its PNG read
    back in metadata mode) and the A1111 txt2img and img2img routes
    (``qwen_image_server``, ``qwen_image_server_img2img``)."""
    import tempfile

    from sdtpu_torch.tools.qwen_image_file import write_qwen_image_files
    from sdtpu_torch.utils.image import write_image

    def load_check(rep):
        load = rep["load"]
        if load["version"] != "qwen_image" or not str(load["llm_tokenizer"]).startswith("gguf:"):
            raise RuntimeError(f"the CLI loaded {load['version']} (LLM tokenizer "
                               f"{load['llm_tokenizer']}), not qwen_image with the GGUF's vocab")
        if rep["timings"].get("encode", 0.0) <= 0.0:
            raise RuntimeError("the CLI's -i request encoded no init image")

    def file_args(files):
        paths = files["paths"]
        return ["--diffusion-model", paths["diffusion_model"], "--llm", paths["llm"], "--vae",
                paths["vae"]]

    def check(request, forwards):
        """One request's checks: its CFG batch of two over the longer of its
        two contexts (the ids less the template's 34)."""
        rows = qwen_image_encode_rows([request])
        forms = {n: c * forwards for n, c in qwen_image_file_forms(2, max(rows) - 34).items()}
        return lambda path, counts, plain: _check_dit_launches(
            path, counts, plain, forwards, QWEN_IMAGE_ATTENTION_CALLS, len(rows),
            QWEN_IMAGE_LLM_LAYERS, forms)

    def entry_check(cli, server):
        """The CLI's (img2img) checks on its path, the server's (txt2img) on its."""
        return lambda path, *a: (cli if path.endswith("_cli") else server)(path, *a)

    steps = QWEN_IMAGE_CLI_REQUEST["sample_steps"]
    i2i_steps = img2img_steps(steps, QWEN_IMAGE_STRENGTH)
    i2i_server = dict(QWEN_IMAGE_CLI_REQUEST, prompt=QWEN_IMAGE_SERVER_IMG2IMG_BODY["prompt"])
    img, _ = init_image_and_mask(1024)
    root = ROOT / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    images = Path(tempfile.mkdtemp(prefix="qwen_init_", dir=root))
    try:
        init = str(images / "init.png")
        write_image(init, img)
        b64 = base64.b64encode(Path(init).read_bytes()).decode("ascii")
        return _file_entry_check(
            wrappers, card, "qwen_image",
            lambda tmp: write_qwen_image_files(tmp, device=DEVICE), file_args,
            QWEN_IMAGE_CLI_ARGV + ["-i", init], QWEN_IMAGE_SERVER_BODY,
            entry_check(check(QWEN_IMAGE_CLI_REQUEST, i2i_steps), check(QWEN_IMAGE_CLI_REQUEST, steps)),
            "euler", (1024, 1024), load_check,
            request=QWEN_IMAGE_CLI_REQUEST,
            more_server=[dict(path="qwen_image_server_img2img", route="/sdapi/v1/img2img",
                              body=QWEN_IMAGE_SERVER_IMG2IMG_BODY,
                              files=lambda tmp: {"init_images": [b64]},
                              check=check(i2i_server, i2i_steps), size=(1024, 1024),
                              sampler="euler")])
    finally:
        shutil.rmtree(images, ignore_errors=True)


# Phase 10f, img2img, masked img2img and the latent hires fix: an init image
# drawn from the seed (uint8 noise) and a mask whose right half regenerates
# (255) and whose left half keeps the init image (0).
IMG2IMG_SEED = 20
# FLUX.1-dev int8 with the bench's VAE tiling (tiles of 64 latent pixels
# overlapping by 8: 512-pixel encode tiles overlapping by 64).  t_enc =
# int(4 x 0.75) = 3 keeps every sigma (the reference's cut), so all 4 steps
# sample; the masked request at 0.6 keeps the last 3.
FLUX_IMG2IMG_REQUEST = dict(prompt="a harbour at dawn, oil on canvas", width=1024, height=1024,
                            sample_steps=4, cfg_scale=1.0, guidance=3.5, seed=5, strength=0.75)
FLUX_MASK_REQUEST = dict(FLUX_IMG2IMG_REQUEST, seed=6, strength=0.6)
# The kept half of the masked request's final latent against the tiled
# encode of the init image: euler's last step (to sigma 0) lands on the
# blended estimate, which is the init latent there, up to float32 rounding;
# the regenerated half must move away from it.
MASK_KEEP_TOL = 1e-4
MASK_MOVED_MIN = 0.05
# SDXL (the full VAE, TAESD-XL detached) and SD3.5-Medium:
# a 1024² request of 4 steps at 0.6 (3 sample)
SDXL_IMG2IMG_REQUEST = dict(SDXL_REQUEST, prompt="a watercolour of a fox in a forest", strength=0.6)
SD3_IMG2IMG_REQUEST = dict(SD3_REQUEST, prompt="a watercolour of a fox in a forest", sample_steps=4,
                           strength=0.6)


def img2img_steps(steps: int, strength: float) -> int:
    """The steps an img2img request samples: t_enc = int(steps x strength),
    one fewer where that is every step, keeps t_enc + 1; at strength 1 all."""
    if strength >= 1.0:
        return steps
    t_enc = int(steps * strength)
    return t_enc - (t_enc == steps) + 1


def init_image_and_mask(size: int):
    """(init image [size, size, 3] uint8, mask [size, size] uint8)."""
    import numpy as np

    img = np.random.default_rng(IMG2IMG_SEED).integers(0, 256, (size, size, 3), dtype=np.uint8)
    mask = np.zeros((size, size), dtype=np.uint8)
    mask[:, size // 2:] = 255
    return img, mask


def _tiles(pipe, size: int) -> tuple:
    """(encode tiles, decode tiles) of a size² image under the pipeline's
    VAE tiling (1 and 1 without)."""
    from sdtpu_torch.models.tiling import _tile_starts

    if not pipe._vae_tiling:
        return 1, 1
    sf, t, o = pipe.scale_factor, pipe._vae_tile, pipe._vae_overlap
    enc = len(_tile_starts(size, t * sf, max((t - o) * sf, 1))) ** 2
    dec = len(_tile_starts(size // sf, t, max(t - o, 1))) ** 2
    return enc, dec


def _check_d512(path: str, counts: dict, want: int, plain: dict, plain_want: int = 0) -> dict:
    """Flash D 512 launched ``want`` times (once a tile of each encode and
    decode through the full VAE); ``plain_want`` plain attention calls on
    the card (T5's)."""
    got = {"flash_d512": counts["flash_attention_d512"], "plain_attention_on_card": plain["calls"]}
    if got != {"flash_d512": want, "plain_attention_on_card": plain_want}:
        raise RuntimeError(f"path {path}: {got}, not {want} D 512 launches and {plain_want} plain "
                           "attention calls on the card")
    return got


def _check_steps(path: str, rep: dict, want: int) -> None:
    if rep["steps"] != want:
        raise RuntimeError(f"path {path}: {rep['steps']} steps sampled, not {want}")


def flux_img2img_paths(pipe, wrappers, card: str, launches: dict):
    """Phase 10f on the int8 FLUX.1-dev pipeline (VAE tiling on): path
    ``img2img`` answers FLUX_IMG2IMG_REQUEST from a 1024² init image, then
    encodes the image once untiled (one D 512 call over 16384 tokens); path
    ``img2img_mask`` answers FLUX_MASK_REQUEST with the mask, whose kept
    half must be the tiled encode of the init image.  Flash D 512 launches
    once a tile of each encode and decode; no attention runs in the plain
    version on the card but T5's 24 a prompt encode."""
    import numpy as np
    import torch

    size = FLUX_IMG2IMG_REQUEST["width"]
    img, mask = init_image_and_mask(size)
    enc, dec = _tiles(pipe, size)
    info = {"encode_tiles": enc, "decode_tiles": dec}

    def run():
        rep = answer(pipe, [dict(FLUX_IMG2IMG_REQUEST, init_image=img)], card, "img2img")
        pipe.set_vae_tiling(False)
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            z = pipe.encode_image(img)  # ends in the copy to the host
            info["untiled_encode"] = {"encode_s": time.time() - t0, "shape": list(z.shape),
                                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                                      "finite": bool(np.isfinite(z).all())}
        finally:
            pipe.set_vae_tiling(True)
        return rep, z

    with plain_attention_on_card() as plain:
        (rep, untiled), launches["img2img"] = _windowed(wrappers, "img2img", run)
    encodes = _forwards_and_encodes([FLUX_IMG2IMG_REQUEST])[1]
    info["img2img"] = _check_d512("img2img", launches["img2img"], enc + dec + 1, plain,
                                  SD3_T5_LAYERS * encodes)
    _check_steps("img2img", rep[0], img2img_steps(4, FLUX_IMG2IMG_REQUEST["strength"]))
    print("untiled_encode " + json.dumps(info["untiled_encode"]), flush=True)
    results = []
    with plain_attention_on_card() as plain:
        rep2, launches["img2img_mask"] = _windowed(wrappers, "img2img_mask", lambda: answer(
            pipe, [dict(FLUX_MASK_REQUEST, init_image=img, mask_image=mask)], card, "img2img_mask",
            results))
    info["img2img_mask"] = _check_d512("img2img_mask", launches["img2img_mask"], enc + dec, plain,
                                       SD3_T5_LAYERS * encodes)
    _check_steps("img2img_mask", rep2[0], img2img_steps(4, FLUX_MASK_REQUEST["strength"]))
    init = pipe.encode_image(img)  # tiled, outside the windows
    lat = results[0].latents
    half = lat.shape[2] // 2
    info["mask"] = {"kept_max_abs": float(np.abs(lat[:, :, :half] - init[:, :, :half]).max()),
                    "tol": MASK_KEEP_TOL,
                    "moved_mean_abs": float(np.abs(lat[:, :, half:] - init[:, :, half:]).mean()),
                    "moved_min": MASK_MOVED_MIN,
                    "untiled_vs_tiled_rel_l2": _rel(torch.from_numpy(untiled), torch.from_numpy(init))}
    print("img2img_mask " + json.dumps(info["mask"]), flush=True)
    if (not info["untiled_encode"]["finite"] or info["mask"]["kept_max_abs"] > MASK_KEEP_TOL
            or info["mask"]["moved_mean_abs"] < MASK_MOVED_MIN):
        raise RuntimeError(f"masked img2img: {info['mask']}, untiled encode {info['untiled_encode']}")
    return rep + rep2, info


def sd15_hires_path(pipe, wrappers, card: str, launches: dict):
    """Phase 10f on the bf16 SD1.5 pipeline: path ``hires`` answers
    SD15_HIRES_REQUEST through ``txt2img_hires`` (512² → 1024², the latent
    upscaler at strength 0.7), flash held to ``_check_unet_family`` for the
    base's and the hires pass's UNet calls and prompt encodes and two
    decodes; a 1024² image, finite latents."""
    import numpy as np
    import torch

    from sdtpu_torch.config import GenerationParams

    gp = GenerationParams(**SD15_HIRES_REQUEST)
    hires_steps = img2img_steps(gp.sample_steps, SD15_HIRES["hires_strength"])

    def run():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = pipe.txt2img_hires(gp, **SD15_HIRES)
        wall_s = time.time() - t0
        size = int(gp.width * SD15_HIRES["hires_scale"])
        if res.images.shape != (1, size, size, 3) or not np.isfinite(res.latents).all() \
                or res.images.std() == 0:
            raise RuntimeError(f"hires: images {res.images.shape}, std {res.images.std()}")
        tm = pipe.last_timings
        rep = {"path": "hires", "size": [gp.width, gp.height], "hires_size": [size, size],
               "steps": gp.sample_steps, "hires_steps": tm["steps"], "cfg_scale": gp.cfg_scale,
               "sampler": gp.sample_method, "seed": gp.seed, "wall_s": wall_s,
               "hires_timings_s": {k: tm[k] for k in ("cond", "sample", "decode", "total")},
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "image_std": float(res.images.std()), "card": card}
        print("request " + json.dumps(rep), flush=True)
        return rep

    with plain_attention_on_card() as plain:
        rep, launches["hires"] = _windowed(wrappers, "hires", run)
    if rep["hires_steps"] != hires_steps:
        raise RuntimeError(f"hires: {rep['hires_steps']} hires steps, not {hires_steps}")
    info = _check_unet_family("hires", launches["hires"], "sd1",
                              sd15_hires_totals(gp.sample_steps, SD15_HIRES["hires_strength"]), plain)
    return [rep], info


def sd15_hires_totals(steps: int, strength: float) -> tuple:
    """``unet_calls`` of SD15_HIRES_REQUEST's hires fix at ``steps`` and
    ``strength``: the base's steps and the hires pass's, each pass's prompt
    encodes (the 1024² pass misses the prompt cache, keyed on the size),
    two decodes."""
    calls, encodes, _ = unet_calls(dict(SD15_HIRES_REQUEST, sample_steps=steps))
    return calls + img2img_steps(steps, strength), 2 * encodes, 2


# SD2.1-768-v (stabilityai/stable-diffusion-2-1: SD2_UNET_CONFIG, OpenCLIP-H,
# the SD VAE, v-prediction): 768², CFG 7 with a negative prompt, 20 euler_a
# steps answered once to warm up and once timed, then 6 heun steps (two UNet
# calls a step but the last's one); the default dtype (float32) answers 2
# heun steps
SD2_REQUEST = dict(prompt="a photograph of an astronaut riding a horse",
                   negative_prompt="blurry, low quality", width=768, height=768, sample_steps=20,
                   cfg_scale=7.0, seed=42, sample_method="euler_a", schedule="discrete")
SD2_REQUESTS = [SD2_REQUEST, SD2_REQUEST, dict(SD2_REQUEST, sample_method="heun", sample_steps=6)]
SD2_F32_REQUESTS = [dict(SD2_REQUEST, sample_method="heun", sample_steps=2)]
# The inpainting and instruct-pix2pix UNets, from an init image drawn from
# IMG2IMG_SEED whose right half the mask regenerates: SD1.5-inpainting at
# 512² x 20 euler_a steps, CFG 7, strength 1 (then the same without the init
# image), SD2-inpainting at 512² x 2, SDXL-inpainting at 1024² x 8 euler,
# CFG 5 (the full VAE, untiled); instruct-pix2pix at 512² x 20 euler_a, CFG
# 7.5 and image guidance 1.5 (three UNet calls a step) from the init image,
# SDXL's at 1024² x 2 from a reference image.
SD15_INPAINT_REQUEST = dict(prompt="a red sofa by the window", negative_prompt="blurry",
                            width=512, height=512, sample_steps=20, cfg_scale=7.0, seed=42,
                            sample_method="euler_a", strength=1.0)
SD2_INPAINT_REQUEST = dict(SD15_INPAINT_REQUEST, sample_steps=2)
SDXL_INPAINT_REQUEST = dict(SD15_INPAINT_REQUEST, width=1024, height=1024, sample_steps=8,
                            cfg_scale=5.0, sample_method="euler")
SD15_PIX2PIX_REQUEST = dict(prompt="make it a snowy winter evening", negative_prompt="",
                            width=512, height=512, sample_steps=20, cfg_scale=7.5,
                            img_cfg_scale=1.5, seed=42, sample_method="euler_a", strength=1.0)
SDXL_PIX2PIX_REQUEST = dict(SD15_PIX2PIX_REQUEST, width=1024, height=1024, sample_steps=2)


def sd2_paths(wrappers, card: str, launches: dict, profile=None):
    """Phase 10g: path ``sd2`` (bf16 SD2.1-768-v, SD2_REQUESTS) and ``sd2_f32``
    (the default dtype, SD2_F32_REQUESTS), each in its launch window, flash
    held to ``_check_unet_family``."""
    import torch

    pipes, reports, prof = [], [], {}
    for label, f32, requests in (("sd2", False, SD2_REQUESTS), ("sd2_f32", True, SD2_F32_REQUESTS)):
        pipe, info = build_unet_pipeline(card, "SD2", default_dtype=f32, v_prediction=True)
        pipes.append(info)
        with plain_attention_on_card() as plain:
            rep, launches[label] = _windowed(wrappers, label,
                                             lambda: answer(pipe, requests, card, label))
        info.update(_check_unet_family(label, launches[label], "sd2", _totals(requests), plain,
                                       f32=f32))
        reports += rep
        if profile and not f32:
            prof[label] = profile_request(pipe, SD2_REQUEST, profile, label, card)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports, prof


def concat_unet_paths(wrappers, card: str, launches: dict):
    """Phase 10g: the inpainting UNets (paths ``sd15_inpaint``, ``sd2_inpaint``,
    ``sdxl_inpaint``) and the instruct-pix2pix ones (``sd15_pix2pix``,
    ``sdxl_pix2pix``) at full width in bf16, each in its launch window, flash
    held to ``_check_unet_family`` (the VAE encodes the init image and the
    masked or edit image)."""
    import torch

    img, mask = init_image_and_mask(512)
    img_xl, mask_xl = init_image_and_mask(1024)
    runs = [
        ("sd15_inpaint", "SD1_INPAINT", "sd1", dict(inpaint=True),
         [dict(SD15_INPAINT_REQUEST, init_image=img, mask_image=mask),
          dict(SD15_INPAINT_REQUEST, mask_image=mask)]),
        ("sd2_inpaint", "SD2_INPAINT", "sd2", dict(inpaint=True),
         [dict(SD2_INPAINT_REQUEST, init_image=img, mask_image=mask)]),
        ("sdxl_inpaint", "SDXL_INPAINT", "sdxl", dict(inpaint=True),
         [dict(SDXL_INPAINT_REQUEST, init_image=img_xl, mask_image=mask_xl)]),
        ("sd15_pix2pix", "SD1_PIX2PIX", "sd1", dict(edit=True),
         [dict(SD15_PIX2PIX_REQUEST, init_image=img)]),
        ("sdxl_pix2pix", "SDXL_PIX2PIX", "sdxl", dict(edit=True),
         [dict(SDXL_PIX2PIX_REQUEST, ref_images=[img])]),
    ]
    pipes, reports = [], []
    for label, version, family, kind, requests in runs:
        pipe, info = build_unet_pipeline(card, version)
        pipes.append(info)
        with plain_attention_on_card() as plain:
            rep, launches[label] = _windowed(wrappers, label,
                                             lambda: answer(pipe, requests, card, label))
        info.update(_check_unet_family(label, launches[label], family, _totals(requests, **kind),
                                       plain))
        for r, want in zip(rep, requests):
            _check_steps(label, r, want["sample_steps"])
        reports += rep
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports


# Phase 11, SD2.1-v and the SD1.5 inpainting and pix2pix UNets on files: the
# CLI with --prediction v and heun on the SD2.1 file; -i / --mask on the
# SD1.5-inpainting file and the A1111 route's masked img2img; -r with image
# guidance on the instruct-pix2pix file (each 512², 8 steps)
SD2_CLI_REQUEST = dict(SD2_REQUEST, sample_method="heun", sample_steps=8)
SD2_CLI_ARGV = ["-p", SD2_REQUEST["prompt"], "-n", SD2_REQUEST["negative_prompt"], "-W", "768",
                "-H", "768", "--steps", "8", "--cfg-scale", "7", "-s", "42", "--prediction", "v",
                "--sampling-method", "heun"]
INPAINT_CLI_ARGV = ["-p", SD15_INPAINT_REQUEST["prompt"], "-n", "blurry", "-W", "512", "-H", "512",
                    "--steps", "8", "--cfg-scale", "7", "-s", "42"]
INPAINT_SERVER_BODY = {"prompt": SD15_INPAINT_REQUEST["prompt"], "negative_prompt": "blurry",
                       "width": 512, "height": 512, "steps": 8, "cfg_scale": 7.0, "seed": 42}
# (the server's masked request takes a prompt of its own: the txt2img
# request's prompts are in the server's prompt cache)
PIX2PIX_CLI_ARGV = ["-p", SD15_PIX2PIX_REQUEST["prompt"], "-W", "512", "-H", "512", "--steps", "8",
                    "--cfg-scale", "7.5", "--img-cfg-scale", "1.5", "-s", "42"]


def _init_and_mask_files(tmp) -> dict:
    """The 512² init image and mask as PNG files in ``tmp`` → their paths."""
    from sdtpu_torch.utils.image import write_image

    import numpy as np

    img, mask = init_image_and_mask(512)
    paths = {"init": str(Path(tmp) / "init.png"), "mask": str(Path(tmp) / "mask.png")}
    write_image(paths["init"], img)
    write_image(paths["mask"], np.repeat(mask[..., None], 3, axis=-1))
    return paths


def sd2_family_entry_check(wrappers, card: str) -> tuple:
    """Phase 11 for SD2.1-v and the SD1.5 inpainting and pix2pix UNets: the
    full-width files of ``tools/sd2_file.py`` and ``tools/sd15_file.py``
    (``in_channels`` 9 and 8) through ``cli.main -m`` (paths ``sd2_cli``,
    ``sd15_inpaint_cli``, ``sd15_pix2pix_cli``; the init image and the mask
    as PNG files) and, on the inpainting file, the A1111 txt2img route
    (``sd15_inpaint_server``), each also with the init image and the mask
    (``sd15_inpaint_cli_img2img``, ``sd15_inpaint_server_img2img``)."""
    import tempfile

    from sdtpu_torch.tools.sd2_file import write_sd2_file
    from sdtpu_torch.tools.sd15_file import write_sd15_file

    def load_check(version, denoiser):
        def check(rep):
            got = (rep["load"]["version"], type(rep["pipeline"].denoiser).__name__)
            if got != (version, denoiser):
                raise RuntimeError(f"the CLI loaded {got}, not {(version, denoiser)}")
        return check

    def write(version, in_channels=4):
        def files(tmp):
            path = tmp / f"{version}.safetensors"
            if version == "sd2":
                return write_sd2_file(path, device=DEVICE)
            return write_sd15_file(path, device=DEVICE, in_channels=in_channels)
        return files

    def model(files):
        return ["-m", files["path"]]

    img, mask = init_image_and_mask(512)
    inpaint = dict(SD15_INPAINT_REQUEST, sample_steps=8)
    png_timing = {}
    report, launches = {}, {}
    root = ROOT / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    images = Path(tempfile.mkdtemp(prefix="init_and_mask_", dir=root))
    try:
        pngs = _init_and_mask_files(images)
        report["sd2"], got = _file_entry_check(
            wrappers, card, "sd2", write("sd2"), model, SD2_CLI_ARGV, None,
            unet_check("sd2", unet_calls(SD2_CLI_REQUEST)), "heun", (768, 768),
            load_check("sd2", "CompVisVDenoiser"))
        launches.update(got)
        masked = unet_check("sd1", unet_calls(dict(inpaint, init_image=img), inpaint=True))
        report["sd15_inpaint"], got = _file_entry_check(
            wrappers, card, "sd15_inpaint", write("sd1_inpaint", 9), model, INPAINT_CLI_ARGV,
            INPAINT_SERVER_BODY, unet_check("sd1", unet_calls(inpaint, inpaint=True)), "euler_a",
            (512, 512), load_check("sd1_inpaint", "CompVisDenoiser"),
            more_cli=[dict(path="sd15_inpaint_cli_img2img", check=masked, size=(512, 512),
                           sampler="euler_a",
                           argv=INPAINT_CLI_ARGV + ["-i", pngs["init"], "--mask", pngs["mask"],
                                                    "--strength", "1.0"])],
            more_server=[dict(path="sd15_inpaint_server_img2img", route="/sdapi/v1/img2img",
                              body=dict(INPAINT_SERVER_BODY, denoising_strength=1.0,
                                        prompt="a green armchair by the window"),
                              files=lambda tmp: _init_and_mask_b64(512, png_timing),
                              check=lambda *a: {**masked(*a), **png_timing}, size=(512, 512),
                              sampler="euler_a")])
        launches.update(got)
        report["sd15_pix2pix"], got = _file_entry_check(
            wrappers, card, "sd15_pix2pix", write("sd1_pix2pix", 8), model,
            PIX2PIX_CLI_ARGV + ["-r", pngs["init"]], None,
            unet_check("sd1", unet_calls(dict(SD15_PIX2PIX_REQUEST, sample_steps=8, ref_images=[img]),
                                         edit=True)),
            "euler_a", (512, 512), load_check("sd1_pix2pix", "CompVisDenoiser"))
        launches.update(got)
    finally:
        shutil.rmtree(images, ignore_errors=True)
    return report, launches


def gguf_block_dit() -> dict:
    """Full-depth FLUX.1-dev DiT weights in the ``q8_0_gguf`` memory class,
    drawn on the card (the seed the factory gives a DiT it synthesizes)."""
    import torch

    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.weights import synthesize

    return synthesize(flux_mod.param_specs(flux_mod.FLUX_DEV_CONFIG), quant="q8_0_gguf", seed=1,
                      device=DEVICE, dtype=torch.bfloat16)


def q4_block_dit() -> dict:
    """Full-depth FLUX.1-dev DiT weights in the ``q4_0`` memory class on a
    q4_0 GGUF's group-32 block grid, drawn on the card (the DiT's seed)."""
    import torch

    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.weights import synthesize

    return synthesize(flux_mod.param_specs(flux_mod.FLUX_DEV_CONFIG), quant="q4_0", seed=1,
                      device=DEVICE, dtype=torch.bfloat16, group=Q4_DIT_GROUP)


def build_pipeline(card: str, diffusion, label: str, default_dtype: bool = False):
    """A full-width FLUX.1-dev pipeline around the given DiT params (None:
    the factory draws the int8 DiT); T5-XXL (4-bit), CLIP-L and the VAE drawn
    on the card; in bf16, or with ``default_dtype`` as a user who names no
    dtype gets it: ``create_pipeline(SDVersion.FLUX, device="cuda", seed=0)``,
    float32 (held here)."""
    import torch

    from sdtpu_torch.config import SDVersion
    from sdtpu_torch.factory import create_pipeline
    from sdtpu_torch.weights import weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if default_dtype:
        pipe = create_pipeline(SDVersion.FLUX, device=DEVICE, seed=0)
        if pipe.compute_dtype != torch.float32:
            raise RuntimeError(f"create_pipeline's default dtype is {pipe.compute_dtype}, not float32")
    else:
        pipe = create_pipeline(SDVersion.FLUX, params={"diffusion": diffusion}, dtype=torch.bfloat16,
                               device=DEVICE, seed=0)
    pipe.set_vae_tiling(True)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    wb = {"diffusion": weight_bytes(pipe.diffusion_params),
          "t5": weight_bytes(pipe.conditioner.pt), "clip_l": weight_bytes(pipe.conditioner.pl),
          "vae": weight_bytes(pipe.vae_params)}
    print(f"pipeline: full-width FLUX.1-dev, DiT {label}, built in {build_s:.2f} s on "
          f"{card}; weight bytes " + json.dumps(wb), flush=True)
    return pipe, {"diffusion": label, "dtype": str(pipe.compute_dtype), "build_s": build_s,
                  "weight_bytes": wb}


def answer(pipe, requests, card: str, label: str, results: list = None):
    """Each request through ``generate`` (an ``init_image`` / ``mask_image``
    key goes to it as such: img2img), its prompt cache emptied first so that
    a repeated prompt is encoded, timed and counted as in a fresh request:
    images and latents of the asked shape, finite, not constant; ``results`` (when given) gets each
    ``GenerationResult``."""
    import numpy as np
    import torch

    from sdtpu_torch.config import GenerationParams

    reports = []
    for kw in requests:
        kw = dict(kw)
        images = {k: kw.pop(k) for k in ("init_image", "mask_image", "ref_images") if k in kw}
        control = {k: kw.pop(k) for k in ("control_image", "control_strength") if k in kw}
        gp = GenerationParams(**{"sample_method": "euler", **kw})
        pipe._cond_cache.clear()  # every request encodes its prompts
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()
        res = pipe.generate(gp, **images, **control)
        if results is not None:
            results.append(res)
        after = torch.cuda.memory_stats()
        peak = torch.cuda.max_memory_allocated()
        img, lat = res.images, res.latents
        bc = gp.batch_count
        if img.shape != (bc, gp.height, gp.width, 3) or img.dtype != np.uint8:
            raise RuntimeError(f"image shape {img.shape} {img.dtype} for {gp.width}x{gp.height}")
        if lat.shape != (bc, gp.height // 8, gp.width // 8, pipe.latent_channels) or not np.isfinite(lat).all():
            raise RuntimeError(f"latents {lat.shape} not finite or of the wrong shape")
        if img.std() == 0 or lat.std() == 0:
            raise RuntimeError("constant image or latents")
        tm = pipe.last_timings
        rep = {"path": label, "size": [gp.width, gp.height], "batch": bc,
               "cfg_scale": gp.cfg_scale, "sampler": gp.sample_method, "steps": tm["steps"],
               "seed": gp.seed, **({"strength": gp.strength, "masked": "mask_image" in images}
                                   if images else {}),
               **({"control_strength": control.get("control_strength", 0.9)} if control else {}),
               "timings_s": {k: tm[k] for k in ("encode", "cond", "sample", "decode", "total")
                             if k in tm},
               "denoise_steps_per_s": tm["steps"] / tm["sample"], "peak_mem_bytes": peak,
               # the caching allocator during the request: cudaMalloc calls
               # and retries (each frees the cache and synchronizes)
               "new_segments": after.get("num_device_alloc", 0) - before.get("num_device_alloc", 0),
               "alloc_retries": after.get("num_alloc_retries", 0) - before.get("num_alloc_retries", 0),
               "image_std": float(img.std()), "card": card}
        print("request " + json.dumps(rep), flush=True)
        reports.append(rep)
    return reports


def profile_request(pipe, request: dict, table: str, label: str, card: str) -> dict:
    """One more request under torch.profiler: device time by kernel name, and
    the device's busy share of the request's wall time (a union of kernel
    intervals, so overlapping kernels count once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdtpu_torch.config import GenerationParams

    request = dict(request)
    frames = request.pop("frames", None)
    gp = GenerationParams(**{"sample_method": "euler", **request})
    path = Path(table)
    path = path.with_name(f"{path.stem}.{label}{path.suffix}")

    pipe._cond_cache.clear()  # the profile covers the prompt encode too
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        if frames is None:
            pipe.generate(gp)
        else:  # a video request (Wan)
            pipe.generate_video(gp, frames=frames)
        wall_s = time.time() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, spans = {}, []
    for e in kernels:
        us = e.time_range.elapsed_us()
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += us
        tot[1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    summary = {"path": label, "card": card, "size": [gp.width, gp.height], "frames": frames,
               "steps": gp.sample_steps,
               "wall_s": wall_s, "timings_s": dict(pipe.last_timings),
               "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / wall_s,
               "kernels": [{"name": n[:90], "ms": v[0] / 1e3, "count": v[1]} for n, v in top[:25]]}
    print("profile " + json.dumps(summary))
    return summary


# ------------------------------------------------------------------ sampling
# Phase 10j, the sampling layer on the card, on the bf16 pipelines its
# families' paths built (each request in its own launch window, counted
# under ``sampling_<family>``; one ``sampling`` line a request):
#   - SD1.5 (after ``hires``): each of the 13 methods ported in the sampling
#     slice once at 512², CFG 7, 6 steps of the karras schedule (eta 1, TCD
#     0.3), every model call's denoised estimates recorded on the card and
#     replayed through the same sampler on the CPU in float32 (the final
#     latent within SAMPLING_REPLAY_LIMIT relative L2 of the card's), and
#     the UNet forwards (two a step but the last for dpm2 and res_2s) held to
#     the flash launches; the 11 new eps schedules through 4 euler steps; one
#     APG request;
#   - SD3.5-Medium (after ``sd3_img2img``): the bench's 1024² request cut to
#     SD3_SLG_STEPS, with and without SLG (layers 7, 8, 9, the CLI's window
#     0.01-0.2): 37 flash calls a forward, 31 a skip-layer forward, one of
#     those a step inside the window;
#   - Wan2.1 (after ``wan``'s checks): 9 frames x 2 steps with block 9
#     skipped at step 0 (60 calls a forward, 58 the skip-layer one);
#   - Z-Image-Turbo (after ``z_image``'s checks): the 1024² x 8 request
#     uncached and under each of the five step caches (34 flash calls a
#     computed forward; the skipped forwards and the wall time beside the
#     uncached request), the flow schedules at 4 euler steps, and the flow
#     form of dpm++2s_a.
SAMPLING_METHODS = ("euler_cfg_pp", "euler_a_cfg_pp", "euler_ge", "dpm2", "dpm++2m_v2", "dpm++2m_sde",
                    "dpm++2m_sde_bt", "ipndm_v", "ddim_trailing", "tcd", "res_multistep", "res_2s",
                    "er_sde")
SAMPLING_EPS_SCHEDULES = ("karras", "exponential", "ays", "gits", "sgm_uniform", "simple", "smoothstep",
                          "bong_tangent", "kl_optimal", "lcm", "beta")
SAMPLING_FLOW_SCHEDULES = ("flux", "flux2", "sefi", "ltx2", "logit_normal")
SAMPLING_SD15_REQUEST = dict(SD15_REQUEST, prompt="a watercolour of a harbour at dawn", sample_steps=6,
                             schedule="karras", eta=1.0)
# the final latent of the card's sampler against the same sampler replayed on
# the CPU in float32 from the card's recorded denoised estimates: only the
# step arithmetic's rounding (float32 on both sides, the transcendentals'
# last bits) separates them; a wrong coefficient or a lost step is ~1e-2
SAMPLING_REPLAY_LIMIT = 1e-4
SAMPLING_APG_REQUEST = dict(SAMPLING_SD15_REQUEST, sample_method="euler", apg_eta=0.5,
                            apg_momentum=0.5, apg_norm_threshold=15.0)
SD3_SLG_STEPS = 10
SD3_SLG_LAYERS = (7, 8, 9)
SD3_SLG_REQUEST = dict(SD3_REQUEST, prompt="a lighthouse on a cliff, oil painting",
                       sample_steps=SD3_SLG_STEPS, slg_scale=2.5, skip_layers=SD3_SLG_LAYERS,
                       slg_start=0.01, slg_end=0.2)
WAN_SLG_REQUEST = dict(WAN_REQUEST, sample_steps=2, frames=WAN_CLI_FRAMES, slg_scale=2.0,
                       skip_layers=(9,), slg_start=0.0, slg_end=0.5)
# each cache's options at 8 steps (the thresholds raised so that the
# data-dependent caches skip on random weights; DBCache under the static SCM
# policy of its mask)
SAMPLING_CACHES = {"easycache": {"reuse_threshold": 1.0}, "ucache": {"threshold": 1.0},
                   "taylorseer": {}, "spectrum": {"warmup_steps": 2},
                   "cache_dit": {"max_warmup_steps": 1, "scm_mask": "1,1,0,0,1,0,1,1",
                                 "scm_policy_dynamic": False}}
for _path, _as in (("sampling_sd15", "sd15"), ("sampling_sd3", "sd3"), ("sampling_wan", "wan"),
                   ("sampling_z_image", "z_image")):
    PATH_KERNELS[_path], PATH_IDLE[_path] = PATH_KERNELS[_as], PATH_IDLE[_as]


@contextlib.contextmanager
def counted_forwards(pipe):
    """Count the diffusion forwards of ``pipe`` (a CFG batch is one; a
    skip-layer forward is counted in ``skip`` too) while the block runs."""
    import inspect

    box = {"calls": 0, "skip": 0}
    fn = pipe.diffusion_fn

    def counted(*a, **kw):
        box["calls"] += 1
        box["skip"] += bool(kw.get("skip_layers"))
        return fn(*a, **kw)

    counted.__signature__ = inspect.signature(fn)  # the pipeline reads skip_layers from it
    pipe.diffusion_fn = counted
    try:
        yield box
    finally:
        pipe.diffusion_fn = fn


@contextlib.contextmanager
def recorded_sampler():
    """Record each ``sample`` call of the pipeline: its initial latent, its
    arguments and every model call's (denoised, uncond) estimates, kept on
    the card until the loop ends, then copied to the CPU."""
    import numpy as np

    import sdtpu_torch.pipeline as pipeline_mod

    real, log = pipeline_mod.sample, []

    def spy(model_fn, x, sigmas, **kw):
        outs = []

        def recorded(xt, sigma, i):
            den, unc = model_fn(xt, sigma, i)
            outs.append((den.detach().clone(), unc.detach().clone()))
            return den, unc

        out = real(recorded, x, sigmas, **kw)
        log.append({"x": x.float().cpu(), "sigmas": np.asarray(sigmas), "kw": kw,
                    "outs": [(d.float().cpu(), u.float().cpu()) for d, u in outs],
                    "out": out.float().cpu()})
        return out

    pipeline_mod.sample = spy
    try:
        yield log
    finally:
        pipeline_mod.sample = real


def replay_on_cpu(rec: dict) -> float:
    """The recorded loop again on the CPU in float32, every model call
    answered by the card's recorded estimates → the relative L2 of the
    card's final latent from the replay's."""
    from sdtpu_torch.diffusion.samplers import sample

    outs = iter(rec["outs"])
    kw = {k: v for k, v in rec["kw"].items() if k != "step_callback"}
    got = sample(lambda xt, sigma, i: next(outs), rec["x"], rec["sigmas"], **kw)
    if next(outs, None) is not None:
        raise RuntimeError("the replay made fewer model calls than the card's loop")
    return _rel(rec["out"], got)


def sampling_request(pipe, wrappers, path: str, request: dict, card: str, check, launches: dict,
                     replay: bool = False, step_cache=None, cache_options=None) -> dict:
    """One request in its own launch window (its counts added to
    ``launches[path]``); ``check(counts, plain, forwards)`` holds the flash
    launches; ``replay``: the sampler replayed on the CPU.  → its
    ``sampling`` line."""
    import numpy as np
    import torch

    from sdtpu_torch.config import GenerationParams

    kw = dict(request)
    frames = kw.pop("frames", None)
    gp = GenerationParams(**kw)
    pipe._cond_cache.clear()  # every request encodes its prompts

    def run():
        if frames is not None:
            return pipe.generate_video(gp, frames=frames)
        return pipe.generate(gp, step_cache=step_cache, cache_options=cache_options)

    with plain_attention_on_card() as plain, counted_forwards(pipe) as fwd, \
            recorded_sampler() as log:
        res, counts = _windowed(wrappers, path, run, echo=False)
    if not np.isfinite(res.latents).all() or res.latents.std() == 0:
        raise RuntimeError(f"{path}: latents not finite or constant for {request}")
    total = launches.setdefault(path, {k: 0 for k in counts})
    for k, v in counts.items():
        total[k] += v
    tm = pipe.last_timings
    line = {"path": path, "sampler": gp.sample_method, "schedule": gp.schedule, "steps": tm["steps"],
            "size": [gp.width, gp.height], "cfg_scale": gp.cfg_scale, "eta": gp.eta,
            "forwards": fwd["calls"], "skip_layer_forwards": fwd["skip"],
            **({"frames": tm["frames"]} if frames else {}),
            **({"slg": [gp.slg_scale, list(gp.skip_layers), gp.slg_start, gp.slg_end]}
               if gp.slg_scale else {}),
            **({"apg": [gp.apg_eta, gp.apg_momentum, gp.apg_norm_threshold]}
               if gp.apg_momentum or gp.apg_eta != 1.0 else {}),
            **({"cache": step_cache, "cache_options": cache_options,
                "cache_skipped": tm["cache_skipped"]} if step_cache else {}),
            "launch_check": check(counts, plain, fwd["calls"], fwd["skip"], tm),
            "timings_s": {k: tm[k] for k in ("cond", "sample", "decode", "total")}, "card": card}
    if replay:
        line["replay_rel_l2"] = replay_on_cpu(log[0])
        line["replay_limit"] = SAMPLING_REPLAY_LIMIT
        if not line["replay_rel_l2"] <= SAMPLING_REPLAY_LIMIT:
            raise RuntimeError(f"{path} {gp.sample_method}: the card's sampler is "
                               f"{line['replay_rel_l2']:.3g} from its CPU replay")
    print("sampling " + json.dumps(line), flush=True)
    torch.cuda.empty_cache()
    return line


def _forwards_as(path: str, got: int, want: int) -> None:
    if got != want:
        raise RuntimeError(f"{path}: {got} diffusion forwards, not {want}")


# the sampling phase's lines and each part's seconds
SAMPLING = {"lines": [], "seconds": {}}


def _sampling_part(family: str, result: tuple) -> None:
    lines, seconds = result
    SAMPLING["lines"] += lines
    SAMPLING["seconds"][family] = seconds
    print(f"elapsed sampling_{family} {seconds:.1f} s", flush=True)


def sampling_sd15(pipe, wrappers, card: str, launches: dict) -> tuple:
    """SD1.5's part of the sampling phase (above) → (lines, seconds)."""
    t0 = time.time()
    path, lines = "sampling_sd15", []

    def unet(request):
        def check(counts, plain, forwards, skip, tm):
            want = unet_calls(dict(request, sample_steps=tm["steps"]))
            _forwards_as(path, forwards, want[0])
            return _check_unet_family(path, counts, "sd1", want, plain)
        return check

    for method in SAMPLING_METHODS:
        req = dict(SAMPLING_SD15_REQUEST, sample_method=method, eta=0.3 if method == "tcd" else 1.0)
        lines.append(sampling_request(pipe, wrappers, path, req, card, unet(req), launches,
                                      replay=True))
    for schedule in SAMPLING_EPS_SCHEDULES:
        req = dict(SAMPLING_SD15_REQUEST, schedule=schedule, sample_method="euler", sample_steps=4)
        lines.append(sampling_request(pipe, wrappers, path, req, card, unet(req), launches))
    lines.append(sampling_request(pipe, wrappers, path, SAMPLING_APG_REQUEST, card,
                                  unet(SAMPLING_APG_REQUEST), launches))
    return lines, time.time() - t0


def sampling_sd3(pipe, wrappers, card: str, launches: dict) -> tuple:
    """SD3.5-Medium's request without SLG, then with it (above) → (lines,
    seconds)."""
    from sdtpu_torch.diffusion.guidance import slg_active_steps

    t0 = time.time()
    path, lines = "sampling_sd3", []
    full = SD3_MMDIT_ATTENTION_CALLS[64]
    skipped = full - sum(1 + (i < 13) for i in SD3_SLG_LAYERS)  # MMDiT-X's 13 self-attentions
    for req in (dict(SD3_SLG_REQUEST, slg_scale=0.0), SD3_SLG_REQUEST):
        i0, i1 = slg_active_steps(SD3_SLG_STEPS, req["slg_start"], req["slg_end"])
        n_slg = max(i1 - i0, 0) if req["slg_scale"] else 0

        def check(counts, plain, forwards, skip, tm, n_slg=n_slg):
            _forwards_as(path, (forwards, skip), (SD3_SLG_STEPS + n_slg, n_slg))
            return {**_check_sd3_launches(path, counts, SD3_SLG_STEPS, 2, 1, plain, full,
                                          extra_calls=skipped * n_slg),
                    "calls_a_forward": full, "calls_a_skip_layer_forward": skipped,
                    "slg_window": [i0, i1]}

        lines.append(sampling_request(pipe, wrappers, path, req, card, check, launches))
    lines[1]["slg_extra_sample_s"] = lines[1]["timings_s"]["sample"] - lines[0]["timings_s"]["sample"]
    print("sampling_slg " + json.dumps({"path": path, "extra_sample_s": lines[1]["slg_extra_sample_s"],
                                        "skip_layer_forwards": lines[1]["skip_layer_forwards"],
                                        "card": card}), flush=True)
    return lines, time.time() - t0


def sampling_wan(pipe, wrappers, card: str, launches: dict) -> tuple:
    """Wan2.1's SLG request (above) → (lines, seconds)."""
    from sdtpu_torch.diffusion.guidance import slg_active_steps

    t0 = time.time()
    path, req = "sampling_wan", WAN_SLG_REQUEST
    i0, i1 = slg_active_steps(req["sample_steps"], req["slg_start"], req["slg_end"])
    skipped = WAN_ATTENTION_CALLS - 2 * len(req["skip_layers"])

    def check(counts, plain, forwards, skip, tm):
        _forwards_as(path, (forwards, skip), (req["sample_steps"] + i1 - i0, i1 - i0))
        return {**_check_wan_launches(path, counts, req["sample_steps"], 2, plain,
                                      extra_calls=skipped * (i1 - i0)),
                "calls_a_skip_layer_forward": skipped, "slg_window": [i0, i1]}

    line = sampling_request(pipe, wrappers, path, req, card, check, launches)
    return [line], time.time() - t0


def sampling_z_image(pipe, wrappers, card: str, launches: dict) -> tuple:
    """Z-Image-Turbo's step caches, flow schedules and flow dpm++2s_a
    (above) → (lines, seconds)."""
    t0 = time.time()
    path, lines = "sampling_z_image", []

    def check_dit(want_forwards):
        def check(counts, plain, forwards, skip, tm):
            want = want_forwards(tm)
            _forwards_as(path, forwards, want)
            return _check_dit_launches(path, counts, plain, want, Z_IMAGE_ATTENTION_CALLS, 1,
                                       Z_IMAGE_LLM_LAYERS,
                                       {"q4_matmul_splitk": Z_IMAGE_LLM_LINEARS}, decodes=1)
        return check

    steps = Z_IMAGE_REQUEST["sample_steps"]
    base = sampling_request(pipe, wrappers, path, Z_IMAGE_REQUEST, card,
                            check_dit(lambda tm: steps), launches)
    lines.append(base)
    for kind, options in SAMPLING_CACHES.items():
        line = sampling_request(pipe, wrappers, path, Z_IMAGE_REQUEST, card,
                                check_dit(lambda tm: steps - tm["cache_skipped"]), launches,
                                step_cache=kind, cache_options=dict(options))
        if not line["cache_skipped"]:
            raise RuntimeError(f"{path}: the {kind} cache skipped no forward")
        line["uncached_sample_s"] = base["timings_s"]["sample"]
        lines.append(line)
    for schedule in SAMPLING_FLOW_SCHEDULES:
        req = dict(Z_IMAGE_REQUEST, schedule=schedule, sample_steps=4)
        lines.append(sampling_request(pipe, wrappers, path, req, card,
                                      check_dit(lambda tm: tm["steps"]), launches))
    # the flow dpm++2s_a: one forward from sigma 1 and on the last step
    req = dict(Z_IMAGE_REQUEST, sample_method="dpm++2s_a", sample_steps=4)
    lines.append(sampling_request(pipe, wrappers, path, req, card,
                                  check_dit(lambda tm: 2 * tm["steps"] - 2), launches, replay=True))
    return lines, time.time() - t0


# ---------------------------------------------------------------------- LoRA
# Phase 12: LoRA on the paths above, with kohya LoRAs of ``LORA_RANK`` drawn
# by ``tools/lora_file.py`` over every linear (no published LoRA is used).
LORA_RANK = 16
LORA_REQUEST = dict(prompt="a watercolour lighthouse at dawn", width=1024, height=1024,
                    sample_steps=4, cfg_scale=1.0, guidance=3.5, seed=17)
LORA_CUT = LORA_BLOCK_CUT = (1, 1)  # the double and single blocks of the merges' forwards
# the dense-merge forward is also read (not held) at 2 + 2 blocks: there the
# int8 base alone is already past REF_REL_TOL from its float32 forward
LORA_DEEPER_CUT = (2, 2)
LORA_FAULT_MULT = 0.9  # a forward with the factors at this multiplier must miss REF_REL_TOL
# one linear's runtime factors against float32 ΔW on the same W8A8 product:
# the error held as a share of the LoRA's contribution, and a multiplier
# that must miss it
LORA_LINEAR_TOL, LORA_LINEAR_FAULT_MULT = 0.02, 0.95
W8A8_COUNTS = ("w8a8_matmul", "w8a8_matmul_gemv", "w8a8_matmul_splitk", "w8a8_matmul_wgmma")
LORA_STEPS_APART = 1e-3  # the share of requantized integers one step off the CPU's
LORA = {"seconds": {}}  # what the phase measured, for --out


def _lora_part(label: str, t0: float) -> None:
    LORA["seconds"][label] = time.time() - t0
    print(f"elapsed lora_{label} {LORA['seconds'][label]:.1f} s", flush=True)


def _lora_shapes(params: dict) -> dict:
    return {k: tuple(v.shape) for k, v in params.items()}


def _sync_s(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return time.time() - t0


def _steps_apart(got, want, what: str) -> float:
    """Integers (or bf16 bit patterns) equal or one step apart on at most
    ``LORA_STEPS_APART`` of the entries → that share."""
    d = (got.long().cpu() - want.long().cpu()).abs()
    share = float((d > 0).float().mean())
    if d.max() > 1 or share > LORA_STEPS_APART:
        raise RuntimeError(f"{what}: {int(d.max())} steps apart, on {share:.3g} of the entries")
    return share


def _restore_check(pipe, what: str) -> float:
    """``set_loras([])`` → its seconds; every entry an epoch had replaced is
    back, bit for bit, as its pristine copy (the base itself, or the host
    copy of a merged one), and no copy is left."""
    import torch

    from sdtpu_torch.pipeline import _tensors

    saved = dict(pipe._lora_base)
    t0 = time.time()
    pipe.set_loras([])
    seconds = _sync_s(t0)
    bad = [k for k, v in saved.items() if type(pipe.diffusion_params[k]) is not type(v)
           or not all(torch.equal(a.cpu(), b.cpu())
                      for a, b in zip(_tensors(pipe.diffusion_params[k]), _tensors(v)))]
    if bad or pipe._lora_base:
        raise RuntimeError(f"{what}: set_loras([]) left {len(bad)} weights off their pristine copy, "
                           f"{len(pipe._lora_base)} copies kept")
    return seconds


def _factor_bytes(params: dict) -> int:
    from sdtpu_torch.ops import quant

    return sum(t.numel() * t.element_size() for v in params.values()
               if isinstance(v, (quant.QuantLoraTensor, quant.LoraTensor))
               for t in (v.lora_down, v.lora_up))


def _lora_group(tensors: dict, prefix: str, name: str) -> dict:
    from sdtpu_torch.models.lora import group_lora_tensors

    return group_lora_tensors(tensors)[prefix + name[:-len(".weight")].replace(".", "_")]


def _ckpt_round_trip(tensors: dict, name: str) -> tuple:
    """The LoRA written as a torch ZIP checkpoint and read back through the
    restricted unpickler (``read_checkpoint_file``): its tensors equal → (the
    tensors read, the file's bytes and the read's seconds and rate; the
    read is warm, the file having just been written)."""
    import numpy as np

    from sdtpu_torch.io.model_loader import read_checkpoint_file
    from sdtpu_torch.tools.lora_file import write_ckpt

    root = ROOT / "build" / "chip_smoke" / "lora"
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"{name}.ckpt"
    try:
        write_ckpt(str(path), tensors)
        nbytes = path.stat().st_size
        t0 = time.time()
        read = read_checkpoint_file(str(path))
        read_s = time.time() - t0
    finally:
        path.unlink(missing_ok=True)
    # (a 0-d alpha reads back as one element, as the JAX package's reader gives it)
    if list(read) != list(tensors) or not all(
            read[k].size == v.size and np.array_equal(read[k].reshape(v.shape), v)
            for k, v in tensors.items()):
        raise RuntimeError(f"{name}.ckpt read back other tensors than were written")
    return read, {"ckpt_bytes": nbytes, "ckpt_read_s": read_s,
                  "ckpt_read_gb_per_s": nbytes / read_s / 1e9, "ckpt_read": "warm"}


def _flux_inputs(cfg, dtype, seed: int, size: int = 1024) -> tuple:
    """One FLUX forward's inputs at ``size``² (FLUX.1-dev's config: 4096
    image tokens at 1024²): the latent, sigma, T5's 256 tokens, CLIP-L's
    pooled vector, the distilled guidance."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return (torch.randn((1, size // 8, size // 8, cfg.in_channels // 4), generator=g,
                        device=DEVICE).to(dtype),
            torch.tensor([0.7], device=DEVICE),
            torch.randn((1, 256, cfg.context_in_dim), generator=g, device=DEVICE).to(dtype),
            torch.randn((1, cfg.vec_in_dim), generator=g, device=DEVICE).to(dtype),
            torch.tensor([3.5], device=DEVICE))


def _flux_cut(params: dict, cut: tuple) -> tuple:
    """The DiT's params with only its first ``cut`` double and single blocks
    (the same tensors) → (params, the config at that depth)."""
    import re

    from sdtpu_torch.models import flux as flux_mod

    def keep(n):
        m = re.match(r"(double|single)_blocks\.(\d+)\.", n)
        return m is None or int(m.group(2)) < cut[m.group(1) == "single"]

    cfg = dataclasses.replace(flux_mod.FLUX_DEV_CONFIG, depth=cut[0], depth_single=cut[1])
    return {n: v for n, v in params.items() if keep(n)}, cfg


def _merge_forward(pipe, tensors: dict, cut: tuple) -> dict:
    """The DiT cut to ``cut`` blocks at full width, with the runtime factors
    ``set_loras`` attached, through W8A8 in bf16 at 1024² (4096 image and
    256 text tokens), against the same forward in float32 on the dense
    merge: each int8 weight dequantized and ΔW (``lora_delta`` of the
    file's tensors, float32, TF32 off) added, flash in its float32 form →
    its relative L2 (``rel_l2``); the int8 base alone against its own
    float32 forward (``base_rel_l2``: the path's error without a LoRA); and
    two faults against the merge: the base without the factors
    (``no_factors``) and the factors at ``LORA_FAULT_MULT``."""
    import torch

    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.models.lora import build_lookup, group_lora_tensors, lora_delta, resolve_target
    from sdtpu_torch.ops import quant

    cut_params, cfg = _flux_cut(pipe.diffusion_params, cut)
    base = {n: pipe._lora_base.get(n, v) for n, v in cut_params.items()}
    faint = {n: v._replace(lora_up=v.lora_up * LORA_FAULT_MULT)
             if isinstance(v, quant.QuantLoraTensor) else v for n, v in cut_params.items()}
    dense = {n: quant.dequantize(v, torch.float32) if isinstance(v, quant.QuantTensor) else v.float()
             for n, v in base.items()}
    x, t, ctx, y, gd = _flux_inputs(cfg, torch.bfloat16, 29)
    with torch.inference_mode():
        want_base = flux_mod.flux_forward(dense, x.float(), t, ctx.float(), y.float(), gd, cfg=cfg)
        lookup = build_lookup({"diffusion": list(cut_params)})
        for key, g in group_lora_tensors(tensors).items():
            target = resolve_target(key, lookup)
            if target is not None:
                dense[target[1]] = dense[target[1]] + lora_delta(g, 1.0, DEVICE)
        want = flux_mod.flux_forward(dense, x.float(), t, ctx.float(), y.float(), gd, cfg=cfg)
        del dense
        got = flux_mod.flux_forward(cut_params, x, t, ctx, y, gd, cfg=cfg)
        bare = flux_mod.flux_forward(base, x, t, ctx, y, gd, cfg=cfg)
        weak = flux_mod.flux_forward(faint, x, t, ctx, y, gd, cfg=cfg)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    return {"blocks": list(cut), "finite": finite, "rel_l2": _rel(got, want),
            "base_rel_l2": _rel(bare, want_base), "no_factors": _rel(bare, want),
            f"mult_{LORA_FAULT_MULT}": _rel(weak, want)}


def _factor_linear(pipe, tensors: dict, names) -> dict:
    """Each named linear alone, with the runtime factors ``set_loras``
    attached (``ops.basic.linear``: W8A8, then the bf16 factor products),
    on one bf16 input at the 1024² path's rows (4096 image rows; 4352 for a
    single block), against the same W8A8 product of its pristine base plus
    x·ΔWᵀ in float32 (ΔW from the file's tensors by ``lora_delta``) → the
    error as a share of the LoRA's contribution ‖x·ΔWᵀ‖ (``rel``), and the
    same with the factors at ``LORA_LINEAR_FAULT_MULT`` (``fault``).  The
    base product is the same kernel on the same integers in both, so the
    error is the factors' own; a whole forward cannot show it, since a
    change that small moves W8A8's int8 activations across rounding
    edges."""
    import torch

    from sdtpu_torch.models.lora import lora_delta
    from sdtpu_torch.ops import basic, quant

    g = torch.Generator(device=DEVICE).manual_seed(37)
    out = {}
    with torch.inference_mode():
        for n in names:
            w, pristine = pipe.diffusion_params[n], pipe._lora_base[n]
            rows = 4352 if n.startswith("single_blocks.") else 4096
            x = torch.randn((rows, w.shape[1]), generator=g, device=DEVICE).to(torch.bfloat16)
            y0 = quant.quant_matmul(x, pristine).float()
            want = x.float() @ lora_delta(_lora_group(tensors, "lora_unet_", n), 1.0, DEVICE).T
            got = basic.linear(x, w).float() - y0
            weak = basic.linear(x, w._replace(lora_up=w.lora_up * LORA_LINEAR_FAULT_MULT)).float() - y0
            out[n] = {"rows": rows, "rel": _rel(got, want), "fault": _rel(weak, want),
                      "finite": bool(torch.isfinite(got).all())}
    return out


def lora_merge_forward_check(pipe, tensors: dict) -> dict:
    """The runtime factors held two ways.  ``_merge_forward`` at
    ``LORA_CUT`` blocks: within REF_REL_TOL (the FLUX path's bf16
    tolerance) of the float32 dense merge, both faults above it; the same
    read at ``LORA_DEEPER_CUT``, where the int8 base's own distance passes
    REF_REL_TOL.  ``_factor_linear`` on five linears: within
    ``LORA_LINEAR_TOL`` of the LoRA's contribution, the fault above it."""
    held = _merge_forward(pipe, tensors, LORA_CUT)
    deeper = _merge_forward(pipe, tensors, LORA_DEEPER_CUT)
    last = max(int(n.split(".")[1]) for n in pipe.diffusion_params if n.startswith("single_blocks."))
    lin = _factor_linear(pipe, tensors, ("double_blocks.0.img_attn.qkv.weight",
                                         "double_blocks.0.img_mlp.2.weight",
                                         "single_blocks.0.linear1.weight",
                                         f"single_blocks.{last}.linear2.weight",
                                         "final_layer.linear.weight"))
    faults = [held["no_factors"], held[f"mult_{LORA_FAULT_MULT}"]]
    ok_forward = held["finite"] and held["rel_l2"] <= REF_REL_TOL < min(faults)
    ok_linear = all(r["finite"] and r["rel"] <= LORA_LINEAR_TOL < r["fault"] for r in lin.values())
    out = {"forward": held, "tol": REF_REL_TOL, "deeper": deeper, "linear": lin,
           "linear_tol": LORA_LINEAR_TOL, "ok": bool(ok_forward and ok_linear)}
    print("lora_merge_forward " + json.dumps(out), flush=True)
    if not ok_forward:
        raise RuntimeError(f"the runtime-factor forward is {held['rel_l2']:.4g} from the float32 "
                           f"dense merge (limit {REF_REL_TOL}; the faults {faults})")
    if not ok_linear:
        raise RuntimeError(f"a linear's runtime factors miss x·ΔWᵀ (limit {LORA_LINEAR_TOL} of "
                           f"the contribution, the fault above it): {lin}")
    return out


def _requant_check(pipe, tensors: dict, names) -> dict:
    """Each named int8 weight that ``immediately`` requantized against its
    plain version on the CPU: the pristine base dequantized, ΔW added and
    quantized per row there → the share of integers one step off (the
    card's float32 sums run in another order), the scales within 1e-6."""
    import torch

    from sdtpu_torch.models.lora import lora_delta
    from sdtpu_torch.ops import quant

    out = {}
    for n in names:
        pristine, got = pipe._lora_base[n], pipe.diffusion_params[n]
        dense = quant.dequantize(quant.QuantTensor(pristine.q.cpu(), pristine.scale.cpu()),
                                 torch.float32)
        want = quant.quantize_per_channel(dense + lora_delta(_lora_group(tensors, "lora_unet_", n),
                                                             1.0, "cpu"))
        srel = float(((got.scale.cpu() - want.scale).abs() / want.scale).max())
        if not isinstance(got, quant.QuantTensor) or srel > 1e-6:
            raise RuntimeError(f"{n}: requantized as {type(got).__name__}, scales {srel:.3g} off")
        out[n] = {"steps_apart": _steps_apart(got.q, want.q, n), "scale_rel": srel}
    return out


def flux_lora_paths(pipe, wrappers, card: str, launches: dict) -> tuple:
    """Phase 12 on the int8 FLUX.1-dev pipeline (full width and depth, the
    bench's main path): a rank-``LORA_RANK`` kohya LoRA over every DiT
    linear, written as a torch ``.ckpt`` and read back; ``LORA_REQUEST``
    (1024² x 4) without it (``lora_none``), after ``set_loras(auto)``
    (runtime factors on every int8 base: ``lora_auto``, held by
    ``lora_merge_forward_check``; ``lora_auto_w8a16`` the same under
    SDTPU_QUANT_MODE=w8a16), after ``immediately`` (requantized per
    row: ``lora_immediately``, its integers held to the CPU's) and after
    ``set_loras([])`` (``lora_restored``: the latents bit-equal to
    ``lora_none``'s).  W8A8 launches as often in each; each epoch's seconds,
    the factors' bytes and the requests' times are recorded."""
    import numpy as np

    from sdtpu_torch.models.lora import group_lora_tensors
    from sdtpu_torch.ops import quant
    from sdtpu_torch.tools.lora_file import lora_tensors

    t_part = t0 = time.time()
    drawn = lora_tensors({"diffusion": _lora_shapes(pipe.diffusion_params)}, rank=LORA_RANK, seed=31)
    info = {"card": card, "rank": LORA_RANK, "draw_s": time.time() - t0}
    tensors, ckpt = _ckpt_round_trip(drawn, "flux_style")
    del drawn
    info.update(ckpt, groups=len(group_lora_tensors(tensors)), epoch_s={})
    reports, latents = [], {}

    def run(path):
        res = []
        rep, launches[path] = _windowed(wrappers, path, lambda: answer(
            pipe, [LORA_REQUEST], card, path, res))
        latents[path] = res[0].latents
        reports.extend(rep)

    def patched(kind):
        fresh = [v for n, v in pipe.diffusion_params.items() if v is not pipe._lora_base.get(n, v)]
        if len(fresh) != info["groups"] or not all(type(v) is kind for v in fresh):
            raise RuntimeError(f"{len(fresh)} of {info['groups']} weights patched, as "
                               f"{sorted({type(v).__name__ for v in fresh})}, not {kind.__name__}")

    run("lora_none")
    t0 = time.time()
    pipe.set_loras([(tensors, 1.0)], "auto")
    info["epoch_s"]["auto"] = _sync_s(t0)
    patched(quant.QuantLoraTensor)  # every DiT linear is int8 here
    info["factor_bytes"] = _factor_bytes(pipe.diffusion_params)
    info["merge_forward"] = lora_merge_forward_check(pipe, tensors)
    run("lora_auto")
    previous = os.environ.get("SDTPU_QUANT_MODE")
    os.environ["SDTPU_QUANT_MODE"] = "w8a16"
    try:  # the same factors beside W8A16
        run("lora_auto_w8a16")
    finally:
        if previous is None:
            del os.environ["SDTPU_QUANT_MODE"]
        else:
            os.environ["SDTPU_QUANT_MODE"] = previous
    t0 = time.time()
    pipe.set_loras([(tensors, 1.0)], "immediately")
    info["epoch_s"]["immediately"] = _sync_s(t0)
    patched(quant.QuantTensor)
    last = max(int(n.split(".")[1]) for n in pipe.diffusion_params if n.startswith("single_blocks."))
    info["requant"] = _requant_check(pipe, tensors, ("double_blocks.0.img_attn.qkv.weight",
                                                     f"single_blocks.{last}.linear2.weight",
                                                     "final_layer.linear.weight"))
    run("lora_immediately")
    info["epoch_s"]["restore"] = _restore_check(pipe, "flux")
    run("lora_restored")
    w8 = {p: [launches[p][k] for k in W8A8_COUNTS] for p in LORA_FLUX_PATHS}
    if any(c != w8["lora_none"] for c in w8.values()):
        raise RuntimeError(f"W8A8 launches differ with a LoRA: {w8}")
    if not np.array_equal(latents["lora_restored"], latents["lora_none"]):
        raise RuntimeError("the latents after set_loras([]) differ from those with no LoRA")

    def rel(a, b):
        return float(np.linalg.norm(latents[a] - latents[b]) / np.linalg.norm(latents[b]))

    info["rel_l2"] = {"auto_none": rel("lora_auto", "lora_none"),
                      "immediately_auto": rel("lora_immediately", "lora_auto")}
    if not info["rel_l2"]["immediately_auto"] < 0.5 * info["rel_l2"]["auto_none"]:
        raise RuntimeError(f"the requantized merge is not near the runtime factors: {info['rel_l2']}")
    info["requests"] = {r["path"]: {"total_s": r["timings_s"]["total"],
                                    "denoise_steps_per_s": r["denoise_steps_per_s"],
                                    "peak_mem_bytes": r["peak_mem_bytes"]} for r in reports}
    info["w8a8_launches"] = dict(zip(W8A8_COUNTS, w8["lora_none"]))
    print("lora flux " + json.dumps(info), flush=True)
    LORA["flux"] = info
    _lora_part("flux", t_part)
    return reports, info


def block_lora_check(pipe, wrappers, card: str, label: str, launches: dict) -> dict:
    """Phase 12 on the ``q4_0`` or ``q8_0_gguf`` FLUX.1-dev DiT (full width,
    cut to ``LORA_BLOCK_CUT`` blocks): a rank-``LORA_RANK`` LoRA over its
    linears merged by ``apply_lora`` (a 4-bit base requantized at group 64,
    a GGUF-block one symmetric at its group), two weights' integers and
    scales held to their plain version on the CPU, then one 1024² forward
    through the 4-bit or group-dequant kernels (path ``lora_<label>``)
    against the same forward with every quantized linear in its plain
    version (REF_REL_TOL)."""
    import torch

    from sdtpu_torch.models import flux as flux_mod
    from sdtpu_torch.models.lora import apply_lora, lora_delta
    from sdtpu_torch.ops import quant
    from sdtpu_torch.tools.lora_file import lora_tensors

    t_part = time.time()
    cut, cfg = _flux_cut(pipe.diffusion_params, LORA_BLOCK_CUT)
    tensors = lora_tensors({"diffusion": _lora_shapes(cut)}, rank=LORA_RANK, seed=37)
    work = dict(cut)
    t0 = time.time()
    applied, total = apply_lora({"diffusion": work}, tensors, 1.0, mode="auto")
    merge_s = _sync_s(t0)
    if applied != total:
        raise RuntimeError(f"{label}: {applied} of {total} LoRA groups applied")
    blocks = [n for n, v in cut.items() if isinstance(v, (quant.Q4Tensor, quant.GroupQuantTensor))]
    for n in blocks:
        old, new = cut[n], work[n]
        group = quant.Q4_GROUP if isinstance(old, quant.Q4Tensor) else old.group
        if type(new) is not type(old) or new.group != group or getattr(new, "zero", None) is not None:
            raise RuntimeError(f"{label}/{n}: merged into {type(new).__name__} g{new.group}")
    checked = {}
    for n in ("double_blocks.0.img_mlp.0.weight", "single_blocks.0.linear1.weight"):
        old, new = cut[n], work[n]
        delta = lora_delta(_lora_group(tensors, "lora_unet_", n), 1.0, "cpu")
        if isinstance(old, quant.Q4Tensor):
            host = dataclasses.replace(old, packed=old.packed.cpu(), scale=old.scale.cpu())
            want = quant.quantize_q4(quant.dequantize_q4(host, torch.float32) + delta)
            nib = [torch.stack([p & 0xF, p >> 4], -1) for p in (new.packed, want.packed)]
            share = _steps_apart(nib[0], nib[1], n)
        else:
            host = dataclasses.replace(old, q=old.q.cpu(), scale=old.scale.cpu())
            want = quant.quantize_group(quant.dequantize_group(host, torch.float32) + delta,
                                        group=old.group)
            share = _steps_apart(new.q, want.q, n)
        srel = float(((new.scale.cpu() - want.scale).abs() / want.scale).max())
        if srel > 1e-6:
            raise RuntimeError(f"{label}/{n}: the requantized scales are {srel:.3g} off the CPU's")
        checked[n] = {"steps_apart": share, "scale_rel": srel}
    x, t, ctx, y, gd = _flux_inputs(cfg, torch.bfloat16, 41)
    path = f"lora_{label}"
    with torch.inference_mode():
        got, launches[path] = _windowed(wrappers, path, lambda: flux_mod.flux_forward(
            work, x, t, ctx, y, gd, cfg=cfg))
        with plain_quant_linears():
            want = flux_mod.flux_forward(work, x, t, ctx, y, gd, cfg=cfg)
    rel = _rel(got, want)
    ok = bool(torch.isfinite(got).all() and torch.isfinite(want).all() and rel <= REF_REL_TOL)
    out = {"card": card, "blocks": list(LORA_BLOCK_CUT), "applied": applied, "merge_s": merge_s,
           "requantized": len(blocks), "requant": checked, "rel_l2": rel, "tol": REF_REL_TOL,
           "ok": ok}
    print(f"lora {label} " + json.dumps(out), flush=True)
    if not ok:
        raise RuntimeError(f"{path}: the merged forward is {rel:.4g} from its plain version")
    LORA[label] = out
    _lora_part(label, t_part)
    return out


def sdxl_lora_epochs(pipe, card: str) -> dict:
    """Phase 12 on the dense bf16 SDXL pipeline: a rank-``LORA_RANK`` LoRA
    over every UNet linear through ``set_loras`` in each mode (``auto`` and
    ``immediately`` merge, ``at_runtime`` attaches ``LoraTensor`` factors),
    then ``[]``: each epoch's seconds; one merged weight held to its plain
    merge on the CPU (bf16 steps); the restore puts the pristine weights
    back (``_restore_check``)."""
    import torch

    from sdtpu_torch.models.lora import group_lora_tensors, lora_delta
    from sdtpu_torch.tools.lora_file import lora_tensors

    t_part = time.time()
    tensors = lora_tensors({"diffusion": _lora_shapes(pipe.diffusion_params)}, rank=LORA_RANK,
                           seed=43)
    groups = len(group_lora_tensors(tensors))
    name = next(n for n in sorted(pipe.diffusion_params) if n.endswith("attn1.to_q.weight"))
    out = {"card": card, "groups": groups, "epoch_s": {}}
    for mode in ("auto", "immediately", "at_runtime"):
        t0 = time.time()
        pipe.set_loras([(tensors, 1.0)], mode)
        out["epoch_s"][mode] = _sync_s(t0)
        fresh = [n for n, v in pipe.diffusion_params.items() if v is not pipe._lora_base.get(n, v)]
        if len(fresh) != groups:
            raise RuntimeError(f"sdxl {mode}: {len(fresh)} of {groups} weights patched")
        if mode == "at_runtime":
            out["factor_bytes"] = _factor_bytes(pipe.diffusion_params)
            continue
        want = (pipe._lora_base[name].cpu().float()
                + lora_delta(_lora_group(tensors, "lora_unet_", name), 1.0, "cpu")).to(torch.bfloat16)
        out[f"{mode}_steps_apart"] = _steps_apart(pipe.diffusion_params[name].view(torch.int16),
                                                  want.view(torch.int16), name)
    out["epoch_s"]["restore"] = _restore_check(pipe, "sdxl")
    print("lora sdxl " + json.dumps(out), flush=True)
    LORA["sdxl"] = out
    _lora_part("sdxl", t_part)
    return out


def hint_image(size: int):
    """A [size, size, 3] uint8 picture with edges (a disc and two bars over
    faint noise), the control image ``canny`` turns into the hint."""
    import numpy as np

    rng = np.random.default_rng(IMG2IMG_SEED)
    yy, xx = np.mgrid[:size, :size]
    img = (rng.random((size, size, 3)) * 40).astype(np.uint8)
    img[(yy - size / 2) ** 2 + (xx - size / 3) ** 2 < (size / 5) ** 2] = (220, 180, 40)
    img[size // 6:size // 4, :] = (20, 200, 240)
    img[:, 3 * size // 4:4 * size // 5] = (240, 60, 60)
    return img


def tiny_unet_paths(wrappers, card: str, launches: dict):
    """Phase 13a: the tiny UNets at full width, random dense weights on the
    card: SDXS-0.9 (paths ``sdxs09``: SDXS09_REQUEST, ``sdxs09_cfg``:
    SDXS09_CFG_REQUEST, and ``sdxs09_f32``: SDXS09_REQUEST in the default
    float32), SD1 tiny (``sd1_tiny``), SD2 tiny (``sd2_tiny``) and
    SDXS-512-DS (``sdxs512``) at TINY_REQUEST, each in its launch window,
    flash held to ``_check_unet_family`` (TINY_ATTENTION_CALLS: SDXS-0.9's
    D 320 six times a forward)."""
    import torch

    runs = [("SDXS_09", False, [("sdxs09", [SDXS09_REQUEST]), ("sdxs09_cfg", [SDXS09_CFG_REQUEST])]),
            ("SDXS_09", True, [("sdxs09_f32", [SDXS09_REQUEST])]),
            ("SD1_TINY_UNET", False, [("sd1_tiny", [TINY_REQUEST])]),
            ("SD2_TINY_UNET", False, [("sd2_tiny", [TINY_REQUEST])]),
            ("SDXS_512_DS", False, [("sdxs512", [TINY_REQUEST])])]
    pipes, reports = [], []
    for version, f32, paths in runs:
        pipe, info = build_unet_pipeline(card, version, default_dtype=f32)
        pipes.append(info)
        for label, requests in paths:
            with plain_attention_on_card() as plain:
                rep, launches[label] = _windowed(wrappers, label,
                                                 lambda: answer(pipe, requests, card, label))
            info[label] = _check_unet_family(label, launches[label], version.lower(),
                                             _totals(requests), plain, f32=f32)
            reports += rep
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports


def controlled_forward_plain_check(pipe, hint, label: str) -> dict:
    """One full-width controlled UNet forward at the request's shapes (CFG 1:
    a batch of one, the latent of the hint's size, a 77-token context; SDXL
    with its vector): the ControlNet's residuals and the UNet through the
    kernels, against the same forward with every attention in the plain
    version on the card (bf16 both: REF_REL_TOL).  The fault, the plain side
    without the ControlNet's residuals, must read above the limit."""
    import torch

    from sdtpu_torch.models import unet as unet_mod
    from sdtpu_torch.ops.flash_attention import plain_attention

    g = torch.Generator(device=DEVICE).manual_seed(29)
    dt = pipe.compute_dtype
    h, w = hint.shape[:2]
    x = torch.randn((1, h // 8, w // 8, 4), generator=g, device=DEVICE, dtype=dt)
    t = torch.tensor([499.0], device=DEVICE)
    cn = pipe.controlnet_params
    ctx_w = next(v.shape[1] for k, v in cn.items() if k.endswith("attn2.to_k.weight"))
    ctx = torch.randn((1, 77, ctx_w), generator=g, device=DEVICE, dtype=dt)
    y = (torch.randn((1, cn["label_emb.0.0.weight"].shape[1]), generator=g, device=DEVICE, dtype=dt)
         if "label_emb.0.0.weight" in cn else None)
    hint_t = torch.from_numpy(hint.astype("float32") / 255.0)[None].to(DEVICE, dt)

    def forward(controlled: bool):
        controls = pipe.controlnet_fn(cn, x, hint_t, t, ctx, y) if controlled else None
        return pipe.diffusion_fn(pipe.diffusion_params, x, t, ctx, y, controls=controls,
                                 control_strength=CONTROL_STRENGTH)

    with torch.inference_mode():
        got = forward(True)
        kernel_attention = unet_mod.attention
        unet_mod.attention = lambda q, k, v, mask=None: plain_attention(q, k, v, mask=mask)
        try:
            want = forward(True)
            fault = _rel(forward(False), want)
        finally:
            unet_mod.attention = kernel_attention
    rel = _rel(got, want)
    ok = bool(torch.isfinite(got).all() and torch.isfinite(want).all() and rel <= REF_REL_TOL < fault)
    out = {"rel_l2": rel, "tol": REF_REL_TOL, "no_controls": fault, "ok": ok, "shape": list(got.shape)}
    print(f"{label}_forward_plain " + json.dumps(out), flush=True)
    if not ok:
        raise RuntimeError(f"path {label}: the controlled UNet forward is {rel:.4g} from the one with "
                           f"plain attention (limit {REF_REL_TOL}; without the ControlNet it reads "
                           f"{fault:.4g})")
    return out


def controlnet_paths(wrappers, card: str, launches: dict):
    """Phase 13b: ControlNet on SD1.5 (path ``sd15_controlnet``,
    SD15_CN_REQUEST) and on SDXL (``sdxl_controlnet``, SDXL_CN_REQUEST) at
    full width, the UNet and the ControlNet (``tools/controlnet_file.py``'s
    specs: its taps drawn non-zero) random dense on the card, the hint the
    canny edges of ``hint_image``; flash held to ``_check_unet_family``
    (the UNet's and the ControlNet's calls a step), then one controlled
    forward against plain attention (``controlled_forward_plain_check``)."""
    import torch

    from sdtpu_torch.config import SDVersion
    from sdtpu_torch.diffusion.preprocessing import canny
    from sdtpu_torch.factory import unet_config_for
    from sdtpu_torch.tools.controlnet_file import file_specs
    from sdtpu_torch.weights import synthesize, weight_bytes

    pipes, reports = [], []
    for label, version, family, request in (("sd15_controlnet", "SD1", "sd1_controlnet", SD15_CN_REQUEST),
                                            ("sdxl_controlnet", "SDXL", "sdxl_controlnet", SDXL_CN_REQUEST)):
        pipe, info = build_unet_pipeline(card, version)
        cn = synthesize(file_specs(unet_config_for(getattr(SDVersion, version))), seed=CONTROLNET_SEED,
                        device=DEVICE, dtype=pipe.compute_dtype)
        pipe.set_controlnet(cn)
        info["weight_bytes"]["controlnet"] = weight_bytes(cn)
        pipes.append(info)
        t0 = time.time()
        hint = canny(hint_image(request["width"]))
        info["canny_s"] = time.time() - t0
        requests = [dict(request, control_image=hint, control_strength=CONTROL_STRENGTH)]
        with plain_attention_on_card() as plain:
            rep, launches[label] = _windowed(wrappers, label, lambda: answer(pipe, requests, card, label))
        info[label] = _check_unet_family(label, launches[label], family, _totals(requests), plain)
        info["forward_plain"] = controlled_forward_plain_check(pipe, hint, label)
        reports += rep
        del pipe, cn
        gc.collect()
        torch.cuda.empty_cache()
    return pipes, reports


def _same_tensors(label: str, a: dict, b: dict) -> int:
    """Two loaded module dicts hold the same names and, bit for bit, the
    same values → the tensor count."""
    import numpy as np

    if sorted(a) != sorted(b):
        raise RuntimeError(f"{label}: the diffusers file loads {len(a)} names, the original "
                           f"{len(b)}; {sorted(set(a) ^ set(b))[:5]} differ")
    bad = [k for k in a if not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))]
    if bad:
        raise RuntimeError(f"{label}: {len(bad)} tensors differ between the namings, e.g. {bad[:3]}")
    return len(a)


def diffusers_entry_check(wrappers, card: str) -> tuple:
    """Phase 13c, files under diffusers names, written under the build
    directory (deleted after): the SD1.5 UNet (``tools/sd15_file.py``), the
    SD1.5 ControlNet (``tools/controlnet_file.py``), SD3.5-Medium's MMDiT cut
    to SD3_FILE_DEPTH blocks (``tools/sd3_file.py``) and the Wan 2.1 VAE with
    its encoder (``tools/wan_file.py``, beside a Wan DiT cut to two
    blocks), each also under its original names from the same seed: each
    diffusers file loads (``load_model_bundle`` / ``load_controlnet``) to
    the original's tensors, bit for bit.  Then ``cli.main`` answers
    SD15_CN_CLI_ARGV with ``--diffusion-model`` the diffusers UNet,
    ``--clip_l`` / ``--vae`` files, ``--control-net`` the diffusers
    ControlNet, ``--control-image`` a PNG of ``hint_image`` and ``--canny``
    (path ``sd15_controlnet_cli``, held to ``_check_unet_family``)."""
    import tempfile

    import torch

    from sdtpu_torch import cli
    from sdtpu_torch.io.model_loader import load_controlnet, load_model_bundle
    from sdtpu_torch.models import clip as clip_mod
    from sdtpu_torch.models import vae as vae_mod
    from sdtpu_torch.tools import controlnet_file, sd3_file, sd15_file, wan_file
    from sdtpu_torch.tools.flux_files import _Draw, write_safetensors
    from sdtpu_torch.utils.image import write_image

    root = ROOT / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="diffusers_files_", dir=root))
    report, launches = {"card": card}, {}
    try:
        t0 = time.time()
        files = {"sd15_unet": sd15_file.write_unet_files(tmp, device=DEVICE),
                 "controlnet": controlnet_file.write_controlnet_files(tmp, device=DEVICE),
                 "sd3_mmdit": sd3_file.write_mmdit_files(tmp, device=DEVICE, depth=SD3_FILE_DEPTH),
                 "wan_vae": wan_file.write_vae_files(tmp, device=DEVICE)}
        clip_path, vae_path = tmp / "clip_l.safetensors", tmp / "sd_vae.safetensors"
        write_safetensors(clip_path, clip_mod.param_specs(clip_mod.CLIP_L_CONFIG), _Draw(1, DEVICE),
                          torch.float16)
        write_safetensors(vae_path, vae_mod.vae_specs(vae_mod.SD_VAE_CONFIG), _Draw(2, DEVICE),
                          torch.float16)
        report["write_s"] = time.time() - t0
        report["files"] = {k: {"bytes": v["bytes"], "tensors": v["tensors"]} for k, v in files.items()}
        t0 = time.time()
        loads = {}
        for key, module, kw in (("sd15_unet", "diffusion", lambda p: dict(diffusion_model_path=p)),
                                ("sd3_mmdit", "diffusion", lambda p: dict(diffusion_model_path=p)),
                                ("wan_vae", "vae", lambda p: dict(
                                    diffusion_model_path=files["wan_vae"]["paths"]["dit"], vae_path=p))):
            paths = files[key]["paths"]
            got = load_model_bundle(**kw(paths["diffusers"]))
            want = load_model_bundle(**kw(paths["original"]))
            if got.version != want.version:
                raise RuntimeError(f"{key}: the diffusers file fingerprints as {got.version.value}, "
                                   f"the original as {want.version.value}")
            loads[key] = {"version": got.version.value,
                          "tensors": _same_tensors(key, getattr(got, module), getattr(want, module))}
            del got, want
        cn_paths = files["controlnet"]["paths"]
        loads["controlnet"] = {"tensors": _same_tensors("controlnet", load_controlnet(cn_paths["diffusers"]),
                                                        load_controlnet(cn_paths["original"]))}
        report["load_s"] = time.time() - t0
        report["loads"] = loads
        print(f"entry diffusers files on {card}: " + json.dumps(report), flush=True)
        hint_path, png, cli_rep = tmp / "control.png", tmp / "sd15_controlnet_cli.png", {}
        write_image(str(hint_path), hint_image(512))
        argv = ["--diffusion-model", files["sd15_unet"]["paths"]["diffusers"], "--clip_l", str(clip_path),
                "--vae", str(vae_path), "--control-net", cn_paths["diffusers"], "--control-image",
                str(hint_path), "--canny", *SD15_CN_CLI_ARGV, "-o", str(png)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with plain_attention_on_card() as plain:
            rc, launches["sd15_controlnet_cli"] = _windowed(
                wrappers, "sd15_controlnet_cli", lambda: cli.main(argv, report=cli_rep))
        wall_s = time.time() - t0
        if rc != 0 or cli_rep["load"]["version"] != "sd1":
            raise RuntimeError(f"sdtpu_torch.cli.main on the diffusers files exited {rc}")
        if cli_rep["pipeline"].controlnet_params is None:
            raise RuntimeError("the CLI answered without its ControlNet")
        report["cli"] = {"load": cli_rep["load"], "wall_s": wall_s, "timings_s": cli_rep["timings"],
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         **_check_unet_family("sd15_controlnet_cli", launches["sd15_controlnet_cli"],
                                              "sd1_controlnet", unet_calls(SD15_CN_CLI_REQUEST), plain),
                         **_check_png(png.read_bytes(), 512, 512, "euler_a")}
        print("entry sd15_controlnet cli " + json.dumps(report["cli"]), flush=True)
        del cli_rep
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report, launches


def launch_counters() -> dict:
    """Each kernel's launch counter: name → (wrapper, attribute); the D 512
    kernel, the wgmma forms, the GEMVs, the split-K forms, the float32 forms
    (and the affine mma.sync form) are counted apart by their wrappers."""
    from sdtpu_torch.ops import flash_attention, quant

    wrappers = {"flash_attention": (flash_attention.flash_attention, "launches"),
                "flash_attention_d512": (flash_attention.flash_attention, "launches_d512"),
                "flash_attention_d64": (flash_attention.flash_attention, "launches_d64"),
                "flash_attention_d40": (flash_attention.flash_attention, "launches_d40"),
                "flash_attention_d80": (flash_attention.flash_attention, "launches_d80"),
                "flash_attention_d160": (flash_attention.flash_attention, "launches_d160"),
                D320: (flash_attention.flash_attention, "launches_d320"),
                "w8a8_matmul_gemv": (quant.quant_matmul_w8a8, "launches_gemv"),
                "w8a8_matmul_splitk": (quant.quant_matmul_w8a8, "launches_splitk"),
                "w8a8_matmul_wgmma": (quant.quant_matmul_w8a8, "launches_wgmma"),
                "q4_matmul_wgmma": (quant.q4_matmul, "launches_wgmma"),
                "q4_matmul_gemv": (quant.q4_matmul, "launches_gemv"),
                "q4_matmul_splitk": (quant.q4_matmul, "launches_splitk"),
                "gq_matmul_gemv": (quant.gq_matmul, "launches_gemv"),
                "gq_matmul_splitk": (quant.gq_matmul, "launches_splitk"),
                "gq_matmul_wgmma": (quant.gq_matmul, "launches_wgmma"),
                "gq_zero_matmul_mma": (quant.gq_zero_matmul, "launches_mma"),
                "w8a16_matmul_gemv": (quant.w8a16_matmul, "launches_gemv"),
                "w8a16_matmul_splitk": (quant.w8a16_matmul, "launches_splitk"),
                "w8a16_matmul_wgmma": (quant.w8a16_matmul, "launches_wgmma"),
                "flash_attention_f32": (flash_attention.flash_attention, "launches_f32"),
                "q4_matmul_f32": (quant.q4_matmul, "launches_f32"),
                "w8a16_matmul_f32": (quant.w8a16_matmul, "launches_f32"),
                "gq_matmul_f32": (quant.gq_matmul, "launches_f32"),
                "gq_zero_matmul_f32": (quant.gq_zero_matmul, "launches_f32")}
    for name, fn in (("w8a8_matmul", quant.quant_matmul_w8a8), ("q4_matmul", quant.q4_matmul),
                     ("gq_matmul", quant.gq_matmul), ("gq_matmul_ws", quant.gq_matmul_ws),
                     ("gq_zero_matmul", quant.gq_zero_matmul), ("w8a16_matmul", quant.w8a16_matmul)):
        wrappers[name] = (fn, "launches")
    return wrappers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measured number to this JSON file")
    ap.add_argument("--profile", metavar="TABLE",
                    help="after each main path, profile one more request (1024² for FLUX, "
                         "SDXL, SD3, Z-Image and Qwen-Image, 512² for SD1.5, 768² for SD2.1, the bench's "
                         "832x480 x 33-frame clip for Wan) and write the profiler's tables to "
                         "TABLE with .int8 / .w8a16 / .q8_0_gguf / .q4_0 / .f32 / .cli / .sd15 / "
                         ".sdxl / .sd3 / .wan / .z_image / .qwen_image / .sd2 before its "
                         "suffix")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
          "TF32 off for matmul and cuDNN")

    from sdtpu_torch.ops import _build, flash_attention, quant

    elapsed, t_start = {}, time.time()

    def lap(phase: str) -> None:
        """The script's seconds so far, at the end of ``phase``."""
        elapsed[phase] = time.time() - t_start
        print(f"elapsed {phase} {elapsed[phase]:.1f} s", flush=True)

    t0 = time.time()
    _build.library()
    build_s = time.time() - t0
    print(f"build: {build_s:.1f} s → {_build.build_dir()}")
    spills = [ln for ln in (_build.build_dir() / "build.log").read_text().splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    print(f"ptxas: {len(spills)} kernel(s) with a stack frame or spills" + "".join(
        "\n  " + ln.strip() for ln in spills))

    if args.out:
        shutil.copy(_build.build_dir() / "build.log", Path(args.out).with_suffix(".build.log"))

    cases = []
    check_w8a8(cases)
    check_flash(cases)
    check_q4(cases)
    check_group_quant(cases)
    check_w8a16(cases)
    check_int8_splitk(cases)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"{len(bad)} kernel case(s) disagree with the plain version: {bad}")
    lap("kernel cases")

    ref = reference_check()
    print("reference " + json.dumps(ref), flush=True)
    if not all(r["ok"] for rs in ref.values() for r in rs.values()):
        raise RuntimeError(f"small-input reference check failed: {ref}")

    wrappers = launch_counters()
    launches = {}
    loader, launches["gguf_loader"], launches["gguf_file"] = loader_check(wrappers, card)
    lap("reference and loader")

    pipes, reports = [], []
    pipe, info = build_pipeline(card, None, "q8_0")
    pipes.append(info)
    rep, launches["int8"] = _windowed(wrappers, "int8",
                                      lambda: answer(pipe, INT8_REQUESTS, card, "int8"))
    _check_m1_linears("int8", launches["int8"]["w8a8_matmul_gemv"],
                      launches["int8"]["w8a8_matmul_splitk"], INT8_REQUESTS)
    reports += rep
    prof = {}
    if args.profile:
        prof["int8"] = profile_request(pipe, INT8_REQUESTS[-1], args.profile, "int8", card)
    previous = os.environ.get("SDTPU_QUANT_MODE")
    os.environ["SDTPU_QUANT_MODE"] = "w8a16"
    try:
        rep, launches["w8a16"] = _windowed(wrappers, "w8a16",
                                           lambda: answer(pipe, W8A16_REQUESTS, card, "w8a16"))
        _check_m1_linears("w8a16", launches["w8a16"]["w8a16_matmul_gemv"],
                          launches["w8a16"]["w8a16_matmul_splitk"], W8A16_REQUESTS)
        if args.profile:
            prof["w8a16"] = profile_request(pipe, W8A16_REQUESTS[-1], args.profile, "w8a16", card)
    finally:
        if previous is None:
            del os.environ["SDTPU_QUANT_MODE"]
        else:
            os.environ["SDTPU_QUANT_MODE"] = previous
    reports += rep
    rep, pipes[-1]["img2img"] = flux_img2img_paths(pipe, wrappers, card, launches)
    reports += rep
    rep, pipes[-1]["lora"] = flux_lora_paths(pipe, wrappers, card, launches)
    reports += rep
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    pipe, info = build_pipeline(card, gguf_block_dit(), "q8_0_gguf")
    pipes.append(info)
    rep, launches["q8_0_gguf"] = _windowed(wrappers, "q8_0_gguf",
                                           lambda: answer(pipe, GGUF_REQUESTS, card, "q8_0_gguf"))
    _check_m1_linears("q8_0_gguf", launches["q8_0_gguf"]["gq_matmul_gemv"],
                      launches["q8_0_gguf"]["gq_matmul_splitk"], GGUF_REQUESTS)
    reports += rep
    if args.profile:
        prof["q8_0_gguf"] = profile_request(pipe, GGUF_REQUESTS[-1], args.profile, "q8_0_gguf",
                                            card)
    pipes[-1]["lora"] = block_lora_check(pipe, wrappers, card, "q8_0_gguf", launches)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    pipe, info = build_pipeline(card, q4_block_dit(), f"q4_0 g{Q4_DIT_GROUP}")
    pipes.append(info)
    rep, launches["q4_0"] = _windowed(wrappers, "q4_0",
                                      lambda: answer(pipe, GGUF_REQUESTS, card, "q4_0"))
    reports += rep
    q4c = launches["q4_0"]
    _check_m1_linears("q4_0", q4c["q4_matmul_gemv"], q4c["q4_matmul_splitk"], GGUF_REQUESTS)
    if args.profile:
        prof["q4_0"] = profile_request(pipe, GGUF_REQUESTS[-1], args.profile, "q4_0", card)
    pipes[-1]["lora"] = block_lora_check(pipe, wrappers, card, "q4_0", launches)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    pipe, info = build_pipeline(card, None, "q8_0", default_dtype=True)
    pipes.append(info)
    rep, launches["f32"] = _windowed(wrappers, "f32",
                                     lambda: answer(pipe, F32_REQUESTS, card, "f32"))
    _check_m1_linears("f32", launches["f32"]["w8a8_matmul_gemv"],
                      launches["f32"]["w8a8_matmul_splitk"], F32_REQUESTS)
    reports += rep
    if args.profile:
        prof["f32"] = profile_request(pipe, F32_REQUESTS[-1], args.profile, "f32", card)
    os.environ["SDTPU_QUANT_MODE"] = "w8a16"
    try:
        rep, launches["f32_w8a16"] = _windowed(
            wrappers, "f32_w8a16", lambda: answer(pipe, F32_W8A16_REQUESTS, card, "f32_w8a16"))
    finally:
        if previous is None:
            del os.environ["SDTPU_QUANT_MODE"]
        else:
            os.environ["SDTPU_QUANT_MODE"] = previous
    reports += rep
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    lap("flux paths")
    sd15_pipes, rep, sd15_prof = sd15_paths(wrappers, card, launches, args.profile)
    pipes += sd15_pipes
    reports += rep
    prof.update(sd15_prof)
    sdxl_pipes, rep, sdxl_prof = sdxl_paths(wrappers, card, launches, args.profile)
    pipes += sdxl_pipes
    reports += rep
    prof.update(sdxl_prof)
    sdxl_q_pipes, rep = sdxl_quant_paths(wrappers, card, launches)
    pipes += sdxl_q_pipes
    reports += rep
    lap("int8 sdxl paths")
    sd3_pipes, rep, sd3_prof = sd3_paths(wrappers, card, launches, args.profile)
    pipes += sd3_pipes
    reports += rep
    prof.update(sd3_prof)
    wan_pipes, rep, wan_prof, wan_extra = wan_paths(wrappers, card, launches, args.profile)
    pipes += wan_pipes
    reports += rep
    prof.update(wan_prof)
    zi_pipes, rep, zi_prof, zi_extra = z_image_paths(wrappers, card, launches, args.profile)
    pipes += zi_pipes
    reports += rep
    prof.update(zi_prof)
    lap("sd3, wan and z_image paths")
    qi_pipes, rep, qi_prof, qi_extra = qwen_image_paths(wrappers, card, launches, args.profile)
    pipes += qi_pipes
    reports += rep
    prof.update(qi_prof)
    lap("qwen_image paths")
    sd2_pipes, rep, sd2_prof = sd2_paths(wrappers, card, launches, args.profile)
    pipes += sd2_pipes
    reports += rep
    prof.update(sd2_prof)
    concat_pipes, rep = concat_unet_paths(wrappers, card, launches)
    pipes += concat_pipes
    reports += rep
    lap("sd2, inpainting and pix2pix paths")

    entry, launches["cli"], launches["server"], launches["cli_img2img"] = entry_points_check(
        wrappers, card, args.profile)
    if "profile" in entry:
        prof["cli"] = entry.pop("profile")
    lap("flux entry points")
    entry["sd15"], sd15_launches = sd15_entry_check(wrappers, card)
    launches.update(sd15_launches)
    entry["sdxl"], sdxl_launches = sdxl_entry_check(wrappers, card)
    launches.update(sdxl_launches)
    entry["sd3"], sd3_launches = sd3_entry_check(wrappers, card)
    launches.update(sd3_launches)
    entry["wan"], wan_launches = wan_entry_check(wrappers, card)
    launches.update(wan_launches)
    entry["z_image"], zi_launches = z_image_entry_check(wrappers, card)
    launches.update(zi_launches)
    lap("sd15, sdxl, sd3, wan and z_image entry points")
    entry["qwen_image"], qi_launches = qwen_image_entry_check(wrappers, card)
    launches.update(qi_launches)
    lap("qwen_image entry points")
    entry["sd2_family"], sd2_launches = sd2_family_entry_check(wrappers, card)
    launches.update(sd2_launches)
    lap("sd2, inpainting and pix2pix entry points")
    tiny_pipes, rep = tiny_unet_paths(wrappers, card, launches)
    pipes += tiny_pipes
    reports += rep
    lap("tiny unet paths")
    cn_pipes, rep = controlnet_paths(wrappers, card, launches)
    pipes += cn_pipes
    reports += rep
    lap("controlnet paths")
    entry["diffusers"], diffusers_launches = diffusers_entry_check(wrappers, card)
    launches.update(diffusers_launches)
    lap("diffusers-named files")
    elapsed["sampling"] = sum(SAMPLING["seconds"].values())
    print(f"elapsed sampling {elapsed['sampling']:.1f} s (inside the sd15, sd3, wan and z_image "
          f"paths: {len(SAMPLING['lines'])} requests) on {card}", flush=True)
    elapsed["lora"] = sum(LORA["seconds"].values())
    print(f"elapsed lora {elapsed['lora']:.1f} s (inside the int8, q8_0_gguf, q4_0 and sdxl paths; "
          "the sdxl_lora_cli and sd15_lora_server entry paths apart) on " + card, flush=True)

    headline = {"flash_attention": ([1, 24, 4352, 4352, 128], {}),
                "flash_attention_d512": ([1, 1, 4096, 4096, 512], {}),
                "flash_attention_f32": ([1, 24, 4352, 4352, 128], {}),
                "flash_attention_d64": ([2, 10, 4096, 4096, 64], {"dtype": "bf16"}),
                "flash_attention_d40": ([2, 8, 4096, 4096, 40], {"dtype": "bf16"}),
                "flash_attention_d80": ([2, 8, 1024, 1024, 80], {"dtype": "bf16"}),
                "flash_attention_d160": ([2, 8, 256, 256, 160], {"dtype": "bf16"}),
                D320: ([1, 1, 4096, 4096, 320], {"dtype": "bf16"}),
                "w8a8_matmul": ([4352, 3072, 12288], {"dtype": "bf16"}),
                "w8a8_matmul_gemv": ([1, 3072, 18432], {}),
                "q4_matmul": ([256, 4096, 10240], {"group": 64, "dtype": "bf16"}),
                "q4_matmul_f32": ([256, 4096, 10240], {"group": 64}),
                "q4_matmul_wgmma": ([4352, 3072, 12288], {"group": 32}),
                "q4_matmul_gemv": ([1, 3072, 18432], {"group": 32}),
                "q4_matmul_splitk": ([77, 4096, 10240], {"group": 64, "dtype": "bf16"})}
    for name in ("gq_matmul", "gq_matmul_ws", "gq_zero_matmul"):
        headline[name] = ([4352, 3072, 12288], {"group": 32, "dtype": "bf16"})
    headline["w8a16_matmul"] = ([4352, 3072, 12288], {"dtype": "bf16"})
    headline["w8a16_matmul_f32"] = ([4352, 3072, 12288], {})
    headline["gq_matmul_f32"] = ([4352, 3072, 12288], {"group": 32})
    headline["gq_zero_matmul_f32"] = ([4352, 3072, 12288], {"group": 32})
    headline["gq_matmul_gemv"] = ([1, 3072, 18432], {"group": 32})
    headline["w8a16_matmul_gemv"] = ([1, 3072, 18432], {})
    headline["w8a8_matmul_splitk"] = ([77, 2048, 1280], {"dtype": "bf16"})
    headline["gq_matmul_splitk"] = ([77, 2048, 1280], {"group": 32})
    headline["w8a16_matmul_splitk"] = ([77, 2048, 1280], {"dtype": "bf16"})
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        # a form counted apart (the 4-bit wgmma form, the GEMVs) has the cases
        # of its wrapper that ran in it
        mine = [c for c in cases if name in (c["kernel"], f"{c['kernel']}_{c.get('form')}")]
        shape, extra = headline[name]
        head = next(c for c in mine if c["shape"] == shape
                    and all(c.get(k) == v for k, v in extra.items()))
        # the exponentials are operations too: "exp" names which ones
        by = {"bound_by": "operations", "bound_term": "exp"} if head["bound_by"] == "exp" else {
            "bound_by": head["bound_by"]}
        kernels.append({"name": name, "shape": shape, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(c[name] for c in launches.values()),
                        "max_abs_err": max(c["max_abs_err"] for c in mine),
                        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                        **by, "library_ms": head["library_ms"]})
        # the device clock's reading and the K splits, where the case has them
        kernels[-1].update({key: head[key] for key in ("device_ms", "library_device_ms", "splits")
                            if head.get(key)})
        if name in (*UNET_FLASH, D320, "flash_attention_d64"):  # the float32 form at the same shape
            f32 = next(c for c in cases if c["kernel"] in (name, "flash_attention_f32")
                       and c["shape"] == shape and c["dtype"] == "f32")
            kernels[-1].update({f"f32_{k}": f32[k] for k in ("ms", "plain_ms", "bound_ms",
                                                              "library_ms", "splits")})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "elapsed_s": elapsed, "cases": cases,
                       "reference": ref,
                       "loader": loader, "pipelines": pipes, "requests": reports, "entry": entry,
                       "wan": wan_extra, "z_image": zi_extra, "qwen_image": qi_extra,
                       "sampling": SAMPLING, "lora": LORA,
                       "launches": launches, "kernels": kernels, "profile": prof}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
