"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no result line):

0. device: requires CUDA; prints the card's name and power limit; turns
   TF32 off so that float32 references are true float32; checks that the
   facades (`StableDiffusion_XL`, `StableDiffusion_1`,
   `StableDiffusion_1_Inpainting`, `SegmentAnything`) built with no device
   land on the card (small sub-models, built on the host and moved).
1. build: compiles the CUDA kernels from ``refiners_tpu_torch/csrc/`` into
   ``build/refiners_tpu_torch/``, one ``nvcc`` per source, side by side.
2. kernels: every hand-written kernel against its plain PyTorch version on
   inputs from a seed, in bf16 (tensor cores) and in float32 (FFMA); times
   are medians over CUDA events. Float32 cases are held to 1e-5 against
   the float32 plain version.
   - the packed forward (``flash_attention_packed``) at the SDXL path's
     shapes (the UNet's d = 64 on the narrow wgmma kernel, the VAE's
     d = 512 on the wide one), at SD1.5's inference shapes (the UNet's
     d = 40 and d = 80, no lse; the VAE's d = 512 at 64×64 latents), at
     phase 9's sites with keys twice as long as the queries (StyleAligned
     at batch 4, reference-only at batch 2, d = 40 and d = 80), at phase
     10's MultiUpscaler sites (a 144 × 112 latent tile: 16128 tokens at
     d = 40 and 4032 at d = 80; the tiled VAE's 9216 and 5184 tokens at
     d = 512, the second a ragged 40.5 key tiles), at phase 12's DINOv2
     sites (1374 and 1370 tokens, ragged on both sides, 24 heads of
     d = 64 at batch 4, also in float32)
     plus ragged, causal, d = 80, d = 128,
     d = 256, d = 200 and float16 cases: relative Frobenius error ≤ 1e-2
     against the plain version in float32; uniform weights on causal rows
     that have no admissible key;
   - the forward with bias and logsumexp (``flash_attention``, K2, on the
     narrow kernel) at the SD1.5 shapes, a ragged, two causal (one with
     Lq > Lk) and four biased cases (full, broadcast over heads, a key bias
     broadcast over batch, heads and rows, d = 128): out ≤ 1e-2, lse max
     abs ≤ 1e-3; a boolean mask with a fully masked row gives uniform
     weights;
   - the backward kernels (``flash_attention_bwd_dkv``, K4a, and
     ``flash_attention_bwd_dq``, K4b, both on TMA + wgmma) at the SD1.5
     shapes, causal cases at d = 80, d = 128, d = 40 with Lq > Lk and
     d = 80 with Lq < Lk, and through strided heads of a packed fused
     projection: dq, dk, dv each ≤ 2e-2 against
     ``flash_attention_backward_plain`` in float32; the registers and spill
     bytes of every dQ instance from the build's ptxas output; at
     128 < d ≤ 512 (``flash_bwd_wide_wgmma_kernel``, wgmma on TMA, one
     kernel for both entries, a block 64 rows of one gradient; the float32
     kernels' wide instances): the SD1.5 VAE
     decoder's mid-block at 512² (2, 4096, 4096, 1, 512) and
     (1, 1024, 1024, 2, 256), timed single and queued against their bounds
     (0.139 and 0.104 ms at the VAE site) and the memory-efficient
     attention's backward, a ragged causal d = 512, d = 200, float16 and
     float32 at d = 512, strided heads of a fused (1, 4096, 3·512)
     projection; the registers of the 12 wide instances, none of which may
     spill;
   - the forward with SAM's decomposed relative-position bias
     (``flash_attention_relpos``) at the SAM-H global and windowed layers'
     shapes and at a 10 × 10 key grid, in bf16 and float32, against
     ``flash_attention_relpos_plain`` in float32 (≤ 1e-2 in bf16, ≤ 1e-5
     in float32), on strided head views of a fused projection; at the
     global shape the kernel may allocate at most 64 MiB beyond its output;
   - the fused GroupNorm+SiLU (``group_norm_stats``, K5a, then
     ``group_norm_apply``, K5b) at the SDXL UNet's and VAE's shapes and a
     ragged (2, 96, 5, 6), in bf16 and float32, against
     ``group_norm_silu_plain`` in float32 (≤ 1e-2 in bf16, ≤ 1e-5 in
     float32), once without SiLU; each kernel also against its own plain
     version;
   - the int8 quantization (``quantize_int8``, K6) at the SDXL linears'
     shapes, a ragged (520, 300) and (37, 301) and a weight that starts
     off a 16-byte boundary: values and scales bit-equal to
     ``quantize_int8_plain`` (the same Philox stream), |q| ≤ 127, q between
     floor and ceil of w/scale, and unbiased over 64 seeds;
   - its round-to-nearest row mode (``quantize_rows_int8``, the W8A8
     activations) at the SDXL UNet's activation shapes, a ragged (37, 301),
     a row-offset view off a 16-byte boundary and float32: bit-equal to
     ``quantize_rows_int8_plain``, |q| ≤ 127, zero padding rows; and the
     host cost of one call against the eager sequence it replaces;
   - for every kernel at its main-path shape: the bound (the larger of the
     bytes over 3.35 TB/s and the operations over 989 TFLOP/s in bf16, or
     67 TFLOP/s in float32 FFMA) and the time of one PyTorch call that
     computes the same function where there is one (``library_ms``, timed
     here and used nowhere in the port); for K1's two UNet sites and K3's
     two layers also the device time of calls queued behind a stream sleep,
     of the kernel and of the library call, which leaves out the host's
     share of a single launch; and the CUDA kernel that serves each entry
     (``flash_attention.forward_kernel``). K2 and K4 at both SD1.5 sites
     (64×64 and 32×32 latents) queued and single, against
     ``aten._scaled_dot_product_flash_attention`` (which returns the lse, as
     K2 does) and its backward (against the delta reduction + K4a + K4b).
3. SDXL serving: full-width SDXL (UNet, CLIP-L + CLIP-G, VAE) in bf16 with
   seeded synthetic weights, one UNet step through the kernel against the
   same step on the plain path, then 3 requests through ``TextToImage`` at
   1024², 30 DDIM steps, CFG 5.0. Each image must be finite and not
   constant, and each request must launch the packed kernel exactly
   70 × 30 + 1 times (70 UNet self-attention sites per step, one VAE site).
   Each request's VAE decode is also timed alone (host clock between
   synchronizes around the decoder), and one bf16 UNet step through the
   kernels is traced with ``torch.profiler``: its device time by kernel
   kind and its idle share.
4. SD1.5 training: full-width ``SD1UNet`` with seeded synthetic weights,
   batch 2 of 64×64 latents.
   (a) one forward + backward of the DDPM noise-regression loss four ways:
   float32 on the plain path (the reference), bf16 on the plain path, bf16
   through the kernels and float32 through the kernels (each kernel route
   exactly 10 + 10 + 10 launches); the bf16 kernel route's gradient, over
   all parameters, may be at most twice as far from the reference as the
   bf16 plain route's, and the float32 kernel route at most 1e-4 from it.
   (b) the port's ``Trainer`` (``refiners_tpu_torch.examples.train_unet``)
   in bf16: 4 steps, gradient accumulation 2, AdamW at lr 1e-3. Every loss
   and grad norm finite, every weight of two or more dims changed, every
   parameter finite, and exactly 10 forward + 10 dK/dV + 10 dQ launches per
   step.
   (c) the SD1.5 VAE's decoder trained on the MSE of its reconstruction
   (sd-vae-ft-mse's fine-tune), full-width ``SD1Autoencoder`` with seeded
   synthetic weights, the encoder frozen, batches of 2 seeded 512² images
   from ``create_data_loader``: one decoder step four ways as in (a)
   (exactly one forward with lse, one dK/dV and one dQ launch, all at the
   mid-block's one head of d = 512); in bf16, 4 steps of Lion straight
   against 2 steps, a ``CheckpointCallback`` save and a fresh trainer
   restored for the last 2 (cuDNN deterministic; losses within 1e-3 and
   every weight within Lion's bound of the straight run's); 2 steps of
   Prodigy in float32 (finite losses and parameters, every weight of two or
   more dims moved); 2 steps with ``apply_remat`` on the decoder's Resnet,
   SelfAttention2d and Upsample blocks against 2 without (lower peak
   memory, the same first loss). Every step launches the frozen encoder's
   K1 once, the decoder's forward with lse once (twice under remat) and
   K4a and K4b once each; seconds, peak memory and launches a step; one
   step traced.
5. SAM serving: full-width ``SegmentAnythingH`` (ViT-H, 1280 wide, 32
   layers, 16 heads) in bf16 with seeded synthetic weights and a
   single-mask decoder. (a) One image embedding four ways: float32 on the
   plain path (the reference), float32 through the kernel (≤ 1e-4 from the
   reference), bf16 on the plain path and bf16 through the kernel (at most
   twice as far from the reference as the bf16 plain route); each kernel
   route launches ``flash_attention_relpos`` exactly 32 times, each plain
   route never; the bf16 kernel route traced with ``torch.profiler``
   (device time by kernel kind, idle share). (b) 3 requests (1024 × 768, 600 × 400 and 1024 × 1024
   images): one ``compute_image_embedding`` (exactly 32 launches), a
   ``predict`` with two foreground points and one background point and a
   ``predict`` with a box (no launch each), then ``predict_pipelined`` over
   the three embeddings (equal to the serial ``predict``); then HQ-SAM
   injected, one embedding and one ``predict``. Masks must have the
   original size and not be constant, IoU predictions finite.
6. SDXL under the opt-in passes: full-width SDXL in bf16 with the weights of
   phase 3. (a) ``fuse_group_norm_silu`` fuses 35 pairs in the UNet and 50
   in the VAE (21 encoder, 29 decoder); one UNet step four ways: float32
   unfused on the plain path (the reference), bf16 unfused, bf16 fused
   through K5 (at most twice as far from the reference as bf16 unfused) and
   float32 fused through K5 (≤ 1e-4 from it). (b) ``quantize_linears(unet,
   min_features=256)`` replaces 743 linears with W8A8 ``QuantizedLinear``s,
   one K6 launch each. (c) 2 requests through ``TextToImage`` with phase 3's
   first prompts and seeds: exactly 35 × 30 + 29 launches of K5a and of K5b,
   70 × 30 + 1 of K1 and 743 × 30 of the row mode (each W8A8 linear once a
   UNet step) each; images finite and not constant; request 0's image at
   PSNR ≥ 20 against phase 3's bf16 image (the JAX package's int8 gate).
   Then one W8A8 UNet step is traced with ``torch.profiler`` (device time
   by kind, idle share).
7. SD1.5 serving: full-width ``StableDiffusion_1`` (UNet of 859,520,964
   parameters, CLIP-L, VAE) in bf16 with seeded synthetic weights, DPM++
   30 steps, CFG 7.5, 512². (a) One CFG UNet step at 64×64 latents three
   ways: float32 on the plain path (the reference), bf16 on the plain path
   (no K1 launch) and bf16 through the kernels (exactly 10 K1 launches); the
   kernel route at most twice as far from the reference as the bf16 plain
   route; the bf16 kernel step traced with ``torch.profiler``. (b) Requests,
   each timed on the host clock between synchronizes with its peak memory
   and K1 launches: 3 text-to-image requests through ``TextToImage``
   (distinct prompts and seeds; 10 × 30 + 1 launches each), one with
   ``num_images=2`` (301: batch 4 in one UNet call a step; each image at
   PSNR ≥ 35 dB against a single run on its noise), one img2img at
   strength 0.5 on the first image (first step 14: 10 × 16 + 2, the VAE
   encoder's mid-block included) and one inpainting request on a 9-channel
   ``StableDiffusion_1_Inpainting`` with the same weights apart from its
   ``conv_in`` (10 × 30 + 2). Every decoded image finite and not constant.
8. SD1.5 with adapters: phase 7's model, one request through
   ``TextToImage`` for each adapter set, injected before it and ejected
   after it: (a) two rank-32 LoRAs in the reference key layout on every
   Linear of the UNet's transformer blocks and of CLIP, through
   ``SDLoraManager.add_loras`` at scales 1.0 and 0.5; (b) one ControlNet,
   "canny", at 1.0; (c) "depth" at 0.3 injected under "canny" at 0.7; (d) a
   T2I-Adapter, "pose", at 0.8; (e) FreeU, backbone (1.2, 1.4), skip (0.9,
   0.2). Conditions are seeded 512² images. For each: one CFG UNet step
   three ways, gated as in phase 7 (K1 launches 10, 14, 18, 10, 10); the
   request's seconds, peak memory and K1 launches (10 × 30 + 1, plus 4 × 30
   per ControlNet), its image finite and not constant; after the eject,
   one base UNet step bit-equal to the one taken before the first
   injection. A LoRA at scale 0 gives the base step bit for bit and the
   scales move it. With the ControlNet, the float32 reference step is also
   taken once under PyTorch's default (cuDNN TF32 on) and its distance
   from the TF32-off step printed (no gate), and one bf16 step is traced.
9. SD1.5 with guidance and image prompts: phase 7's model, one request
   for each adapter set, injected before it and ejected after it: (a)
   self-attention guidance at 0.75 (through ``TextToImage``); (b)
   StyleAligned at 0.8 on two prompts in one batch; (c) reference-only
   control (style_cfg 0.5) on a seeded 512² guide image, encoded once and
   noised to each step; (d) Restart (10 timesteps, 2 iterations) on DDIM
   30 steps; (e) IP-Adapter with a full-width ``CLIPImageEncoderH`` on a
   seeded 512² image; (f) IP-Adapter plus (the same encoder's grid
   features, a perceiver resampler); (g) a textual-inversion concept on
   CLIP-L. For each: one CFG UNet step three ways, gated as in phase 8 (K1
   launches 20, 10, 30, 10, 10, 10, 10; SAG's routes all take the float32
   step's mask, and the pixels each route's own mask would flip are
   printed); the request's seconds, peak memory and K1 launches (601,
   301, 902, 481, 301, 301, 301), every image finite and not constant;
   after the eject the base step bit-equal to the one before the first
   injection. Also: StyleAligned's reference sample in float32 against
   the bare step (printed); the guide UNet adds no parameters and at most
   1 MiB of device memory; IP-Adapter at scale 0 bit-equal to the base
   step; the text embedding bit-equal after the concept's eject; one
   reference-only step traced (device time by kind, idle share, K1's
   share).
10. SD1.5's ELLA, IC-Light, MultiDiffusion and MultiUpscaler: (a) phase
   7's model with ``SD1ELLAAdapter`` injected (its encoder's synthetic
   weights damped ×0.2, as ``golden_cfg.build_ella`` damps them) on a
   (2, 128, 2048) LLM embedding: one step three ways (10 K1 launches), one
   request (301), the base step bit-equal after the eject; (b) an
   ``ICLight`` from phase 7's UNet weights plus a seeded 0.02·randn patch,
   its condition a gray composite of a seeded 512² image: one step three
   ways (10), one request at CFG 2.0 (302: the condition's encode); (c)
   ``SD1MultiDiffusion`` over a 512 × 1024 panorama, three 64² tiles with
   their own DDIM, 30 steps (901); (d) ``MultiUpscaler`` built from
   safetensors files written under ``build/`` (phase 7's UNet, CLIP-L and
   VAE, a seeded tile ControlNet, two rank-32 LoRAs, a (4, 768) negative
   embedding), at clarity-upscaler's defaults: one tile-step (UNet +
   ControlNet at 144 × 112 latents) three ways (14) and traced, one tiled
   decode of 192² latents three ways (6: the frozen pass and four tiles),
   then a seeded 768² image upscaled ×2 (402: 7 steps × 4 tiles × 14, and
   10 on the VAE's tiles and frozen pass), 1536² and finite, the VAE's
   decode bit-equal after ``tiled_inference`` exits.

11. SDXL's adapter zoo: phase 3's bf16 SDXL (rebuilt from its seeds) at
   1024², two bare requests first (2101 K1 launches each), then one
   request for each adapter set, injected before it and ejected after it:
   (a) self-attention guidance at 1.0 through ``set_self_attention_guidance``
   (a batch-1 UNet call a step on the degraded latents; 30 DDIM steps, CFG
   5.0); (b) ``SDXLT2IAdapter`` "canny" at 0.8 on a seeded 1024² condition;
   (c) ``SDXLIPAdapter`` and (d) its plus variant on a full-width
   ``CLIPImageEncoderH`` and a seeded image; (e) two rank-32 LoRAs through
   ``SDLoraManager`` (every Linear of the UNet's transformers, of CLIP-L
   and of CLIP-G) at 1.0 and 0.5; (f) ``SDXLLcmAdapter`` with ``LCMSolver``,
   (g) an LCM-LoRA at rank 64 through ``add_lcm_lora`` with ``LCMSolver``
   and (h) an SDXL-Lightning LoRA through ``add_lcm_lora(name="lightning",
   scale=1.0)`` with 4 trailing ``Euler`` steps, each 4 steps without
   classifier-free guidance; (i) ``ControlLoraAdapter`` "depth" at rank
   128 from a seeded checkpoint in stability-ai's original format
   (``load_original_weights``) on a seeded condition; (j)
   ``SDXLMultiDiffusion`` over a 1024 × 2048 panorama (three 128² latent
   tiles, 30 DDIM steps) and one decode of the whole image. For (a)-(i):
   one UNet step three ways, gated as in phase 8 (K1 launches 140, 70, 70,
   70, 70, 70, 70, 70, 104; SAG's routes take the float32 step's mask; the
   sets without guidance at batch 1); each request's seconds, peak memory
   and K1 launches (4201, 2101 × 4, 281 × 3, 3121, the panorama 6301),
   every image finite and not constant; after each eject the base step
   bit-equal to the one before the first injection. The Control-LoRA's
   copy shares the UNet's tensors (device memory added at most its own
   parameters' plus 64 MiB) and its LoRAs leave the UNet's own path
   alone; one Control-LoRA step is traced (device time by kind, idle and
   K1 share). Phase 2 holds K1 at the new sites: (1, 4096, 4096, 10, 64),
   (1, 1024, 1024, 20, 64) and (1, 32768, 32768, 1, 512).

12. DINOv2, its Fréchet distance and the BoxSegmenter: (a)
   ``DINOv2_giant_reg`` and ``DINOv2_giant`` at 518² (1374 and 1370
   tokens), bf16, seeded weights, a batch of 4 seeded images through
   ``preprocess``: one forward three ways (float32 plain, bf16 plain, bf16
   kernels), gated as in phase 8 (the kernel route within twice the bf16
   plain route's distance from float32), exactly 40 K1 launches a forward
   (one a layer); seconds per forward (median of 5 warm), peak memory, one
   forward traced (device time by kind, idle and K1 share). The CLIP
   tokenizer's merge engine is printed and must be the native one (``g++``
   is there wherever ``nvcc`` is). (b) ``dinov2_frechet_distance`` with
   ``DINOv2_small`` (float32, 224², 257 tokens: no K1 launch) between two
   directories of 16 seeded PNGs written under ``build/`` and deleted after:
   a set against itself within 1e-6 of its covariance's trace of 0, two
   sets finite and positive. (c) ``BoxSegmenter`` on a full-width MVANet
   (Swin-B, depths [2, 2, 18, 2]), float32 under PyTorch's default (cuDNN
   convolves in TF32), seeded weights, a seeded 1536 × 1024 image with a box
   prompt: 4 requests (the first warm-up), the mask an ``L`` image of the
   image's size, every probability finite, no kernel launched; the model's
   logits on the request's input against the same weights on the CPU once:
   in true float32 (TF32 off) within 1e-4, under TF32 within 2e-2
   (relative Frobenius); seconds per request (median of 3), peak memory,
   one MVANet forward traced. Then the ComfyUI nodes: the weights saved to a
   safetensors file, ``LoadBoxSegmenter().load(file, margin, "cuda")`` and
   ``BoxSegmenter().process`` on the image as ComfyUI's (1, H, W, 3) tensor
   and the same box: the (1, H, W) mask bit-equal to the direct call's.
13. SD1.5 from upstream-layout files (run after phase 10, on phase 7's
   model): its UNet written in diffusers' layout, its VAE in the original
   LDM's (the mid-block attention projections as (512, 512, 1, 1)
   convolutions) and its CLIP-L in transformers', as bf16 safetensors
   under ``build/chip_smoke_conversion/``; each converted through
   ``refiners_tpu_torch.conversion.cli.main(["--from-file", ...,
   "--format", ...])``; the model's weights zeroed, the three outputs
   loaded with strict=True, every tensor bit-equal to the one written out;
   phase 7's first request served before and after the round trip (301 K1
   launches each, the image and the decoded tensor bit-equal); a
   refiners-layout VAE at ``Hub.local_path`` under a temporary
   ``REFINERS_TPU_WEIGHTS`` converted by ``REGISTRY["sd15.autoencoder"].convert()``
   into ``converted_torch/`` and loaded with strict=True, bit-equal. The
   seconds and bytes of each conversion are printed; the files deleted.

The last lines are a JSON summary of the kernels (launches counted over
phases 3, 4b, 4c, 5b, 6, 7b, 8b, 9b, 10, 11, 12 and 13's runs, each with
the counts set to 0 just before it; K1's over phases 3, 4c, 7b, 8b, 9b,
10, 11, 12a and 13, by path),
the ``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from typing import Any, Callable

import numpy as np
import torch
from PIL import Image

REL_TOL = 1e-2  # bf16 unit roundoff 3.9e-3; P and O are each rounded once
LSE_TOL = 1e-3  # lse is float32 from the same bf16 q and k: summation order only
GRAD_TOL = 2e-2  # the backward rounds P and dS once each and sums over a sequence
F32_TOL = 1e-5  # float32 kernels against float32 plain versions: summation order only
# a float32 UNet step through the kernels against the same step on the plain
# path: summation order (≈1e-7 per op) amplified through the UNet's depth
F32_STEP_TOL = 1e-4
BF16, F32 = torch.bfloat16, torch.float32
LAUNCHES_PER_REQUEST = 70 * 30 + 1
LAUNCHES_PER_TRAINING_STEP = 10  # of each of the forward, dK/dV and dQ kernels
TRAINING_STEP_LAUNCHES = {
    "flash_attention_packed": 0,
    "flash_attention": LAUNCHES_PER_TRAINING_STEP,
    "flash_attention_bwd_dkv": LAUNCHES_PER_TRAINING_STEP,
    "flash_attention_bwd_dq": LAUNCHES_PER_TRAINING_STEP,
    "flash_attention_relpos": 0,
    "group_norm_stats": 0,
    "group_norm_apply": 0,
    "quantize_int8": 0,
    "quantize_rows_int8": 0,
}
# phase 4c: the SD1.5 VAE's decoder trained on the MSE of its reconstruction (sd-vae-ft-mse's fine-tune)
VAE_SIZE = 512
VAE_IMAGES = 4  # seeded images: batches of 2, two steps an epoch
VAE_WEIGHTS_SEED = 21
VAE_LION_LR = 1e-4
VAE_LION_WD = 1e-2  # the config's default weight decay, which Lion8bit takes
VAE_TRAIN_CONFIG = """
[clock]
verbose = false

[training]
duration = "{steps}:step"
dtype = "{dtype}"
device = "cuda"
seed = 0

[optimizer]
optimizer = "{optimizer}"
learning_rate = {lr}

[lr_scheduler]
type = "ConstantLR"

[encoder]
requires_grad = false

[decoder]
requires_grad = true
"""
# a decoder step: its mid-block's forward with the lse, and one launch of each backward kernel
VAE_DECODER_LAUNCHES = {"flash_attention": 1, "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1}
# a training step also encodes the batch: the frozen encoder's mid-block, no lse
VAE_STEP_LAUNCHES = {"flash_attention_packed": 1, **VAE_DECODER_LAUNCHES}
# with the mid-block under remat its forward runs again in the backward
VAE_REMAT_LAUNCHES = {**VAE_STEP_LAUNCHES, "flash_attention": 2}
# the resumed run against the straight one: a bit-equal run gives 0; a few Lion sign flips change a
# bf16 loss over 1.5M pixels far less than this
VAE_RESUME_LOSS_TOL = 1e-3
# remat recomputes the same forward: the first step's loss within float32 summation order
VAE_REMAT_LOSS_TOL = 1e-6
ATTENTION_SHAPES = [
    # (batch, q_len, kv_len, heads, head_dim, causal, dtype)
    (2, 4096, 4096, 10, 64, False, BF16),  # SDXL UNet self-attention at 64×64 latents
    (2, 1024, 1024, 20, 64, False, BF16),  # SDXL UNet self-attention at 32×32 latents
    (1, 16384, 16384, 1, 512, False, BF16),  # SDXL VAE decoder mid-block at 128×128
    (2, 1000, 1100, 5, 64, False, BF16),  # ragged
    (2, 1024, 1024, 10, 64, True, BF16),  # causal
    (2, 4096, 4096, 8, 40, False, BF16),  # SD1.5 self-attention at 64×64 latents, inference (narrow kernel)
    (1, 1000, 1300, 4, 80, True, BF16),  # d = 80: a 64-column and a 16-column box; causal, ragged
    (1, 900, 1000, 4, 128, False, torch.float16),  # d = 128: two 64-column boxes; ragged
    (1, 4096, 4096, 1, 512, False, F32),  # a float32 VAE mid-block at 64×64 latents
    (2, 1024, 1024, 4, 256, False, BF16),  # the wgmma kernel's D = 256 template
    (1, 1000, 1100, 3, 200, False, BF16),  # d = 200, padded to 256; ragged
    (1, 2900, 3000, 1, 512, True, BF16),  # ragged and causal at d = 512
    (1, 4096, 4096, 1, 512, False, torch.float16),  # a float16 VAE mid-block at 64×64 latents
    (2, 1024, 1024, 8, 80, False, BF16),  # SD1.5 self-attention at 32×32 latents, inference
    (1, 4096, 4096, 1, 512, False, BF16),  # SD1.5 VAE mid-block at 64×64 latents
    # keys twice as long as the queries (the reference's or the guide's appended): at 64×64 latents
    (4, 4096, 8192, 8, 40, False, BF16),  # StyleAligned, 2 images (CFG batch 4), the 64² sites
    (4, 1024, 2048, 8, 80, False, BF16),  # StyleAligned, the 32² sites
    (2, 4096, 8192, 8, 40, False, BF16),  # reference-only's guided self-attention, the 64² sites
    (2, 1024, 2048, 8, 80, False, BF16),  # reference-only, the 32² sites
    # the MultiUpscaler's sites (phase 10): a 144 × 112 latent tile and its 72 × 56 level; the tiled
    # VAE's 128 × 72 and 72² latent tiles (ragged: 40.5 key tiles of 128)
    (2, 16128, 16128, 8, 40, False, BF16),
    (2, 4032, 4032, 8, 80, False, BF16),
    (1, 9216, 9216, 1, 512, False, BF16),
    (1, 5184, 5184, 1, 512, False, BF16),
    # phase 11's sites: the SDXL UNet at batch 1 (SAG's degraded pass, LCM, Lightning), and the VAE
    # decoder's mid-block on a 1024 × 2048 panorama's 128 × 256 latents (512 blocks of 64 rows)
    (1, 4096, 4096, 10, 64, False, BF16),
    (1, 1024, 1024, 20, 64, False, BF16),
    (1, 32768, 32768, 1, 512, False, BF16),
    # phase 12's sites: DINOv2-g at 518², batch 4, with and without its four registers; ragged on both
    # sides (1374 = 10·128 + 94), different data in each batch element; also on the float32 kernel
    (4, 1374, 1374, 24, 64, False, BF16),
    (4, 1370, 1370, 24, 64, False, BF16),
    (4, 1374, 1374, 24, 64, False, F32),
]
VAE_SHAPE = [1, 16384, 16384, 1, 512]  # (batch, q_len, kv_len, heads, head_dim) of K1's VAE site
UNET32_SHAPE = [2, 1024, 1024, 20, 64]  # K1's second UNet site (60 of its 70 launches per step)
# K1's SD1.5 inference sites: 5 + 5 launches per UNet call, one VAE launch per encode or decode
SD15_SHAPES = {"K1 SD1.5 64²": [2, 4096, 4096, 8, 40], "K1 SD1.5 32²": [2, 1024, 1024, 8, 80],
               "K1 SD1.5 VAE": [1, 4096, 4096, 1, 512]}  # fmt: skip
# K1 at phase 9's sites with Lk = 2·Lq: 5 + 5 launches per UNet call of StyleAligned, and of
# reference-only's guided pass (its guide and unguided passes run at Lk = Lq)
SD15_ZOO_SHAPES = {"K1 StyleAligned 64²": [4, 4096, 8192, 8, 40], "K1 StyleAligned 32²": [4, 1024, 2048, 8, 80],
                   "K1 ref-only 64²": [2, 4096, 8192, 8, 40], "K1 ref-only 32²": [2, 1024, 2048, 8, 80]}  # fmt: skip
# K1 at the MultiUpscaler's sites (phase 10): 5 + 5 launches per UNet call and 2 + 2 per ControlNet
# call on a 144 × 112 latent tile; the tiled VAE's encoder and decoder mid-blocks on tiles of 128 × 72
# and 72 × 72 latents (its 128² tiles are the SDXL VAE row's shape)
SD15_UPSCALER_SHAPES = {"K1 upscaler 144×112": [2, 16128, 16128, 8, 40], "K1 upscaler 72×56": [2, 4032, 4032, 8, 80],
                        "K1 tiled VAE 128×72": [1, 9216, 9216, 1, 512], "K1 tiled VAE 72²": [1, 5184, 5184, 1, 512]}  # fmt: skip
# K1 at phase 11's sites: 10 + 60 launches per UNet call at batch 1, one per panorama decode
SDXL_ZOO_SHAPES = {"K1 SDXL 64² batch 1": [1, 4096, 4096, 10, 64], "K1 SDXL 32² batch 1": [1, 1024, 1024, 20, 64],
                   "K1 SDXL VAE 128×256": [1, 32768, 32768, 1, 512]}  # fmt: skip
# K1 at phase 12's sites: one launch per DINOv2 layer at 518²
DINOV2_SHAPES = {"K1 DINOv2 518² reg": [4, 1374, 1374, 24, 64], "K1 DINOv2 518²": [4, 1370, 1370, 24, 64]}
TRAIN32_SHAPE = [2, 1024, 1024, 8, 80]  # K2's and K4's second SD1.5 site (5 of their 10 launches per step)
FORWARD_SHAPES = [
    # (batch, q_len, kv_len, heads, head_dim, causal, bias shape or None, dtype)
    (2, 4096, 4096, 8, 40, False, None, BF16),  # SD1.5 UNet self-attention at 64×64 latents
    (2, 1024, 1024, 8, 80, False, None, BF16),  # SD1.5 UNet self-attention at 32×32 latents
    (2, 1000, 1100, 5, 64, False, None, BF16),  # ragged
    (2, 1024, 1024, 8, 80, True, None, BF16),  # causal
    (2, 1200, 1000, 8, 40, True, None, BF16),  # causal, Lq > Lk: 200 rows without a key
    (1, 1024, 1024, 4, 64, False, (1, 4, 1024, 1024), BF16),  # a float32 bias (B, H, Lq, Lk)
    (2, 1024, 1024, 8, 40, False, (2, 1, 1024, 1024), BF16),  # broadcast over heads (stride 0)
    (2, 4096, 4096, 8, 40, False, (1, 1, 1, 4096), BF16),  # a key bias broadcast over B, H and rows
    (1, 1000, 1100, 4, 128, False, (1, 4, 1000, 1100), BF16),  # d = 128, ragged, biased
    (2, 4096, 4096, 8, 40, False, None, F32),
    (2, 1024, 1024, 8, 80, False, None, F32),
    (2, 1000, 1100, 5, 64, True, (2, 5, 1000, 1100), F32),  # ragged, causal and biased
]
RELPOS_SHAPES = [
    # (batch, kh, kw, heads, head_dim, dtype); q_len = kv_len = kh·kw
    (1, 64, 64, 16, 80, BF16),  # SAM-H global-attention layer
    (25, 14, 14, 16, 80, BF16),  # SAM-H windowed layer (25 windows of 14 × 14)
    (1, 10, 10, 1, 32, BF16),  # a grid where the TPU kernel falls back to a dense bias
    (1, 64, 64, 16, 80, F32),
    (25, 14, 14, 16, 80, F32),
]
RELPOS_EXTRA_BYTES = 64 * 2**20  # what K3 may allocate beyond its output at the global shape
SAM_LAUNCHES_PER_EMBEDDING = 32  # one per ViT-H layer
SAM_F32_TOL = 1e-4  # a float32 ViT-H embedding through K3 against the plain route: summation order over 32 layers
SAM_IMAGES = [(1024, 768), (600, 400), (1024, 1024)]  # (width, height)
GROUP_NORM_SHAPES = [
    # (shape, groups); the first is the main-path row of the kernel table
    ((2, 320, 128, 128), 32),  # SDXL UNet, 8 sites per step
    ((2, 960, 128, 128), 32),  # SDXL UNet up block at 128² (after a skip concatenation)
    ((2, 1280, 32, 32), 32),  # SDXL UNet, 10 sites per step
    ((2, 2560, 32, 32), 32),  # SDXL UNet up block at 32²
    ((1, 512, 256, 256), 32),  # SDXL VAE decoder
    ((1, 128, 1024, 1024), 32),  # SDXL VAE decoder at full resolution, 6 sites
    ((2, 96, 5, 6), 32),  # 90-element groups: unaligned chunks, ragged tails
]
QUANT_SHAPES = [
    # (out, in) in the port's layout; the first is the main-path row
    (1280, 1280),  # 381 of the 743 SDXL UNet linears
    (1280, 2048),  # 120: cross-attention keys and values
    (10240, 1280),  # 60: GEGLU feed-forward in
    (1280, 5120),  # 60: feed-forward out
    (1280, 2816),  # the add-embedding
    (520, 300),  # ragged: rows that do not start on a Philox block
    (37, 301),  # ragged, odd width: 3-block vectors and scalar heads and tails
]
ROW_QUANT_SHAPES = [
    # (tokens, features) of the W8A8 activations in one SDXL UNet step at 1024², CFG batch 2;
    # the first is the main-path row
    (8192, 640),  # the 64×64 level: q, k, v, out, cross q, feed-forward in, projections (80 a step)
    (8192, 2560),  # feed-forward out at 64×64 (10)
    (2048, 1280),  # the 32×32 level (432)
    (2048, 5120),  # feed-forward out at 32×32 (60)
    (154, 2048),  # text keys and values (140)
    (2, 2816),  # the add-embedding, padded to 32 rows
    (2, 1280),  # time embeddings, padded to 32 rows
    (37, 301),  # ragged
]
QUANT_SEEDS = 64  # unbiasedness: mean of 64 stochastic roundings on a (256, 1024) weight
QUANT_UNBIASED_TOL = 0.375  # 6σ of a mean of 64 Bernoulli draws (σ ≤ 1/16): deterministic given the seeds
PASSES_UNET_FUSED = 35  # GroupNorm → SiLU pairs in the SDXL UNet
PASSES_VAE_FUSED = (21, 29)  # in the VAE's encoder and decoder
PASSES_QUANTIZED = 743  # SDXL UNet linears with both widths ≥ 256
ROW_QUANT_LAUNCHES_PER_REQUEST = PASSES_QUANTIZED * 30  # each W8A8 linear runs once a UNet step
GROUP_NORM_LAUNCHES_PER_REQUEST = PASSES_UNET_FUSED * 30 + PASSES_VAE_FUSED[1]  # the encoder does not run
INT8_PSNR_FLOOR = 20.0  # tests/tpu/test_bf16_tpu.py: the int8 image against the bf16 image
SD15_UNET_PARAMETERS = 859_520_964
SD15_SIZE = 512  # image side of the SD1.5 requests (64×64 latents)
# K1 launches of one SD1.5 UNet call at 64×64 latents: self-attention at 64² (2 down, 3 up; seq 4096,
# 8 heads, d = 40) and at 32² (2 down, 3 up; seq 1024, d = 80); the 16², 8² and text sites stay plain
SD15_LAUNCHES_PER_STEP = 10
SD15_LAUNCHES_PER_REQUEST = SD15_LAUNCHES_PER_STEP * 30 + 1  # 30 DPM++ steps and the VAE decoder's mid-block
# an image of a num_images=2 request against a single request on its noise: bf16 rounds the
# batch-4 and batch-2 UNet calls differently, and 30 steps carry it into the image; the golden
# tests' PSNR floor for the same image (tests/e2e/test_golden.py:29)
SD15_PAIR_PSNR = 35.0
SD15_PAIR_SEED, SD15_IMG2IMG_SEED, SD15_INPAINT_SEED = 10, 20, 30
SD15_IMG2IMG_STRENGTH = 0.5
LORA_RANK = 32
LORA_SCALES = {"style": 1.0, "detail": 0.5}  # the two LoRAs of phase 8's first request
LORA_LAYERS = 16 * 10 + 12 * 6  # Linears of the UNet's 16 transformer blocks and of CLIP-L's 12 layers
CONTROLNET_PARAMETERS = 361_279_120
VIT_H_PARAMETERS = 632_076_800  # CLIPImageEncoderH, IP-Adapter's image encoder
SAG_SCALE = 0.75  # the golden's (tests/e2e/golden_cfg.py, build_sag)
ZOO_CONCEPT = "<zoo-style>"  # phase 9's textual-inversion token
ZOO_PROMPT = f"a cute cat sitting on a windowsill, in the style of {ZOO_CONCEPT}"
ELLA_DAMP = 0.2  # golden_cfg.build_ella: undamped random ELLA latents saturate the softmax into chaos
ELLA_TOKENS = 128  # phase 10's LLM embedding: a flan-t5-xl prompt's length
IC_LIGHT_CONV_IN = "DownBlocks.Chain_1.Conv2d.weight"
IC_LIGHT_PATCH_STD, IC_LIGHT_SCALE = 0.02, 2.0  # golden_cfg.build_ic_light's patch; ICLight's default CFG
PANORAMA = (512, 1024)  # phase 10's MultiDiffusion image (height, width)
# the MultiUpscaler's defaults (clarity-upscaler's): ×2, 18 DPM++ steps at denoise 0.35 (first step 11),
# MultiDiffusion tiles of 144 × 112 latents, ControlNet scale 0.6 and decay 0.825, VAE tiles of 1024 px
UPSCALE_INPUT = 768
UPSCALER_TILE = (144, 112)
UPSCALER_STEPS, UPSCALER_DENOISE = 18, 0.35
UPSCALER_CONTROLNET = (0.6, 0.825)
UPSCALER_VAE_TILE = 1024
UPSCALER_TILES, UPSCALER_VAE_TILES = 4, 4  # over 192 × 192 latents: 2 × 2 of each
UPSCALER_PROMPTS = ("masterpiece, best quality, highres", "worst quality, low quality, normal quality")
# phase 11: SDXL's adapter zoo at 1024² (the panorama 1024 × 2048), bf16, phase 3's weights
SDXL_SIZE = 1024
SDXL_PANORAMA = (1024, 2048)  # (height, width)
SDXL_LAUNCHES_PER_CALL = 70  # K1's UNet sites: 10 self-attentions at 4096 tokens, 60 at 1024
CONTROL_LORA_SITES = 4 + 20 + 10  # the half-UNet's: its down blocks at 4096 and 1024 tokens, its middle block
SDXL_SAG_SCALE = 1.0
SDXL_LORA_RANK, SDXL_LORA_SCALES = 32, {"style": 1.0, "detail": 0.5}
LCM_LORA_RANK = 64  # the LCM-LoRA's and the Lightning LoRA's
CONTROL_LORA_RANK = 128  # stability-ai's published Control-LoRAs: rank 128 and 256
# phase 12: DINOv2-g at its native size, the Fréchet distance's sets, the BoxSegmenter's request
DINOV2_SIZE = 518
DINOV2_BATCH = 4
DINOV2_GIANT_LAYERS = 40  # one K1 launch per layer at 1370 or 1374 tokens
DINOV2_FORWARDS = 5  # timed warm forwards of each model
FD_IMAGES = 16
BOX_IMAGE = (1536, 1024)  # (width, height)
BOX_PROMPT = (300, 120, 1260, 900)
BOX_REQUESTS = 4  # the first a warm-up
# the float32 MVANet's logits on the card against the CPU: in true float32, summation order through
# ~100 layers; under cuDNN's TF32 (PyTorch's default, the port's float32) each of its ~25
# convolutions rounds its inputs to 10 mantissa bits (unit roundoff 4.9e-4): 25 × 4.9e-4 ≈ 1.2e-2
BOX_F32_TOL = 1e-4
BOX_TF32_TOL = 2e-2
# the card's peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {BF16: 989e12, torch.float16: 989e12, F32: 67e12}
BACKWARD_SHAPES = [
    # (batch, q_len, kv_len, heads, head_dim, causal, dtype)
    (2, 4096, 4096, 8, 40, False, BF16),  # SD1.5 UNet self-attention at 64×64 latents
    (2, 1024, 1024, 8, 80, False, BF16),  # at 32×32 latents
    (2, 1024, 1024, 8, 80, True, BF16),
    (2, 1024, 1024, 8, 128, True, BF16),  # the D = 128 instance
    (2, 1200, 1000, 8, 40, True, BF16),  # Lq > Lk: 200 query rows without a key
    (2, 1000, 1100, 8, 80, True, BF16),  # Lq < Lk: every row sees keys, the diagonal 100 keys in
    (2, 4096, 4096, 8, 40, False, F32),
    (2, 1024, 1024, 8, 80, False, F32),
    (2, 1000, 1100, 5, 64, True, F32),
    # 128 < d <= 512: the wide kernel (bf16, fp16) and the float32 kernels' wide instances
    (2, 4096, 4096, 1, 512, False, BF16),  # the SD1.5 VAE decoder's mid-block at 512² (phase 4c's site)
    (1, 1024, 1024, 2, 256, False, BF16),
    (1, 1000, 1100, 1, 512, True, BF16),  # ragged and causal
    (1, 1024, 1024, 1, 200, False, BF16),  # d not a multiple of 16, padded to 256
    (1, 1024, 1024, 1, 512, False, torch.float16),
    (1, 1024, 1024, 1, 512, False, F32),
]
VAE_TRAIN_SHAPE = [2, 4096, 4096, 1, 512]  # K4a's and K4b's site on phase 4c's path (one launch each a step)
WIDE_BACKWARD_SHAPES = {"VAE": VAE_TRAIN_SHAPE, "d = 256": [1, 1024, 1024, 2, 256]}


def _tols(dtype: torch.dtype) -> tuple[float, float, float]:
    """(out, lse, gradient) tolerances of a kernel in `dtype` against its
    plain version in float32 on the same inputs."""
    return (F32_TOL, F32_TOL, F32_TOL) if dtype == F32 else (REL_TOL, LSE_TOL, GRAD_TOL)
PROMPTS = [
    ("a cute cat sitting on a windowsill, soft morning light", "blurry, low quality"),
    ("an astronaut riding a horse on the moon, highly detailed", "cartoon"),
    ("a bowl of ramen, studio photograph", ""),
]
TRAIN_CONFIG = """
[training]
duration = "4:step"
gradient_accumulation = "2:step"
dtype = "bfloat16"
device = "cuda"

[optimizer]
optimizer = "AdamW"
learning_rate = 1e-3

[lr_scheduler]
type = "ConstantLR"

[unet]
requires_grad = true
"""


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )  # fmt: skip
    return out.stdout.strip().splitlines()[0]


def _kernel_name(ptxas_line: str) -> str:
    """`flash_bwd_dkv_wgmma_kernel<bf16, 128>` from the ptxas line that names
    a kernel of this repository's sources: the last scope of its mangled
    name (each scope is its length, then its name) and the template's type
    and integer arguments."""
    mangled = ptxas_line.split("'")[1] if "'" in ptxas_line else ptxas_line.strip()
    pos, name = 3, mangled
    while mangled.startswith("_ZN") and pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        start = pos + len(digits)
        name, pos = mangled[start : start + int(digits)], start + int(digits)
    template = re.match(r"I(\w*?)EE?v", mangled[pos:])
    if template is None:
        return name
    types = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "float32", "b0": "false", "b1": "true"}
    tokens = re.findall(r"13__nv_bfloat16|6__half|^f|(?<=Li)\d+|(?<=L)b[01]", template.group(1))
    args = [types.get(tok, tok) for tok in tokens]
    return f"{name}<{', '.join(args)}>"


def _time_ms(fn: Callable[[], Any], reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn: Callable[[], Any], reps: int = 20) -> float:
    """Device milliseconds per call of `fn`, for calls shorter than their
    host overhead: the calls are enqueued while the stream sleeps, so the
    events bracket back-to-back device work and no host time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ≈ 25 ms at the H100's clock: the host enqueues the calls meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn: Callable[[], Any], reps: int = 200) -> float:
    """Host milliseconds a call: `reps` calls enqueued without a synchronize."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float()))


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _counters() -> dict[str, Any]:
    from refiners_tpu_torch.ops import flash_attention as fa
    from refiners_tpu_torch.ops import group_norm as gn
    from refiners_tpu_torch.ops import quant

    return {
        "flash_attention_packed": fa.flash_attention_packed,
        "flash_attention": fa.flash_attention,
        "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_attention_relpos": fa.flash_attention_relpos,
        "group_norm_stats": gn.group_norm_stats,
        "group_norm_apply": gn.group_norm_apply,
        "quantize_int8": quant.quantize_int8,
        "quantize_rows_int8": quant.quantize_rows_int8,
    }


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in _counters().items()}


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_packed_forward(dev: torch.device) -> list[dict]:
    from refiners_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_packed_plain

    results = []
    gen = torch.Generator(dev).manual_seed(0)
    for b, lq, lk, h, d, causal, dtype in ATTENTION_SHAPES:
        q, k, v = (torch.randn((b, n, h * d), generator=gen, device=dev).to(dtype) for n in (lq, lk, lk))
        out = flash_attention_packed(q, k, v, is_causal=causal, head_dim=d)
        torch.cuda.synchronize()
        ref = flash_attention_packed_plain(q.float(), k.float(), v.float(), is_causal=causal, head_dim=d)
        rel, max_abs = _rel(out, ref), _max_abs(out, ref)
        ms = _time_ms(lambda: flash_attention_packed(q, k, v, is_causal=causal, head_dim=d), reps=10)
        plain_ms = _time_ms(lambda: flash_attention_packed_plain(q, k, v, is_causal=causal, head_dim=d), reps=3, warmup=1)
        flops = 4 * b * h * lq * lk * d / (2 if causal else 1)
        print(
            f"packed forward (B={b}, Lq={lq}, Lk={lk}, H={h}, d={d}, causal={causal}, {dtype}): rel_err={rel:.3e} "
            f"max_abs_err={max_abs:.3e} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"kernel_TFLOP/s={flops / ms / 1e9:.1f}"
        )
        if not rel <= _tols(dtype)[0]:
            raise AssertionError(f"packed kernel disagrees with the plain version: rel_err={rel} > {_tols(dtype)[0]}")
        results.append(
            {"shape": [b, lq, lk, h, d], "causal": causal, "dtype": str(dtype), "rel_err": rel,
             "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
        )  # fmt: skip
        del q, k, v, out, ref

    # causal with Lq > Lk: rows i < Lq - Lk have no admissible key; every
    # score ties at -1e30 and the kernel gives them uniform weights (the mean
    # of V), where the plain path gives NaN
    b, lq, lk, h, d = 1, 300, 200, 2, 64
    q = torch.randn((b, lq, h * d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, lk, h * d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, lk, h * d), generator=gen, device=dev).bfloat16()
    out = flash_attention_packed(q, k, v, is_causal=True, head_dim=d).float()
    torch.cuda.synchronize()
    empty = lq - lk
    uniform = v.float().mean(dim=1, keepdim=True).expand(b, empty, h * d)
    rel_uniform = _rel(out[:, :empty], uniform)
    ref_rest = flash_attention_packed_plain(q.float(), k.float(), v.float(), is_causal=True, head_dim=d)[:, empty:]
    rel_rest = _rel(out[:, empty:], ref_rest)
    print(f"packed forward, fully-masked causal rows: rel_err vs uniform={rel_uniform:.3e}, other rows {rel_rest:.3e}")
    if not (rel_uniform <= REL_TOL and rel_rest <= REL_TOL):
        raise AssertionError("causal rows with no admissible key must get uniform weights")
    return results


def check_forward(dev: torch.device) -> list[dict]:
    from refiners_tpu_torch.ops import flash_attention as fa
    from refiners_tpu_torch.ops.attention import dot_product_attention

    results = []
    gen = torch.Generator(dev).manual_seed(1)
    for b, lq, lk, h, d, causal, bias_shape, dtype in FORWARD_SHAPES:
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device=dev).to(dtype) for n in (lq, lk, lk))
        bias = torch.randn(bias_shape, generator=gen, device=dev) if bias_shape else None
        out, lse = fa.flash_attention_forward(q, k, v, bias, is_causal=causal, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa._plain_forward(q.float(), k.float(), v.float(), bias, causal, None)
        rel, max_abs, lse_err = _rel(out, ref), _max_abs(out, ref), _max_abs(lse, ref_lse)
        ms = _time_ms(lambda: fa.flash_attention_forward(q, k, v, bias, is_causal=causal, with_lse=True), reps=10)
        plain_ms = _time_ms(lambda: fa._plain_forward(q, k, v, bias, causal, None), reps=3, warmup=1)
        flops = 4 * b * h * lq * lk * d / (2 if causal else 1)
        print(
            f"forward+lse (B={b}, Lq={lq}, Lk={lk}, H={h}, d={d}, causal={causal}, bias={bias_shape}, {dtype}): "
            f"rel_err={rel:.3e} max_abs_err={max_abs:.3e} lse_max_abs_err={lse_err:.3e} kernel_ms={ms:.3f} "
            f"plain_ms={plain_ms:.3f} kernel_TFLOP/s={flops / ms / 1e9:.1f}"
        )
        tol, lse_tol, _ = _tols(dtype)
        if not (rel <= tol and lse_err <= lse_tol):
            raise AssertionError(f"forward kernel disagrees: rel_err={rel} (≤ {tol}), lse {lse_err} (≤ {lse_tol})")
        results.append(
            {"shape": [b, lq, lk, h, d], "causal": causal, "bias": bias_shape, "dtype": str(dtype), "rel_err": rel,
             "max_abs_err": max_abs, "lse_max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms}
        )  # fmt: skip
        del q, k, v, bias, out, lse, ref, ref_lse
        _free()

    # a boolean keep-mask with one fully masked row: uniform weights
    q, k, v = (torch.randn((1, 4, 1024, 64), generator=gen, device=dev).bfloat16() for _ in range(3))
    mask = torch.rand((1, 1, 1024, 1024), generator=gen, device=dev) > 0.5
    mask[..., 17, :] = False
    got = dot_product_attention(q, k, v, mask=mask, use_flash=True)
    torch.cuda.synchronize()
    rel_mask = _rel(got, fa.flash_attention_plain(q.float(), k.float(), v.float(), bias=torch.where(mask, 0.0, -1e30)))
    rel_uniform = _rel(got[..., 17, :], v.float().mean(dim=2))
    print(f"forward, boolean mask: rel_err={rel_mask:.3e}, fully masked row vs uniform rel_err={rel_uniform:.3e}")
    if not (rel_mask <= REL_TOL and rel_uniform <= REL_TOL):
        raise AssertionError("a boolean-masked row with no key must get uniform weights")
    return results


def check_backward(dev: torch.device) -> tuple[list[dict], list[dict]]:
    from refiners_tpu_torch.ops import flash_attention as fa
    from refiners_tpu_torch.ops.attention import split_heads

    dkv_results, dq_results = [], []
    gen = torch.Generator(dev).manual_seed(2)

    def one(label: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, timed: bool) -> None:
        out, lse = fa.flash_attention_forward(q, k, v, is_causal=causal, with_lse=True)
        do = torch.randn(out.shape, generator=gen, device=dev).to(q.dtype)
        dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse, do, is_causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse, do.float(), causal)
        rels = [_rel(g, w) for g, w in zip((dq, dk, dv), want)]
        errs = [_max_abs(g, w) for g, w in zip((dq, dk, dv), want)]
        line = f"backward {label}, {q.dtype}: rel_err dq={rels[0]:.3e} dk={rels[1]:.3e} dv={rels[2]:.3e}"
        if timed:
            b, h, lq, d = q.shape
            scale = 1.0 / math.sqrt(d)
            delta = (do.float() * out.float()).sum(-1)
            dkv_ms = _time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale), reps=10)
            dq_ms = _time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale), reps=10)
            plain_ms = _time_ms(lambda: fa.flash_attention_backward_plain(q, k, v, out, lse, do, causal), reps=3, warmup=1)
            lk = k.shape[2]
            flops = b * h * lq * lk * d / (2 if causal else 1)
            line += (
                f" dkv_ms={dkv_ms:.3f} ({8 * flops / dkv_ms / 1e9:.1f} TFLOP/s) dq_ms={dq_ms:.3f} "
                f"({6 * flops / dq_ms / 1e9:.1f} TFLOP/s) plain_ms={plain_ms:.3f} (dq, dk, dv together)"
            )
            shape = {"shape": [b, lq, lk, h, d], "causal": causal, "dtype": str(q.dtype), "plain_ms": plain_ms}
            dkv_results.append({**shape, "rel_err": max(rels[1:]), "max_abs_err": max(errs[1:]), "ms": dkv_ms})
            dq_results.append({**shape, "rel_err": rels[0], "max_abs_err": errs[0], "ms": dq_ms})
        print(line)
        tol = _tols(q.dtype)[2]
        if not max(rels) <= tol:
            raise AssertionError(f"backward kernels disagree with the plain version: {rels} > {tol}")

    for b, lq, lk, h, d, causal, dtype in BACKWARD_SHAPES:
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device=dev).to(dtype) for n in (lq, lk, lk))
        one(f"(B={b}, Lq={lq}, Lk={lk}, H={h}, d={d}, causal={causal})", q, k, v, causal, timed=True)
        del q, k, v
        _free()
    # heads read through strides: column slices of a packed fused projection
    qkv = torch.randn((2, 4096, 3 * 320), generator=gen, device=dev).bfloat16()
    q, k, v = (split_heads(qkv[..., i * 320 : (i + 1) * 320], 8) for i in range(3))
    one("strided heads of a fused (2, 4096, 3·8·40) projection", q, k, v, False, timed=False)
    qkv = torch.randn((1, 4096, 3 * 512), generator=gen, device=dev).bfloat16()
    q, k, v = (split_heads(qkv[..., i * 512 : (i + 1) * 512], 1) for i in range(3))
    one("strided heads of a fused (1, 4096, 3·512) projection (the wide kernel)", q, k, v, False, timed=False)
    return dkv_results, dq_results


def check_relpos(dev: torch.device) -> list[dict]:
    from refiners_tpu_torch.ops import flash_attention as fa

    results = []
    gen = torch.Generator(dev).manual_seed(4)
    for b, kh, kw, h, d, dtype in RELPOS_SHAPES:
        seq = kh * kw
        # q, k, v as head views of one fused (B, L, 3, H, D) projection, as SAM's encoder reads them
        qkv = torch.randn((b, seq, 3 * h * d), generator=gen, device=dev).to(dtype)
        q, k, v = qkv.reshape(b, seq, 3, h, d).permute(2, 0, 3, 1, 4)
        v_rel = torch.randn((b, h, seq, kh), generator=gen, device=dev).to(dtype)
        h_rel = torch.randn((b, h, seq, kw), generator=gen, device=dev).to(dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = fa.flash_attention_relpos(q, k, v, v_rel, h_rel)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - base - out.numel() * out.element_size()
        ref = fa.flash_attention_relpos_plain(*(x.float() for x in (q, k, v, v_rel, h_rel)))
        rel, max_abs = _rel(out, ref), _max_abs(out, ref)
        del ref
        ms = _time_ms(lambda: fa.flash_attention_relpos(q, k, v, v_rel, h_rel), reps=10)
        plain_ms = _time_ms(lambda: fa.flash_attention_relpos_plain(q, k, v, v_rel, h_rel), reps=3, warmup=1)
        flops = 4 * b * h * seq * seq * d
        print(
            f"relpos forward (B={b}, L={seq}, grid {kh}x{kw}, H={h}, d={d}, {dtype}): rel_err={rel:.3e} "
            f"max_abs_err={max_abs:.3e} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"kernel_TFLOP/s={flops / ms / 1e9:.1f} allocated beyond the output {extra / 2**20:.2f} MiB"
        )
        tol = _tols(dtype)[0]
        if not rel <= tol:
            raise AssertionError(f"relpos kernel disagrees with the plain version: rel_err={rel} > {tol}")
        if (kh, kw) == (64, 64) and not extra < RELPOS_EXTRA_BYTES:
            raise AssertionError(f"relpos kernel allocated {extra} bytes beyond its output (limit {RELPOS_EXTRA_BYTES})")
        results.append(
            {"shape": [b, seq, seq, h, d], "grid": [kh, kw], "dtype": str(dtype), "rel_err": rel,
             "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "extra_bytes": extra}
        )  # fmt: skip
        del qkv, q, k, v, v_rel, h_rel, out
        _free()
    return results


def _bound(flops: float, nbytes: float, dtype: torch.dtype) -> dict[str, Any]:
    """The least time the card could take: the larger of the operations over
    the peak rate of `dtype` and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _print_row(label: str, ms: float, row: dict[str, Any]) -> None:
    library = f"{row['library_ms']:.4f}" if row["library_ms"] is not None else "none"
    library_queued = f"{row['library_device_ms']:.4f}" if row.get("library_device_ms") is not None else "none"
    queued = (
        f" queued device_ms={row['device_ms']:.4f} (share {row['bound_ms'] / row['device_ms']:.3f}), "
        f"library {library_queued}"
        if "device_ms" in row
        else ""
    )
    kernel = f" [{row['cuda_kernel']}]" if "cuda_kernel" in row else ""
    print(
        f"row {label}{kernel}: kernel_ms={ms:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
        f"share={row['bound_ms'] / ms:.3f} library_ms={library} ({row['library_call']}){queued}"
    )


def _library_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor) -> tuple[Any, str]:
    """One PyTorch call computing dq, dk and dv from the forward's residuals
    at a wide head: the backward of ``F.scaled_dot_product_attention`` under
    the memory-efficient backend (its ``aten._scaled_dot_product_efficient_attention_backward``,
    which takes d = 512 where the flash one stops at 256), through
    ``torch.autograd.grad`` on a forward taken once; the flash backend where
    the efficient one refuses; (None, why) where both do."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    reasons = []
    for backend, op in ((SDPBackend.EFFICIENT_ATTENTION, "_scaled_dot_product_efficient_attention_backward"),
                        (SDPBackend.FLASH_ATTENTION, "_scaled_dot_product_flash_attention_backward")):  # fmt: skip
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(*leaves)

            def library(out: torch.Tensor = out, leaves: list[torch.Tensor] = leaves) -> Any:
                return torch.autograd.grad(out, leaves, do, retain_graph=True)

            library()
            torch.cuda.synchronize()
            return library, f"aten.{op} (dq, dk, dv), through torch.autograd.grad of F.scaled_dot_product_attention"
        except RuntimeError as e:
            reasons.append(f"{backend.name}: {str(e).splitlines()[0][:120]}")
    return None, "none (" + "; ".join(reasons) + ")"


def attention_rows(dev: torch.device) -> dict[str, dict[str, Any]]:
    """Bound and library time of K1-K4 at their main-path shapes (bf16),
    the rows of the kernel table, and the CUDA kernel that serves each; for
    K1's UNet sites and K3's layers also the queued device time of the
    kernel and of the library call. The library calls are timed here only."""
    import torch.nn.functional as F

    from refiners_tpu_torch.ops import flash_attention as fa

    rows: dict[str, dict[str, Any]] = {}
    gen = torch.Generator(dev).manual_seed(5)

    def randn(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=dev).to(BF16)

    # K1: packed (B, L, H·D) at the SDXL UNet's 64×64 and 32×32
    # self-attention, and at the VAE decoder's mid-block (one head of d = 512
    # over 128×128 latents)
    sites = [("K1", (2, 4096, 4096, 10, 64)), ("K1 32²", (2, 1024, 1024, 20, 64)), ("K1 VAE", (1, 16384, 16384, 1, 512))]
    sites += [(label, tuple(shape)) for label, shape in
              {**SD15_SHAPES, **SD15_ZOO_SHAPES, **SD15_UPSCALER_SHAPES, **SDXL_ZOO_SHAPES, **DINOV2_SHAPES}.items()]  # fmt: skip
    for label, (b, lq, lk, h, d) in sites:
        q, k, v = randn(b, lq, h * d), randn(b, lk, h * d), randn(b, lk, h * d)
        heads = lambda t: t.view(b, t.shape[1], h, d).transpose(1, 2)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v))  # noqa: E731
        rows[label] = {
            # q, k, v read once and the output written once
            **_bound(4 * b * h * lq * lk * d, 2 * b * (lq + lk) * h * d * 2, BF16),
            "library_ms": _time_ms(library, reps=10),
            "library_call": f"F.scaled_dot_product_attention on the {(b, h, lq, d)} query and {(b, h, lk, d)} key views",
            "cuda_kernel": fa.forward_kernel(BF16, d),
        }
        if label != "K1 VAE":
            rows[label]["device_ms"] = _device_ms(lambda: fa.flash_attention_packed(q, k, v, head_dim=d))
            rows[label]["library_device_ms"] = _device_ms(library)
        del q, k, v
    # K2 and K4 at the SD1.5 UNet's self-attention sites, (B, H, L, D) at
    # 64×64 and 32×32 latents (5 launches each per training step), against
    # the flash-attention calls of PyTorch that return and take the lse
    aten = torch.ops.aten
    for label, (b, h, seq, d) in (("", (2, 8, 4096, 40)), (" 32²", (2, 8, 1024, 80))):
        q, k, v, do = randn(b, h, seq, d), randn(b, h, seq, d), randn(b, h, seq, d), randn(b, h, seq, d)
        n, scale = b * h * seq * d, 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention_forward(q, k, v, with_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        library = lambda: aten._scaled_dot_product_flash_attention(q, k, v, scale=scale)  # noqa: E731
        lib = library()
        library_backward = lambda: aten._scaled_dot_product_flash_attention_backward(  # noqa: E731
            do, q, k, v, lib[0], lib[1], lib[2], lib[3], lib[4], lib[5], 0.0, False, lib[6], lib[7], scale=scale
        )
        backward = lambda: fa.flash_attention_backward(q, k, v, out, lse, do)  # noqa: E731
        dkv = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, False, scale)  # noqa: E731
        dq = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, False, scale)  # noqa: E731
        backward_call = (
            "aten._scaled_dot_product_flash_attention_backward (dq, dk, dv), against flash_attention_backward "
            "(the delta reduction + K4a + K4b)"
        )
        library_backward_ms, library_backward_device_ms = _time_ms(library_backward, reps=10), _device_ms(library_backward)
        backward_ms, backward_device_ms = _time_ms(backward, reps=10), _device_ms(backward)
        together = {"backward_ms": backward_ms, "backward_device_ms": backward_device_ms}
        rows["K2" + label] = {
            **_bound(4 * b * h * seq * seq * d, 4 * n * 2 + b * h * seq * 4, BF16),
            "library_ms": _time_ms(library, reps=10),
            "library_call": "aten._scaled_dot_product_flash_attention (out and lse)",
            "cuda_kernel": fa.forward_kernel(BF16, d),
            "device_ms": _device_ms(lambda: fa.flash_attention_forward(q, k, v, with_lse=True)),
            "library_device_ms": _device_ms(library),
        }
        rows["K4a" + label] = {
            **_bound(8 * b * h * seq * seq * d, 6 * n * 2 + 2 * b * h * seq * 4, BF16),
            "library_ms": library_backward_ms, "library_call": backward_call, "cuda_kernel": fa.BACKWARD_KERNELS[BF16][0],
            "device_ms": _device_ms(dkv), "library_device_ms": library_backward_device_ms, **together,
        }  # fmt: skip
        rows["K4b" + label] = {
            **_bound(6 * b * h * seq * seq * d, 5 * n * 2 + 2 * b * h * seq * 4, BF16),
            "library_ms": library_backward_ms, "library_call": backward_call, "cuda_kernel": fa.BACKWARD_KERNELS[BF16][1],
            "device_ms": _device_ms(dq), "library_device_ms": library_backward_device_ms, **together,
        }  # fmt: skip
        del q, k, v, do, out, lse, delta, lib
        _free()
    # K4a and K4b at the wide heads: the SD1.5 VAE decoder's mid-block at 512² (phase 4c, one launch
    # each a step) and d = 256; both on `flash_bwd_wide_wgmma_kernel`
    for label, (b, seq, _, h, d) in WIDE_BACKWARD_SHAPES.items():
        q, k, v, do = randn(b, h, seq, d), randn(b, h, seq, d), randn(b, h, seq, d), randn(b, h, seq, d)
        n, scale = b * h * seq * d, 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention_forward(q, k, v, with_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        dkv = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, False, scale)  # noqa: E731
        dq = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, False, scale)  # noqa: E731
        library_backward, backward_call = _library_backward(q, k, v, do)
        library = (
            {"library_ms": _time_ms(library_backward, reps=10), "library_device_ms": _device_ms(library_backward)}
            if library_backward is not None
            else {"library_ms": None, "library_device_ms": None}
        )
        backward = lambda: fa.flash_attention_backward(q, k, v, out, lse, do)  # noqa: E731
        together = {"backward_ms": _time_ms(backward, reps=10), "backward_device_ms": _device_ms(backward)}
        kernels = fa.backward_kernels(BF16, d)
        rows[f"K4a {label}"] = {
            **_bound(8 * b * h * seq * seq * d, 6 * n * 2 + 2 * b * h * seq * 4, BF16), **library,
            "library_call": backward_call + ", against the delta reduction + K4a + K4b", "cuda_kernel": kernels[0],
            "ms": _time_ms(dkv, reps=10), "device_ms": _device_ms(dkv), **together,
        }  # fmt: skip
        rows[f"K4b {label}"] = {
            **_bound(6 * b * h * seq * seq * d, 5 * n * 2 + 2 * b * h * seq * 4, BF16), **library,
            "library_call": backward_call + ", against the delta reduction + K4a + K4b", "cuda_kernel": kernels[1],
            "ms": _time_ms(dq, reps=10), "device_ms": _device_ms(dq), **together,
        }  # fmt: skip
        del q, k, v, do, out, lse, delta
        _free()
    # K3: SAM-H's global and windowed layers; the dense bias is built outside the timed call
    for label, (b, kh, h, d) in (("K3 global", (1, 64, 16, 80)), ("K3 windowed", (25, 14, 16, 80))):
        seq = kh * kh
        q, k, v = randn(b, h, seq, d), randn(b, h, seq, d), randn(b, h, seq, d)
        v_rel, h_rel = randn(b, h, seq, kh), randn(b, h, seq, kh)
        bias = (v_rel[..., :, None] + h_rel[..., None, :]).reshape(b, h, seq, seq)
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)  # noqa: E731
        rows[label] = {
            **_bound(4 * b * h * seq * seq * d, 4 * b * h * seq * d * 2 + 2 * b * h * seq * kh * 2, BF16),
            "library_ms": _time_ms(library, reps=10),
            "library_call": "F.scaled_dot_product_attention with the dense bias as attn_mask",
            "cuda_kernel": fa.forward_kernel(BF16, d),
            "device_ms": _device_ms(lambda: fa.flash_attention_relpos(q, k, v, v_rel, h_rel)),
            "library_device_ms": _device_ms(library),
        }
        del q, k, v, v_rel, h_rel, bias
        _free()
    return rows


def check_group_norm(dev: torch.device) -> tuple[list[dict], list[dict]]:
    """K5a and K5b at the SDXL path's shapes, bf16 and float32."""
    import torch.nn.functional as F

    from refiners_tpu_torch.ops import group_norm as gn

    stats_results, apply_results = [], []
    gen = torch.Generator(dev).manual_seed(6)
    for shape, groups in GROUP_NORM_SHAPES:
        for dtype in (BF16, F32):
            c = shape[1]
            x = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
            w = (torch.randn((c,), generator=gen, device=dev) * 0.2 + 1.0).to(dtype)
            b = (torch.randn((c,), generator=gen, device=dev) * 0.1).to(dtype)
            partials = gn.group_norm_stats(x, groups)
            y = gn.group_norm_apply(x, partials, w, b, groups)
            torch.cuda.synchronize()
            rel = _rel(y, gn.group_norm_silu_plain(x.float(), w.float(), b.float(), groups))
            stats_plain = gn.group_norm_stats_plain(x, groups)
            stats_rel, stats_err = _rel(partials, stats_plain), _max_abs(partials, stats_plain)
            apply_err = _max_abs(y, gn.group_norm_apply_plain(x.float(), partials, w.float(), b.float(), groups))
            stats_ms = _device_ms(lambda: gn.group_norm_stats(x, groups))
            apply_ms = _device_ms(lambda: gn.group_norm_apply(x, partials, w, b, groups))
            fused_ms = _device_ms(lambda: gn.group_norm_silu(x, w, b, groups))
            host_ms = _time_ms(lambda: gn.group_norm_silu(x, w, b, groups), reps=20)
            stats_plain_ms = _device_ms(lambda: gn.group_norm_stats_plain(x, groups), reps=5)
            apply_plain_ms = _device_ms(lambda: gn.group_norm_apply_plain(x, partials, w, b, groups), reps=5)
            plain_ms = _device_ms(lambda: gn.group_norm_silu_plain(x, w, b, groups), reps=5)
            var_mean_ms = _device_ms(lambda: torch.var_mean(x.view(shape[0], groups, -1), dim=-1))
            library_ms = _device_ms(lambda: F.silu(F.group_norm(x, groups, w, b, 1e-5)))
            numel, size = x.numel(), x.element_size()
            # float32 arithmetic on FFMA: 3 operations an element for the sums, about 8 for the apply and SiLU
            stats_row = {**_bound(3 * numel, numel * size + partials.numel() * 4, F32), "library_ms": var_mean_ms,
                         "library_call": "torch.var_mean over the groups"}  # fmt: skip
            apply_row = {**_bound(8 * numel, 2 * numel * size + partials.numel() * 4 + 2 * c * size, F32),
                         "library_ms": library_ms,
                         "library_call": "F.silu(F.group_norm(...)): two calls, the whole op, against K5a + K5b"}  # fmt: skip
            print(
                f"group norm + SiLU ({tuple(shape)}, G={groups}, {dtype}): rel_err={rel:.3e} | K5a stats rel_err="
                f"{stats_rel:.3e} max_abs_err={stats_err:.3e} ms={stats_ms:.4f} plain_ms={stats_plain_ms:.4f} "
                f"bound_ms={stats_row['bound_ms']:.4f} var_mean_ms={var_mean_ms:.4f} | K5b apply max_abs_err="
                f"{apply_err:.3e} ms={apply_ms:.4f} plain_ms={apply_plain_ms:.4f} bound_ms={apply_row['bound_ms']:.4f} "
                f"| K5a+K5b {fused_ms:.4f} ms ({host_ms:.4f} ms as one call timed alone, host included), plain "
                f"{plain_ms:.4f} ms, F.silu(F.group_norm) {library_ms:.4f} ms"
            )
            tol = F32_TOL if dtype == F32 else REL_TOL
            if not (rel <= tol and stats_rel <= F32_TOL):
                raise AssertionError(f"K5 disagrees with its plain version: rel_err={rel} (≤ {tol}), stats {stats_rel}")
            common = {"shape": list(shape), "groups": groups, "dtype": str(dtype), "rel_err": rel,
                      "fused_ms": fused_ms, "fused_host_ms": host_ms, "fused_plain_ms": plain_ms}  # fmt: skip
            stats_results.append({**common, **stats_row, "max_abs_err": stats_err, "ms": stats_ms, "plain_ms": stats_plain_ms})
            apply_results.append({**common, **apply_row, "max_abs_err": apply_err, "ms": apply_ms, "plain_ms": apply_plain_ms})
            del x, w, b, partials, y, stats_plain
            _free()

    shape, groups = GROUP_NORM_SHAPES[0]
    x = torch.randn(shape, generator=gen, device=dev).to(BF16)
    w, b = torch.ones(shape[1], device=dev, dtype=BF16), torch.zeros(shape[1], device=dev, dtype=BF16)
    rel = _rel(gn.group_norm_silu(x, w, b, groups, apply_silu=False),
               gn.group_norm_silu_plain(x.float(), w.float(), b.float(), groups, apply_silu=False))  # fmt: skip
    print(f"group norm without SiLU ({tuple(shape)}, bf16): rel_err={rel:.3e}")
    if not rel <= REL_TOL:
        raise AssertionError(f"K5 without SiLU disagrees with its plain version: {rel}")
    return stats_results, apply_results


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `x` that starts one element past a 16-byte boundary."""
    buffer = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    shifted = buffer[1:].view(x.shape)
    shifted.copy_(x)
    return shifted


def check_quantize(dev: torch.device) -> list[dict]:
    """K6 at the SDXL linears' shapes: bit-equal to its plain version."""
    from refiners_tpu_torch.ops import quant

    results = []
    gen = torch.Generator(dev).manual_seed(8)
    cases = [(shape, BF16, False) for shape in QUANT_SHAPES] + [(QUANT_SHAPES[0], F32, False), ((37, 301), BF16, True)]
    for (rows, cols), dtype, unaligned in cases:
        w = (torch.randn((rows, cols), generator=gen, device=dev) * cols**-0.5).to(dtype)
        if unaligned:
            w = _unaligned(w)
        seed = rows * cols
        values, scales = quant.quantize_int8(w, seed=seed)
        torch.cuda.synchronize()
        want_values, want_scales = quant.quantize_int8_plain(w, seed=seed)
        mismatches = int((values != want_values).sum()) + int((scales != want_scales).sum())
        scaled = w.float() / scales[0][:, None]
        q = values.float()
        bracket = bool(((q == torch.floor(scaled)) | (q == torch.ceil(scaled))).all())
        clipped = int(values.abs().max()) <= 127
        ms = _device_ms(lambda: quant.quantize_int8(w, seed=seed))
        plain_ms = _device_ms(lambda: quant.quantize_int8_plain(w, seed=seed), reps=3)
        # Philox: 10 rounds of 2 multiplies and 4 other operations per 4 elements, about 6 more per element
        row = {**_bound(21 * rows * cols, rows * cols * (w.element_size() + 1) + rows * 4, F32), "library_ms": None,
               "library_call": "no single PyTorch call computes it"}  # fmt: skip
        print(
            f"int8 quantize ({rows}, {cols}), {dtype}{', off a 16-byte boundary' if unaligned else ''}: mismatches "
            f"against the plain version {mismatches}, "
            f"floor/ceil bracket {bracket}, |q| <= 127 {clipped}, kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
        )
        if mismatches or not (bracket and clipped):
            raise AssertionError(f"K6 at ({rows}, {cols}) is not bit-equal to its plain version or leaves its bracket")
        results.append({"shape": [rows, cols], "dtype": str(dtype), "unaligned": unaligned, "max_abs_err": 0.0, "ms": ms,
                        "plain_ms": plain_ms, **row})  # fmt: skip
        del w, values, scales, want_values, want_scales, scaled, q

    w = torch.randn((256, 1024), generator=gen, device=dev) * 0.02
    total = torch.zeros(w.shape, device=dev, dtype=torch.float64)
    for seed in range(QUANT_SEEDS):
        values, scales = quant.quantize_int8(w, seed=seed)
        total += values.double()
    error = total / QUANT_SEEDS - (w / scales[0][:, None]).double()
    worst, mean = float(error.abs().max()), float(error.mean())
    print(f"int8 quantize, {QUANT_SEEDS} seeds on (256, 1024): max |mean q - w/scale| = {worst:.4f}, mean error {mean:.2e}")
    if not (worst <= QUANT_UNBIASED_TOL and abs(mean) <= 1e-3):
        raise AssertionError(f"K6's rounding is biased: max {worst} (≤ {QUANT_UNBIASED_TOL}), mean {mean} (≤ 1e-3)")
    return results


def check_quantize_rows(dev: torch.device) -> tuple[list[dict], dict[str, float]]:
    """The row mode at the W8A8 activations' shapes: bit-equal to its plain
    version; and the host cost of one call against the eager sequence."""
    from refiners_tpu_torch.ops import quant

    results = []
    gen = torch.Generator(dev).manual_seed(10)
    cases = [(shape, BF16, "") for shape in ROW_QUANT_SHAPES]
    cases += [(ROW_QUANT_SHAPES[0], F32, ""), ((300, 1280), BF16, "row view")]
    for (rows, cols), dtype, layout in cases:
        x = (torch.randn((rows, cols), generator=gen, device=dev) * 3.0).to(dtype)
        x[0] *= 40.0  # an outlier token
        if layout:  # every row starts elsewhere, the first one element past a 16-byte boundary
            x = torch.cat([torch.zeros((rows, 1), device=dev, dtype=dtype), x], dim=1)[:, 1:]
        values, scales = quant.quantize_rows_int8(x, min_rows=32)
        torch.cuda.synchronize()
        want_values, want_scales = quant.quantize_rows_int8_plain(x)
        mismatches = int((values[:rows] != want_values).sum()) + int((scales != want_scales).sum())
        padding = int(values[rows:].count_nonzero())
        clipped = int(values.abs().max()) <= 127
        ms = _device_ms(lambda: quant.quantize_rows_int8(x, min_rows=32))
        plain_ms = _device_ms(lambda: quant.quantize_rows_int8_plain(x), reps=5)
        # about 9 float32 operations an element: the abs-max, the division in five, the rounding and the clamp
        row = {**_bound(9 * rows * cols, rows * cols * (x.element_size() + 1) + rows * 4, F32), "library_ms": None,
               "library_call": "no single PyTorch call computes it"}  # fmt: skip
        print(
            f"int8 rows ({rows}, {cols}), {dtype}{', ' + layout if layout else ''}: mismatches against the plain "
            f"version {mismatches}, nonzero padding {padding}, |q| <= 127 {clipped}, kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) share={row['bound_ms'] / ms:.3f}"
        )
        if mismatches or padding or not clipped:
            raise AssertionError(f"the row mode at ({rows}, {cols}) is not bit-equal to its plain version")
        results.append({"shape": [rows, cols], "dtype": str(dtype), "layout": layout or "contiguous", "max_abs_err": 0.0,
                        "ms": ms, "plain_ms": plain_ms, **row})  # fmt: skip
        del x, values, scales, want_values, want_scales

    # the host's share: one call of the entry against the eager sequence, on a small input
    x = torch.randn((154, 2048), generator=gen, device=dev).to(BF16)
    host = {"host_ms": _host_ms(lambda: quant.quantize_rows_int8(x, min_rows=32)),
            "plain_host_ms": _host_ms(lambda: quant.quantize_rows_int8_plain(x))}  # fmt: skip
    print(f"int8 rows, host cost per call at (154, 2048): kernel entry {host['host_ms']:.4f} ms, eager sequence "
          f"{host['plain_host_ms']:.4f} ms (200 calls enqueued without a synchronize)")  # fmt: skip
    return results, host


def check_device_default() -> None:
    """Facades built with no device land on the card, their parts moved there."""
    from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder, CLIPTokenizer
    from refiners_tpu_torch.foundationals.latent_diffusion import (
        DDIM,
        DoubleTextEncoder,
        SD1Autoencoder,
        SD1UNet,
        SDXLAutoencoder,
        SDXLUNet,
        StableDiffusion_1,
        StableDiffusion_1_Inpainting,
        StableDiffusion_XL,
    )
    from refiners_tpu_torch.foundationals.segment_anything import (
        MaskDecoder,
        MaskEncoder,
        PointEncoder,
        SAMViT,
        SegmentAnything,
    )

    small = dict(num_layers=1, feedforward_dim=64)
    text_l = CLIPTextEncoder(embedding_dim=768, num_attention_heads=12, use_quick_gelu=True, **small)
    text_g = CLIPTextEncoder(embedding_dim=1280, num_attention_heads=20, tokenizer=CLIPTokenizer(pad_token_id=0), **small)
    sd = StableDiffusion_XL(
        unet=SDXLUNet(in_channels=4, base_channels=32), lda=SDXLAutoencoder(),
        clip_text_encoder=DoubleTextEncoder(text_encoder_l=text_l, text_encoder_g=text_g),
        solver=DDIM(num_inference_steps=2),
    )  # fmt: skip
    sam = SegmentAnything(
        SAMViT(embedding_dim=32, num_layers=2, num_heads=2, global_attention_indices=(1,)),
        PointEncoder(), MaskEncoder(), MaskDecoder(multimask_output=False),
    )  # fmt: skip
    text_sd1 = CLIPTextEncoder(embedding_dim=768, num_attention_heads=12, use_quick_gelu=True, **small)
    sd1 = StableDiffusion_1(unet=SD1UNet(in_channels=4, base_channels=32), lda=SD1Autoencoder(), clip_text_encoder=text_sd1)
    inpainting = StableDiffusion_1_Inpainting(unet=SD1UNet(in_channels=9, base_channels=32), lda=sd1.lda,
                                              clip_text_encoder=text_sd1)  # fmt: skip
    models = (sd, sam, sd1, inpainting)
    devices = {p.device.type for model in models for p in model.parameters()}
    devices |= {m.solver.timesteps.device.type for m in (sd, sd1, inpainting)}
    print(f"device default: StableDiffusion_XL(), StableDiffusion_1(), StableDiffusion_1_Inpainting() and "
          f"SegmentAnything(...) with no device hold their tensors on {devices}")  # fmt: skip
    if devices != {"cuda"}:
        raise AssertionError(f"a facade built with no device left tensors on {devices}")
    del sd, sam, sd1, inpainting, models, text_l, text_g, text_sd1
    _free()


# ---------------------------------------------------------------------------
# phase 3: SDXL serving
# ---------------------------------------------------------------------------


def _profile(label: str, fn: Callable[[], Any], unit: str) -> dict[str, Any]:
    """`fn` once to warm up, its host-clock milliseconds (median of 3), then
    once under ``torch.profiler``: device time by kernel kind and idle share."""
    from refiners_tpu_torch.examples.profile_sam import _profiled
    from refiners_tpu_torch.examples.profile_train import device_breakdown

    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    wall = statistics.median(walls)
    return {"wall_ms": wall * 1e3, **device_breakdown(_profiled(fn), wall, label=label, unit=unit, top=4)}


def run_sdxl(dev: torch.device) -> tuple[dict[str, int], list[float], list[float], int, np.ndarray, dict[str, Any]]:
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, StableDiffusion_XL
    from refiners_tpu_torch.pipelines import TextToImage

    t0 = time.perf_counter()
    manual_seed(0)
    sd = StableDiffusion_XL(solver=DDIM(num_inference_steps=30, device=dev), device=dev, dtype=torch.bfloat16)
    synthesize_weights(sd, seed=7)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sd.parameters())
    print(f"sdxl: StableDiffusion_XL built, {n_params} parameters, bf16, {time.perf_counter() - t0:.1f} s")

    # One full-width UNet step (CFG batch 2) three ways: bf16 through the
    # kernel, bf16 on the plain path, and float32 on the plain path as the
    # reference. Random weights amplify rounding noise through 70 attention
    # layers, so the kernel route is held to the plain route's own distance
    # from the float32 reference, not to the plain route itself.
    pipe = TextToImage(sd, size=(1024, 1024))
    sdpa = list(sd.unet.layers(fl.ScaledDotProductAttention, recurse=True))
    with torch.inference_mode():
        emb, pooled = sd.compute_clip_text_embedding(*PROMPTS[0])
        x = torch.randn((1, 4, 128, 128), generator=torch.Generator(dev).manual_seed(0), device=dev)

        def step(dtype: torch.dtype, kernel: bool) -> torch.Tensor:
            for layer in sdpa:
                layer.is_optimized = kernel
            sd.unet.to(dtype=dtype)
            noise = sd.predict_noise(
                x.to(dtype), 0, clip_text_embedding=emb.to(dtype), pooled_text_embedding=pooled.to(dtype),
                time_ids=sd.default_time_ids, condition_scale=5.0,
            )  # fmt: skip
            return noise.float()

        reference = step(torch.float32, kernel=False)
        plain_noise = step(torch.bfloat16, kernel=False)
        kernel_noise = step(torch.bfloat16, kernel=True)
    err_kernel, err_plain = _rel(kernel_noise, reference), _rel(plain_noise, reference)
    print(
        f"sdxl: one UNet step (1024², CFG batch 2) vs float32 reference: kernel route rel_err={err_kernel:.3e}, "
        f"plain bf16 route rel_err={err_plain:.3e}, kernel vs plain rel_err={_rel(kernel_noise, plain_noise):.3e}"
    )
    if not (torch.isfinite(kernel_noise).all() and err_kernel <= 2 * err_plain):
        raise AssertionError(f"the kernel route is further from float32 than the plain route: {err_kernel} > 2 × {err_plain}")

    # one bf16 UNet step through the kernels, warm: host clock, then traced
    with torch.inference_mode():
        inputs = dict(clip_text_embedding=emb.to(BF16), pooled_text_embedding=pooled.to(BF16),
                      time_ids=sd.default_time_ids, condition_scale=5.0)  # fmt: skip
        x16 = x.to(BF16)
        unet_profile = _profile("sdxl: one UNet step (1024², CFG batch 2, bf16, kernels)",
                                lambda: sd.predict_noise(x16, 0, **inputs), unit="step")  # fmt: skip

    # the VAE decode alone: host clock between synchronizes around the decoder
    decoded: list[torch.Tensor] = []
    decode_seconds: list[float] = []
    decode_start: list[float] = []

    def before_decode(_module: Any, _inputs: Any) -> None:
        torch.cuda.synchronize()
        decode_start.append(time.perf_counter())

    def after_decode(_module: Any, _inputs: Any, out: torch.Tensor) -> None:
        torch.cuda.synchronize()
        decode_seconds.append(time.perf_counter() - decode_start[-1])
        decoded.append(out)

    hooks = [sd.lda[1].register_forward_pre_hook(before_decode), sd.lda[1].register_forward_hook(after_decode)]
    seconds = []
    images = []
    reset_launches()
    for seed, (prompt, negative) in enumerate(PROMPTS):
        before = read_launches()["flash_attention_packed"]
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        start = time.perf_counter()
        image = pipe(prompt, negative_prompt=negative, seed=seed, condition_scale=5.0)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        launched = read_launches()["flash_attention_packed"] - before
        out = decoded[-1]
        arr = np.asarray(image)
        images.append(arr)
        peak = torch.cuda.max_memory_allocated(dev)
        print(
            f"sdxl request {seed}: {seconds[-1]:.3f} s (VAE decode {decode_seconds[-1]:.4f} s), kernel launches "
            f"{launched}, image {image.size}, "
            f"decoded mean {float(out.float().mean()):.4f} std {float(out.float().std()):.4f}, "
            f"peak memory {peak / 2**30:.2f} GiB"
        )
        if launched != LAUNCHES_PER_REQUEST:
            raise AssertionError(f"request {seed} launched the kernel {launched} times, not {LAUNCHES_PER_REQUEST}")
        if tuple(out.shape) != (1, 3, 1024, 1024) or not torch.isfinite(out).all():
            raise AssertionError(f"request {seed}: decoded image of shape {tuple(out.shape)} is not finite")
        if float(out.float().std()) == 0.0 or arr.min() == arr.max():
            raise AssertionError(f"request {seed}: the image is constant")
    launches = read_launches()
    for hook in hooks:
        hook.remove()
    del sd, pipe, sdpa, decoded, emb, pooled, x, x16, reference, plain_noise, kernel_noise
    _free()
    return launches, seconds, decode_seconds, peak, images[0], unet_profile


# ---------------------------------------------------------------------------
# phase 6: SDXL under the opt-in passes
# ---------------------------------------------------------------------------


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(255.0**2 / mse)


def run_sdxl_passes(dev: torch.device, bf16_image: np.ndarray) -> tuple[dict[str, Any], dict[str, int]]:
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.optimization import FusedGroupNormSiLU, fuse_group_norm_silu, quantize_linears
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, StableDiffusion_XL
    from refiners_tpu_torch.pipelines import TextToImage

    t0 = time.perf_counter()
    manual_seed(0)  # the weights of phase 3
    sd = StableDiffusion_XL(solver=DDIM(num_inference_steps=30, device=dev), device=dev, dtype=BF16)
    synthesize_weights(sd, seed=7)
    torch.cuda.synchronize()
    print(f"passes: StableDiffusion_XL built, bf16, {time.perf_counter() - t0:.1f} s")
    report: dict[str, Any] = {}

    # (a) GroupNorm + SiLU fusion, and one UNet step four ways
    pipe = TextToImage(sd, size=(1024, 1024))
    sdpa = list(sd.unet.layers(fl.ScaledDotProductAttention, recurse=True))
    with torch.inference_mode():
        emb, pooled = sd.compute_clip_text_embedding(*PROMPTS[0])
        x = torch.randn((1, 4, 128, 128), generator=torch.Generator(dev).manual_seed(0), device=dev)

    def step(dtype: torch.dtype, kernels: bool) -> tuple[torch.Tensor, dict[str, int]]:
        for layer in sdpa:
            layer.is_optimized = kernels
        sd.unet.to(dtype=dtype)
        reset_launches()
        with torch.inference_mode():
            noise = sd.predict_noise(
                x.to(dtype), 0, clip_text_embedding=emb.to(dtype), pooled_text_embedding=pooled.to(dtype),
                time_ids=sd.default_time_ids, condition_scale=5.0,
            )  # fmt: skip
        torch.cuda.synchronize()
        return noise.float(), read_launches()

    reference, ref_launches = step(F32, kernels=False)
    plain, plain_launches = step(BF16, kernels=True)
    fused_unet, fused_lda = fuse_group_norm_silu(sd.unet), fuse_group_norm_silu(sd.lda)
    fused_parts = tuple(sum(1 for _ in part.layers(FusedGroupNormSiLU, recurse=True)) for part in sd.lda)
    print(f"passes: fuse_group_norm_silu fused {fused_unet} pairs in the UNet, {fused_lda} in the VAE {fused_parts}")
    if fused_unet != PASSES_UNET_FUSED or fused_parts != PASSES_VAE_FUSED:
        raise AssertionError(f"fused {fused_unet} UNet and {fused_parts} VAE pairs, not {PASSES_UNET_FUSED}, {PASSES_VAE_FUSED}")
    fused, fused_launches = step(BF16, kernels=True)
    f32_fused, f32_launches = step(F32, kernels=True)
    sd.unet.to(dtype=BF16)
    err_plain, err_fused, err_f32 = (_rel(n, reference) for n in (plain, fused, f32_fused))
    gn_launches = {k: [r[k] for r in (ref_launches, plain_launches, fused_launches, f32_launches)]
                   for k in ("group_norm_stats", "group_norm_apply")}  # fmt: skip
    print(
        f"passes: one UNet step (1024², CFG batch 2) vs float32 unfused on the plain path: bf16 unfused rel_err="
        f"{err_plain:.3e}, bf16 fused through K5 rel_err={err_fused:.3e}, float32 fused through K5 rel_err="
        f"{err_f32:.3e}; K5a/K5b launches (reference, bf16 unfused, bf16 fused, float32 fused) {gn_launches}"
    )
    want = [0, 0, PASSES_UNET_FUSED, PASSES_UNET_FUSED]
    if gn_launches["group_norm_stats"] != want or gn_launches["group_norm_apply"] != want:
        raise AssertionError(f"the UNet steps launched K5 {gn_launches} times, not {want}")
    if not (torch.isfinite(fused).all() and err_fused <= 2 * err_plain):
        raise AssertionError(f"the fused bf16 step is further from float32 than twice the unfused: {err_fused} > 2 × {err_plain}")
    if not err_f32 <= F32_STEP_TOL:
        raise AssertionError(f"the fused float32 step is {err_f32} from the float32 reference (> {F32_STEP_TOL})")
    report["unet_step_rel_err"] = {"bf16_unfused": err_plain, "bf16_fused": err_fused, "f32_fused": err_f32}
    del reference, plain, fused, f32_fused
    _free()

    decoded: list[torch.Tensor] = []
    hook = sd.lda[1].register_forward_hook(lambda _m, _i, out: decoded.append(out))
    want_fused = {**{k: 0 for k in _counters()}, "flash_attention_packed": LAUNCHES_PER_REQUEST,
                  "group_norm_stats": GROUP_NORM_LAUNCHES_PER_REQUEST,
                  "group_norm_apply": GROUP_NORM_LAUNCHES_PER_REQUEST}  # fmt: skip

    def request(seed: int, label: str, want_launches: dict[str, int]) -> tuple[float, int, float | None]:
        """One request; (seconds, peak memory, PSNR against phase 3's image of the same seed or None)."""
        prompt, negative = PROMPTS[seed]
        before = read_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        start = time.perf_counter()
        image = pipe(prompt, negative_prompt=negative, seed=seed, condition_scale=5.0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        after = read_launches()
        launched = {k: after[k] - before[k] for k in after}
        out, arr = decoded[-1], np.asarray(image)
        peak = torch.cuda.max_memory_allocated(dev)
        psnr = _psnr(arr, bf16_image) if seed == 0 else None
        print(
            f"passes {label} request {seed}: {seconds:.3f} s, peak memory {peak / 2**30:.2f} GiB, launches {launched}, "
            f"decoded mean {float(out.float().mean()):.4f} std {float(out.float().std()):.4f}"
            + (f", PSNR against phase 3's bf16 image {psnr:.2f} dB" if psnr is not None else "")
        )
        if launched != want_launches:
            raise AssertionError(f"{label} request {seed} launched {launched}, not {want_launches}")
        if tuple(out.shape) != (1, 3, 1024, 1024) or not torch.isfinite(out).all():
            raise AssertionError(f"{label} request {seed}: decoded image of shape {tuple(out.shape)} is not finite")
        if float(out.float().std()) == 0.0 or arr.min() == arr.max():
            raise AssertionError(f"{label} request {seed}: the image is constant")
        return seconds, peak, psnr

    # the fusion alone, for comparison: one request before quantizing
    seconds, peak, psnr = request(0, "fused-only", want_fused)
    report["fused_only"] = {"seconds": seconds, "peak_memory_bytes": peak, "psnr_vs_bf16": psnr}

    # (b) int8 quantization: the counts are set to 0 here and read after the requests
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    quantized = quantize_linears(sd.unet, min_features=256)
    torch.cuda.synchronize()
    report["quantize_seconds"] = time.perf_counter() - start
    k6 = read_launches()["quantize_int8"]
    print(f"passes: quantize_linears replaced {quantized} linears in {report['quantize_seconds']:.3f} s, {k6} K6 launches; "
          f"UNet dtype {sd.unet.dtype}")  # fmt: skip
    if quantized != PASSES_QUANTIZED or k6 != PASSES_QUANTIZED:
        raise AssertionError(f"quantized {quantized} linears with {k6} launches, not {PASSES_QUANTIZED}")
    if sd.unet.dtype != BF16:
        raise AssertionError(f"the quantized UNet's dtype is {sd.unet.dtype}, not bf16")

    # (c) requests under both passes
    report["seconds"], report["peak_memory_bytes"] = [], []
    want_int8 = {**want_fused, "quantize_rows_int8": ROW_QUANT_LAUNCHES_PER_REQUEST}
    for seed in range(2):
        seconds, peak, psnr = request(seed, "int8 + fused", want_int8)
        report["seconds"].append(seconds)
        report["peak_memory_bytes"].append(peak)
        if psnr is not None:
            report["psnr_vs_bf16"] = psnr
    if not report["psnr_vs_bf16"] >= INT8_PSNR_FLOOR:
        raise AssertionError(f"int8 + fused image at PSNR {report['psnr_vs_bf16']:.2f} < {INT8_PSNR_FLOOR} against bf16")
    launches = read_launches()
    hook.remove()

    # one W8A8 UNet step, warm: host clock, then traced (after the counts are read)
    with torch.inference_mode():
        inputs = dict(clip_text_embedding=emb.to(BF16), pooled_text_embedding=pooled.to(BF16),
                      time_ids=sd.default_time_ids, condition_scale=5.0)  # fmt: skip
        x16 = x.to(BF16)
        report["w8a8_unet_step_profile"] = _profile(
            "passes: one W8A8 UNet step (1024², CFG batch 2, bf16, both passes)",
            lambda: sd.predict_noise(x16, 0, **inputs), unit="step",
        )  # fmt: skip
    del sd, pipe, sdpa, decoded, emb, pooled, x, x16
    _free()
    return report, launches


# ---------------------------------------------------------------------------
# phase 4: SD1.5 training
# ---------------------------------------------------------------------------


def _training_routes(label: str, module: torch.nn.Module, loss_of: Callable[[torch.dtype], torch.Tensor],
                     want: dict[str, int]) -> dict[str, float]:
    """One forward + backward of `loss_of(dtype)` four ways: float32 on the
    plain path (the reference), float32 through the kernels, bf16 on the
    plain path and bf16 through the kernels (float32 first: the bf16 routes
    round the weights). Gates: no launch on the plain routes and exactly
    `want` on each kernel route; the bf16 kernel route's gradient, over all
    of `module`'s parameters, at most twice as far from the reference as the
    bf16 plain route's, and the float32 kernel route's within F32_STEP_TOL."""
    import refiners_tpu_torch.fluxion.layers as fl

    sdpa = list(module.layers(fl.ScaledDotProductAttention, recurse=True))  # type: ignore[attr-defined]
    params = list(module.parameters())

    def grads(dtype: torch.dtype, kernel: bool) -> tuple[list[torch.Tensor], float, dict[str, int]]:
        for layer in sdpa:
            layer.is_optimized = kernel
        module.to(dtype=dtype)
        module.zero_grad(set_to_none=True)
        reset_launches()
        loss = loss_of(dtype)
        loss.backward()
        torch.cuda.synchronize()
        return [p.grad.float() for p in params], float(loss.detach()), read_launches()

    reference, ref_loss, ref_launches = grads(F32, kernel=False)
    ref_norm = math.sqrt(sum(float((g * g).sum()) for g in reference))

    def distance(got: list[torch.Tensor]) -> float:
        return math.sqrt(sum(float(((g - r) ** 2).sum()) for g, r in zip(got, reference))) / ref_norm

    f32_kernel, f32_kernel_loss, f32_launches = grads(F32, kernel=True)
    err_f32_kernel = distance(f32_kernel)
    del f32_kernel
    plain, plain_loss, plain_launches = grads(BF16, kernel=False)
    err_plain = distance(plain)
    del plain
    kernel, kernel_loss, kernel_launches = grads(BF16, kernel=True)
    err_kernel = distance(kernel)
    finite = all(bool(torch.isfinite(g).all()) for g in kernel)
    del kernel, reference
    print(
        f"{label} losses float32 plain {ref_loss:.5f}, bf16 plain {plain_loss:.5f}, bf16 kernels {kernel_loss:.5f}, "
        f"float32 kernels {f32_kernel_loss:.5f}; gradient vs float32 plain: bf16 kernel route rel_err={err_kernel:.3e}, "
        f"bf16 plain route rel_err={err_plain:.3e} (ratio {err_kernel / err_plain:.3f}), float32 kernel route "
        f"rel_err={err_f32_kernel:.3e}; launches float32 plain {ref_launches}, bf16 plain {plain_launches}, bf16 "
        f"kernels {kernel_launches}, float32 kernels {f32_launches}"
    )
    if any(ref_launches.values()) or any(plain_launches.values()):
        raise AssertionError("the plain steps must launch no kernel")
    if kernel_launches != want or f32_launches != want:
        raise AssertionError(f"the kernel steps launched {kernel_launches} (bf16), {f32_launches} (float32), not {want}")
    if not (finite and err_kernel <= 2 * err_plain):
        raise AssertionError(f"the kernel route's gradient is further from float32 than twice the plain route's: {err_kernel} > 2 × {err_plain}")
    if not err_f32_kernel <= F32_STEP_TOL:
        raise AssertionError(f"the float32 kernel route's gradient is {err_f32_kernel} from the plain route's (> {F32_STEP_TOL})")
    return {"grad_rel_err_kernel": err_kernel, "grad_rel_err_plain_bf16": err_plain, "grad_rel_err_f32_kernel": err_f32_kernel}


def check_training_step(dev: torch.device) -> dict[str, float]:
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.latent_diffusion import DDPM, SD1UNet

    t0 = time.perf_counter()
    unet = SD1UNet(in_channels=4, device=dev)
    synthesize_weights(unet, seed=11)
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"sd15: SD1UNet built, {n_params} parameters, {time.perf_counter() - t0:.1f} s")
    solver = DDPM(num_inference_steps=1000, device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    x = torch.randn((2, 4, 64, 64), generator=gen, device=dev)
    noise = torch.randn((2, 4, 64, 64), generator=gen, device=dev)
    text = torch.randn((2, 77, 768), generator=gen, device=dev)
    steps = [250, 750]

    def loss_of(dtype: torch.dtype) -> torch.Tensor:
        unet.set_timestep(solver.timesteps[steps])
        unet.set_clip_text_embedding(text.to(dtype))
        noised = solver.add_noise(x.to(dtype), noise.to(dtype), steps)
        return ((unet(noised).float() - noise) ** 2).mean()

    report = _training_routes("sd15: one training step (batch 2, 64×64, fwd+bwd)", unet, loss_of, TRAINING_STEP_LAUNCHES)
    del unet
    _free()
    return report


def run_trainer(dev: torch.device) -> tuple[dict[str, int], list[dict[str, Any]]]:
    from refiners_tpu_torch.examples.train_unet import UnetConfig, UnetTrainer

    records: list[dict[str, Any]] = []

    class SmokeTrainer(UnetTrainer):
        """Times each step and counts its kernel launches."""

        def step(self, batch: dict[str, torch.Tensor]) -> None:
            before = read_launches()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            start = time.perf_counter()
            super().step(batch)
            torch.cuda.synchronize()
            after = read_launches()
            records.append(
                {"seconds": time.perf_counter() - start, "loss": float(self.loss.detach()),
                 "optimizer_step": self.clock.num_minibatches_processed == 0, "grad_norm": self.grad_norm,
                 "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                 "launches": {k: after[k] - before[k] for k in after}}
            )  # fmt: skip

    t0 = time.perf_counter()
    trainer = SmokeTrainer(UnetConfig.load_from_toml_string(TRAIN_CONFIG), batch_size=2, latent_size=64, num_batches=4)
    before = {name: p.detach().clone() for name, p in trainer.unet.named_parameters() if p.ndim >= 2}
    print(f"sd15 trainer: built in {time.perf_counter() - t0:.1f} s, bf16, {trainer.learnable_parameter_count} parameters")
    reset_launches()
    trainer.train()
    launches = read_launches()
    for i, r in enumerate(records):
        print(
            f"sd15 trainer step {i}: {r['seconds']:.3f} s, loss {r['loss']:.5f}, optimizer step {r['optimizer_step']}, "
            f"grad norm {r['grad_norm']:.4f}, peak memory {r['peak_memory_bytes'] / 2**30:.2f} GiB, launches {r['launches']}"
        )
    want = TRAINING_STEP_LAUNCHES
    if len(records) != 4 or any(r["launches"] != want for r in records):
        raise AssertionError(f"each of the 4 training steps must launch {want}")
    if not all(math.isfinite(r["loss"]) for r in records):
        raise AssertionError("a training loss is not finite")
    if not all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in records if r["optimizer_step"]):
        raise AssertionError("a grad norm is not finite")
    params = dict(trainer.unet.named_parameters())
    unchanged = [name for name, w in before.items() if torch.equal(params[name].detach(), w)]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} weights did not change after two optimizer steps: {unchanged[:5]}")
    if not all(bool(torch.isfinite(p).all()) for p in params.values()):
        raise AssertionError("a parameter is not finite after training")
    print(f"sd15 trainer: {len(before)} weights of two or more dims all changed; every parameter finite")
    del trainer, before, params
    _free()
    return launches, records


# ---------------------------------------------------------------------------
# phase 4c: training the SD1.5 VAE's decoder
# ---------------------------------------------------------------------------


def _vae_image(index: int) -> torch.Tensor:
    """Seeded 512² RGB image `index` in [-1, 1], made on the card: uniform
    noise at 64², bilinearly upsampled."""
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(1000 + index)
    low = torch.rand((1, 3, VAE_SIZE // 8, VAE_SIZE // 8), generator=gen, device="cuda") * 2 - 1
    return F.interpolate(low, size=(VAE_SIZE, VAE_SIZE), mode="bilinear", align_corners=False)[0]


def _vae_autoencoder(dev: torch.device) -> Any:
    """Full-width `SD1Autoencoder` on the card, float32, seeded weights."""
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.latent_diffusion import SD1Autoencoder

    manual_seed(VAE_WEIGHTS_SEED)
    autoencoder = SD1Autoencoder(device=dev)
    synthesize_weights(autoencoder, seed=VAE_WEIGHTS_SEED)
    return autoencoder


def check_vae_step(dev: torch.device) -> dict[str, float]:
    """One decoder forward + backward of the MSE reconstruction loss four
    ways (as phase 4a), on latents of two seeded 512² images encoded once in
    float32 on the plain path."""
    import refiners_tpu_torch.fluxion.layers as fl

    autoencoder = _vae_autoencoder(dev)
    encoder, decoder = autoencoder[0], autoencoder[1]
    images = torch.stack([_vae_image(i) for i in range(2)])
    for layer in encoder.layers(fl.ScaledDotProductAttention, recurse=True):
        layer.is_optimized = False
    with torch.no_grad():
        latents = encoder(images)

    def loss_of(dtype: torch.dtype) -> torch.Tensor:
        return ((decoder(latents.to(dtype)).float() - images) ** 2).mean()

    want = {**{name: 0 for name in read_launches()}, **VAE_DECODER_LAUNCHES}
    report = _training_routes("vae train: one decoder step (batch 2, 512², fwd+bwd)", decoder, loss_of, want)
    del autoencoder, encoder, decoder
    _free()
    return report


def _vae_trainer(dev: torch.device, toml: str, records: list[dict[str, Any]], checkpoints: Any = None) -> Any:
    """A `Trainer` of sd-vae-ft-mse's fine-tune: the SD1.5 VAE's decoder on
    the MSE of its reconstruction of seeded 512² images (batches of 2 from
    `create_data_loader`, shuffled by the training seed), the encoder
    frozen; it records each step's seconds, loss, peak memory and launches.
    With `checkpoints`, a `CheckpointCallback` saves into that directory at
    each epoch's end (two steps)."""
    from functools import cached_property

    from refiners_tpu_torch import training_utils as tu

    # the field types as objects, not strings: they are resolved here, where the class is made
    annotations = {"encoder": tu.ModelConfig, "decoder": tu.ModelConfig, "checkpoint": tu.CheckpointConfig | None}
    VaeConfig = type("VaeConfig", (tu.BaseConfig,), {"__annotations__": annotations, "checkpoint": None})

    class VaeTrainer(tu.Trainer[VaeConfig, torch.Tensor]):
        @cached_property
        def autoencoder(self) -> Any:
            return _vae_autoencoder(dev)

        @tu.register_model()
        def encoder(self, config: tu.ModelConfig) -> Any:
            return self.autoencoder[0]

        @tu.register_model()
        def decoder(self, config: tu.ModelConfig) -> Any:
            return self.autoencoder[1]

        @tu.register_callback()
        def checkpoint(self, config: tu.CheckpointConfig) -> Any:
            return tu.CheckpointCallback(config)

        def create_data_iterable(self) -> Any:
            config = tu.DataLoaderConfig(batch_size=2, shuffle=True)
            return tu.create_data_loader(_vae_image, VAE_IMAGES, config, collate_fn=torch.stack, seed=self.config.training.seed)

        def compute_loss(self, batch: torch.Tensor) -> torch.Tensor:
            images = batch.to(self.dtype)
            with torch.no_grad():
                latents = self.encoder(images)
            return ((self.decoder(latents).float() - batch) ** 2).mean()

        def step(self, batch: torch.Tensor) -> None:
            before = read_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            start = time.perf_counter()
            super().step(batch)
            torch.cuda.synchronize()
            after = read_launches()
            records.append(
                {"seconds": time.perf_counter() - start, "loss": float(self.loss.detach()), "grad_norm": self.grad_norm,
                 "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                 "launches": {k: after[k] - before[k] for k in after}}
            )  # fmt: skip

    config = VaeConfig.load_from_toml_string(toml)
    if checkpoints is not None:
        config.checkpoint = tu.CheckpointConfig(directory=str(checkpoints), interval="1:epoch", keep=2)
    return VaeTrainer(config)


def _print_vae_steps(label: str, records: list[dict[str, Any]]) -> None:
    for i, r in enumerate(records):
        print(
            f"vae train {label} step {i}: {r['seconds']:.3f} s, loss {r['loss']:.6f}, grad norm {r['grad_norm']:.4f}, "
            f"peak memory {r['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }"
        )


def _check_vae_launches(label: str, records: list[dict[str, Any]], want: dict[str, int]) -> None:
    for r in records:
        got = {k: v for k, v in r["launches"].items() if v}
        if got != want:
            raise AssertionError(f"vae train {label}: a step launched {got}, not {want}")


def run_vae_training(dev: torch.device) -> tuple[dict[str, int], dict[str, Any]]:
    """Phase 4c (b)-(e): Lion with a checkpoint and a resume, Prodigy, remat,
    one traced step. Returns the launches of the runs and the report."""
    import shutil
    from pathlib import Path

    from refiners_tpu_torch.fluxion.layers import SelfAttention2d, Upsample
    from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import Resnet
    from refiners_tpu_torch.parallel import Recompute, apply_remat

    directory = Path(__file__).resolve().parent / "build" / "chip_smoke_vae"
    shutil.rmtree(directory, ignore_errors=True)
    report: dict[str, Any] = {}
    launches = {name: 0 for name in read_launches()}

    def config(optimizer: str, lr: float, steps: int, dtype: str = "bfloat16") -> str:
        return VAE_TRAIN_CONFIG.format(optimizer=optimizer, lr=lr, steps=steps, dtype=dtype)

    def train(trainer: Any, records: list[dict[str, Any]]) -> None:
        reset_launches()
        trainer.train()
        for name, n in read_launches().items():
            launches[name] += n

    def weights(trainer: Any) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in trainer.decoder.state_dict().items()}

    # (b) Lion, 4 steps straight, against 2 steps, a checkpoint and a fresh trainer resumed for 2;
    # cuDNN's deterministic algorithms, so that the two runs can agree bit for bit
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    straight_records: list[dict[str, Any]] = []
    t0 = time.perf_counter()
    straight = _vae_trainer(dev, config("Lion8bit", VAE_LION_LR, 4), straight_records, directory / "straight")
    print(f"vae train: SD1Autoencoder built in {time.perf_counter() - t0:.1f} s, bf16, decoder "
          f"{straight.learnable_parameter_count} trainable parameters, encoder frozen")  # fmt: skip
    initial = weights(straight)
    train(straight, straight_records)
    _print_vae_steps("Lion straight", straight_records)
    straight_weights = weights(straight)
    del straight
    _free()
    first_records: list[dict[str, Any]] = []
    first = _vae_trainer(dev, config("Lion8bit", VAE_LION_LR, 2), first_records, directory / "resumed")
    train(first, first_records)
    del first
    _free()
    tags = sorted(p.name for p in (directory / "resumed").iterdir())
    resumed_records: list[dict[str, Any]] = []
    resumed = _vae_trainer(dev, config("Lion8bit", VAE_LION_LR, 4), resumed_records, directory / "resumed")
    resumed.checkpoint.restore(resumed, "step_2")
    train(resumed, resumed_records)
    _print_vae_steps("Lion resumed at step 2", resumed_records)
    resumed_weights = weights(resumed)
    meta = json.loads((directory / "resumed" / "step_2" / "meta.json").read_text())
    del resumed
    _free()
    torch.backends.cudnn.deterministic = False
    losses = [r["loss"] for r in straight_records]
    resumed_losses = [r["loss"] for r in first_records + resumed_records]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(resumed_losses, losses))
    # Lion moves an element by lr (1 + weight_decay |w|) a step; an update whose sign flips between the
    # two runs moves it by twice that, and bf16 rounds each result (at most 2^-8 |w|): over the 2 resumed steps
    bound = {k: 4 * VAE_LION_LR * (1 + VAE_LION_WD * v.float().abs()) + 2 * 2**-8 * v.float().abs()
             for k, v in straight_weights.items()}  # fmt: skip
    excess = max(float(((resumed_weights[k].float() - v.float()).abs() - bound[k]).max()) for k, v in straight_weights.items())
    differing = sum(int((resumed_weights[k] != v).sum()) for k, v in straight_weights.items())
    total = sum(v.numel() for v in straight_weights.values())
    print(
        f"vae train: checkpoint tags {tags}, meta {meta}; losses straight {losses}, first + resumed {resumed_losses} "
        f"(largest relative gap {loss_gap:.3e}); resumed weights differ from the straight run's in {differing} of "
        f"{total} elements, largest excess over the bound {excess:.3e}"
    )
    if tags != ["step_2"] or meta != {"step": 2, "epoch": 1, "iteration": 2, "scheduler_steps": 2}:
        raise AssertionError(f"the checkpoint after step 2 is {tags}, {meta}")
    if len(losses) != 4 or len(resumed_losses) != 4 or not loss_gap <= VAE_RESUME_LOSS_TOL:
        raise AssertionError(f"the resumed run's losses {resumed_losses} are not the straight run's {losses}")
    if not excess <= 0:
        raise AssertionError(f"the resumed run's weights lie {excess} beyond Lion's bound from the straight run's")
    # bf16 holds a weight near 0.17 (the 4-channel conv_in's scale) to 2^-10: Lion's 1e-4 steps round away there
    unmoved = [k for k, v in initial.items() if v.ndim >= 2 and torch.equal(straight_weights[k], v)]
    print(f"vae train: Lion moved {sum(v.ndim >= 2 for v in initial.values()) - len(unmoved)} of the decoder's weights "
          f"of two or more dims; unmoved in bf16: {unmoved}")  # fmt: skip
    if all(torch.equal(straight_weights[k], v) for k, v in initial.items()):
        raise AssertionError("Lion did not move the decoder")
    for label, records in (("Lion straight", straight_records), ("Lion first", first_records), ("Lion resumed", resumed_records)):
        _check_vae_launches(label, records, VAE_STEP_LAUNCHES)
    report["lion"] = {"losses": losses, "resumed_losses": resumed_losses, "loss_gap": loss_gap,
                      "differing_elements": differing, "elements": total, "checkpoint_meta": meta,
                      "seconds": [r["seconds"] for r in straight_records],
                      "peak_memory_bytes": [r["peak_memory_bytes"] for r in straight_records]}  # fmt: skip
    del initial, straight_weights, resumed_weights, bound

    # (c) Prodigy, float32: its first steps move a weight by about estim_lr0 = 1e-6, below bf16's resolution
    prodigy_records: list[dict[str, Any]] = []
    prodigy = _vae_trainer(dev, config("Prodigy", 1.0, 2, dtype="float32"), prodigy_records)
    initial = weights(prodigy)
    train(prodigy, prodigy_records)
    _print_vae_steps("Prodigy float32", prodigy_records)
    after = weights(prodigy)
    unmoved = [k for k, v in initial.items() if v.ndim >= 2 and torch.equal(after[k], v)]
    estimate = prodigy.models["decoder"].optimizer.param_groups[0]["estim_lr"]
    finite = all(bool(torch.isfinite(p).all()) for p in prodigy.decoder.parameters())
    print(f"vae train: Prodigy's estimate after 2 steps {estimate:.3e}; {sum(v.ndim >= 2 for v in initial.values())} "
          f"weights of two or more dims, {len(unmoved)} unmoved; every parameter finite: {finite}")  # fmt: skip
    if unmoved or not finite or not all(math.isfinite(r["loss"]) for r in prodigy_records):
        raise AssertionError(f"Prodigy: unmoved {unmoved[:5]}, finite parameters {finite}, losses {[r['loss'] for r in prodigy_records]}")
    _check_vae_launches("Prodigy", prodigy_records, VAE_STEP_LAUNCHES)
    report["prodigy"] = {"losses": [r["loss"] for r in prodigy_records], "estim_lr": estimate,
                         "seconds": [r["seconds"] for r in prodigy_records]}  # fmt: skip
    del prodigy, initial, after
    _free()

    # (d) remat on the decoder's blocks: the second (warm) step with and without it
    plain_records: list[dict[str, Any]] = []
    plain = _vae_trainer(dev, config("Lion8bit", VAE_LION_LR, 2), plain_records)
    train(plain, plain_records)
    # (e) one traced step, on the trainer without remat
    batch = torch.stack([_vae_image(i) for i in range(2)])
    profile = _profile("vae train: one decoder step (batch 2, 512², bf16, Lion, kernels)", lambda: plain.step(batch), "step")
    del plain
    _free()
    remat_records: list[dict[str, Any]] = []
    remat = _vae_trainer(dev, config("Lion8bit", VAE_LION_LR, 2), remat_records)
    wrapped = apply_remat(remat.decoder, (Resnet, SelfAttention2d, Upsample))
    train(remat, remat_records)
    _print_vae_steps("Lion without remat", plain_records)
    _print_vae_steps(f"Lion with remat ({wrapped} blocks wrapped)", remat_records)
    if wrapped != sum(1 for _ in remat.decoder.walk(Recompute, recurse=True)):
        raise AssertionError("apply_remat's count disagrees with the Recompute chains in the decoder")
    _check_vae_launches("no remat", plain_records, VAE_STEP_LAUNCHES)
    _check_vae_launches("remat", remat_records, VAE_REMAT_LAUNCHES)
    gap = abs(remat_records[0]["loss"] - plain_records[0]["loss"]) / plain_records[0]["loss"]
    peak, remat_peak = plain_records[1]["peak_memory_bytes"], remat_records[1]["peak_memory_bytes"]
    print(f"vae train: remat peak memory {remat_peak / 2**30:.2f} GiB against {peak / 2**30:.2f} GiB without, "
          f"{remat_records[1]['seconds']:.3f} s a step against {plain_records[1]['seconds']:.3f}; first loss gap {gap:.3e}")  # fmt: skip
    if not remat_peak < peak or not gap <= VAE_REMAT_LOSS_TOL:
        raise AssertionError(f"remat: peak {remat_peak} against {peak}, loss gap {gap}")
    report["remat"] = {"wrapped": wrapped, "peak_memory_bytes": remat_peak, "peak_memory_bytes_without": peak,
                       "seconds": remat_records[1]["seconds"], "seconds_without": plain_records[1]["seconds"]}  # fmt: skip
    report["step_profile"] = profile
    del remat
    _free()
    shutil.rmtree(directory, ignore_errors=True)
    return launches, report


# ---------------------------------------------------------------------------
# phase 5: SAM serving
# ---------------------------------------------------------------------------


def _sam_image(seed: int, size: tuple[int, int]) -> Any:
    """A seeded (width, height) RGB image: smooth gradients plus noise."""
    from PIL import Image

    w, h = size
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], axis=-1) * 200.0
    return Image.fromarray(np.clip(base + rs.randint(0, 55, (h, w, 3)), 0, 255).astype(np.uint8))


def _check_masks(label: str, masks: torch.Tensor, iou: torch.Tensor, size: tuple[int, int]) -> None:
    w, h = size
    if tuple(masks.shape[-2:]) != (h, w) or masks.dtype != torch.bool:
        raise AssertionError(f"{label}: masks of shape {tuple(masks.shape)} and {masks.dtype}, not (…, {h}, {w}) bool")
    if not (bool(masks.any()) and not bool(masks.all())):
        raise AssertionError(f"{label}: the mask is constant")
    if not bool(torch.isfinite(iou).all()):
        raise AssertionError(f"{label}: the IoU prediction is not finite")


def run_sam(dev: torch.device) -> tuple[dict[str, Any], dict[str, int]]:
    from refiners_tpu_torch.foundationals.segment_anything import HQSAMAdapter, SegmentAnythingH
    from refiners_tpu_torch.foundationals.segment_anything.image_encoder import RelativePositionAttention
    from refiners_tpu_torch.fluxion.utils import synthesize_weights

    t0 = time.perf_counter()
    sam = SegmentAnythingH(multimask_output=False, device=dev, dtype=BF16)
    synthesize_weights(sam, seed=13)
    sam.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sam.parameters())
    print(f"sam: SegmentAnythingH built, {n_params} parameters, bf16, {time.perf_counter() - t0:.1f} s")
    relpos = list(sam.layers(RelativePositionAttention, recurse=True))
    images = [_sam_image(i, size) for i, size in enumerate(SAM_IMAGES)]

    # (a) one embedding four ways; float32 first, from the same (bf16) weights
    def embed(dtype: torch.dtype, kernel: bool) -> tuple[torch.Tensor, int]:
        for layer in relpos:
            layer.is_optimized = kernel
        sam.to(dtype=dtype)
        reset_launches()
        with torch.inference_mode():
            features = sam.compute_image_embedding(images[0]).features.float()
        torch.cuda.synchronize()
        return features, read_launches()["flash_attention_relpos"]

    reference, ref_launches = embed(F32, kernel=False)
    f32_kernel, f32_launches = embed(F32, kernel=True)
    plain, plain_launches = embed(BF16, kernel=False)
    kernel, kernel_launches = embed(BF16, kernel=True)
    err_f32, err_plain, err_kernel = (_rel(x, reference) for x in (f32_kernel, plain, kernel))
    print(
        f"sam: one ViT-H image embedding vs the float32 plain route: float32 kernel route rel_err={err_f32:.3e}, "
        f"bf16 plain route rel_err={err_plain:.3e}, bf16 kernel route rel_err={err_kernel:.3e}; relpos launches "
        f"float32 plain {ref_launches}, float32 kernel {f32_launches}, bf16 plain {plain_launches}, bf16 kernel "
        f"{kernel_launches}"
    )
    if ref_launches or plain_launches:
        raise AssertionError("the plain routes must launch no kernel")
    if not f32_launches == kernel_launches == SAM_LAUNCHES_PER_EMBEDDING:
        raise AssertionError(f"the kernel routes launched {f32_launches}, {kernel_launches} times, not {SAM_LAUNCHES_PER_EMBEDDING}")
    if not err_f32 <= SAM_F32_TOL:
        raise AssertionError(f"the float32 kernel route is {err_f32} from the float32 plain route (> {SAM_F32_TOL})")
    if not (torch.isfinite(kernel).all() and err_kernel <= 2 * err_plain):
        raise AssertionError(f"the bf16 kernel route is further from float32 than twice the plain route: {err_kernel} > 2 × {err_plain}")
    del reference, f32_kernel, plain, kernel
    _free()
    with torch.inference_mode():
        embedding_profile = _profile("sam: one ViT-H image embedding (bf16, kernels)",
                                     lambda: sam.compute_image_embedding(images[0]), unit="embedding")  # fmt: skip

    # (b) serving
    fg_bg = [((0.3, 0.4), (0.6, 0.5)), ((0.1, 0.1),)]  # foreground and background points, as fractions of the size
    report: dict[str, Any] = {"embedding_seconds": [], "predict_ms": [], "pipelined_ms": None,
                              "embedding_profile": embedding_profile}  # fmt: skip
    embeddings, prompts, serial = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()

    def timed(fn: Callable[[], Any]) -> tuple[Any, float, int]:
        before = read_launches()["flash_attention_relpos"]
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start, read_launches()["flash_attention_relpos"] - before

    with torch.inference_mode():
        for i, (image, (w, h)) in enumerate(zip(images, SAM_IMAGES)):
            embedding, seconds, launched = timed(lambda: sam.compute_image_embedding(image))
            report["embedding_seconds"].append(seconds)
            if launched != SAM_LAUNCHES_PER_EMBEDDING:
                raise AssertionError(f"request {i}: the embedding launched the kernel {launched} times, not {SAM_LAUNCHES_PER_EMBEDDING}")
            points = dict(
                foreground_points=[(fx * w, fy * h) for fx, fy in fg_bg[0]],
                background_points=[(fx * w, fy * h) for fx, fy in fg_bg[1]],
            )
            box = dict(box_points=[[(0.2 * w, 0.25 * h), (0.7 * w, 0.8 * h)]])
            line = f"sam request {i} ({w}x{h}): embedding {seconds:.3f} s, {launched} launches"
            for label, prompt in (("points", points), ("box", box)):
                (masks, iou, low), seconds, launched = timed(lambda: sam.predict(embedding, **prompt))
                report["predict_ms"].append(seconds * 1e3)
                if launched:
                    raise AssertionError(f"request {i}: a predict on an ImageEmbedding launched the kernel {launched} times")
                _check_masks(f"request {i}, {label}", masks, iou, (w, h))
                line += f"; predict ({label}) {seconds * 1e3:.2f} ms, iou {float(iou.float().flatten()[0]):.4f}, mask share {float(masks.float().mean()):.3f}"
                if label == "points":
                    serial.append((masks, iou, low))
            print(line)
            embeddings.append(embedding)
            prompts.append(points)

        pipelined, seconds, launched = timed(lambda: sam.predict_pipelined(embeddings, prompts))
        report["pipelined_ms"] = seconds * 1e3
        for i, ((masks, iou, low), (p_masks, p_iou, p_low)) in enumerate(zip(serial, pipelined)):
            if not (np.array_equal(masks.cpu().numpy(), p_masks) and np.allclose(low.float().cpu().numpy(), p_low.astype(np.float32), atol=1e-3)):
                raise AssertionError(f"request {i}: predict_pipelined differs from predict")
        print(f"sam: predict_pipelined over 3 embeddings in {seconds * 1e3:.2f} ms ({launched} launches), equal to the serial predicts")

        hq = HQSAMAdapter(sam).inject()
        (w, h) = SAM_IMAGES[0]
        embedding, seconds, launched = timed(lambda: sam.compute_image_embedding(images[0]))
        if launched != SAM_LAUNCHES_PER_EMBEDDING:
            raise AssertionError(f"HQ-SAM: the embedding launched the kernel {launched} times")
        (masks, iou, _), predict_seconds, launched = timed(lambda: sam.predict(embedding, **prompts[0]))
        if launched:
            raise AssertionError("HQ-SAM: a predict on an ImageEmbedding launched the kernel")
        _check_masks("HQ-SAM", masks, iou, (w, h))
        report["hq_embedding_seconds"], report["hq_predict_ms"] = seconds, predict_seconds * 1e3
        print(f"sam: HQ-SAM embedding {seconds:.3f} s, predict {predict_seconds * 1e3:.2f} ms, mask share {float(masks.float().mean()):.3f}")
        hq.eject()
    launches = read_launches()
    report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(
        f"sam: seconds per embedding {[round(x, 4) for x in report['embedding_seconds']]}, ms per predict "
        f"{[round(x, 2) for x in report['predict_ms']]}, peak memory {report['peak_memory_bytes'] / 2**30:.2f} GiB, "
        f"launches {launches}"
    )
    del sam, relpos, embeddings, serial, pipelined, hq
    _free()
    return report, launches


# ---------------------------------------------------------------------------
# phase 7: SD1.5 serving
# ---------------------------------------------------------------------------


def run_sd15(dev: torch.device) -> tuple[dict[str, Any], dict[str, int]]:
    """Full-width SD1.5 at 512² in bf16: one UNet step three ways, then
    text-to-image, `num_images=2`, img2img and inpainting requests, each
    with its K1 launches counted."""
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.utils import synthesize_weights, tensor_to_image
    from refiners_tpu_torch.foundationals.latent_diffusion import (
        SD1UNet,
        StableDiffusion_1,
        StableDiffusion_1_Inpainting,
    )
    from refiners_tpu_torch.pipelines import TextToImage

    t0 = time.perf_counter()
    manual_seed(0)
    sd = StableDiffusion_1(device=dev, dtype=BF16)  # DPM++ 30 steps, CFG 7.5
    synthesize_weights(sd, seed=11)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in sd.unet.parameters())
    print(f"sd15: StableDiffusion_1 built, UNet {n_unet} parameters, {sum(p.numel() for p in sd.parameters())} in all, "
          f"bf16, {type(sd.solver).__name__} {sd.solver.num_inference_steps} steps, {time.perf_counter() - t0:.1f} s")  # fmt: skip
    if n_unet != SD15_UNET_PARAMETERS:
        raise AssertionError(f"the SD1.5 UNet has {n_unet} parameters, not {SD15_UNET_PARAMETERS}")
    report: dict[str, Any] = {"unet_parameters": n_unet}
    latent = SD15_SIZE // 8

    # One CFG UNet step at 64² latents three ways, held as phase 3 holds SDXL's
    sdpa = list(sd.unet.layers(fl.ScaledDotProductAttention, recurse=True))
    with torch.inference_mode():
        emb = sd.compute_clip_text_embedding(*PROMPTS[0])
        x = torch.randn((1, 4, latent, latent), generator=torch.Generator(dev).manual_seed(0), device=dev)

        def step(dtype: torch.dtype, kernel: bool) -> tuple[torch.Tensor, int]:
            for layer in sdpa:
                layer.is_optimized = kernel
            sd.unet.to(dtype=dtype)
            reset_launches()
            noise = sd.predict_noise(x.to(dtype), 0, clip_text_embedding=emb.to(dtype), condition_scale=7.5)
            torch.cuda.synchronize()
            return noise.float(), read_launches()["flash_attention_packed"]

        reference, _ = step(F32, kernel=False)
        plain_noise, plain_launches = step(BF16, kernel=False)
        kernel_noise, step_launches = step(BF16, kernel=True)
    err_kernel, err_plain = _rel(kernel_noise, reference), _rel(plain_noise, reference)
    print(
        f"sd15: one UNet step (512², CFG batch 2) vs float32 reference: kernel route rel_err={err_kernel:.3e}, "
        f"plain bf16 route rel_err={err_plain:.3e}, kernel vs plain rel_err={_rel(kernel_noise, plain_noise):.3e}; "
        f"K1 launches {step_launches} (plain route {plain_launches})"
    )
    if not (torch.isfinite(kernel_noise).all() and err_kernel <= 2 * err_plain):
        raise AssertionError(f"the kernel route is further from float32 than the plain route: {err_kernel} > 2 × {err_plain}")
    if (step_launches, plain_launches) != (SD15_LAUNCHES_PER_STEP, 0):
        raise AssertionError(f"one UNet step launched K1 {step_launches} times (plain route {plain_launches}), "
                             f"not {SD15_LAUNCHES_PER_STEP} (0)")  # fmt: skip
    report["unet_step_rel_err"] = {"bf16_kernels": err_kernel, "bf16_plain": err_plain}
    with torch.inference_mode():
        emb16, x16 = emb.to(BF16), x.to(BF16)
        report["unet_step_profile"] = _profile("sd15: one UNet step (512², CFG batch 2, bf16, kernels)",
                                               lambda: sd.predict_noise(x16, 0, clip_text_embedding=emb16), unit="step")  # fmt: skip
    del reference, plain_noise, kernel_noise, x, x16
    _free()

    # the 9-channel inpainting model: the same weights, apart from its conv_in, sharing the VAE and CLIP
    unet9 = SD1UNet(in_channels=9, device=dev, dtype=BF16)
    synthesize_weights(unet9, seed=12)
    shared = {k: v for k, v in sd.unet.state_dict().items() if v.shape == unet9.state_dict()[k].shape}
    unet9.load_state_dict(shared, strict=False)
    inpainting = StableDiffusion_1_Inpainting(unet=unet9, lda=sd.lda, clip_text_encoder=sd.clip_text_encoder,
                                              device=dev, dtype=BF16)  # fmt: skip
    print(f"sd15: StableDiffusion_1_Inpainting built, {len(unet9.state_dict()) - len(shared)} tensor(s) not shared "
          f"with the text-to-image UNet")  # fmt: skip

    # each decode also timed alone: host clock between synchronizes around the decoder
    decoded: list[torch.Tensor] = []
    decode_seconds: list[float] = []

    def before_decode(_module: Any, _inputs: Any) -> None:
        torch.cuda.synchronize()
        decode_seconds.append(-time.perf_counter())

    def after_decode(_module: Any, _inputs: Any, out: torch.Tensor) -> None:
        torch.cuda.synchronize()
        decode_seconds[-1] += time.perf_counter()
        decoded.append(out.float())

    hooks = [sd.lda[1].register_forward_pre_hook(before_decode), sd.lda[1].register_forward_hook(after_decode)]
    requests: list[dict[str, Any]] = []

    def request(label: str, want: int, fn: Callable[[], Any]) -> Any:
        """`fn` between synchronizes: seconds, peak memory and K1 launches;
        every image it decodes finite and not constant."""
        del decoded[:], decode_seconds[:]
        before = read_launches()["flash_attention_packed"]
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launched = read_launches()["flash_attention_packed"] - before
        peak = torch.cuda.max_memory_allocated(dev)
        images = out if isinstance(out, list) else [out]
        z = torch.cat(decoded)
        print(
            f"sd15 {label}: {seconds:.3f} s (VAE decode {decode_seconds[-1]:.4f} s), peak memory {peak / 2**30:.2f} GiB, "
            f"K1 launches {launched}, {len(images)} image(s) {images[0].size}, "
            f"decoded mean {float(z.mean()):.4f} std {float(z.std()):.4f}"
        )
        if launched != want:
            raise AssertionError(f"sd15 {label} launched K1 {launched} times, not {want}")
        if tuple(z.shape) != (len(images), 3, SD15_SIZE, SD15_SIZE) or not torch.isfinite(z).all():
            raise AssertionError(f"sd15 {label}: decoded images of shape {tuple(z.shape)} are not finite")
        if any(float(z[i].std()) == 0.0 or np.ptp(np.asarray(im)) == 0 for i, im in enumerate(images)):
            raise AssertionError(f"sd15 {label}: an image is constant")
        requests.append({"request": label, "seconds": seconds, "vae_decode_seconds": decode_seconds[-1],
                         "peak_memory_bytes": peak, "k1_launches": launched})  # fmt: skip
        return out

    reset_launches()
    pipe = TextToImage(sd, size=(SD15_SIZE, SD15_SIZE))  # CFG 7.5
    images = [request(f"text-to-image {seed}", SD15_LAUNCHES_PER_REQUEST,
                      lambda: pipe(prompt, negative_prompt=negative, seed=seed))
              for seed, (prompt, negative) in enumerate(PROMPTS)]  # fmt: skip

    # num_images = 2: one batch of 2 latents (CFG batch 4), each image held
    # against a single request on its noise
    pair = request("num_images=2", SD15_LAUNCHES_PER_REQUEST,
                   lambda: TextToImage(sd, size=pipe.size, num_images=2)(*PROMPTS[0], seed=SD15_PAIR_SEED))  # fmt: skip
    pair_decoded = decoded[-1]
    noise = torch.randn((2, 4, latent, latent), generator=torch.Generator(dev).manual_seed(SD15_PAIR_SEED), device=dev)
    pair_err, pair_psnr = [], []
    with torch.inference_mode():
        for i in range(2):
            z = sd.diffuse(noise[i : i + 1].to(BF16), clip_text_embedding=emb16, condition_scale=7.5)
            single = sd.lda.decode(z).float()
            pair_err.append(_rel(pair_decoded[i : i + 1], single))
            pair_psnr.append(_psnr(np.asarray(pair[i]), np.asarray(tensor_to_image((single + 1) / 2))))
    print(f"sd15 num_images=2 against single requests on the same noise: rel_err {pair_err}, PSNR {pair_psnr} dB")
    if not min(pair_psnr) >= SD15_PAIR_PSNR:
        raise AssertionError(f"an image of the num_images=2 request is at PSNR {min(pair_psnr)} from its single run "
                             f"(< {SD15_PAIR_PSNR})")  # fmt: skip
    report["num_images_against_single"] = {"rel_err": pair_err, "psnr": pair_psnr}

    # img2img at strength 0.5 on the first image: the solver starts at step
    # round((1 - strength) · (steps - 1))
    first_step = round((1 - SD15_IMG2IMG_STRENGTH) * (sd.solver.num_inference_steps - 1))

    def img2img() -> Any:
        generator = torch.Generator(dev).manual_seed(SD15_IMG2IMG_SEED)
        with torch.inference_mode():
            x = sd.init_latents(pipe.size, init_image=images[0], generator=generator)
            z = sd.diffuse(x, clip_text_embedding=sd.compute_clip_text_embedding(*PROMPTS[1]), generator=generator)
            return sd.lda.latents_to_image(z)

    sd.set_inference_steps(30, first_step=first_step)
    request(f"img2img (strength {SD15_IMG2IMG_STRENGTH}, first step {first_step})",
            SD15_LAUNCHES_PER_STEP * (30 - first_step) + 2, img2img)  # fmt: skip
    sd.set_inference_steps(30)

    # inpainting: the right half of the first image repainted
    half = np.arange(SD15_SIZE)[None, :] >= SD15_SIZE // 2
    mask = Image.fromarray(np.where(half, 255, 0).astype(np.uint8).repeat(SD15_SIZE, 0), mode="L")

    def inpaint() -> Any:
        with torch.inference_mode():
            inpainting.set_inpainting_conditions(images[0], mask, latents_size=(latent, latent))
        return TextToImage(inpainting, size=pipe.size)(*PROMPTS[2], seed=SD15_INPAINT_SEED)

    request("inpainting", SD15_LAUNCHES_PER_REQUEST + 1, inpaint)
    # the path's launches: the requests' own, not those of the single runs the pair was held against
    launches = {"flash_attention_packed": sum(r["k1_launches"] for r in requests)}
    for hook in hooks:
        hook.remove()
    report["requests"] = requests
    del inpainting, unet9, pipe, sdpa, decoded, images, pair, pair_decoded, noise, emb, emb16
    _free()
    return report, launches, sd


# ---------------------------------------------------------------------------
# phase 8: SD1.5 with adapters
# ---------------------------------------------------------------------------


def _lora_weights(sd: Any, seed: int, dev: torch.device) -> dict[str, torch.Tensor]:
    """A CivitAI-style SD1.5 LoRA in the reference layout: `key.lora_down.weight`
    (rank, in), `key.lora_up.weight` (out, rank) and `key.alpha` for every
    Linear of the UNet's transformer blocks (attention and feed-forward) and
    of CLIP, keyed in the order of the tree; the up weights scaled so that a
    LoRA at scale 1 moves each layer's output by about 30 %."""
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock

    gen = torch.Generator(dev).manual_seed(seed)
    unet = [l for b in sd.unet.layers(CrossAttentionBlock, recurse=True) for l in b.layers(fl.Linear, recurse=True)]
    tensors: dict[str, torch.Tensor] = {}
    for prefix, linears in (("lora_unet", unet), ("lora_te_text_model", list(sd.clip_text_encoder.layers(fl.Linear, recurse=True)))):
        for n, linear in enumerate(linears):
            key = f"{prefix}_{n:04d}"
            down = torch.randn((LORA_RANK, linear.in_features), generator=gen, device=dev) * linear.in_features**-0.5
            up = torch.randn((linear.out_features, LORA_RANK), generator=gen, device=dev) * (0.3 * LORA_RANK**-0.5)
            tensors[f"{key}.lora_down.weight"], tensors[f"{key}.lora_up.weight"] = down, up
            tensors[f"{key}.alpha"] = torch.tensor(float(LORA_RANK))
    return tensors


class AdaptedServing:
    """Phases 8 to 11: a bf16 model (phase 7's SD1.5, or SDXL) with adapter
    sets injected in turn. One UNet step (at step 0 of the model's solver)
    three ways, gated; after each eject the bare CFG step, which must equal
    the one taken before the first injection bit for bit; and requests, each
    between synchronizes with its seconds, peak memory and K1 launches
    (counted from 0), every image it decodes finite and not constant.
    `extra` holds the model's other step inputs (SDXL: the pooled
    embedding and the time ids), `prefix` names the model in the log."""

    def __init__(self, dev: torch.device, sd: Any, x: torch.Tensor, emb: torch.Tensor, prefix: str = "sd15",
                 condition_scale: float = 7.5, extra: dict[str, torch.Tensor] | None = None,
                 size: tuple[int, int] | None = None) -> None:  # fmt: skip
        self.dev, self.sd, self.x, self.emb = dev, sd, x, emb
        self.prefix, self.condition_scale, self.extra = prefix, condition_scale, extra or {}
        self.size = size if size is not None else (SD15_SIZE, SD15_SIZE)
        self.decoded: list[torch.Tensor] = []
        self.hook = sd.lda[1].register_forward_hook(lambda _m, _i, out: self.decoded.append(out.float()))
        self.requests: list[dict[str, Any]] = []
        self.base, _ = self.step(BF16, kernel=True)

    def step(self, dtype: torch.dtype, kernel: bool, prepare: Callable[[], None] = lambda: None,
             inputs: tuple[torch.Tensor, ...] | None = None,
             extra: dict[str, torch.Tensor] | None = None) -> tuple[torch.Tensor, int]:  # fmt: skip
        """One UNet step in `dtype`, through the kernels or on the plain
        path; `prepare` sets the adapters' inputs in the UNet's dtype;
        `inputs` (latents, text embedding) and `extra` replace the default ones."""
        import refiners_tpu_torch.fluxion.layers as fl

        self.sd.unet.to(dtype=dtype)
        for layer in self.sd.unet.layers(fl.ScaledDotProductAttention, recurse=True):
            layer.is_optimized = kernel
        prepare()
        latents, embedding = inputs if inputs is not None else (self.x, self.emb)
        kwargs = {k: v.to(dtype) if v.is_floating_point() else v for k, v in (extra or self.extra).items()}
        with torch.inference_mode():
            reset_launches()
            noise = self.sd.predict_noise(latents.to(dtype), 0, clip_text_embedding=embedding.to(dtype),
                                          condition_scale=self.condition_scale, **kwargs)  # fmt: skip
            torch.cuda.synchronize()
        return noise.float(), read_launches()["flash_attention_packed"]

    def gate(self, label: str, want: int, prepare: Callable[[], None] = lambda: None,
             inputs: tuple[torch.Tensor, ...] | None = None, tf32: bool = False,
             extra: dict[str, torch.Tensor] | None = None) -> dict[str, Any]:  # fmt: skip
        """The adapted step three ways, held as phase 7 holds the bare one:
        the bf16 kernel route at most twice as far from float32 (TF32 off)
        as the bf16 plain route, and exactly `want` K1 launches (0 plain)."""
        reference, _ = self.step(F32, kernel=False, prepare=prepare, inputs=inputs, extra=extra)
        out: dict[str, Any] = {}
        if tf32:
            # PyTorch's default float32 on the card: cuDNN convolutions in TF32, matmuls exact
            torch.backends.cudnn.allow_tf32 = True
            reference_tf32, _ = self.step(F32, kernel=False, prepare=prepare, inputs=inputs, extra=extra)
            torch.backends.cudnn.allow_tf32 = False
            out["f32_tf32_default_rel_err"] = _rel(reference_tf32, reference)
            print(f"{self.prefix} {label}: float32 step under PyTorch's default (cudnn.allow_tf32=True) vs TF32 off: "
                  f"rel_err={out['f32_tf32_default_rel_err']:.3e}")  # fmt: skip
            del reference_tf32
        plain, plain_launches = self.step(BF16, kernel=False, prepare=prepare, inputs=inputs, extra=extra)
        kernels, launches = self.step(BF16, kernel=True, prepare=prepare, inputs=inputs, extra=extra)
        err_kernel, err_plain = _rel(kernels, reference), _rel(plain, reference)
        print(f"{self.prefix} {label}: one UNet step vs float32 reference: kernel route rel_err={err_kernel:.3e}, "
              f"plain bf16 route rel_err={err_plain:.3e}; K1 launches {launches} (plain route {plain_launches})")  # fmt: skip
        if not (torch.isfinite(kernels).all() and err_kernel <= 2 * err_plain):
            raise AssertionError(f"{self.prefix} {label}: the kernel route is further from float32 than the plain "
                                 f"route: {err_kernel} > 2 × {err_plain}")  # fmt: skip
        if (launches, plain_launches) != (want, 0):
            raise AssertionError(f"{self.prefix} {label}: one UNet step launched K1 {launches} times (plain route "
                                 f"{plain_launches}), not {want} (0)")  # fmt: skip
        return {**out, "bf16_kernels": err_kernel, "bf16_plain": err_plain, "step_launches": launches}

    def check_base(self, label: str) -> None:
        """After an eject, the bare UNet's step is the one taken before the
        first injection, bit for bit: the same modules, weights and inputs
        run the same (deterministic) forward kernels."""
        again, _ = self.step(BF16, kernel=True)
        if not torch.equal(again, self.base):
            raise AssertionError(f"{self.prefix} {label}: after eject the base step moved, "
                                 f"max abs {_max_abs(again, self.base)}")  # fmt: skip
        print(f"{self.prefix} {label}: ejected; the base UNet step is bit-equal to the one before the first injection")

    def request(self, label: str, want: int, fn: Callable[[], Any], size: tuple[int, int] | None = None) -> None:
        """One request, `fn` (its per-request conditions included), of images of `size` (height, width;
        the serving's size by default)."""
        size = size if size is not None else self.size
        del self.decoded[:]
        torch.cuda.reset_peak_memory_stats(self.dev)
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launched = read_launches()["flash_attention_packed"]
        peak = torch.cuda.max_memory_allocated(self.dev)
        images = out if isinstance(out, list) else [out]
        z = torch.cat(self.decoded)
        print(f"{self.prefix} {label}: {seconds:.3f} s, peak memory {peak / 2**30:.2f} GiB, K1 launches {launched}, "
              f"{len(images)} image(s), decoded mean {float(z.mean()):.4f} std {float(z.std()):.4f}")  # fmt: skip
        if launched != want:
            raise AssertionError(f"{self.prefix} {label} launched K1 {launched} times, not {want}")
        if tuple(z.shape) != (len(images), 3, *size) or not torch.isfinite(z).all():
            raise AssertionError(f"{self.prefix} {label}: decoded images of shape {tuple(z.shape)} are not finite")
        if any(float(z[i].std()) == 0.0 or np.ptp(np.asarray(im)) == 0 for i, im in enumerate(images)):
            raise AssertionError(f"{self.prefix} {label}: an image is constant")
        self.requests.append({"request": label, "seconds": seconds, "peak_memory_bytes": peak, "k1_launches": launched})

    def close(self) -> tuple[list[dict[str, Any]], dict[str, int]]:
        """The requests, and the path's K1 launches (the requests' own)."""
        self.hook.remove()
        return self.requests, {"flash_attention_packed": sum(r["k1_launches"] for r in self.requests)}


def run_sd15_adapters(dev: torch.device, sd: Any) -> tuple[dict[str, Any], dict[str, int]]:
    """Phase 7's bf16 SD1.5 with, in turn: two LoRAs, one ControlNet, a stack
    of two, a T2I-Adapter and FreeU, each injected before its request and
    ejected after it (`AdaptedServing`)."""
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.latent_diffusion import (
        SD1ControlnetAdapter,
        SD1T2IAdapter,
        SDFreeUAdapter,
        SDLoraManager,
    )
    from refiners_tpu_torch.pipelines import TextToImage

    steps = sd.solver.num_inference_steps
    latent = SD15_SIZE // 8
    gen = torch.Generator(dev).manual_seed(40)
    x = torch.randn((1, 4, latent, latent), generator=gen, device=dev)
    conditions = {name: torch.rand((1, 3, SD15_SIZE, SD15_SIZE), generator=gen, device=dev)
                  for name in ("canny", "depth", "pose")}  # fmt: skip
    with torch.inference_mode():
        emb = sd.compute_clip_text_embedding(*PROMPTS[0])
    serving = AdaptedServing(dev, sd, x, emb)
    report: dict[str, Any] = {}
    pipe = TextToImage(sd, size=(SD15_SIZE, SD15_SIZE))

    def served(seed: int, prepare: Callable[[], None] = lambda: None) -> Callable[[], Any]:
        """A text-to-image request, `prepare` (the per-request condition) included."""

        def run() -> Any:
            prepare()
            return pipe(*PROMPTS[seed % len(PROMPTS)], seed=seed)

        return run

    per_request = {n: SD15_LAUNCHES_PER_STEP * steps + 1 + 4 * n * steps for n in range(3)}  # n ControlNets

    # (a) two LoRAs through SDLoraManager, at scales 1.0 and 0.5
    manager = SDLoraManager(sd)
    t0 = time.perf_counter()
    weights = {name: _lora_weights(sd, seed, dev) for name, seed in zip(LORA_SCALES, (41, 42))}  # before any attaches
    for name, scale in LORA_SCALES.items():
        manager.add_loras(name, tensors=weights[name], scale=scale, unet_inclusions=["CrossAttentionBlock"])
    torch.cuda.synchronize()
    n_lora = len(manager.loras)
    print(f"sd15 LoRA: {n_lora} LoRA layers of rank {LORA_RANK} ({len(manager.lora_adapters)} adapters, "
          f"UNet and CLIP) loaded in {time.perf_counter() - t0:.2f} s")  # fmt: skip
    if n_lora != 2 * LORA_LAYERS:
        raise AssertionError(f"{n_lora} LoRA layers attached, not 2 × {LORA_LAYERS}")
    manager.update_scales({name: 0.0 for name in LORA_SCALES})
    zero, _ = serving.step(BF16, kernel=True)
    manager.update_scales(LORA_SCALES)
    scaled, _ = serving.step(BF16, kernel=True)
    moved = _rel(scaled, serving.base)
    print(f"sd15 LoRA: at scale 0 the step equals the base step: {torch.equal(zero, serving.base)}; at scales "
          f"{LORA_SCALES} it moves rel {moved:.3e}")  # fmt: skip
    if not torch.equal(zero, serving.base) or not moved > 1e-3:
        raise AssertionError(f"sd15 LoRA: scale 0 differs from the base step ({_max_abs(zero, serving.base)}) "
                             f"or the scales move it by only {moved}")  # fmt: skip
    report["lora"] = {"layers": n_lora, "rank": LORA_RANK, "scaled_rel_move": moved,
                      **serving.gate("LoRA", SD15_LAUNCHES_PER_STEP)}  # fmt: skip
    serving.request("LoRA x2", per_request[0], served(50))
    manager.remove_all()
    serving.check_base("LoRA")

    # (b) one ControlNet, "canny", at scale 1.0; (c) "depth" at 0.3 under "canny" at 0.7
    t0 = time.perf_counter()
    canny = SD1ControlnetAdapter(sd.unet, name="canny", scale=1.0)
    depth = SD1ControlnetAdapter(sd.unet, name="depth", scale=0.3)
    synthesize_weights(canny.controlnet, seed=43)
    synthesize_weights(depth.controlnet, seed=44)
    torch.cuda.synchronize()
    n_cn = sum(p.numel() for p in canny.controlnet.parameters())
    print(f"sd15 ControlNet: 2 built ({n_cn} parameters each, {canny.controlnet.dtype}) in {time.perf_counter() - t0:.2f} s")
    if n_cn != CONTROLNET_PARAMETERS:
        raise AssertionError(f"a ControlNet has {n_cn} parameters, not {CONTROLNET_PARAMETERS}")

    def set_canny() -> None:
        canny.set_controlnet_condition(conditions["canny"])

    def set_both() -> None:
        depth.set_controlnet_condition(conditions["depth"])
        canny.set_controlnet_condition(conditions["canny"])

    canny.inject()
    report["controlnet"] = serving.gate("ControlNet", SD15_LAUNCHES_PER_STEP + 4, set_canny, tf32=True)
    set_canny()
    with torch.inference_mode():
        x16, emb16 = x.to(BF16), emb.to(BF16)
        report["controlnet"]["unet_step_profile"] = _profile(
            "sd15 ControlNet: one UNet step (512², CFG batch 2, bf16, kernels)",
            lambda: sd.predict_noise(x16, 0, clip_text_embedding=emb16), unit="step")  # fmt: skip
    serving.request("ControlNet canny", per_request[1], served(51, set_canny))
    canny.eject()
    serving.check_base("ControlNet")
    depth.inject()
    canny.scale = 0.7
    canny.inject()
    report["controlnet_stack"] = serving.gate("ControlNet stack", SD15_LAUNCHES_PER_STEP + 8, set_both)
    serving.request("ControlNet stack depth + canny", per_request[2], served(52, set_both))
    canny.eject()
    depth.eject()
    serving.check_base("ControlNet stack")
    del canny, depth
    _free()

    # (d) a T2I-Adapter, "pose", at scale 0.8: its encoder runs once per condition
    pose = SD1T2IAdapter(sd.unet, name="pose", scale=0.8)
    synthesize_weights(pose.condition_encoder, seed=45)

    def set_pose() -> None:
        pose.condition_encoder.to(dtype=sd.unet.dtype)
        with torch.inference_mode():
            pose.set_condition_features(pose.compute_condition_features(conditions["pose"]))

    pose.inject()
    report["t2i_adapter"] = serving.gate("T2I-Adapter", SD15_LAUNCHES_PER_STEP, set_pose)
    serving.request("T2I-Adapter pose", per_request[0], served(53, set_pose))
    pose.eject()
    serving.check_base("T2I-Adapter")
    del pose, set_pose
    _free()

    # (e) FreeU
    freeu = SDFreeUAdapter(sd.unet, backbone_scales=[1.2, 1.4], skip_scales=[0.9, 0.2]).inject()
    report["freeu"] = serving.gate("FreeU", SD15_LAUNCHES_PER_STEP)
    serving.request("FreeU", per_request[0], served(54))
    freeu.eject()
    serving.check_base("FreeU")

    report["requests"], launches = serving.close()
    del pipe, manager, weights, freeu, serving, x, emb, conditions
    _free()
    return report, launches


# ---------------------------------------------------------------------------
# phase 9: SD1.5 with guidance and image prompts
# ---------------------------------------------------------------------------


def run_sd15_zoo(dev: torch.device, sd: Any) -> tuple[dict[str, Any], dict[str, int]]:
    """Phase 7's bf16 SD1.5 with, in turn: self-attention guidance,
    StyleAligned, reference-only control, Restart, IP-Adapter, IP-Adapter
    plus and a textual-inversion concept, each injected before its request
    and ejected after it (`AdaptedServing`)."""
    from refiners_tpu_torch.fluxion.utils import synthesize_weights, tensor_to_images
    from refiners_tpu_torch.foundationals.clip import ConceptExtender
    from refiners_tpu_torch.foundationals.latent_diffusion import (
        DDIM,
        ReferenceOnlyControlAdapter,
        Restart,
        SD1IPAdapter,
        StyleAlignedAdapter,
    )
    from refiners_tpu_torch.pipelines import TextToImage

    steps = sd.solver.num_inference_steps
    per_call = SD15_LAUNCHES_PER_STEP
    latent = SD15_SIZE // 8
    gen = torch.Generator(dev).manual_seed(60)
    x = torch.randn((1, 4, latent, latent), generator=gen, device=dev)
    x2 = torch.randn((2, 4, latent, latent), generator=gen, device=dev)
    guide_noise = torch.randn((2, 4, latent, latent), generator=gen, device=dev)
    concept = torch.randn(768, generator=gen, device=dev) * 768**-0.5  # rows of the synthetic token table have norm ≈ 1
    guide_image, prompt_image = (
        Image.fromarray((np.random.RandomState(seed).rand(SD15_SIZE, SD15_SIZE, 3) * 255).astype(np.uint8))
        for seed in (61, 62)
    )
    pair_prompts = ([PROMPTS[0][0], PROMPTS[1][0]], [PROMPTS[0][1], PROMPTS[1][1]])  # the first is StyleAligned's reference
    with torch.inference_mode():
        emb = sd.compute_clip_text_embedding(*PROMPTS[0])
        emb2 = sd.compute_clip_text_embedding(*pair_prompts)
    serving = AdaptedServing(dev, sd, x, emb)
    report: dict[str, Any] = {}
    pipe = TextToImage(sd, size=(SD15_SIZE, SD15_SIZE))

    # (a) self-attention guidance at 0.75: a second UNet call a step (batch 1) on the degraded latents.
    # Its mask thresholds the middle block's attention mass, so routes that differ by bf16 rounding
    # can flip mask pixels: for the gate, every route takes the float32 step's mask, and the pixels
    # each route's own mask would flip are printed.
    sd.set_self_attention_guidance(True, scale=SAG_SCALE)
    sag = sd._find_sag_adapter()
    own_mask = sag.compute_sag_mask
    masks: dict[str, Any] = {"flips": []}

    def float32_mask(latents: torch.Tensor, classifier_free_guidance: bool = True) -> torch.Tensor:
        mask = own_mask(latents, classifier_free_guidance)
        masks.setdefault("float32", mask.float())  # the gate's first step is the float32 one
        masks["flips"].append(int((mask[:, 0].float() != masks["float32"][:, 0]).sum()))
        return masks["float32"].to(mask.dtype)

    sag.compute_sag_mask = float32_mask
    report["sag"] = serving.gate("SAG", 2 * per_call)
    del sag.compute_sag_mask
    masked = int(masks["float32"][:, 0].sum())
    print(f"sd15 SAG: the float32 step's mask holds {masked} of {latent * latent} pixels; each route's own mask "
          f"flips (plain bf16, kernels bf16) {masks['flips'][1:]}")  # fmt: skip
    report["sag"].update({"mask_pixels": masked, "own_mask_flips": masks["flips"][1:]})
    serving.request("SAG", 2 * per_call * steps + 1, lambda: pipe(*PROMPTS[0], seed=70))
    sd.set_self_attention_guidance(False)
    if sd.has_self_attention_guidance():
        raise AssertionError("sd15 SAG: still injected after set_self_attention_guidance(False)")
    serving.check_base("SAG")

    # (b) StyleAligned at 0.8 on two prompts in one batch (CFG batch 4), the first the reference:
    # every self-attention's keys and values extended by the reference's
    # the reference sample attends to its own keys twice (the same softmax) after AdaIN onto itself:
    # in float32 its step stays the bare step's, the other sample's moves
    pair = (x2, emb2)
    bare_pair, _ = serving.step(F32, kernel=False, inputs=pair)
    shared = StyleAlignedAdapter(sd.unet, scale=0.8).inject()
    adapted_pair, _ = serving.step(F32, kernel=False, inputs=pair)
    reference_rel, other_rel = _rel(adapted_pair[:1], bare_pair[:1]), _rel(adapted_pair[1:], bare_pair[1:])
    print(f"sd15 StyleAligned: float32 step against the bare one on the pair: the reference sample rel "
          f"{reference_rel:.3e}, the other sample rel {other_rel:.3e}")  # fmt: skip
    report["style_aligned"] = {"reference_sample_rel": reference_rel, "other_sample_rel": other_rel,
                               **serving.gate("StyleAligned", per_call, inputs=pair)}  # fmt: skip

    def style_aligned_request() -> list[Any]:
        generator = torch.Generator(dev).manual_seed(71)
        with torch.inference_mode():
            embedding = sd.compute_clip_text_embedding(*pair_prompts)
            noise = torch.randn((2, 4, latent, latent), generator=generator, device=dev).to(sd.unet.dtype)
            z = sd.diffuse(sd.solver.scale_model_input(noise, step=-1), clip_text_embedding=embedding,
                           condition_scale=7.5, generator=generator)  # fmt: skip
            return tensor_to_images((sd.lda.decode(z) + 1) / 2)

    serving.request("StyleAligned (2 images)", per_call * steps + 1, style_aligned_request)
    shared.eject()
    serving.check_base("StyleAligned")
    del shared, bare_pair, adapted_pair

    # (c) reference-only control, style_cfg 0.5: the guide UNet (a structural copy: no new weights)
    # on the guide's latents noised to each step, then guided (Lk = 2·Lq) and unguided self-attention
    parameters = {id(p) for p in sd.unet.parameters()}
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    refonly = ReferenceOnlyControlAdapter(sd.unet, style_cfg=0.5).inject()
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated(dev) - allocated
    print(f"sd15 reference-only: injected; the UNet's parameters the same tensors: "
          f"{({id(p) for p in sd.unet.parameters()} == parameters)}, device memory added at the peak {added} bytes")  # fmt: skip
    if {id(p) for p in sd.unet.parameters()} != parameters or added > 2**20:
        raise AssertionError(f"sd15 reference-only: the guide UNet added weights ({added} bytes)")
    with torch.inference_mode():
        guide = sd.lda.image_to_latents(guide_image)
    guide2 = torch.cat([guide, guide])

    def set_guide() -> None:
        refonly.set_controlnet_condition(sd.solver.add_noise(guide2, guide_noise, 0))

    report["reference_only"] = serving.gate("reference-only", 3 * per_call, set_guide)
    report["reference_only"]["added_bytes"] = added
    set_guide()
    with torch.inference_mode():
        x16, emb16 = x.to(BF16), emb.to(BF16)
        profile = _profile("sd15 reference-only: one UNet step (512², CFG batch 2, bf16, kernels)",
                           lambda: sd.predict_noise(x16, 0, clip_text_embedding=emb16), unit="step")  # fmt: skip
    profile["k1_share"] = profile["by_kind_ms"].get("attention (flash kernels)", 0.0) / profile["device_ms"]
    print(f"sd15 reference-only: K1's share of the step's device time {profile['k1_share']:.3f}")
    report["reference_only"]["unet_step_profile"] = profile

    def refonly_request() -> Any:
        generator = torch.Generator(dev).manual_seed(72)
        with torch.inference_mode():
            latents = sd.lda.image_to_latents(guide_image)  # the guide encoded once a request
            pair_latents = torch.cat([latents, latents])
            embedding = sd.compute_clip_text_embedding(*PROMPTS[1])
            noise = torch.randn((1, 4, latent, latent), generator=generator, device=dev).to(sd.unet.dtype)
            z = sd.solver.scale_model_input(noise, step=-1)
            for i in sd.steps:
                step_noise = torch.randn(pair_latents.shape, generator=generator, device=dev)
                refonly.set_controlnet_condition(sd.solver.add_noise(pair_latents, step_noise, i))
                z = sd(z, i, clip_text_embedding=embedding, condition_scale=7.5, generator=generator)
            return tensor_to_images((sd.lda.decode(z) + 1) / 2)[0]

    serving.request("reference-only", 3 * per_call * steps + 2, refonly_request)
    refonly.eject()
    serving.check_base("reference-only")
    del refonly, guide, guide2

    # (d) Restart on DDIM 30 steps: 10 restart timesteps, 2 iterations at its start step
    dpm = sd.solver
    sd.solver = DDIM(steps, device=dev)
    restart = Restart(ldm=sd, num_steps=10, num_iterations=2)
    restart_solver = DDIM(steps, device=dev)
    restart_solver.timesteps = restart.timesteps.to(dev)
    ddim = sd.solver
    print(f"sd15 Restart: start step {restart.start_step}, timesteps {restart.timesteps.tolist()}")

    def use_restart_solver() -> None:
        sd.solver = restart_solver

    report["restart"] = {"start_step": restart.start_step, "timesteps": restart.timesteps.tolist(),
                         **serving.gate("Restart (its first timestep)", per_call, use_restart_solver)}  # fmt: skip
    sd.solver = ddim

    def restart_request() -> Any:
        generator = torch.Generator(dev).manual_seed(73)
        with torch.inference_mode():
            embedding = sd.compute_clip_text_embedding(*PROMPTS[2])
            z = torch.randn((1, 4, latent, latent), generator=generator, device=dev).to(sd.unet.dtype)
            for i in sd.steps:
                z = sd(z, i, clip_text_embedding=embedding, condition_scale=7.5)
                if i == restart.start_step:
                    z = restart(z, clip_text_embedding=embedding, condition_scale=7.5, generator=generator)
            return tensor_to_images((sd.lda.decode(z) + 1) / 2)[0]

    extra = restart.num_iterations * (restart.num_steps - 1)
    serving.request(f"Restart ({extra} extra UNet calls)", per_call * (steps + extra) + 1, restart_request)
    sd.solver = dpm
    serving.check_base("Restart")

    # (e) IP-Adapter: a full-width ViT-H/14 (on the UNet's device, in its dtype) on a 512² image
    t0 = time.perf_counter()
    ip = SD1IPAdapter(sd.unet, scale=1.0)
    synthesize_weights(ip.clip_image_encoder, seed=46)
    synthesize_weights(ip.image_proj, seed=47)
    torch.cuda.synchronize()
    n_encoder = sum(p.numel() for p in ip.clip_image_encoder.parameters())
    print(f"sd15 IP-Adapter: CLIPImageEncoderH ({n_encoder} parameters, {ip.clip_image_encoder.dtype}, "
          f"{ip.clip_image_encoder.device}) built in {time.perf_counter() - t0:.2f} s")  # fmt: skip
    if n_encoder != VIT_H_PARAMETERS or ip.clip_image_encoder.device != dev:
        raise AssertionError(f"the image encoder has {n_encoder} parameters on {ip.clip_image_encoder.device}")
    ip.inject()
    with torch.inference_mode():
        image_embedding = ip.compute_clip_image_embedding(prompt_image)
    print(f"sd15 IP-Adapter: image tokens {tuple(image_embedding.shape)} {image_embedding.dtype}")

    def set_image() -> None:
        ip.set_clip_image_embedding(image_embedding)

    report["ip_adapter"] = serving.gate("IP-Adapter", per_call, set_image)
    ip.scale = 0.0
    zero, _ = serving.step(BF16, kernel=True, prepare=set_image)
    ip.scale = 1.0
    print(f"sd15 IP-Adapter: at scale 0 the step equals the base step: {torch.equal(zero, serving.base)}")
    if not torch.equal(zero, serving.base):
        raise AssertionError(f"sd15 IP-Adapter: scale 0 differs from the base step ({_max_abs(zero, serving.base)})")

    def ip_request(adapter: Any, seed: int) -> Callable[[], Any]:
        def run() -> Any:
            with torch.inference_mode():
                adapter.set_clip_image_embedding(adapter.compute_clip_image_embedding(prompt_image))
            return pipe(*PROMPTS[1], seed=seed)

        return run

    serving.request("IP-Adapter", per_call * steps + 1, ip_request(ip, 74))
    ip.eject()
    serving.check_base("IP-Adapter")

    # (f) IP-Adapter plus: the same encoder's penultimate grid features through a perceiver resampler
    plus = SD1IPAdapter(sd.unet, clip_image_encoder=ip.clip_image_encoder, fine_grained=True)
    synthesize_weights(plus.image_proj, seed=48)
    plus.inject()
    with torch.inference_mode():
        plus_embedding = plus.compute_clip_image_embedding(prompt_image)
    print(f"sd15 IP-Adapter plus: image tokens {tuple(plus_embedding.shape)}")
    report["ip_adapter_plus"] = serving.gate("IP-Adapter plus", per_call, lambda: plus.set_clip_image_embedding(plus_embedding))
    serving.request("IP-Adapter plus", per_call * steps + 1, ip_request(plus, 75))
    plus.eject()
    serving.check_base("IP-Adapter plus")
    del ip, plus, image_embedding, plus_embedding
    _free()

    # (g) textual inversion: one 768-d concept added to CLIP-L
    extender = ConceptExtender(sd.clip_text_encoder)
    extender.add_concept(ZOO_CONCEPT, concept)
    extender.inject()
    ids = sd.clip_text_encoder[0](ZOO_PROMPT)
    if 49408 not in ids[0].tolist():
        raise AssertionError(f"the concept's token is not in the prompt's ids {ids[0].tolist()[:12]}")
    with torch.inference_mode():
        emb_concept = sd.compute_clip_text_embedding(ZOO_PROMPT, PROMPTS[0][1])
    report["textual_inversion"] = serving.gate("textual inversion", per_call, inputs=(x, emb_concept))
    serving.request("textual inversion", per_call * steps + 1, lambda: pipe(ZOO_PROMPT, negative_prompt=PROMPTS[0][1], seed=76))
    extender.eject()
    with torch.inference_mode():
        again = sd.compute_clip_text_embedding(*PROMPTS[0])
    if not torch.equal(again, emb):
        raise AssertionError("sd15 textual inversion: after eject the text embedding moved")
    serving.check_base("textual inversion")

    report["requests"], launches = serving.close()
    del pipe, serving, x, x2, emb, emb2
    _free()
    return report, launches


# ---------------------------------------------------------------------------
# phase 10: SD1.5's ELLA, IC-Light, MultiDiffusion and the MultiUpscaler
# ---------------------------------------------------------------------------


def run_sd15_slice(dev: torch.device, sd: Any) -> tuple[dict[str, Any], dict[str, int]]:
    """Phase 7's bf16 SD1.5 with ELLA injected and ejected, an IC-Light model
    from its UNet plus a patch, a MultiDiffusion panorama, and the
    MultiUpscaler built from files of its weights, a tile ControlNet, two
    LoRAs and a negative embedding, upscaling a 768² image ×2."""
    import shutil
    from pathlib import Path

    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.fluxion.utils import save_to_safetensors, synthesize_weights, tensor_to_images
    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, Controlnet, SD1ELLAAdapter, SD1UNet
    from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import FixedGroupNorm
    from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import MultiDiffusion, Size
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1 import (
        ICLight,
        MultiUpscaler,
        SD1DiffusionTarget,
        SD1MultiDiffusion,
        UpscalerCheckpoints,
    )
    from refiners_tpu_torch.pipelines import TextToImage

    steps = sd.solver.num_inference_steps
    per_call = SD15_LAUNCHES_PER_STEP
    latent = SD15_SIZE // 8
    gen = torch.Generator(dev).manual_seed(90)
    x = torch.randn((1, 4, latent, latent), generator=gen, device=dev)
    with torch.inference_mode():
        emb = sd.compute_clip_text_embedding(*PROMPTS[0])
    serving = AdaptedServing(dev, sd, x, emb)
    report: dict[str, Any] = {}
    pipe = TextToImage(sd, size=(SD15_SIZE, SD15_SIZE))

    # (a) ELLA: its encoder first in the UNet, the 32 text UseContexts of the cross-attentions pointed at
    # its latents; synthetic weights damped as golden_cfg.build_ella damps them
    t0 = time.perf_counter()
    ella = SD1ELLAAdapter(sd.unet)
    synthesize_weights(ella.latents_encoder, seed=91)
    with torch.no_grad():
        for p in ella.latents_encoder.parameters():
            p.mul_(ELLA_DAMP)
    llm = ELLA_DAMP * torch.randn((2, ELLA_TOKENS, 2048), generator=gen, device=dev)
    n_ella = sum(p.numel() for p in ella.latents_encoder.parameters())
    ella.inject()
    print(f"sd15 ELLA: encoder of {n_ella} parameters ({ella.latents_encoder.dtype}) built and injected in "
          f"{time.perf_counter() - t0:.2f} s; {len(ella.sub_adapters)} cross-attention inputs adapted")  # fmt: skip

    def set_llm() -> None:
        ella.set_llm_text_embedding(llm)

    def ella_request() -> Any:
        set_llm()
        return pipe(*PROMPTS[1], seed=100)

    report["ella"] = {"parameters": n_ella, **serving.gate("ELLA", per_call, set_llm)}
    serving.request(f"ELLA ({ELLA_TOKENS} LLM tokens)", per_call * steps + 1, ella_request)
    ella.eject()
    if any(isinstance(m, type(ella.latents_encoder)) for m in sd.unet):
        raise AssertionError("sd15 ELLA: the encoder is still in the UNet after eject")
    serving.check_base("ELLA")
    del ella, llm

    # (b) IC-Light: a second UNet with phase 7's weights, its conv_in widened to 8 channels, plus a
    # seeded patch (golden_cfg.build_ic_light); the condition a gray composite encoded once a request
    t0 = time.perf_counter()
    unet = SD1UNet(in_channels=4, device=dev, dtype=BF16)
    unet.load_state_dict(sd.unet.state_dict())
    shapes = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    shapes[IC_LIGHT_CONV_IN] = (shapes[IC_LIGHT_CONV_IN][0], 8, *shapes[IC_LIGHT_CONV_IN][2:])
    patch_gen = torch.Generator(dev).manual_seed(92)
    patch = {k: (IC_LIGHT_PATCH_STD * torch.randn(shape, generator=patch_gen, device=dev)).to(BF16)
             for k, shape in sorted(shapes.items())}  # fmt: skip
    ic = ICLight(patch_weights=patch, unet=unet, lda=sd.lda, clip_text_encoder=sd.clip_text_encoder, device=dev, dtype=BF16)
    del patch
    torch.cuda.synchronize()
    print(f"sd15 IC-Light: built from phase 7's UNet and a patch in {time.perf_counter() - t0:.2f} s, conv_in "
          f"{tuple(ic.unet.state_dict()[IC_LIGHT_CONV_IN].shape)}")  # fmt: skip
    rs = np.random.RandomState(93)
    foreground = Image.fromarray((rs.rand(SD15_SIZE, SD15_SIZE, 3) * 255).astype(np.uint8))
    yy, xx = np.indices((SD15_SIZE, SD15_SIZE)) - SD15_SIZE // 2
    subject = Image.fromarray(np.where(yy**2 + xx**2 < (SD15_SIZE // 3) ** 2, 255, 0).astype(np.uint8), mode="L")
    with torch.inference_mode():
        ic.set_ic_light_condition(foreground, subject)
    ic_serving = AdaptedServing(dev, ic, x, emb)
    report["ic_light"] = ic_serving.gate("IC-Light", per_call)
    ic_pipe = TextToImage(ic, size=(SD15_SIZE, SD15_SIZE), condition_scale=IC_LIGHT_SCALE)

    def ic_request() -> Any:
        with torch.inference_mode():
            ic.set_ic_light_condition(foreground, subject)  # the condition's encode: one wide K1 launch
        return ic_pipe(*PROMPTS[0], seed=101)

    ic_serving.request(f"IC-Light (CFG {IC_LIGHT_SCALE})", per_call * steps + 2, ic_request)
    ic_requests, _ = ic_serving.close()
    del ic, unet, ic_serving, ic_pipe
    _free()

    # (c) MultiDiffusion: a 512 × 1024 panorama, three 64² tiles of 64 × 128 latents (overlap 32), each
    # with its own DDIM, 30 steps, CFG 7.5
    md = SD1MultiDiffusion(sd)
    height, width = PANORAMA
    tiles = MultiDiffusion.generate_latent_tiles(Size(height // 8, width // 8), Size(latent, latent), min_overlap=latent // 2)
    print(f"sd15 MultiDiffusion: {len(tiles)} tiles {[tuple(t) for t in tiles]}")
    if len(tiles) != 3:
        raise AssertionError(f"the panorama has {len(tiles)} tiles, not 3")

    def panorama() -> Any:
        generator = torch.Generator(dev).manual_seed(102)
        with torch.inference_mode():
            embedding = sd.compute_clip_text_embedding(*PROMPTS[2])
            targets = [SD1DiffusionTarget(tile=t, solver=DDIM(steps, device=dev), clip_text_embedding=embedding,
                                          condition_scale=7.5) for t in tiles]  # fmt: skip
            noise = torch.randn((1, 4, height // 8, width // 8), generator=generator, device=dev).to(sd.unet.dtype)
            z = noise
            for step in sd.steps:
                z = md(z, noise=noise, step=step, targets=targets)
            return tensor_to_images((sd.lda.decode(z) + 1) / 2)[0]

    serving.request(f"MultiDiffusion {height} × {width}", len(tiles) * per_call * steps + 1, panorama, size=PANORAMA)
    serving.check_base("MultiDiffusion")
    requests, launches = serving.close()
    requests += ic_requests
    launches = {"flash_attention_packed": sum(r["k1_launches"] for r in requests)}
    del serving, pipe, md
    _free()

    # (d) the MultiUpscaler at clarity-upscaler's defaults, from files of phase 7's weights, a seeded
    # tile ControlNet, two rank-32 LoRAs and a (4, 768) negative embedding
    folder = Path(__file__).resolve().parent / "build" / "sd15_upscaler"
    folder.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    files = {name: folder / f"{name}.safetensors" for name in ("unet", "clip", "lda", "controlnet", "negative")}
    for name, module in (("unet", sd.unet), ("clip", sd.clip_text_encoder), ("lda", sd.lda)):
        save_to_safetensors(files[name], module.state_dict())
    controlnet = Controlnet(name="tile", device=dev, dtype=BF16)
    synthesize_weights(controlnet, seed=94)
    save_to_safetensors(files["controlnet"], controlnet.state_dict())
    del controlnet
    loras = {name: folder / f"lora_{name}.safetensors" for name in LORA_SCALES}
    for (name, path), seed in zip(loras.items(), (95, 96)):
        save_to_safetensors(path, _lora_weights(sd, seed, dev))
    negative = torch.randn((4, 768), generator=gen, device=dev) * 768**-0.5
    save_to_safetensors(files["negative"], {"emb_params": negative})
    written = sum(f.stat().st_size for f in folder.iterdir())
    print(f"sd15 MultiUpscaler: {written / 2**30:.2f} GiB of checkpoints written in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    upscaler = MultiUpscaler(
        UpscalerCheckpoints(unet=files["unet"], clip_text_encoder=files["clip"], lda=files["lda"],
                            controlnet_tile=files["controlnet"], negative_embedding=files["negative"],
                            negative_embedding_key="emb_params", loras=loras),
        device=dev, dtype=BF16,
    )  # fmt: skip
    torch.cuda.synchronize()
    usd, lda = upscaler.sd, upscaler.sd.lda
    n_lora = len(upscaler.manager.loras) if upscaler.manager is not None else 0
    print(f"sd15 MultiUpscaler: loaded in {time.perf_counter() - t0:.2f} s ({usd.unet.dtype}, {usd.unet.device}); "
          f"{n_lora} LoRA layers; negative tokens {upscaler.negative_embedding_token!r}")  # fmt: skip
    if n_lora != 2 * LORA_LAYERS or upscaler.negative_embedding_token != ", <0> <1> <2> <3> ":
        raise AssertionError(f"sd15 MultiUpscaler: {n_lora} LoRA layers, tokens {upscaler.negative_embedding_token!r}")
    if any(not torch.equal(v, sd.unet.state_dict()[k]) for k, v in usd.unet.state_dict().items() if k in sd.unet.state_dict()):
        raise AssertionError("sd15 MultiUpscaler: the UNet read from its file differs from phase 7's")
    upscaler.controlnet.scale, upscaler.controlnet.scale_decay = UPSCALER_CONTROLNET

    # one tile-step (UNet + tile ControlNet at 144 × 112 latents, CFG) three ways, and traced
    tile_h, tile_w = UPSCALER_TILE
    x_tile = torch.randn((1, 4, tile_h, tile_w), generator=gen, device=dev)
    tile_condition = torch.rand((1, 3, 8 * tile_h, 8 * tile_w), generator=gen, device=dev)
    with torch.inference_mode():
        tile_emb = upscaler.compute_clip_text_embedding(UPSCALER_PROMPTS[0], UPSCALER_PROMPTS[1])

    def set_tile() -> None:
        upscaler.controlnet.set_controlnet_condition(tile_condition)

    set_tile()
    tile_serving = AdaptedServing(dev, usd, x_tile, tile_emb)
    report["upscaler_tile_step"] = tile_serving.gate(f"MultiUpscaler tile-step ({tile_h} × {tile_w})", per_call + 4, set_tile)
    tile_serving.close()
    set_tile()
    with torch.inference_mode():
        x16, emb16 = x_tile.to(BF16), tile_emb.to(BF16)
        profile = _profile("sd15 MultiUpscaler: one tile-step (144 × 112 latents, CFG batch 2, UNet + ControlNet, bf16, kernels)",
                           lambda: usd.predict_noise(x16, 0, clip_text_embedding=emb16, condition_scale=6.0),
                           unit="step")  # fmt: skip
    profile["k1_share"] = profile["by_kind_ms"].get("attention (flash kernels)", 0.0) / profile["device_ms"]
    print(f"sd15 MultiUpscaler: K1's share of the tile-step's device time {profile['k1_share']:.3f}")
    report["upscaler_tile_step"]["unet_step_profile"] = profile
    del tile_serving, x16, emb16

    # one tiled decode of 192² latents (four tiles, statistics frozen on the 1536² image) three ways
    source = Image.fromarray((np.random.RandomState(97).rand(UPSCALE_INPUT, UPSCALE_INPUT, 3) * 255).astype(np.uint8))
    upscaled_input = upscaler.pre_upscale(source, upscale_factor=2)
    side = upscaled_input.width // 8
    z_tiles = torch.randn((1, 4, side, side), generator=gen, device=dev)
    z_small = torch.randn((1, 4, latent, latent), generator=gen, device=dev).to(BF16)
    vae_sdpa = list(lda.layers(fl.ScaledDotProductAttention, recurse=True))
    with torch.inference_mode():
        untiled = lda.decode(z_small)

    def tiled_decode(dtype: torch.dtype, kernel: bool) -> tuple[torch.Tensor, int, int]:
        lda.to(dtype=dtype)
        for layer in vae_sdpa:
            layer.is_optimized = kernel
        with torch.inference_mode():
            reset_launches()
            with lda.tiled_inference(upscaled_input, (UPSCALER_VAE_TILE, UPSCALER_VAE_TILE)):
                frozen = sum(1 for _ in lda.layers(FixedGroupNorm, recurse=True))
                out = lda._tiled_decode(z_tiles.to(dtype), lda._tile_size, lda._blending)
            torch.cuda.synchronize()
        return out.float(), read_launches()["flash_attention_packed"], frozen

    reference, _, frozen = tiled_decode(F32, kernel=False)
    plain, plain_launches, _ = tiled_decode(BF16, kernel=False)
    kernels, decode_launches, _ = tiled_decode(BF16, kernel=True)
    err_kernel, err_plain = _rel(kernels, reference), _rel(plain, reference)
    print(f"sd15 MultiUpscaler: one tiled decode of {side}² latents ({frozen} GroupNorms frozen) vs float32 reference: "
          f"kernel route rel_err={err_kernel:.3e}, plain bf16 route rel_err={err_plain:.3e}; K1 launches "
          f"{decode_launches} (plain route {plain_launches})")  # fmt: skip
    if not (torch.isfinite(kernels).all() and err_kernel <= 2 * err_plain):
        raise AssertionError(f"the tiled decode's kernel route is further from float32 than the plain route: "
                             f"{err_kernel} > 2 × {err_plain}")  # fmt: skip
    if (decode_launches, plain_launches) != (2 + UPSCALER_VAE_TILES, 0):
        raise AssertionError(f"one tiled decode launched K1 {decode_launches} times (plain route {plain_launches}), "
                             f"not {2 + UPSCALER_VAE_TILES} (0)")  # fmt: skip
    report["upscaler_tiled_decode"] = {"bf16_kernels": err_kernel, "bf16_plain": err_plain,
                                       "launches": decode_launches, "frozen_group_norms": frozen}  # fmt: skip
    del reference, plain, kernels

    # the request: 768² ×2 at the defaults, timed between synchronizes
    finite: list[bool] = []
    hook = lda[1].register_forward_hook(lambda _m, _i, out: finite.append(bool(torch.isfinite(out).all())))
    first_step = int(UPSCALER_STEPS * (1 - UPSCALER_DENOISE))
    want = (UPSCALER_STEPS - first_step) * UPSCALER_TILES * (per_call + 4) + 2 + 2 * UPSCALER_VAE_TILES
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    image = upscaler.upscale(source, prompt=UPSCALER_PROMPTS[0], negative_prompt=UPSCALER_PROMPTS[1],
                             tile_size=UPSCALER_TILE, autoencoder_tile_length=UPSCALER_VAE_TILE,
                             generator=torch.Generator(dev).manual_seed(103))  # fmt: skip
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launched = read_launches()["flash_attention_packed"]
    peak = torch.cuda.max_memory_allocated(dev)
    hook.remove()
    pixels = np.asarray(image)
    print(f"sd15 MultiUpscaler {UPSCALE_INPUT}² ×2 (first step {first_step} of {UPSCALER_STEPS}, {UPSCALER_TILES} "
          f"tiles): {seconds:.3f} s, peak memory {peak / 2**30:.2f} GiB, K1 launches {launched}, image {image.size}, "
          f"{len(finite)} decodes finite: {all(finite)}, pixel mean {pixels.mean():.2f} std {pixels.std():.2f}")  # fmt: skip
    if launched != want:
        raise AssertionError(f"sd15 MultiUpscaler launched K1 {launched} times, not {want}")
    if image.size != (2 * UPSCALE_INPUT, 2 * UPSCALE_INPUT) or not all(finite) or np.ptp(pixels) == 0:
        raise AssertionError(f"sd15 MultiUpscaler: the image {image.size} is not finite or is constant")
    if any(True for _ in lda.layers(FixedGroupNorm, recurse=True)):
        raise AssertionError("sd15 MultiUpscaler: a FixedGroupNorm is left after the tiled inference")
    with torch.inference_mode():
        again = lda.decode(z_small)
    if not torch.equal(again, untiled):
        raise AssertionError(f"sd15 MultiUpscaler: after the tiled inference the VAE's decode moved, "
                             f"max abs {_max_abs(again, untiled)}")  # fmt: skip
    print("sd15 MultiUpscaler: after tiled_inference the VAE's decode is bit-equal to the one before")
    requests.append({"request": f"MultiUpscaler {UPSCALE_INPUT}² x2", "seconds": seconds, "peak_memory_bytes": peak,
                     "k1_launches": launched})  # fmt: skip
    launches["flash_attention_packed"] += launched
    report["requests"] = requests
    del upscaler, usd, lda, image, z_tiles, z_small, untiled, again, x_tile, tile_condition, tile_emb
    shutil.rmtree(folder)
    _free()
    return report, launches


# ---------------------------------------------------------------------------
# phase 11: SDXL's adapter zoo
# ---------------------------------------------------------------------------


def _pair(gen: torch.Generator, dev: torch.device, rank: int, out_features: int, fan_in: tuple[int, ...],
          up_kernel: tuple[int, ...] = ()) -> tuple[torch.Tensor, torch.Tensor]:  # fmt: skip
    """A LoRA's (down, up) in the reference (torch) layout: down of `rank`
    rows over `fan_in` (in_features, or in_channels and a kernel) with unit
    output scale, up scaled so that the LoRA at scale 1 moves its layer's
    output by about 30 %."""
    down = torch.randn((rank, *fan_in), generator=gen, device=dev) * math.prod(fan_in) ** -0.5
    up = torch.randn((out_features, rank, *up_kernel), generator=gen, device=dev) * (0.3 * rank**-0.5)
    return down, up


def _sdxl_lora_weights(sd: Any, seed: int, dev: torch.device, rank: int) -> dict[str, torch.Tensor]:
    """A kohya-style SDXL LoRA: `lora_unet_*` on every Linear of the UNet's
    11 transformers (projections, attention, feed-forward), `lora_te1_*` on
    CLIP-L's and `lora_te2_*` on CLIP-G's, keyed in the order of the tree."""
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLCrossAttention

    gen = torch.Generator(dev).manual_seed(seed)
    parallel = sd.clip_text_encoder.layer("Parallel", fl.Parallel)
    groups = (("lora_unet", [l for a in sd.unet.layers(SDXLCrossAttention, recurse=True) for l in a.layers(fl.Linear, recurse=True)]),
              ("lora_te1_text_model", list(parallel[0].layers(fl.Linear, recurse=True))),
              ("lora_te2_text_model", list(parallel[1].layers(fl.Linear, recurse=True))))  # fmt: skip
    tensors: dict[str, torch.Tensor] = {}
    for prefix, linears in groups:
        for n, linear in enumerate(linears):
            down, up = _pair(gen, dev, rank, linear.out_features, (linear.in_features,))
            tensors[f"{prefix}_{n:04d}.lora_down.weight"], tensors[f"{prefix}_{n:04d}.lora_up.weight"] = down, up
    return tensors


def _lcm_lora_weights(unet: Any, seed: int, dev: torch.device, rank: int) -> dict[str, torch.Tensor]:
    """An LCM-LoRA (or SDXL-Lightning LoRA) in diffusers' key names: each
    transformer's `proj_in`/`proj_out` (`lora_unet_down_blocks_1_attentions_0_proj_in`, ...)
    and every Linear of its transformer blocks."""
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLCrossAttention

    gen = torch.Generator(dev).manual_seed(seed)
    diffusers = {"DownBlocks": ("down_blocks", [0, 0, 0, 0, 1, 1, 1, 2, 2]), "UpBlocks": ("up_blocks", [0, 0, 0, 1, 1, 1, 2, 2, 2])}
    tensors: dict[str, torch.Tensor] = {}
    attentions: dict[str, int] = {}

    def add(key: str, linear: Any) -> None:
        down, up = _pair(gen, dev, rank, linear.out_features, (linear.in_features,))
        tensors[f"{key}.lora_down.weight"], tensors[f"{key}.lora_up.weight"] = down, up

    for name in ("DownBlocks", "MiddleBlock", "UpBlocks"):
        chains = [unet.layer(name, fl.Chain)] if name == "MiddleBlock" else list(unet.layer(name, fl.Chain))
        for i, chain in enumerate(chains):
            for attention in chain.layers(SDXLCrossAttention):
                block = "mid_block" if name == "MiddleBlock" else f"{diffusers[name][0]}_{diffusers[name][1][i]}"
                prefix = f"lora_unet_{block}_attentions_{attentions.setdefault(block, 0)}"
                attentions[block] += 1
                linears = list(attention.layers(fl.Linear, recurse=True))
                add(f"{prefix}_proj_in", linears[0])
                add(f"{prefix}_proj_out", linears[-1])
                for j, transformer in enumerate(attention.layers(CrossAttentionBlock, recurse=True)):
                    for n, linear in enumerate(transformer.layers(fl.Linear, recurse=True)):
                        add(f"{prefix}_transformer_blocks_{j}_lin_{n}", linear)
    return tensors


def _control_lora_checkpoint(control: Any, seed: int, dev: torch.device, rank: int) -> tuple[dict[str, torch.Tensor], int]:
    """A stability-ai-format Control-LoRA of `rank` shaped from the
    ControlLora's tree (torch layouts): a `.down`/`.up` pair for every Linear
    and Conv2d outside its zero convolutions and condition encoder, in the
    order of the tree (conv LoRAs down at the layer's kernel, up 1×1);
    `input_hint_block.{2i}` for the condition encoder's convolutions;
    `zero_convs.{i}.0` and `middle_block_out.0` at a tenth of unit scale.
    Also the number of layers the LoRAs are for."""
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.control_lora import (
        ConditionEncoder,
        ZeroConvolution,
    )

    gen = torch.Generator(dev).manual_seed(seed)
    excluded = {id(w) for kind in (ConditionEncoder, ZeroConvolution) for sub in control.layers(kind, recurse=True)
                for w in sub.layers(fl.WeightedModule, recurse=True)}  # fmt: skip
    layers = [m for m, _ in control.walk(lambda m, _: isinstance(m, (fl.Linear, fl.Conv2d)), recurse=True)
              if id(m) not in excluded]  # fmt: skip
    tensors: dict[str, torch.Tensor] = {}
    for n, layer in enumerate(layers):
        if isinstance(layer, fl.Linear):
            down, up = _pair(gen, dev, rank, layer.out_features, (layer.in_features,))
        else:
            down, up = _pair(gen, dev, rank, layer.out_channels, (layer.in_channels, *layer.weight.shape[2:]), (1, 1))
        tensors[f"lora.a{n:04d}.down"], tensors[f"lora.a{n:04d}.up"] = down, up

    def conv(stem: str, layer: Any, gain: float) -> None:
        fan_in = math.prod(layer.weight.shape[1:])
        tensors[f"{stem}.weight"] = gain * fan_in**-0.5 * torch.randn(layer.weight.shape, generator=gen, device=dev)
        tensors[f"{stem}.bias"] = torch.zeros(layer.out_channels, device=dev)

    for i, layer in enumerate(control.ensure_find(ConditionEncoder).layers(fl.Conv2d, recurse=True)):
        conv(f"input_hint_block.{2 * i}", layer, 1.0)
    zero_convs = [z.ensure_find(fl.Conv2d) for z in control.layers(ZeroConvolution, recurse=True)]
    for i, layer in enumerate(zero_convs):
        conv(f"zero_convs.{i}.0" if i < len(zero_convs) - 1 else "middle_block_out.0", layer, 0.1)
    return tensors, len(layers)


def build_sdxl(dev: torch.device) -> Any:
    """Phase 3's model: full-width SDXL in bf16, synthetic weights from phase 3's seeds, DDIM 30 steps."""
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, StableDiffusion_XL

    manual_seed(0)
    sd = StableDiffusion_XL(solver=DDIM(num_inference_steps=30, device=dev), device=dev, dtype=BF16)
    synthesize_weights(sd, seed=7)
    return sd


def run_sdxl_zoo(dev: torch.device, sd: Any, image_encoder: Any = None) -> tuple[dict[str, Any], dict[str, int]]:
    """Phase 3's bf16 SDXL with, in turn: self-attention guidance, a
    T2I-Adapter, IP-Adapter and IP-Adapter plus, two LoRAs, the LCM adapter,
    an LCM-LoRA, an SDXL-Lightning LoRA and a Control-LoRA, each injected
    before its request and ejected after it (`AdaptedServing`), then a
    MultiDiffusion panorama. `image_encoder` is the IP-Adapters' (a
    full-width `CLIPImageEncoderH` on the UNet's device and dtype when None)."""
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.fluxion.adapters import LoraAdapter
    from refiners_tpu_torch.fluxion.utils import synthesize_weights, tensor_to_images
    from refiners_tpu_torch.foundationals.clip import CLIPImageEncoderH
    from refiners_tpu_torch.foundationals.latent_diffusion import (
        DDIM,
        Euler,
        LCMSolver,
        ModelPredictionType,
        SDLoraManager,
        SolverParams,
        TimestepSpacing,
    )
    from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import MultiDiffusion, Size
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl import (
        ControlLoraAdapter,
        SDXLIPAdapter,
        SDXLLcmAdapter,
        SDXLMultiDiffusion,
        SDXLT2IAdapter,
        SDXLTarget,
        add_lcm_lora,
    )
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.lcm import ConditionScaleBlock
    from refiners_tpu_torch.foundationals.latent_diffusion.t2i_adapter import ConditionEncoderXL
    from refiners_tpu_torch.pipelines import TextToImage

    steps = sd.solver.num_inference_steps
    per_call = SDXL_LAUNCHES_PER_CALL
    per_request = per_call * steps + 1
    size, latent = SDXL_SIZE, SDXL_SIZE // 8
    gen = torch.Generator(dev).manual_seed(110)
    x = torch.randn((1, 4, latent, latent), generator=gen, device=dev)
    conditions = {name: torch.rand((1, 3, size, size), generator=gen, device=dev) for name in ("canny", "depth")}
    prompt_image = Image.fromarray((np.random.RandomState(111).rand(size, size, 3) * 255).astype(np.uint8))
    with torch.inference_mode():
        emb, pooled = sd.compute_clip_text_embedding(*PROMPTS[0])
    time_ids = sd.default_time_ids
    extra = {"pooled_text_embedding": pooled, "time_ids": time_ids}
    # the conditional halves: the batch-1 inputs of the sets without classifier-free guidance
    single = {"inputs": (x, emb[1:]), "extra": {"pooled_text_embedding": pooled[1:], "time_ids": time_ids[1:]}}
    serving = AdaptedServing(dev, sd, x, emb, prefix="sdxl", condition_scale=5.0, extra=extra, size=(size, size))
    report: dict[str, Any] = {}
    pipe = TextToImage(sd, size=(size, size))

    def served(seed: int, prepare: Callable[[], None] = lambda: None) -> Callable[[], Any]:
        """A text-to-image request, `prepare` (the per-request condition) included."""

        def run() -> Any:
            prepare()
            return pipe(*PROMPTS[seed % len(PROMPTS)], seed=seed, condition_scale=5.0)

        return run

    # bare requests, for comparison within this call
    for seed in (112, 113):
        serving.request(f"bare (seed {seed})", per_request, served(seed))

    # (a) self-attention guidance at 1.0: a second UNet call a step (batch 1) on the degraded latents;
    # every route takes the float32 step's mask in the gate (its threshold flips pixels under bf16 rounding)
    sd.set_self_attention_guidance(True, scale=SDXL_SAG_SCALE)
    sag = sd._find_sag_adapter()
    own_mask = sag.compute_sag_mask
    masks: dict[str, Any] = {"flips": []}

    def float32_mask(latents: torch.Tensor, classifier_free_guidance: bool = True) -> torch.Tensor:
        mask = own_mask(latents, classifier_free_guidance)
        masks.setdefault("float32", mask.float())  # the gate's first step is the float32 one
        masks["flips"].append(int((mask[:, 0].float() != masks["float32"][:, 0]).sum()))
        return masks["float32"].to(mask.dtype)

    sag.compute_sag_mask = float32_mask
    report["sag"] = serving.gate("SAG", 2 * per_call)
    del sag.compute_sag_mask
    masked = int(masks["float32"][:, 0].sum())
    print(f"sdxl SAG: the float32 step's mask holds {masked} of {latent * latent} pixels; each route's own mask "
          f"flips (plain bf16, kernels bf16) {masks['flips'][1:]}")  # fmt: skip
    report["sag"].update({"mask_pixels": masked, "own_mask_flips": masks["flips"][1:]})
    serving.request("SAG", 2 * per_call * steps + 1, served(114))
    sd.set_self_attention_guidance(False)
    if sd.has_self_attention_guidance():
        raise AssertionError("sdxl SAG: still injected after set_self_attention_guidance(False)")
    serving.check_base("SAG")
    del sag

    # (b) a T2I-Adapter, "canny", at 0.8, its encoder of the UNet's widths; it runs once per condition
    c = sd.unet.base_channels
    t2i = SDXLT2IAdapter(sd.unet, name="canny", scale=0.8,
                         condition_encoder=ConditionEncoderXL(channels=(c, 2 * c, 4 * c, 4 * c), device=dev, dtype=BF16))  # fmt: skip
    synthesize_weights(t2i.condition_encoder, seed=115)

    def set_canny() -> None:
        t2i.condition_encoder.to(dtype=sd.unet.dtype)
        with torch.inference_mode():
            t2i.set_condition_features(t2i.compute_condition_features(conditions["canny"]))

    t2i.inject()
    report["t2i_adapter"] = serving.gate("T2I-Adapter", per_call, set_canny)
    serving.request("T2I-Adapter canny", per_request, served(116, set_canny))
    t2i.eject()
    serving.check_base("T2I-Adapter")
    del t2i, set_canny
    _free()

    # (c) IP-Adapter at 1.0 and (d) IP-Adapter plus, on a full-width ViT-H/14 and a seeded image
    t0 = time.perf_counter()
    encoder = image_encoder if image_encoder is not None else CLIPImageEncoderH(device=dev, dtype=BF16)
    if image_encoder is None:
        synthesize_weights(encoder, seed=117)
    ip = SDXLIPAdapter(sd.unet, clip_image_encoder=encoder)
    synthesize_weights(ip.image_proj, seed=118)
    torch.cuda.synchronize()
    n_encoder = sum(p.numel() for p in encoder.parameters())
    print(f"sdxl IP-Adapter: image encoder of {n_encoder} parameters ({encoder.dtype}, {encoder.device}) and "
          f"projection built in {time.perf_counter() - t0:.2f} s")  # fmt: skip
    if image_encoder is None and n_encoder != VIT_H_PARAMETERS:
        raise AssertionError(f"the image encoder has {n_encoder} parameters, not {VIT_H_PARAMETERS}")

    def ip_request(adapter: Any, seed: int) -> Callable[[], Any]:
        def prepare() -> None:
            with torch.inference_mode():
                adapter.set_clip_image_embedding(adapter.compute_clip_image_embedding(prompt_image))

        return served(seed, prepare)

    for label, adapter, seed in (("IP-Adapter", ip, 119), ("IP-Adapter plus", None, 120)):
        if adapter is None:
            adapter = SDXLIPAdapter(sd.unet, clip_image_encoder=encoder, fine_grained=True)
            synthesize_weights(adapter.image_proj, seed=121)
        adapter.inject()
        with torch.inference_mode():
            image_embedding = adapter.compute_clip_image_embedding(prompt_image)
        print(f"sdxl {label}: image tokens {tuple(image_embedding.shape)} {image_embedding.dtype}")
        key = "ip_adapter_plus" if adapter.fine_grained else "ip_adapter"
        report[key] = serving.gate(label, per_call, lambda: adapter.set_clip_image_embedding(image_embedding))
        report[key]["image_tokens"] = list(image_embedding.shape)
        serving.request(label, per_request, ip_request(adapter, seed))
        adapter.eject()
        serving.check_base(label)
    del ip, adapter, encoder, image_embedding
    _free()

    # (e) two rank-32 LoRAs through SDLoraManager on the UNet and both text encoders, at 1.0 and 0.5
    manager = SDLoraManager(sd)
    weights = {name: _sdxl_lora_weights(sd, seed, dev, SDXL_LORA_RANK) for name, seed in zip(SDXL_LORA_SCALES, (122, 123))}
    t0 = time.perf_counter()
    for name, scale in SDXL_LORA_SCALES.items():
        manager.add_loras(name, tensors=weights[name], scale=scale)
    torch.cuda.synchronize()
    n_lora, seconds = len(manager.loras), time.perf_counter() - t0
    print(f"sdxl LoRA: {n_lora} LoRA layers of rank {SDXL_LORA_RANK} ({len(manager.lora_adapters)} adapters: UNet, "
          f"CLIP-L, CLIP-G) attached in {seconds:.2f} s")  # fmt: skip
    if n_lora != sum(len(w) // 2 for w in weights.values()):
        raise AssertionError(f"{n_lora} LoRA layers attached, not {sum(len(w) // 2 for w in weights.values())}")
    report["lora"] = {"layers": n_lora, "rank": SDXL_LORA_RANK, "attach_seconds": seconds,
                      **serving.gate("LoRA x2", per_call)}  # fmt: skip
    serving.request("LoRA x2", per_request, served(124))
    manager.remove_all()
    serving.check_base("LoRA x2")
    del weights
    _free()

    # (f) LCM: the adapter (guidance scale 8 as an embedding), (g) an LCM-LoRA at rank 64 and
    # (h) an SDXL-Lightning LoRA, each 4 steps without classifier-free guidance: one UNet call a step
    ddim = sd.solver
    lightning_solver = Euler(num_inference_steps=4, params=SolverParams(timesteps_spacing=TimestepSpacing.TRAILING,
                             model_prediction_type=ModelPredictionType.NOISE), device=dev)  # fmt: skip

    def distilled(label: str, key: str, solver: Any, seed: int) -> None:
        sd.solver, sd.classifier_free_guidance = solver, False
        report[key] = serving.gate(label, per_call, **single)
        serving.request(label, per_call * solver.num_inference_steps + 1, served(seed))
        sd.solver, sd.classifier_free_guidance = ddim, True

    lcm = SDXLLcmAdapter(sd.unet, condition_scale=8.0).inject()
    synthesize_weights(next(sd.unet.layers(ConditionScaleBlock, recurse=True)), seed=125)
    distilled("LCM (4 steps)", "lcm", LCMSolver(num_inference_steps=4, device=dev), 126)
    lcm.eject()
    serving.check_base("LCM")
    for label, key, name, scale, solver, seed in (
        ("LCM-LoRA (4 steps)", "lcm_lora", "lcm", 8.0 / 64.0, LCMSolver(num_inference_steps=4, device=dev), 127),
        ("Lightning (4 steps)", "lightning", "lightning", 1.0, lightning_solver, 129),
    ):
        manager = SDLoraManager(sd)
        t0 = time.perf_counter()
        add_lcm_lora(manager, _lcm_lora_weights(sd.unet, seed + 1, dev, LCM_LORA_RANK), name=name, scale=scale)
        torch.cuda.synchronize()
        print(f"sdxl {label}: {len(manager.loras)} LoRA layers of rank {LCM_LORA_RANK} at scale {scale} attached "
              f"through add_lcm_lora in {time.perf_counter() - t0:.2f} s")  # fmt: skip
        distilled(label, key, solver, seed)
        report[key]["layers"] = len(manager.loras)
        manager.remove_all()
        serving.check_base(label)
    del manager
    _free()

    # (i) a Control-LoRA at rank 128 from a seeded checkpoint in stability-ai's original format, on a
    # seeded condition: the UNet's first half, copied onto the same weights, runs first in every call
    parameters = {p.data_ptr() for p in sd.unet.parameters()}
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated(dev)
    control = ControlLoraAdapter(name="depth", target=sd.unet, scale=1.0)
    checkpoint, n_layers = _control_lora_checkpoint(control.control_lora, 130, dev, CONTROL_LORA_RANK)
    t0 = time.perf_counter()
    control.load_original_weights(checkpoint)
    control.inject()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_control = len(list(control.control_lora.layers(LoraAdapter, recurse=True)))
    del checkpoint
    _free()
    added = torch.cuda.memory_allocated(dev) - allocated
    own = [p for p in control.control_lora.parameters() if p.data_ptr() not in parameters]
    own_bytes = sum(p.numel() * p.element_size() for p in own)
    print(f"sdxl Control-LoRA: {n_control} LoRAs of rank {CONTROL_LORA_RANK} on the half-UNet's {n_layers} layers, "
          f"loaded from the original format and injected in {seconds:.2f} s; its own parameters {own_bytes} bytes, "
          f"device memory added {added} bytes; the UNet's parameters the same tensors: "
          f"{ {p.data_ptr() for p in sd.unet.parameters()} >= parameters}")  # fmt: skip
    if n_control != n_layers or added > own_bytes + 64 * 2**20:
        raise AssertionError(f"sdxl Control-LoRA: {n_control} LoRAs on {n_layers} layers, or the copy added weights "
                             f"({added} bytes against its own {own_bytes})")  # fmt: skip
    if list(sd.unet.layer("DownBlocks", fl.Chain).layers(LoraAdapter, recurse=True)):
        raise AssertionError("sdxl Control-LoRA: a LoRA of the copy landed on the UNet's own path")

    def set_depth() -> None:
        control.set_condition(conditions["depth"])

    report["control_lora"] = {"loras": n_control, "rank": CONTROL_LORA_RANK, "added_bytes": added,
                              "own_bytes": own_bytes, "load_seconds": seconds,
                              **serving.gate("Control-LoRA", per_call + CONTROL_LORA_SITES, set_depth)}  # fmt: skip
    set_depth()
    with torch.inference_mode():
        x16 = x.to(BF16)
        inputs = {"clip_text_embedding": emb.to(BF16), "pooled_text_embedding": pooled.to(BF16), "time_ids": time_ids}
        profile = _profile("sdxl Control-LoRA: one UNet step (1024², CFG batch 2, bf16, kernels)",
                           lambda: sd.predict_noise(x16, 0, condition_scale=5.0, **inputs), unit="step")  # fmt: skip
    profile["k1_share"] = profile["by_kind_ms"].get("attention (flash kernels)", 0.0) / profile["device_ms"]
    print(f"sdxl Control-LoRA: K1's share of the step's device time {profile['k1_share']:.3f}")
    report["control_lora"]["unet_step_profile"] = profile
    serving.request("Control-LoRA depth", (per_call + CONTROL_LORA_SITES) * steps + 1, served(131, set_depth))
    control.eject()
    serving.check_base("Control-LoRA")
    del control, own, x16, inputs
    _free()

    # (j) MultiDiffusion: a 1024 × 2048 panorama, three 128² latent tiles (overlap 64), each with its own
    # DDIM, 30 steps, CFG 5.0; one decode of the whole 128 × 256 latent
    md = SDXLMultiDiffusion(sd)
    height, width = SDXL_PANORAMA
    tiles = MultiDiffusion.generate_latent_tiles(Size(height // 8, width // 8), Size(latent, latent), min_overlap=latent // 2)
    print(f"sdxl MultiDiffusion: {len(tiles)} tiles {[tuple(t) for t in tiles]}")
    if len(tiles) != 3:
        raise AssertionError(f"the panorama has {len(tiles)} tiles, not 3")

    def panorama() -> Any:
        generator = torch.Generator(dev).manual_seed(132)
        with torch.inference_mode():
            embedding, pooled_embedding = sd.compute_clip_text_embedding(*PROMPTS[2])
            targets = [SDXLTarget(tile=t, solver=DDIM(steps, device=dev), clip_text_embedding=embedding,
                                  pooled_text_embedding=pooled_embedding, time_ids=sd.default_time_ids,
                                  condition_scale=5.0) for t in tiles]  # fmt: skip
            noise = torch.randn((1, 4, height // 8, width // 8), generator=generator, device=dev).to(sd.unet.dtype)
            z = noise
            for step in sd.steps:
                z = md(z, noise=noise, step=step, targets=targets)
            return tensor_to_images((sd.lda.decode(z) + 1) / 2)[0]

    serving.request(f"MultiDiffusion {height} × {width}", len(tiles) * per_call * steps + 1, panorama, size=SDXL_PANORAMA)
    if sd.solver is not ddim:
        raise AssertionError("sdxl MultiDiffusion: the model's solver was not restored")
    serving.check_base("MultiDiffusion")

    report["requests"], launches = serving.close()
    del pipe, serving, md, x, emb, pooled, conditions
    _free()
    return report, launches


# ---------------------------------------------------------------------------
# phase 12: DINOv2, its Fréchet distance and the BoxSegmenter
# ---------------------------------------------------------------------------


def _timed_runs(fn: Callable[[], Any], runs: int) -> tuple[list[float], Any]:
    """Host-clock seconds of `runs` calls of `fn`, each between synchronizes; the last output."""
    seconds, out = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    return seconds, out


def run_dinov2(dev: torch.device) -> tuple[dict[str, Any], dict[str, int]]:
    """Phase 12a: DINOv2-g with and without registers at 518², batch 4, bf16."""
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals import dinov2
    from refiners_tpu_torch.foundationals.clip.tokenizer import CLIPTokenizer

    engine = CLIPTokenizer().engine
    print(f"dinov2: the CLIP tokenizer's merge engine: {engine}")
    if engine != "native":
        raise AssertionError(f"the tokenizer runs its {engine} engine: the native one did not build")
    images = torch.stack([dinov2.preprocess(_sam_image(200 + i, (640, 480)), dim=DINOV2_SIZE)
                          for i in range(DINOV2_BATCH)]).to(dev)  # fmt: skip
    report: dict[str, Any] = {"tokenizer_engine": engine}
    launches = dict.fromkeys(_counters(), 0)
    for seed, name in enumerate(("DINOv2_giant_reg", "DINOv2_giant")):
        t0 = time.perf_counter()
        manual_seed(0)
        model = getattr(dinov2, name)(device=dev, dtype=BF16)
        synthesize_weights(model, seed=170 + seed)
        torch.cuda.synchronize()
        tokens = 1 + model.num_registers + (DINOV2_SIZE // model.patch_size) ** 2
        n_params = sum(p.numel() for p in model.parameters())
        print(f"dinov2 {name}: built, {n_params} parameters, bf16, {tokens} tokens at {DINOV2_SIZE}², "
              f"{time.perf_counter() - t0:.1f} s")  # fmt: skip
        sdpa = list(model.layers(fl.ScaledDotProductAttention, recurse=True))

        # one forward three ways, held as phase 3 holds a UNet step
        def forward(dtype: torch.dtype, kernel: bool) -> tuple[torch.Tensor, int]:
            for layer in sdpa:
                layer.is_optimized = kernel
            model.to(dtype=dtype)
            before = read_launches()["flash_attention_packed"]
            with torch.inference_mode():
                out = model(images.to(dtype)).float()
            torch.cuda.synchronize()
            return out, read_launches()["flash_attention_packed"] - before

        reference, ref_launches = forward(F32, kernel=False)
        plain, plain_launches = forward(BF16, kernel=False)
        kernel, kernel_launches = forward(BF16, kernel=True)
        err_plain, err_kernel = _rel(plain, reference), _rel(kernel, reference)
        print(f"dinov2 {name}: one forward (batch {DINOV2_BATCH}) vs the float32 plain route: bf16 kernel route "
              f"rel_err={err_kernel:.3e}, bf16 plain route rel_err={err_plain:.3e}, ratio {err_kernel / err_plain:.3f}; "
              f"K1 launches float32 plain {ref_launches}, bf16 plain {plain_launches}, bf16 kernels {kernel_launches}")  # fmt: skip
        if tuple(kernel.shape) != (DINOV2_BATCH, tokens, model.embedding_dim):
            raise AssertionError(f"dinov2 {name}: output of shape {tuple(kernel.shape)}")
        if ref_launches or plain_launches or kernel_launches != DINOV2_GIANT_LAYERS:
            raise AssertionError(f"dinov2 {name}: K1 launches {ref_launches}, {plain_launches}, {kernel_launches}, "
                                 f"not 0, 0, {DINOV2_GIANT_LAYERS}")  # fmt: skip
        if not (torch.isfinite(kernel).all() and err_kernel <= 2 * err_plain):
            raise AssertionError(f"dinov2 {name}: the kernel route is further from float32 than twice the plain "
                                 f"route: {err_kernel} > 2 × {err_plain}")  # fmt: skip
        del reference, plain, kernel
        _free()

        # serving: warm forwards with the counts set to 0 just before them; the input in the model's
        # dtype (a float32 input would run every layer in float32: the layers cast weights to it)
        x = images.to(BF16)
        with torch.inference_mode():
            model(x)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            seconds, out = _timed_runs(lambda: model(x), DINOV2_FORWARDS)
            served = read_launches()
            peak = torch.cuda.max_memory_allocated(dev)
            if (served["flash_attention_packed"] != DINOV2_FORWARDS * DINOV2_GIANT_LAYERS or out.dtype != BF16
                    or not torch.isfinite(out).all()):
                raise AssertionError(f"dinov2 {name}: {served['flash_attention_packed']} K1 launches in "
                                     f"{DINOV2_FORWARDS} forwards, or a non-finite or {out.dtype} output")  # fmt: skip
            for key, count in served.items():
                launches[key] += count
            median = statistics.median(seconds)
            print(f"dinov2 {name}: seconds per forward (batch {DINOV2_BATCH}) {[round(x, 4) for x in seconds]}, "
                  f"median {median:.4f}, {DINOV2_BATCH / median:.1f} images/s, peak memory {peak / 2**30:.2f} GiB")  # fmt: skip
            profile = _profile(f"dinov2 {name}: one forward ({DINOV2_SIZE}², batch {DINOV2_BATCH}, bf16, kernels)",
                               lambda: model(x), unit="forward")  # fmt: skip
        profile["k1_share"] = profile["by_kind_ms"].get("attention (flash kernels)", 0.0) / profile["device_ms"]
        print(f"dinov2 {name}: K1's share of the forward's device time {profile['k1_share']:.3f}")
        report[name] = {"parameters": n_params, "tokens": tokens, "rel_err_kernel": err_kernel,
                        "rel_err_plain": err_plain, "seconds_per_forward": seconds, "median_seconds": median,
                        "peak_memory_bytes": peak, "launches_per_forward": kernel_launches, "profile": profile}  # fmt: skip
        del model, sdpa, out, x
        _free()
    return report, launches


def run_frechet_distance(dev: torch.device) -> dict[str, Any]:
    """Phase 12b: the DINOv2 Fréchet distance between two directories of PNGs."""
    import shutil
    from pathlib import Path

    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.dinov2 import DINOv2_small
    from refiners_tpu_torch.training_utils.metrics import DinoDataset, _batched, dinov2_frechet_distance, get_dinov2_representations

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_fd"
    shutil.rmtree(root, ignore_errors=True)
    for set_name, seed in (("a", 300), ("b", 400)):
        (root / set_name).mkdir(parents=True)
        for i in range(FD_IMAGES):
            image = _sam_image(seed + i, (320 + 16 * (i % 4), 240))
            if set_name == "b":
                image = image.transpose(Image.Transpose.FLIP_LEFT_RIGHT).rotate(90, expand=True)
            image.save(root / set_name / f"{i:02d}.png")
    manual_seed(0)
    model = DINOv2_small(device=dev)
    synthesize_weights(model, seed=180)
    reset_launches()
    seconds, fd_ab = _timed_runs(lambda: dinov2_frechet_distance(root / "a", root / "b", model, batch_size=8), 1)
    fd_aa = dinov2_frechet_distance(root / "a", root / "a", model, batch_size=8)
    launches = read_launches()
    reps = get_dinov2_representations(model, _batched(DinoDataset(root / "a"), 8))
    trace = float(np.trace(np.cov(reps.T)))
    print(f"dinov2 Fréchet distance (DINOv2_small, float32, 224², {FD_IMAGES} images a set): between the sets "
          f"{fd_ab:.6f} in {seconds[0]:.3f} s, a set with itself {fd_aa:.3e} (its covariance's trace {trace:.6f}); "
          f"launches {launches}")  # fmt: skip
    shutil.rmtree(root)
    if any(launches.values()):
        raise AssertionError(f"the Fréchet distance at 224² launched kernels: {launches}")
    if not (abs(fd_aa) <= 1e-6 * trace and math.isfinite(fd_ab) and fd_ab > 0):
        raise AssertionError(f"Fréchet distances {fd_aa} (a set with itself, trace {trace}) and {fd_ab}")
    del model
    _free()
    return {"between_sets": fd_ab, "with_itself": fd_aa, "trace": trace, "seconds": seconds[0], "images": FD_IMAGES}


def run_box_segmenter(dev: torch.device) -> dict[str, Any]:
    """Phase 12c: the BoxSegmenter on a full-width MVANet, float32 under
    PyTorch's default TF32 convolutions, directly and through the ComfyUI nodes."""
    import shutil
    from pathlib import Path

    from refiners_tpu_torch.comfyui.box_segmenter import BoxSegmenter as BoxSegmenterNode
    from refiners_tpu_torch.comfyui.box_segmenter import LoadBoxSegmenter
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.utils import image_to_tensor, save_to_safetensors, synthesize_weights
    from refiners_tpu_torch.foundationals.swin.mvanet import MVANet
    from refiners_tpu_torch.solutions import BoxSegmenter

    t0 = time.perf_counter()
    manual_seed(0)
    segmenter = BoxSegmenter(device=dev)
    synthesize_weights(segmenter.model, seed=190)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in segmenter.model.parameters())
    print(f"box segmenter: MVANet (Swin-B) built, {n_params} parameters, float32, {time.perf_counter() - t0:.1f} s")
    image = _sam_image(210, BOX_IMAGE)
    captured: dict[str, torch.Tensor] = {}
    hook = segmenter.model.register_forward_hook(lambda _m, inputs, out: captured.update(input=inputs[0], logits=out))
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the port's float32
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        seconds, mask = _timed_runs(lambda: segmenter(image, BOX_PROMPT), BOX_REQUESTS)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        hook.remove()
        x, logits_tf32 = captured["input"], captured["logits"].float().cpu()
        with torch.inference_mode():
            profile = _profile("box segmenter: one MVANet forward (1024², float32, TF32 convolutions)",
                               lambda: segmenter.model(x), unit="forward")  # fmt: skip
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            logits_f32 = segmenter.model(x).float().cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    median = statistics.median(seconds[1:])
    arr = np.asarray(mask)
    probabilities = torch.sigmoid(logits_tf32)
    print(f"box segmenter: {BOX_IMAGE[0]} × {BOX_IMAGE[1]} image, box {BOX_PROMPT}: seconds per request "
          f"{[round(s, 4) for s in seconds]} (median of the warm {median:.4f}), peak memory {peak / 2**30:.2f} GiB, "
          f"mask {mask.mode} {mask.size}, share above 127 {float((arr > 127).mean()):.4f}, probabilities "
          f"{float(probabilities.min()):.4f}..{float(probabilities.max()):.4f}; launches {launches}")  # fmt: skip
    if mask.mode != "L" or mask.size != image.size or not torch.isfinite(probabilities).all():
        raise AssertionError(f"box segmenter: mask {mask.mode} {mask.size}, or non-finite probabilities")
    if any(launches.values()):
        raise AssertionError(f"box segmenter: kernels launched {launches}")

    # the ComfyUI nodes: the weights saved to a file, loaded on the card by `LoadBoxSegmenter`, the
    # image as ComfyUI's (1, H, W, 3): the direct call's mask, bit for bit, under the same TF32 setting
    folder = Path(__file__).resolve().parent / "build" / "chip_smoke_box_segmenter"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    try:
        checkpoint = folder / "mvanet.safetensors"
        save_to_safetensors(checkpoint, segmenter.model.state_dict())
        (node_model,) = LoadBoxSegmenter().load(str(checkpoint), segmenter.margin, "cuda")
        torch.backends.cudnn.allow_tf32 = True
        try:
            (node_mask,) = BoxSegmenterNode().process(node_model, image_to_tensor(image).permute(0, 2, 3, 1), BOX_PROMPT)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    want_mask = image_to_tensor(mask)[:, 0]
    print(f"box segmenter: the ComfyUI nodes (LoadBoxSegmenter on {checkpoint.name}, BoxSegmenter): mask "
          f"{tuple(node_mask.shape)}, {int((node_mask != want_mask).sum())} pixels differ from the direct call's")  # fmt: skip
    if not torch.equal(node_mask, want_mask):
        raise AssertionError("box segmenter: the ComfyUI node's mask differs from the direct call's")
    del node_model

    # the same weights and input on the CPU, once, in float32
    cpu_model = MVANet().eval()
    cpu_model.load_state_dict(segmenter.model.state_dict())
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits_cpu = cpu_model(x.cpu())
    cpu_seconds = time.perf_counter() - t0
    err_f32, err_tf32 = _rel(logits_f32, logits_cpu), _rel(logits_tf32, logits_cpu)
    probability_err = float((probabilities - torch.sigmoid(logits_cpu)).abs().max())
    print(f"box segmenter: logits against the CPU (float32, {cpu_seconds:.1f} s on {torch.get_num_threads()} "
          f"threads): card in float32 rel_err={err_f32:.3e}, card under TF32 rel_err={err_tf32:.3e} (probabilities "
          f"max abs {probability_err:.3e}); logits std {float(logits_cpu.std()):.4f}")  # fmt: skip
    if not (err_f32 <= BOX_F32_TOL and err_tf32 <= BOX_TF32_TOL):
        raise AssertionError(f"box segmenter: the card's logits are {err_f32} (float32) and {err_tf32} (TF32) "
                             f"from the CPU's, not within {BOX_F32_TOL} and {BOX_TF32_TOL}")  # fmt: skip
    del segmenter, cpu_model, captured, x
    _free()
    return {"parameters": n_params, "seconds_per_request": seconds, "median_seconds": median,
            "peak_memory_bytes": peak, "rel_err_float32": err_f32, "rel_err_tf32": err_tf32,
            "probability_max_abs_err_tf32": probability_err, "cpu_seconds": cpu_seconds, "forward_profile": profile,
            "comfyui_node_mask_bit_equal": True}  # fmt: skip


# ---------------------------------------------------------------------------
# phase 13: SD1.5 from upstream-layout files
# ---------------------------------------------------------------------------


def upstream_state(state: dict[str, torch.Tensor], recipe: Any,
                   upstream_shape: Callable[[tuple[int, ...]], tuple[int, ...]]) -> dict[str, torch.Tensor]:  # fmt: skip
    """A refiners-layout state dict in a recipe's upstream layout: each key
    through the inverse of the key map, the recipe's prefix added; a tensor
    the recipe reshapes given its upstream shape (`upstream_shape`)."""
    inverse = {target: source for source, target in recipe.key_map.items()}
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        stem, leaf = key.rsplit(".", 1)
        source = f"{recipe.key_prefix}{inverse[stem]}.{leaf}"
        out[source] = value.reshape(upstream_shape(tuple(value.shape))) if key in recipe.tensor_reshapes else value
    return out


def run_sd15_conversion(dev: torch.device, sd: Any) -> tuple[dict[str, Any], dict[str, int]]:
    """Phase 13: phase 7's bf16 SD1.5 written as upstream checkpoints (its
    UNet in diffusers' layout, its VAE in the original LDM's, its CLIP-L in
    transformers'), converted through the port's CLI, loaded with
    strict=True over zeroed weights and served; then a refiners-layout VAE
    converted through the hub registry from a temporary cache."""
    import os
    import shutil
    from pathlib import Path

    from refiners_tpu_torch.conversion import cli
    from refiners_tpu_torch.conversion.models.registry import REGISTRY, upstream_recipes
    from refiners_tpu_torch.fluxion.utils import load_from_safetensors, save_to_safetensors
    from refiners_tpu_torch.pipelines import TextToImage

    folder = Path(__file__).resolve().parent / "build" / "chip_smoke_conversion"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    pipe = TextToImage(sd, size=(SD15_SIZE, SD15_SIZE))  # DPM++ 30 steps, CFG 7.5
    prompt, negative = PROMPTS[0]
    decoded: list[torch.Tensor] = []
    hook = sd.lda[1].register_forward_hook(lambda _m, _i, out: decoded.append(out.float().cpu()))

    def serve(label: str) -> tuple[np.ndarray, torch.Tensor, int, float]:
        """Phase 7's first request: its image, decoded tensor, K1 launches and seconds."""
        reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        image = pipe(prompt, negative_prompt=negative, seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()["flash_attention_packed"]
        print(f"conversion: {label}: {seconds:.3f} s, K1 launches {launches}")
        if launches != SD15_LAUNCHES_PER_REQUEST:
            raise AssertionError(f"conversion: {label} launched K1 {launches} times, not {SD15_LAUNCHES_PER_REQUEST}")
        return np.asarray(image), decoded[-1], launches, seconds

    def restore(module: torch.nn.Module, path: Path, original: dict[str, torch.Tensor], label: str) -> None:
        """Zero `module`, load `path` into it with strict=True, and hold every tensor bit-equal to `original`."""
        with torch.no_grad():
            for tensor in module.state_dict().values():
                tensor.zero_()
        module.load_state_dict(load_from_safetensors(path), strict=True)
        differ = [k for k, v in module.state_dict().items() if not torch.equal(v.cpu(), original[k])]
        if differ:
            raise AssertionError(f"conversion: {label}: {len(differ)} tensors differ after the load, e.g. {differ[:4]}")

    try:
        want_image, want_decoded, _, _ = serve("the request before the round trip")
        recipes = upstream_recipes()
        parts = [("unet", sd.unet, "sd15.unet/diffusers", lambda s: s),
                 ("autoencoder", sd.lda, "autoencoder/civitai", lambda s: (*s, 1, 1)),  # LDM's 1×1 convolutions
                 ("clip_text", sd.clip_text_encoder, "clip_text/transformers", lambda s: s)]  # fmt: skip
        originals: dict[str, dict[str, torch.Tensor]] = {}
        conversions = []
        for name, module, spec, shape in parts:
            originals[name] = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
            source, converted = folder / f"{name}.{spec.split('/')[1]}.safetensors", folder / f"{name}.safetensors"
            save_to_safetensors(source, upstream_state(originals[name], recipes[spec], shape))
            start = time.perf_counter()
            rc = cli.main(["--from-file", str(source), "--format", spec, "--output", str(converted)])
            seconds = time.perf_counter() - start
            if rc != 0:
                raise AssertionError(f"conversion: the CLI returned {rc} on {spec}")
            conversions.append({"part": name, "format": spec, "tensors": len(originals[name]), "seconds": seconds,
                                "bytes_in": source.stat().st_size, "bytes_out": converted.stat().st_size})  # fmt: skip
            print(f"conversion: {spec}: {len(originals[name])} tensors, {source.stat().st_size} bytes in, "
                  f"{converted.stat().st_size} bytes out, {seconds:.3f} s (load, translate, save; "
                  f"{next(iter(originals[name].values())).dtype})")  # fmt: skip
        for name, module, spec, _ in parts:
            restore(module, folder / f"{name}.safetensors", originals[name], spec)
        print(f"conversion: the three converted files loaded with strict=True over zeroed weights, "
              f"{sum(len(o) for o in originals.values())} tensors bit-equal")  # fmt: skip
        image, got_decoded, launches, seconds = serve("the request from the converted files")
        if not (np.array_equal(image, want_image) and torch.equal(got_decoded, want_decoded)):
            raise AssertionError(f"conversion: the image from the converted files differs (max abs "
                                 f"{float((got_decoded - want_decoded).abs().max())} on the decoded tensor)")  # fmt: skip

        # the hub registry: a refiners-layout file at the Hub's local path under a temporary cache
        entry = REGISTRY["sd15.autoencoder"]
        previous = os.environ.get("REFINERS_TPU_WEIGHTS")
        os.environ["REFINERS_TPU_WEIGHTS"] = str(folder / "weights")
        try:
            entry.source.local_path.parent.mkdir(parents=True)
            save_to_safetensors(entry.source.local_path, originals["autoencoder"])
            start = time.perf_counter()
            out = entry.convert()
            registry_seconds = time.perf_counter() - start
            if out != entry.converted_path or "converted_torch" not in out.parts:
                raise AssertionError(f"conversion: the registry wrote {out}, not {entry.converted_path}")
            restore(sd.lda, out, originals["autoencoder"], "sd15.autoencoder (registry)")
            registry = {"entry": entry.name, "seconds": registry_seconds, "bytes_in": entry.source.local_path.stat().st_size,
                        "bytes_out": out.stat().st_size}  # fmt: skip
        finally:
            if previous is None:
                os.environ.pop("REFINERS_TPU_WEIGHTS", None)
            else:
                os.environ["REFINERS_TPU_WEIGHTS"] = previous
        print(f"conversion: REGISTRY['sd15.autoencoder'].convert(): {registry['bytes_in']} bytes in, "
              f"{registry['bytes_out']} bytes out, {registry_seconds:.3f} s; loaded with strict=True, bit-equal")  # fmt: skip
    finally:
        hook.remove()
        shutil.rmtree(folder, ignore_errors=True)
    _free()
    report = {"conversions": conversions, "registry": registry, "request_seconds": seconds, "k1_launches": launches,
              "image_bit_equal": True}  # fmt: skip
    return report, {"flash_attention_packed": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card", file=sys.stderr)
        return 1
    from refiners_tpu_torch.ops import build
    from refiners_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False, torch.backends.cudnn.allow_tf32=False")

    start = time.perf_counter()
    paths, log = build.build_libraries()
    build.load_library()
    print(f"build: {', '.join(p.name for p in paths.values())} in {time.perf_counter() - start:.1f} s")
    entry, ptxas = "", {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = _kernel_name(line)
        elif "Used" in line or "spill" in line:
            ptxas.setdefault(entry, []).append(line.split("info    :")[-1].strip())
            print(f"  ptxas: {entry}: {ptxas[entry][-1]}")
    dq_kernel = fa.BACKWARD_KERNELS[BF16][1]
    dq_ptxas = {name: "; ".join(lines) for name, lines in ptxas.items() if name.startswith(dq_kernel + "<")}
    if log and not dq_ptxas:
        raise AssertionError(f"the build's ptxas output names no {dq_kernel} instance")
    for name, lines in dq_ptxas.items():
        print(f"ptxas K4b {name}: {lines}")
    # the wide backward's instances (bf16, fp16 at D = 256 and 512; dK/dV true, dQ false) and the
    # float32 kernels' wide ones: all 12 built, none spilling
    wide_ptxas = {name: "; ".join(lines) for name, lines in ptxas.items()
                  if name.startswith(fa.WIDE_BACKWARD_KERNEL + "<") or re.match(r"flash_bwd_d(kv|q)_f32_kernel<(256|512),", name)}  # fmt: skip
    if log and len(wide_ptxas) != 12:
        raise AssertionError(
            f"the build's ptxas output names {sorted(wide_ptxas)}, not the 8 wide wgmma and 4 float32 wide instances"
        )
    for name, lines in wide_ptxas.items():
        registers = re.search(r"Used (\d+) registers", lines)
        print(f"ptxas K4 wide {name}: {registers.group(1) if registers else '?'} registers; {lines}")
        if registers is None or "0 bytes spill stores, 0 bytes spill loads" not in lines:
            raise AssertionError(f"wide backward instance {name} spills or reports no registers: {lines}")

    check_device_default()
    packed = check_packed_forward(dev)
    forward = check_forward(dev)
    dkv, dq = check_backward(dev)
    relpos = check_relpos(dev)
    _free()
    rows = attention_rows(dev)
    gn_stats, gn_apply = check_group_norm(dev)
    quantize = check_quantize(dev)
    quantize_rows, rows_host = check_quantize_rows(dev)
    for first, label in ((packed, "K1"), (forward, "K2"), (relpos, "K3 global"), (dkv, "K4a"), (dq, "K4b")):
        _print_row(label, first[0]["ms"], rows[label])
    # the SD1.5 UNet's 32×32 site: the first bf16 case at its shape in each list
    train32 = {label: next(r for r in results if r["shape"] == TRAIN32_SHAPE and r["dtype"] == str(BF16))
               for results, label in ((forward, "K2 32²"), (dkv, "K4a 32²"), (dq, "K4b 32²"))}  # fmt: skip
    for label, result in train32.items():
        _print_row(label, result["ms"], rows[label])
    for label in WIDE_BACKWARD_SHAPES:
        for kernel in ("K4a", "K4b"):
            _print_row(f"{kernel} {label}", rows[f"{kernel} {label}"]["ms"], rows[f"{kernel} {label}"])
        row = rows[f"K4a {label}"]
        library = f"{row['library_ms']:.4f} / {row['library_device_ms']:.4f}" if row["library_ms"] is not None else "none"
        print(f"row K4 {label}: delta + K4a + K4b {row['backward_ms']:.4f} ms single, {row['backward_device_ms']:.4f} "
              f"queued; library {library} ({row['library_call']})")  # fmt: skip
    for label in ("K4a", "K4a 32²"):
        print(
            f"row {label}: delta + K4a + K4b {rows[label]['backward_ms']:.4f} ms single, "
            f"{rows[label]['backward_device_ms']:.4f} queued; library {rows[label]['library_ms']:.4f} / "
            f"{rows[label]['library_device_ms']:.4f}"
        )
    vae = next(r for r in packed if r["shape"] == VAE_SHAPE and r["dtype"] == str(BF16))
    _print_row("K1 VAE", vae["ms"], rows["K1 VAE"])
    unet32 = next(r for r in packed if r["shape"] == UNET32_SHAPE and r["dtype"] == str(BF16))
    _print_row("K1 32²", unet32["ms"], rows["K1 32²"])
    sd15_packed = {label: next(r for r in packed if r["shape"] == shape and r["dtype"] == str(BF16) and not r["causal"])
                   for label, shape in {**SD15_SHAPES, **SD15_ZOO_SHAPES, **SD15_UPSCALER_SHAPES, **SDXL_ZOO_SHAPES,
                                        **DINOV2_SHAPES}.items()}  # fmt: skip
    for label, result in sd15_packed.items():
        _print_row(label, result["ms"], rows[label])
    windowed = next(r for r in relpos if r["grid"] == [14, 14] and r["dtype"] == str(BF16))
    _print_row("K3 windowed", windowed["ms"], rows["K3 windowed"])
    for results, label in ((gn_stats, "K5a"), (gn_apply, "K5b"), (quantize, "K6"), (quantize_rows, "K6 rows")):
        _print_row(label, results[0]["ms"], results[0])
    _free()
    sdxl_launches, seconds, decode_seconds, sdxl_peak, bf16_image, unet_profile = run_sdxl(dev)
    step_check = check_training_step(dev)
    train_launches, train_records = run_trainer(dev)
    vae_step = check_vae_step(dev)
    vae_launches, vae_report = run_vae_training(dev)
    sam_report, sam_launches = run_sam(dev)
    passes_report, passes_launches = run_sdxl_passes(dev, bf16_image)
    sd15_report, sd15_launches, sd15 = run_sd15(dev)
    adapters_report, adapters_launches = run_sd15_adapters(dev, sd15)
    zoo_report, zoo_launches = run_sd15_zoo(dev, sd15)
    slice_report, slice_launches = run_sd15_slice(dev, sd15)
    conversion_report, conversion_launches = run_sd15_conversion(dev, sd15)
    del sd15
    _free()
    sdxl_zoo_report, sdxl_zoo_launches = run_sdxl_zoo(dev, build_sdxl(dev))
    _free()
    dinov2_report, dinov2_launches = run_dinov2(dev)
    fd_report = run_frechet_distance(dev)
    box_report = run_box_segmenter(dev)

    def kernel(name: str, source: str, replaces: str, launches: int, shapes: list[dict], row: dict) -> dict[str, Any]:
        return {
            "name": name, "route": "cuda", "source": f"refiners_tpu_torch/csrc/{source}",
            "replaces": f"refiners_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shapes), "ms": shapes[0]["ms"],
            "plain_ms": shapes[0]["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        }  # fmt: skip

    # K1's three sites on the SDXL path: the UNet's d = 64 at 64×64 and 32×32 latents (the narrow
    # wgmma kernel) and the VAE's d = 512 (the wide wgmma kernel); SD1.5's three: the UNet's d = 40
    # and d = 80 (narrow) and the VAE's d = 512 at 64×64 latents (wide)
    sites = [
        {"site": site, "shape": result["shape"], "ms": result["ms"], "plain_ms": result["plain_ms"],
         **{key: rows[label][key] for key in ("bound_ms", "bound_by", "library_ms", "cuda_kernel", "device_ms",
                                              "library_device_ms") if key in rows[label]}}
        for site, label, result in (("SDXL UNet 64², d = 64", "K1", packed[0]), ("SDXL UNet 32², d = 64", "K1 32²", unet32),
                                    ("SDXL VAE, d = 512", "K1 VAE", vae),
                                    ("SD1.5 UNet 64², d = 40", "K1 SD1.5 64²", sd15_packed["K1 SD1.5 64²"]),
                                    ("SD1.5 UNet 32², d = 80", "K1 SD1.5 32²", sd15_packed["K1 SD1.5 32²"]),
                                    ("SD1.5 VAE, d = 512", "K1 SD1.5 VAE", sd15_packed["K1 SD1.5 VAE"]),
                                    ("SD1.5 StyleAligned 64², d = 40, Lk = 2·Lq", "K1 StyleAligned 64²",
                                     sd15_packed["K1 StyleAligned 64²"]),
                                    ("SD1.5 StyleAligned 32², d = 80, Lk = 2·Lq", "K1 StyleAligned 32²",
                                     sd15_packed["K1 StyleAligned 32²"]),
                                    ("SD1.5 reference-only 64², d = 40, Lk = 2·Lq", "K1 ref-only 64²",
                                     sd15_packed["K1 ref-only 64²"]),
                                    ("SD1.5 reference-only 32², d = 80, Lk = 2·Lq", "K1 ref-only 32²",
                                     sd15_packed["K1 ref-only 32²"]),
                                    *((f"SD1.5 {label.removeprefix('K1 ')}, d = {shape[4]}", label, sd15_packed[label])
                                      for label, shape in SD15_UPSCALER_SHAPES.items()),
                                    *((f"{label.removeprefix('K1 ')}, d = {shape[4]}", label, sd15_packed[label])
                                      for label, shape in {**SDXL_ZOO_SHAPES, **DINOV2_SHAPES}.items()))
    ]  # fmt: skip
    k1_launches = {"sdxl": sdxl_launches["flash_attention_packed"], "sd15": sd15_launches["flash_attention_packed"],
                   "sd15_adapters": adapters_launches["flash_attention_packed"],
                   "sd15_zoo": zoo_launches["flash_attention_packed"],
                   "sd15_slice": slice_launches["flash_attention_packed"],
                   "sdxl_zoo": sdxl_zoo_launches["flash_attention_packed"],
                   "dinov2": dinov2_launches["flash_attention_packed"],
                   "vae_train": vae_launches["flash_attention_packed"],
                   "conversion": conversion_launches["flash_attention_packed"]}  # fmt: skip
    # K2's, K4a's and K4b's two sites on the training path, 5 launches each per step
    train_keys = ("bound_ms", "bound_by", "library_ms", "library_device_ms", "device_ms", "backward_ms",
                  "backward_device_ms")  # fmt: skip

    def train_sites(label: str, first: dict) -> list[dict]:
        return [
            {"site": site, "shape": result["shape"], "ms": result["ms"], "plain_ms": result["plain_ms"],
             **{key: rows[row][key] for key in train_keys if key in rows[row]}}
            for site, row, result in (("SD1.5 UNet 64², d = 40", label, first),
                                      ("SD1.5 UNet 32², d = 80", f"{label} 32²", train32[f"{label} 32²"]))
        ]  # fmt: skip

    def wide_sites(label: str, results: list[dict]) -> list[dict]:
        """K4a's or K4b's rows at the wide heads (phase 4c's VAE site and d = 256)."""
        sites = []
        for site, shape in WIDE_BACKWARD_SHAPES.items():
            result = next(r for r in results if r["shape"] == shape and r["dtype"] == str(BF16))
            row = rows[f"{label} {site}"]
            sites.append({"site": site, "shape": shape, "ms": row["ms"], "plain_ms": result["plain_ms"],
                          "cuda_kernel": row["cuda_kernel"], "library_call": row["library_call"],
                          **{key: row[key] for key in train_keys if key in row}})  # fmt: skip
        return sites

    backward_launches = {"sd15_train": train_launches["flash_attention_bwd_dkv"], "vae_train": vae_launches["flash_attention_bwd_dkv"]}

    windowed_row = {"shape": windowed["shape"], "ms": windowed["ms"], "plain_ms": windowed["plain_ms"],
                    **{key: rows["K3 windowed"][key] for key in ("bound_ms", "bound_by", "library_ms", "device_ms",
                                                                 "library_device_ms")}}  # fmt: skip
    summary = {
        "kernels": [
            {**kernel("flash_attention_packed", "flash_attention_forward.cu", "flash_attention.py:707",
                      sum(k1_launches.values()), packed, rows["K1"]), "launches_by_path": k1_launches, "sites": sites},
            # the forward with its lse under autograd: K2's sites on the SD1.5 UNet (phase 4b) and, through the
            # packed entry, K1's function at the VAE decoder's mid-block (phase 4c, flash_fwd_wgmma_kernel)
            {**kernel("flash_attention", "flash_attention_forward.cu", "flash_attention.py:105",
                      train_launches["flash_attention"] + vae_launches["flash_attention"], forward, rows["K2"]),
             "cuda_kernel": rows["K2"]["cuda_kernel"], "sites": train_sites("K2", forward[0]),
             "launches_by_path": {"sd15_train": train_launches["flash_attention"],
                                  "vae_train (K1 at d = 512, with the lse)": vae_launches["flash_attention"]}},
            {**kernel("flash_attention_bwd_dkv", "flash_attention_backward.cu", "flash_attention.py:521",
                      sum(backward_launches.values()), dkv, rows["K4a"]), "launches_by_path": backward_launches,
             "cuda_kernel": rows["K4a"]["cuda_kernel"], "sites": train_sites("K4a", dkv[0]) + wide_sites("K4a", dkv)},
            {**kernel("flash_attention_bwd_dq", "flash_attention_backward.cu", "flash_attention.py:553",
                      train_launches["flash_attention_bwd_dq"] + vae_launches["flash_attention_bwd_dq"], dq, rows["K4b"]),
             "launches_by_path": {"sd15_train": train_launches["flash_attention_bwd_dq"],
                                  "vae_train": vae_launches["flash_attention_bwd_dq"]},
             "cuda_kernel": rows["K4b"]["cuda_kernel"], "sites": train_sites("K4b", dq[0]) + wide_sites("K4b", dq),
             "ptxas": dq_ptxas, "ptxas_wide": wide_ptxas},
            {**kernel("flash_attention_relpos", "flash_attention_forward.cu", "flash_attention.py:311",
                      sam_launches["flash_attention_relpos"], relpos, rows["K3 global"]),
             "cuda_kernel": rows["K3 global"]["cuda_kernel"], "device_ms": rows["K3 global"]["device_ms"],
             "library_device_ms": rows["K3 global"]["library_device_ms"], "windowed": windowed_row},
            kernel("group_norm_stats", "group_norm.cu", "group_norm.py:55",
                   passes_launches["group_norm_stats"], gn_stats, gn_stats[0]),
            kernel("group_norm_apply", "group_norm.cu", "group_norm.py:82",
                   passes_launches["group_norm_apply"], gn_apply, gn_apply[0]),
            kernel("quantize_int8", "quant.cu", "quant.py:23", passes_launches["quantize_int8"], quantize, quantize[0]),
            # the same kernel's round-to-nearest mode: the activation quantization of the JAX package's
            # W8A8 `int8_matmul` (XLA there, no Pallas kernel)
            {**kernel("quantize_rows_int8", "quant.cu", "quant.py:113", passes_launches["quantize_rows_int8"],
                      quantize_rows, quantize_rows[0]), **rows_host,
             "shapes": [{key: r[key] for key in ("shape", "dtype", "layout", "ms", "plain_ms", "bound_ms")}
                        for r in quantize_rows]},
        ],  # fmt: skip
        "sdxl_seconds_per_request": seconds,
        "sdxl_vae_decode_seconds": decode_seconds,
        "sdxl_peak_memory_bytes": sdxl_peak,
        "sdxl_unet_step_profile": unet_profile,
        "sd15_training_step": step_check,
        "sd15_trainer_seconds_per_step": [r["seconds"] for r in train_records],
        "sd15_trainer_peak_memory_bytes": [r["peak_memory_bytes"] for r in train_records],
        "sd15_trainer_losses": [r["loss"] for r in train_records],
        "vae_training_step": vae_step,
        "vae_training": vae_report,
        "sam": sam_report,
        "sdxl_passes": passes_report,
        "sd15": sd15_report,
        "sd15_adapters": adapters_report,
        "sd15_zoo": zoo_report,
        "sd15_slice": slice_report,
        "sd15_conversion": conversion_report,
        "sdxl_zoo": sdxl_zoo_report,
        "dinov2": dinov2_report,
        "dinov2_frechet_distance": fd_report,
        "box_segmenter": box_report,
    }
    print(json.dumps(summary))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
