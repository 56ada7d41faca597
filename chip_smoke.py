"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no result line):

0. device: requires CUDA; prints the card's name and power limit; turns
   TF32 off so that float32 references are true float32; checks that the
   facades (`StableDiffusion_XL`, `SegmentAnything`) built with no device
   land on the card (small sub-models, built on the host and moved).
1. build: compiles the CUDA kernels from ``refiners_tpu_torch/csrc/`` into
   ``build/refiners_tpu_torch/``, one ``nvcc`` per source, side by side.
2. kernels: every hand-written kernel against its plain PyTorch version on
   inputs from a seed, in bf16 (tensor cores) and in float32 (FFMA); times
   are medians over CUDA events. Float32 cases are held to 1e-5 against
   the float32 plain version.
   - the packed forward (``flash_attention_packed``) at the SDXL path's
     shapes (the UNet's d = 64 on the narrow wgmma kernel, the VAE's
     d = 512 on the wide one) plus ragged, causal, d = 40, d = 80, d = 128,
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
     bytes of every dQ instance from the build's ptxas output;
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

The last lines are a JSON summary of the kernels (launches counted over
phases 3, 4b, 5b and 6, each with the counts set to 0 just before it), the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
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
]
VAE_SHAPE = [1, 16384, 16384, 1, 512]  # (batch, q_len, kv_len, heads, head_dim) of K1's VAE site
UNET32_SHAPE = [2, 1024, 1024, 20, 64]  # K1's second UNet site (60 of its 70 launches per step)
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
]


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
    types = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "float32"}
    args = [types.get(tok, tok) for tok in re.findall(r"13__nv_bfloat16|6__half|^f|(?<=Li)\d+", template.group(1))]
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
    queued = (
        f" queued device_ms={row['device_ms']:.4f} (share {row['bound_ms'] / row['device_ms']:.3f}), "
        f"library {row['library_device_ms']:.4f}"
        if "device_ms" in row
        else ""
    )
    kernel = f" [{row['cuda_kernel']}]" if "cuda_kernel" in row else ""
    print(
        f"row {label}{kernel}: kernel_ms={ms:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
        f"share={row['bound_ms'] / ms:.3f} library_ms={library} ({row['library_call']}){queued}"
    )


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
    for label, (b, seq, h, d) in (("K1", (2, 4096, 10, 64)), ("K1 32²", (2, 1024, 20, 64)), ("K1 VAE", (1, 16384, 1, 512))):
        q, k, v = randn(b, seq, h * d), randn(b, seq, h * d), randn(b, seq, h * d)
        heads = lambda t: t.view(b, seq, h, d).transpose(1, 2)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v))  # noqa: E731
        rows[label] = {
            **_bound(4 * b * h * seq * seq * d, 4 * b * seq * h * d * 2, BF16),
            "library_ms": _time_ms(library, reps=10),
            "library_call": f"F.scaled_dot_product_attention on the {(b, h, seq, d)} head views",
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
        SDXLAutoencoder,
        SDXLUNet,
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
    devices = {p.device.type for model in (sd, sam) for p in model.parameters()} | {sd.solver.timesteps.device.type}
    print(f"device default: StableDiffusion_XL() and SegmentAnything(...) with no device hold their tensors on {devices}")
    if devices != {"cuda"}:
        raise AssertionError(f"a facade built with no device left tensors on {devices}")
    del sd, sam, text_l, text_g
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


def check_training_step(dev: torch.device) -> dict[str, float]:
    import refiners_tpu_torch.fluxion.layers as fl
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
    sdpa = list(unet.layers(fl.ScaledDotProductAttention, recurse=True))
    params = list(unet.parameters())

    def grads(dtype: torch.dtype, kernel: bool) -> tuple[list[torch.Tensor], float, dict[str, int]]:
        for layer in sdpa:
            layer.is_optimized = kernel
        unet.to(dtype=dtype)
        unet.zero_grad(set_to_none=True)
        reset_launches()
        unet.set_timestep(solver.timesteps[steps])
        unet.set_clip_text_embedding(text.to(dtype))
        noised = solver.add_noise(x.to(dtype), noise.to(dtype), steps)
        loss = ((unet(noised).float() - noise) ** 2).mean()
        loss.backward()
        torch.cuda.synchronize()
        return [p.grad.float() for p in params], float(loss.detach()), read_launches()

    reference, ref_loss, ref_launches = grads(torch.float32, kernel=False)
    ref_norm = math.sqrt(sum(float((g * g).sum()) for g in reference))

    def distance(got: list[torch.Tensor]) -> float:
        return math.sqrt(sum(float(((g - r) ** 2).sum()) for g, r in zip(got, reference))) / ref_norm

    # float32 through the kernels first: the bf16 routes round the weights
    f32_kernel, f32_kernel_loss, f32_launches = grads(torch.float32, kernel=True)
    err_f32_kernel = distance(f32_kernel)
    del f32_kernel
    plain, plain_loss, plain_launches = grads(torch.bfloat16, kernel=False)
    err_plain = distance(plain)
    del plain
    kernel, kernel_loss, kernel_launches = grads(torch.bfloat16, kernel=True)
    err_kernel = distance(kernel)
    finite = all(bool(torch.isfinite(g).all()) for g in kernel)
    del kernel, reference
    print(
        f"sd15: one training step (batch 2, 64×64, fwd+bwd) losses float32 plain {ref_loss:.5f}, bf16 plain "
        f"{plain_loss:.5f}, bf16 kernels {kernel_loss:.5f}, float32 kernels {f32_kernel_loss:.5f}; gradient vs "
        f"float32 plain: bf16 kernel route rel_err={err_kernel:.3e}, bf16 plain route rel_err={err_plain:.3e}, "
        f"float32 kernel route rel_err={err_f32_kernel:.3e}; launches float32 plain {ref_launches}, bf16 plain "
        f"{plain_launches}, bf16 kernels {kernel_launches}, float32 kernels {f32_launches}"
    )
    if any(ref_launches.values()) or any(plain_launches.values()):
        raise AssertionError("the plain steps must launch no kernel")
    want = TRAINING_STEP_LAUNCHES
    if kernel_launches != want or f32_launches != want:
        raise AssertionError(f"the kernel steps launched {kernel_launches} (bf16), {f32_launches} (float32), not {want}")
    if not (finite and err_kernel <= 2 * err_plain):
        raise AssertionError(f"the kernel route's gradient is further from float32 than twice the plain route's: {err_kernel} > 2 × {err_plain}")
    if not err_f32_kernel <= F32_STEP_TOL:
        raise AssertionError(f"the float32 kernel route's gradient is {err_f32_kernel} from the plain route's (> {F32_STEP_TOL})")
    del unet, params, sdpa
    _free()
    return {"grad_rel_err_kernel": err_kernel, "grad_rel_err_plain_bf16": err_plain, "grad_rel_err_f32_kernel": err_f32_kernel}


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
    windowed = next(r for r in relpos if r["grid"] == [14, 14] and r["dtype"] == str(BF16))
    _print_row("K3 windowed", windowed["ms"], rows["K3 windowed"])
    for results, label in ((gn_stats, "K5a"), (gn_apply, "K5b"), (quantize, "K6"), (quantize_rows, "K6 rows")):
        _print_row(label, results[0]["ms"], results[0])
    _free()
    sdxl_launches, seconds, decode_seconds, sdxl_peak, bf16_image, unet_profile = run_sdxl(dev)
    step_check = check_training_step(dev)
    train_launches, train_records = run_trainer(dev)
    sam_report, sam_launches = run_sam(dev)
    passes_report, passes_launches = run_sdxl_passes(dev, bf16_image)

    def kernel(name: str, source: str, replaces: str, launches: int, shapes: list[dict], row: dict) -> dict[str, Any]:
        return {
            "name": name, "route": "cuda", "source": f"refiners_tpu_torch/csrc/{source}",
            "replaces": f"refiners_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shapes), "ms": shapes[0]["ms"],
            "plain_ms": shapes[0]["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        }  # fmt: skip

    # K1's three sites on the SDXL path: the UNet's d = 64 at 64×64 and 32×32 latents (the narrow
    # wgmma kernel) and the VAE's d = 512 (the wide wgmma kernel)
    sites = [
        {"site": site, "shape": result["shape"], "ms": result["ms"], "plain_ms": result["plain_ms"],
         **{key: rows[label][key] for key in ("bound_ms", "bound_by", "library_ms", "cuda_kernel", "device_ms",
                                              "library_device_ms") if key in rows[label]}}
        for site, label, result in (("SDXL UNet 64², d = 64", "K1", packed[0]), ("SDXL UNet 32², d = 64", "K1 32²", unet32),
                                    ("SDXL VAE, d = 512", "K1 VAE", vae))
    ]  # fmt: skip
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

    windowed_row = {"shape": windowed["shape"], "ms": windowed["ms"], "plain_ms": windowed["plain_ms"],
                    **{key: rows["K3 windowed"][key] for key in ("bound_ms", "bound_by", "library_ms", "device_ms",
                                                                 "library_device_ms")}}  # fmt: skip
    summary = {
        "kernels": [
            {**kernel("flash_attention_packed", "flash_attention_forward.cu", "flash_attention.py:707",
                      sdxl_launches["flash_attention_packed"], packed, rows["K1"]), "sites": sites},
            {**kernel("flash_attention", "flash_attention_forward.cu", "flash_attention.py:105",
                      train_launches["flash_attention"], forward, rows["K2"]), "cuda_kernel": rows["K2"]["cuda_kernel"],
             "sites": train_sites("K2", forward[0])},
            {**kernel("flash_attention_bwd_dkv", "flash_attention_backward.cu", "flash_attention.py:521",
                      train_launches["flash_attention_bwd_dkv"], dkv, rows["K4a"]),
             "cuda_kernel": rows["K4a"]["cuda_kernel"], "sites": train_sites("K4a", dkv[0])},
            {**kernel("flash_attention_bwd_dq", "flash_attention_backward.cu", "flash_attention.py:553",
                      train_launches["flash_attention_bwd_dq"], dq, rows["K4b"]),
             "cuda_kernel": rows["K4b"]["cuda_kernel"], "sites": train_sites("K4b", dq[0]), "ptxas": dq_ptxas},
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
        "sam": sam_report,
        "sdxl_passes": passes_report,
    }
    print(json.dumps(summary))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
