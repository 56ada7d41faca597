"""Drive the PyTorch/CUDA port's SDXL text-to-image path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no result line):

0. device: requires CUDA; prints the card's name and power limit; turns
   TF32 off so that float32 references are true float32.
1. build: compiles the CUDA kernels from ``refiners_tpu_torch/csrc/`` into
   ``build/refiners_tpu_torch/``.
2. kernels: the hand-written flash attention kernel against its plain
   PyTorch version, bf16 inputs from a seed, at the shapes of the SDXL path
   plus a ragged and a causal case; relative Frobenius error ≤ 1e-2 against
   the plain version computed in float32, and the kernel's uniform weights on
   causal rows that have no admissible key. Times are medians over CUDA events.
3. slice: full-width SDXL (UNet, CLIP-L + CLIP-G, VAE) in bf16 on the card
   with seeded synthetic weights, one UNet step through the kernel against
   the same step on the plain path, then 3 requests through ``TextToImage``
   at 1024², 30 DDIM steps, CFG 5.0. Each image must be finite and not
   constant, and each request must launch the kernel exactly 70 × 30 + 1
   times (70 UNet self-attention sites per step, one VAE site).

The last lines are a JSON summary of the kernels, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REL_TOL = 1e-2  # bf16 unit roundoff 3.9e-3; P and O are each rounded once
LAUNCHES_PER_REQUEST = 70 * 30 + 1
ATTENTION_SHAPES = [
    # (batch, q_len, kv_len, heads, head_dim, causal)
    (2, 4096, 4096, 10, 64, False),  # UNet self-attention at 64×64 latents
    (2, 1024, 1024, 20, 64, False),  # UNet self-attention at 32×32 latents
    (1, 16384, 16384, 1, 512, False),  # VAE decoder mid-block at 128×128
    (2, 1000, 1100, 5, 64, False),  # ragged
    (2, 1024, 1024, 10, 64, True),  # causal
]
PROMPTS = [
    ("a cute cat sitting on a windowsill, soft morning light", "blurry, low quality"),
    ("an astronaut riding a horse on the moon, highly detailed", "cartoon"),
    ("a bowl of ramen, studio photograph", ""),
]


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )  # fmt: skip
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
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


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float()))


def check_kernels(dev: torch.device) -> list[dict]:
    from refiners_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_packed_plain

    results = []
    gen = torch.Generator(dev).manual_seed(0)
    for b, lq, lk, h, d, causal in ATTENTION_SHAPES:
        q = torch.randn((b, lq, h * d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, lk, h * d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, lk, h * d), generator=gen, device=dev).bfloat16()
        out = flash_attention_packed(q, k, v, is_causal=causal, head_dim=d)
        torch.cuda.synchronize()
        ref = flash_attention_packed_plain(q.float(), k.float(), v.float(), is_causal=causal, head_dim=d)
        rel = _rel(out, ref)
        max_abs = float((out.float() - ref).abs().max())
        ms = _time_ms(lambda: flash_attention_packed(q, k, v, is_causal=causal, head_dim=d), reps=10)
        plain_ms = _time_ms(lambda: flash_attention_packed_plain(q, k, v, is_causal=causal, head_dim=d), reps=3, warmup=1)
        flops = 4 * b * h * lq * lk * d / (2 if causal else 1)
        print(
            f"kernel (B={b}, Lq={lq}, Lk={lk}, H={h}, d={d}, causal={causal}): rel_err={rel:.3e} "
            f"max_abs_err={max_abs:.3e} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"kernel_TFLOP/s={flops / ms / 1e9:.1f}"
        )
        if not rel <= REL_TOL:
            raise AssertionError(f"kernel disagrees with the plain version: rel_err={rel} > {REL_TOL}")
        results.append(
            {"shape": [b, lq, lk, h, d], "causal": causal, "rel_err": rel, "max_abs_err": max_abs,
             "ms": ms, "plain_ms": plain_ms}
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
    print(f"kernel fully-masked causal rows: rel_err vs uniform={rel_uniform:.3e}, other rows rel_err={rel_rest:.3e}")
    if not (rel_uniform <= REL_TOL and rel_rest <= REL_TOL):
        raise AssertionError("causal rows with no admissible key must get uniform weights")
    return results


def synthesize_weights(module: torch.nn.Module, seed: int) -> None:
    """Seeded fan-in-scaled normals, drawn on the device, for every weight of
    two or more dims; norms and biases keep their constructor values."""
    gen = torch.Generator(next(module.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim >= 2:
                p.normal_(generator=gen).mul_(math.prod(p.shape[1:]) ** -0.5)


def run_slice(dev: torch.device) -> tuple[int, list[float], int]:
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, StableDiffusion_XL
    from refiners_tpu_torch.ops.flash_attention import flash_attention_packed
    from refiners_tpu_torch.pipelines import TextToImage

    t0 = time.perf_counter()
    manual_seed(0)
    sd = StableDiffusion_XL(solver=DDIM(num_inference_steps=30, device=dev), device=dev, dtype=torch.bfloat16)
    synthesize_weights(sd, seed=7)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sd.parameters())
    print(f"slice: StableDiffusion_XL built, {n_params} parameters, bf16, {time.perf_counter() - t0:.1f} s")

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
        f"slice: one UNet step (1024², CFG batch 2) vs float32 reference: kernel route rel_err={err_kernel:.3e}, "
        f"plain bf16 route rel_err={err_plain:.3e}, kernel vs plain rel_err={_rel(kernel_noise, plain_noise):.3e}"
    )
    if not (torch.isfinite(kernel_noise).all() and err_kernel <= 2 * err_plain):
        raise AssertionError(f"the kernel route is further from float32 than the plain route: {err_kernel} > 2 × {err_plain}")

    decoded: list[torch.Tensor] = []
    hook = sd.lda[1].register_forward_hook(lambda _m, _i, out: decoded.append(out))
    seconds = []
    flash_attention_packed.launches = 0
    for seed, (prompt, negative) in enumerate(PROMPTS):
        before = flash_attention_packed.launches
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        start = time.perf_counter()
        image = pipe(prompt, negative_prompt=negative, seed=seed, condition_scale=5.0)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        launched = flash_attention_packed.launches - before
        out = decoded[-1]
        arr = np.asarray(image)
        peak = torch.cuda.max_memory_allocated(dev)
        print(
            f"request {seed}: {seconds[-1]:.3f} s, kernel launches {launched}, image {image.size}, "
            f"decoded mean {float(out.float().mean()):.4f} std {float(out.float().std()):.4f}, "
            f"peak memory {peak / 2**30:.2f} GiB"
        )
        if launched != LAUNCHES_PER_REQUEST:
            raise AssertionError(f"request {seed} launched the kernel {launched} times, not {LAUNCHES_PER_REQUEST}")
        if tuple(out.shape) != (1, 3, 1024, 1024) or not torch.isfinite(out).all():
            raise AssertionError(f"request {seed}: decoded image of shape {tuple(out.shape)} is not finite")
        if float(out.float().std()) == 0.0 or arr.min() == arr.max():
            raise AssertionError(f"request {seed}: the image is constant")
    launches = flash_attention_packed.launches
    hook.remove()
    return launches, seconds, peak


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card", file=sys.stderr)
        return 1
    from refiners_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False, torch.backends.cudnn.allow_tf32=False")

    start = time.perf_counter()
    path, log = build.build_library()
    build.load_library()
    print(f"build: {path.relative_to(build.BUILD_DIR.parents[1])} in {time.perf_counter() - start:.1f} s")
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    per_shape = check_kernels(dev)
    launches, seconds, peak = run_slice(dev)
    main_site = per_shape[0]
    summary = {
        "kernels": [
            {
                "name": "flash_attention_packed",
                "route": "cuda",
                "source": "refiners_tpu_torch/csrc/flash_attention_packed.cu",
                "replaces": "refiners_tpu/ops/flash_attention.py:707",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in per_shape),
                "ms": main_site["ms"],
                "plain_ms": main_site["plain_ms"],
                "per_shape": per_shape,
            }
        ],
        "seconds_per_request": seconds,
        "peak_memory_bytes": peak,
    }
    print(json.dumps(summary))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
