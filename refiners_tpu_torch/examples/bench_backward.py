"""Time the attention backward of the SD1.5 training slice on one NVIDIA card.

    python -m refiners_tpu_torch.examples.bench_backward [--rounds N]

At the SD1.5 UNet's two self-attention sites, (B, H, L, d) = (2, 8, 4096,
40) at 64×64 latents and (2, 8, 1024, 80) at 32×32, and at the SD1.5 VAE
decoder's mid-block at a 512² image, (2, 1, 4096, 512) (the wide kernel),
in bf16, on inputs from a seed: the device milliseconds of the forward with
lse (K2), the dK/dV kernel (K4a), the dQ kernel (K4b), the whole backward
(the delta reduction + K4a + K4b) and PyTorch's backward as the yardstick
(the port never calls it): the flash backward
(``aten._scaled_dot_product_flash_attention_backward``) at the UNet's
sites, the memory-efficient one through ``torch.autograd.grad`` at the
VAE's (PyTorch has no flash backward at d > 256), each as 20 calls queued
behind a stream sleep (no host time) and as the median of 10 single
launches between CUDA events; dq's relative error against
``flash_attention_backward_plain`` in float32; and the attention of one
training step, 5 × (K2 + K4a + K4b) at each UNet site, from the queued
times. Each round measures everything once; the card's name and power
limit head the output, one JSON line a round follows. The script reads the
package from ``sys.path``, so one command times a parent tree too (unpack
it under ``build/`` and run this file from there with ``PYTHONPATH=.``).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
from typing import Any, Callable

import torch

SITES = {"64x64": (2, 8, 4096, 40), "32x32": (2, 8, 1024, 80)}
LAUNCHES_PER_SITE = 5  # self-attention launches of each site in one SD1.5 UNet pass
VAE_SITE = (2, 1, 4096, 512)  # the SD1.5 VAE decoder's mid-block at a 512² image: one launch a step


def _single_ms(fn: Callable[[], Any], reps: int = 10) -> float:
    for _ in range(2):
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


def _queued_ms(fn: Callable[[], Any], reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # the host enqueues the calls while the stream sleeps
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure_site(b: int, h: int, seq: int, d: int, seed: int) -> dict[str, Any]:
    from refiners_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, seq, d), generator=gen, device=dev).bfloat16() for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = fa.flash_attention_forward(q, k, v, with_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    calls = {
        "K2": lambda: fa.flash_attention_forward(q, k, v, with_lse=True),
        "K4a": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, False, scale),
        "K4b": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, False, scale),
        "backward": lambda: fa.flash_attention_backward(q, k, v, out, lse, do),
        "library_backward": _library_backward(q, k, v, do, scale),
    }
    result: dict[str, Any] = {"shape": [b, h, seq, d]}
    for name, fn in calls.items():
        result[f"{name}_queued_ms"] = _queued_ms(fn)
        result[f"{name}_single_ms"] = _single_ms(fn)
    dq = calls["K4b"]()
    want = fa.flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse, do.float())[0]
    result["dq_rel_err"] = float(torch.linalg.vector_norm(dq.float() - want) / torch.linalg.vector_norm(want))
    result["dq_kernel"] = fa.backward_kernels(torch.bfloat16, d)[1]
    return result


def _library_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, scale: float) -> Callable[[], Any]:
    """PyTorch's backward of the same attention: the flash one from its
    forward's residuals where it takes the head (d ≤ 256), else the
    memory-efficient one through ``torch.autograd.grad`` on a forward taken
    once."""
    if q.shape[-1] <= 256:
        aten = torch.ops.aten
        lib = aten._scaled_dot_product_flash_attention(q, k, v, scale=scale)
        return lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, lib[0], lib[1], lib[2], lib[3], lib[4], lib[5], 0.0, False, lib[6], lib[7], scale=scale
        )
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_backward: no CUDA device; this script runs only on an NVIDIA card")
    from refiners_tpu_torch.ops import build

    build.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )  # fmt: skip
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}")
    for r in range(args.rounds):
        sites = {label: measure_site(*shape, seed=r) for label, shape in SITES.items()}
        step = sum(LAUNCHES_PER_SITE * (s["K2_queued_ms"] + s["K4a_queued_ms"] + s["K4b_queued_ms"]) for s in sites.values())
        sites["vae"] = measure_site(*VAE_SITE, seed=r)
        print(json.dumps({"round": r, "sites": sites, "training_step_attention_queued_ms": step}))


if __name__ == "__main__":
    main()
