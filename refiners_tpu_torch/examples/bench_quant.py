"""Time the int8 quantization kernel on one NVIDIA card: K6 (stochastic
rounding, the weights at load) and its row mode (round to nearest, the W8A8
activations on every quantized linear call).

    python -m refiners_tpu_torch.examples.bench_quant [--rounds N]

bf16 at the SDXL UNet's shapes. For each case, one JSON line a round:

- ``ms``: device milliseconds a call, 20 calls queued behind a stream sleep
  (no host time), on one input (L2-warm where it fits in the 50 MB L2);
- ``cold_ms``: the same over inputs rotated through more than 100 MB, so
  that each call reads its input from device memory;
- ``kernel_ms``: the kernel's own duration, the mean over 20 calls of
  its device events under ``torch.profiler`` (what ``ms`` adds to it is the
  gap between launches);
- ``plain_ms``: the plain PyTorch version, queued likewise (for the row
  mode, the eager sequence that ``int8_matmul`` ran before the kernel);
- ``bound_ms``: the bytes (input once, int8 values and float32 scales once)
  over 3.35 TB/s, and ``share`` = bound / cold_ms;
- for the row mode, ``host_ms`` and ``plain_host_ms``: host milliseconds of
  one call of the kernel entry and of the eager sequence, 200 calls enqueued
  without a synchronize on a small input;
- ``floor``: the queued device time of a one-element fill (``zero_``),
  the least a launch costs in this measurement.

To hold a change against its parent in one call, unpack the parent under
``build/`` and run its tree too: ``cd build/parent && PYTHONPATH=. python
../../refiners_tpu_torch/examples/bench_quant.py``. A tree without the row
mode times the weight mode only. The last line is the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Any, Callable

import torch

# (out, in) weights: 381 of the 743 SDXL UNet linears, and the GEGLU feed-forward in
WEIGHT_SHAPES = [(1280, 1280), (10240, 1280)]
# (tokens, features) activations of the W8A8 linears in one SDXL UNet step at 1024², CFG batch 2
ROW_SHAPES = [
    (8192, 640),  # the 64×64 level: q, k, v, out, cross-attention q, feed-forward in
    (8192, 2560),  # feed-forward out at 64×64
    (2048, 1280),  # the 32×32 level
    (2048, 5120),  # feed-forward out at 32×32
    (154, 2048),  # text keys and values
    (2, 2816),  # the add-embedding, padded to 32 rows
]
HOST_SHAPES = [(2, 1280), (154, 2048)]
PEAK_BYTES_PER_S = 3.35e12
COLD_BYTES = 100 * 2**20


def _device_ms(fns: list[Callable[[], Any]], reps: int = 20) -> float:
    """Device milliseconds a call, `reps` calls (cycling through `fns`)
    enqueued while the stream sleeps."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn: Callable[[], Any], reps: int = 20) -> float:
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA and "quantize" in e.name]
    return sum(times) / len(times) / 1e3 if times else float("nan")


def _host_ms(fn: Callable[[], Any], reps: int = 200) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def _inputs(shape: tuple[int, int], dev: torch.device) -> list[torch.Tensor]:
    gen = torch.Generator(dev).manual_seed(shape[0] + shape[1])
    count = min(64, max(1, -(-COLD_BYTES // (shape[0] * shape[1] * 2))))
    return [(torch.randn(shape, generator=gen, device=dev) * 0.05).to(torch.bfloat16) for _ in range(count)]


def _case(mode: str, shape: tuple[int, int], kernel: Callable, plain: Callable, dev: torch.device) -> dict[str, Any]:
    xs = _inputs(shape, dev)
    rows, cols = shape
    bound = (rows * cols * 3 + rows * 4) / PEAK_BYTES_PER_S * 1e3
    cold = _device_ms([lambda x=x: kernel(x) for x in xs], reps=max(20, len(xs)))
    return {
        "mode": mode, "shape": list(shape), "ms": _device_ms([lambda: kernel(xs[0])]), "cold_ms": cold,
        "kernel_ms": _kernel_ms(lambda: kernel(xs[0])),
        "plain_ms": _device_ms([lambda: plain(xs[0])], reps=5), "bound_ms": bound, "share": bound / cold,
    }  # fmt: skip


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_quant: no CUDA device; this script runs only on an NVIDIA card")
    from refiners_tpu_torch.ops import quant

    dev = torch.device("cuda", 0)
    rows_mode = hasattr(quant, "quantize_rows_int8")
    for round_ in range(args.rounds):
        cases = [
            _case("weight", shape, lambda w: quant.quantize_int8(w, seed=3), lambda w: quant.quantize_int8_plain(w, seed=3), dev)
            for shape in WEIGHT_SHAPES
        ]  # fmt: skip
        if rows_mode:
            cases += [
                _case("row", shape, lambda x: quant.quantize_rows_int8(x, min_rows=32), quant.quantize_rows_int8_plain, dev)
                for shape in ROW_SHAPES
            ]  # fmt: skip
            for shape in HOST_SHAPES:
                x = _inputs(shape, dev)[0]
                cases.append({
                    "mode": "row host", "shape": list(shape),
                    "host_ms": _host_ms(lambda: quant.quantize_rows_int8(x, min_rows=32)),
                    "plain_host_ms": _host_ms(lambda: quant.quantize_rows_int8_plain(x)),
                })  # fmt: skip
        one = torch.zeros(1, device=dev)
        cases.append({"mode": "floor", "ms": _device_ms([one.zero_])})
        for case in cases:
            print(json.dumps({"round": round_, "tree": quant.__file__, **case}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
