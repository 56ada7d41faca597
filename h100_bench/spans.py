"""The port's own spans (`refiners_tpu_torch.fluxion.tracing`) read around
a cell's run, on the card, in one process.

    python3 h100_bench/spans.py --workload <cell> --seed <n> --seconds <s> [--windows <k>]

The traced run turns the tracer on before set-up and keeps its totals,
resets it at the window's start and keeps the window's, then profiles the
cell's stretch with the tracer still on and splits the device's idle time
by the innermost ``refiners.`` span open at each instant (`idle_by_span`).
It prints one JSON line: the set-up's and the window's totals, the per-layer
readings that the spans give (`readings`), the harness's own
``program_host_ms`` beside the spans' sum over the same calls, and the
stretch's idle milliseconds per item by span, beside the host's CUDA
runtime calls by span (`runtime_by_span`) and every annotation's
milliseconds per item (`annotations`). With ``--windows k`` it
instead runs `k` windows after one set-up, the tracer off and on in turns
(off, on, on, off, ...), and prints each window's rate: what the spans
cost. The comparison with the reference is not run. `run.py` does not
call this file.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PREFIX = "refiners."
ROOTS = ("refiners.TextToImage.call", "refiners.Trainer.step")  # a request's or a step's own span
NONE = "none"
PROGRAM = ("refiners.Program.key", "refiners.Program.copy_in", "refiners.Program.replay", "refiners.Program.clone")


def idle_by_span(events: list[Any]) -> dict[str, float]:
    """Idle seconds of the stretch (`trace.STRETCH`) by the innermost
    ``refiners.`` span open at each instant, `NONE` where none is: each
    gap between the device's operations is cut at every span's start and
    end. The values sum to the stretch's idle time."""
    from torch.autograd import DeviceType

    from h100_bench.trace import STRETCH

    spans, device, stretch = [], [], None
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name() == STRETCH:
                stretch = (start, end)
            elif e.is_user_annotation() and e.name().startswith(PREFIX):
                spans.append((start, end, e.name()))
        elif not e.is_user_annotation():
            device.append((start, end))
    if stretch is None:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    begin, finish = stretch
    gaps, cursor = [], begin
    for s, e in sorted(device):
        s, e = max(s, begin), min(e, finish)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        cursor = e
    if finish > cursor:
        gaps.append((cursor, finish))
    out: dict[str, float] = {}
    for g0, g1 in gaps:
        cuts = sorted({g0, g1, *(t for s, e, _ in spans for t in (s, e) if g0 < t < g1)})
        for a, b in zip(cuts, cuts[1:]):
            open_ = [s for s in spans if s[0] <= a and b <= s[1]]
            name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else NONE
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def runtime_by_span(events: list[Any]) -> dict[str, dict[str, float]]:
    """Seconds of the host's CUDA runtime calls (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...) by the innermost
    ``refiners.`` span open at each call's start, `NONE` outside them, and
    by call: how much of a span's time the host spent in launches, copies
    and waits that block."""
    from torch.autograd import DeviceType

    spans, calls = [], []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.is_user_annotation():
            if e.name().startswith(PREFIX):
                spans.append((start, end, e.name()))
        elif e.name().startswith("cuda"):
            calls.append((start, end, e.name()))
    out: dict[str, dict[str, float]] = {}
    for start, end, call in calls:
        open_ = [s for s in spans if s[0] <= start < s[1]]
        name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else NONE
        by_call = out.setdefault(name, {})
        by_call[call] = by_call.get(call, 0.0) + (end - start) / 1e9
    return out


def annotations(events: list[Any]) -> dict[str, float]:
    """Seconds by name of every host annotation of the trace: the port's
    spans, the harness's wrappers and torch's own (``Optimizer.step#...``)."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.is_user_annotation():
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _seconds(totals: dict[str, dict[str, Any]], name: str, kind: str = "self_s") -> float:
    return totals[name][kind] if name in totals else 0.0


def readings(setup: dict[str, Any], window: dict[str, Any], calls: int, idle: dict[str, float] | None) -> dict[str, Any]:
    """The per-layer numbers the spans give: host ms a request or step
    (`calls` in the window), first-call seconds in set-up, and the share of
    the stretch's idle time under a root span or none."""
    if not calls:
        return {}
    per = 1e3 / calls
    out: dict[str, Any] = {
        "program_key_ms": per * _seconds(window, "refiners.Program.key"),
        "program_launch_ms": per * _seconds(window, "refiners.Program.replay", "total_s"),
        "program_first_call_s": _seconds(setup, "refiners.Program.first_call", "total_s"),
        "program_spans_ms": per * sum(_seconds(window, n) for n in PROGRAM),
    }
    if "refiners.TextToImage.call" in window:
        out["encode_ms"] = per * _seconds(window, "refiners.TextToImage.encode")
        out["to_images_ms"] = per * _seconds(window, "refiners.TextToImage.to_images")
    if "refiners.Trainer.step" in window:
        out["optimizer_ms"] = per * _seconds(window, "refiners.Trainer.optimizer_step")
    if idle:
        unnamed = sum(v for k, v in idle.items() if k in ROOTS or k == NONE)
        out["idle_unnamed_share"] = 100 * unnamed / sum(idle.values())
    return out


def _per_call(totals: dict[str, Any], calls: int) -> dict[str, Any]:
    return {n: {"count": t["count"] / calls, "ms": 1e3 * t["total_s"] / calls, "self_ms": 1e3 * t["self_s"] / calls}
            for n, t in totals.items()}  # fmt: skip


def traced(cell: Any, seed: int, seconds: float, device: Any, t0: float) -> dict[str, Any]:
    """Set-up and window with the tracer on, then the profiled stretch."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    from h100_bench import bench, trace
    from refiners_tpu_torch.fluxion import tracing

    run = bench.Run(cell=cell, seed=seed)
    driver = cell.driver().Driver(cell, seed, torch.device(device))
    tracing.reset()
    tracing.enable()
    try:
        driver.setup()
        run.setup_s = time.perf_counter() - t0
        setup = tracing.totals()
        tracing.reset()
        driver.window(run, seconds)
        window = tracing.totals()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
        with torch.profiler.profile(activities=activities) as prof:
            items = driver.stretch(record_function)
    finally:
        tracing.disable()
    events = prof.profiler.kineto_results.events()
    stretch = trace.reduce(events, items)
    idle = idle_by_span(events)
    out = {
        "workload": cell.name, "seed": seed, "setup_s": run.setup_s, "rate": run.items / run.window_s,
        "calls": run.calls, "readings": readings(setup, window, run.calls, idle),
        "program_host_ms": 1e3 * run.program_host_s / run.calls,
        "setup_spans": setup, "window_per_call": _per_call(window, run.calls),
        "idle_ms_per_item": {k: 1e3 * v / items for k, v in idle.items()},
        "runtime_ms_per_item": {k: {c: 1e3 * v / items for c, v in by.items()} for k, by in runtime_by_span(events).items()},
        "annotations_ms_per_item": {k: 1e3 * v / items for k, v in annotations(events).items()},
        "stretch": {"window_s": stretch.window_s, "busy_s": stretch.busy_s, "items": items, "gaps": stretch.gaps[:10]},
        "clocks": bench.clocks(device),
    }  # fmt: skip
    driver.free()
    return out


def cost(cell: Any, seed: int, seconds: float, device: Any, windows: int) -> dict[str, Any]:
    """`windows` windows after one set-up, the tracer off, on, on, off, ...: each window's rate."""
    import torch

    from h100_bench import bench
    from refiners_tpu_torch.fluxion import tracing

    driver = cell.driver().Driver(cell, seed, torch.device(device))
    driver.setup()
    rates: dict[str, list[float]] = {"off": [], "on": []}
    for i in range(windows):
        on = i % 4 in (1, 2)
        if on:
            tracing.enable()
        try:
            run = bench.Run(cell=cell, seed=seed)
            driver.window(run, seconds)
        finally:
            tracing.disable()
            tracing.reset()
        # a serving driver counts the requests of every window so far in `items`, and this window's in `latencies`
        done = len(run.latencies) * cell.mix["num_images"] if run.latencies else run.items
        rates["on" if on else "off"].append(done / run.window_s)
    driver.free()
    return {"workload": cell.name, "seed": seed, "rates": rates, "clocks": bench.clocks(device)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--windows", type=int, default=0, help="k > 0: k windows, the tracer off and on in turns")
    args = p.parse_args(argv)

    from h100_bench import bench

    cell = bench.Cell.load(args.workload, bench.load_json(ROOT / "BENCHMARK.json"))
    bench.pin_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("h100_bench: spans.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.windows:
        out = cost(cell, args.seed, args.seconds, device, args.windows)
    else:
        out = traced(cell, args.seed, args.seconds, device, T0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
