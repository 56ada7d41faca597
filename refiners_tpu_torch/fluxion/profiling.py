"""Profiling aids; counterpart of ``refiners_tpu/fluxion/profiling.py``.

`trace` records a ``torch.profiler`` trace (host and, where there is one,
the card) as a Chrome trace; `benchmark` is a median wall time that waits
for the card; `summarize_memory` reads the caching allocator.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "refiners_tpu_torch" / "trace"


@contextlib.contextmanager
def trace(log_dir: str | Path = DEFAULT_TRACE_DIR) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write ``trace.json`` (Chrome trace format,
    viewable in Perfetto) into `log_dir`.

    with profiling.trace("build/trace") as prof:
        out = model(x)
        torch.cuda.synchronize()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _sync(out: Any) -> None:
    """Wait for the card if any tensor of `out` (nested in tuples, lists or dicts) is on it."""
    stack = [out]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
        elif isinstance(leaf, (tuple, list)):
            stack.extend(leaf)
        elif isinstance(leaf, dict):
            stack.extend(leaf.values())


def benchmark(fn: Callable[..., Any], *args: Any, iterations: int = 10, warmup: int = 2) -> float:
    """Median wall seconds per call of `fn(*args)`, each call waited for
    (``torch.cuda.synchronize`` when its output lies on the card)."""
    times: list[float] = []
    for _ in range(warmup):
        _sync(fn(*args))
    for _ in range(iterations):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def summarize_memory() -> dict[str, int]:
    """Bytes in use by tensors on each CUDA device (empty without one)."""
    if not torch.cuda.is_available():
        return {}
    return {str(torch.device("cuda", i)): torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count())}
