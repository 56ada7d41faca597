"""A stretch of whole requests or steps under ``torch.profiler``, reduced in
memory to what the per-layer metrics read: the stretch's length on the
host, the device's busy time in it (the union of every operation it ran),
each kernel's summed time, and the idle gaps named by the benchmark's host
wrapper that was open when each began.

The stretch is the span of the ``h100_bench.stretch`` annotation that the
driver opens before its first host call and closes after its last
synchronize, so the idle time before the first kernel and after the last
is counted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

STRETCH = "h100_bench.stretch"

# kernel-name fragments → kind, first match wins (`refiners_tpu_torch.examples.profile_train.KINDS`)
KINDS = [
    ("attention (flash kernels)", ("flash_", "fmha", "attention")),
    ("fused GroupNorm+SiLU (K5a, K5b)", ("gn_stats_kernel", "gn_apply_kernel")),
    ("int8 quantization (K6 and its row mode)", ("quantize_rows_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "nchwToNhwc", "nhwcToNchw")),
    ("optimizer and other foreach", ("multi_tensor_apply", "foreach")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("softmax", ("softmax",)),
    ("norm statistics and reductions", ("reduce", "welford", "norm")),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
    ("elementwise arithmetic (no cast)", ("_nocast",)),
    ("copies and casts", ("cast",)),
]


def kind(name: str) -> str:
    for k, fragments in KINDS:
        if any(f in name for f in fragments):
            return k
    return "elementwise and other"


@dataclass
class Stretch:
    window_s: float  # the stretch on the host clock of the trace
    busy_s: float  # seconds in which some operation ran on the device
    items: int  # images or samples completed in the stretch
    kernels: dict[str, float]  # device seconds by operation name
    gaps: list[tuple[str, float]] = field(default_factory=list)  # the longest idle gaps, by host wrapper

    @property
    def device_s(self) -> float:
        return sum(self.kernels.values())

    def by_kind(self) -> dict[str, float]:
        """Device milliseconds per item, by kind of operation."""
        kinds: dict[str, float] = {}
        for name, seconds in self.kernels.items():
            kinds[kind(name)] = kinds.get(kind(name), 0.0) + 1e3 * seconds / max(self.items, 1)
        return dict(sorted(kinds.items(), key=lambda kv: -kv[1]))

    def breakdown(self) -> dict[str, list[list[Any]]]:
        by_name = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {
            "device_ops": [[f"{kind(n)}: {n[:120]}", s] for n, s in by_name],
            "idle_gaps": [[n, s] for n, s in self.gaps[:10]],
        }


def reduce(events: list[Any], items: int) -> Stretch:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType

    spans, device = [], []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation() or e.name() == STRETCH:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif not e.is_user_annotation():  # a range annotation shown on the device would cover its kernels
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    outer = [s for s in spans if s[2] == STRETCH]
    if not outer:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    start, end = outer[0][0], outer[0][1]
    kernels: dict[str, float] = {}
    for s, e, name in device:
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e9
    busy, gaps, cursor = 0, [], start
    for s, e, _ in sorted(device):
        s, e = max(s, start), min(e, end)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        busy += e - max(s, cursor)
        cursor = e
    if end > cursor:
        gaps.append((cursor, end))
    inner = [s for s in spans if s[2] != STRETCH]

    def host(at: int) -> str:
        open_ = [s for s in inner if s[0] <= at < s[1]]
        return min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "outside the benchmark's wrappers"

    named = [(host(g0), (g1 - g0) / 1e9) for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]]
    return Stretch(window_s=(end - start) / 1e9, busy_s=busy / 1e9, items=items, kernels=kernels, gaps=named)


def profile(stretch: Callable[[Callable[[str], Any]], int], device: Any) -> Stretch:
    """Run `stretch(annotate)` under the profiler and reduce it; `stretch`
    opens `annotate(STRETCH)` around its work and returns its item count."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        items = stretch(record_function)
    return reduce(prof.profiler.kineto_results.events(), items)
