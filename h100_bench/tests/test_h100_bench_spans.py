"""`h100_bench/spans.py` on the CPU: the stretch's idle time split by the
port's spans on synthetic events, the readings from synthetic totals, and
a traced run and a cost run of tiny cells.

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path
from types import SimpleNamespace
from typing import Iterator

import pytest
import torch

from h100_bench import spans, trace
from h100_bench.tests import tiny

MS = 1_000_000


def _event(name: str, start: float, end: float, cpu: bool = True, annotation: bool = True) -> SimpleNamespace:
    from torch.autograd import DeviceType

    kind = DeviceType.CPU if cpu else DeviceType.CUDA
    return SimpleNamespace(name=lambda: name, start_ns=lambda: round(start * MS), duration_ns=lambda: round((end - start) * MS),
                           device_type=lambda: kind, is_user_annotation=lambda: annotation)  # fmt: skip


def test_idle_time_is_split_by_the_innermost_span() -> None:
    """A stretch of 0-10 ms, kernels at 1-3 and 5-6; the request's span at
    0.5-10, the key walk's at 3.5-4.5, the read's at 4.5-8, and a harness
    wrapper (not the port's) at 3-10. The gap 3-5 splits three ways, 6-10
    two ways; 0-0.5 lies under no span."""
    call, key, read = "refiners.TextToImage.call", "refiners.Program.key", "refiners.wait.read_images"
    events = [
        _event(trace.STRETCH, 0, 10),
        _event(call, 0.5, 10),
        _event(key, 3.5, 4.5),
        _event(read, 4.5, 8),
        _event("tensor_to_images", 3, 10),
        _event("kernel", 1, 3, cpu=False, annotation=False),
        _event("kernel", 5, 6, cpu=False, annotation=False),
        _event("gpu_user_annotation", 0, 10, cpu=False),
    ]
    idle = spans.idle_by_span(events)
    assert idle == {call: pytest.approx(0.0030), read: pytest.approx(0.0025), key: pytest.approx(0.0010),
                    spans.NONE: pytest.approx(0.0005)}  # fmt: skip
    stretch = trace.reduce(events, items=1)
    assert sum(idle.values()) == pytest.approx(stretch.window_s - stretch.busy_s)
    share = spans.readings({}, {}, 1, idle)["idle_unnamed_share"]
    assert share == pytest.approx(100 * 3.5 / 7)
    launches = [_event("cudaGraphLaunch", 3.6, 4.0, annotation=False), _event("cudaLaunchKernel", 0.2, 0.3, annotation=False),
                _event("cudaLaunchKernel", 5.0, 5.5, annotation=False), _event("aten::add", 5.0, 5.5, annotation=False)]  # fmt: skip
    assert spans.runtime_by_span(events + launches) == {
        key: {"cudaGraphLaunch": pytest.approx(0.0004)}, spans.NONE: {"cudaLaunchKernel": pytest.approx(0.0001)},
        read: {"cudaLaunchKernel": pytest.approx(0.0005)}}  # fmt: skip
    assert spans.annotations(events) == {trace.STRETCH: 0.01, call: 0.0095, "tensor_to_images": 0.007, read: 0.0035, key: 0.001}


def test_readings_from_totals() -> None:
    def t(count: int, total: float, own: float) -> dict[str, float]:
        return {"count": count, "total_s": total, "self_s": own, "by": {}}

    setup = {"refiners.Program.first_call": t(2, 12.5, 0.5)}
    window = {
        "refiners.TextToImage.call": t(4, 8.0, 0.2),
        "refiners.TextToImage.encode": t(4, 0.12, 0.1),
        "refiners.TextToImage.to_images": t(4, 0.16, 0.16),
        "refiners.Program.key": t(8, 0.08, 0.08),
        "refiners.Program.copy_in": t(8, 0.004, 0.004),
        "refiners.Program.replay": t(8, 6.0, 6.0),
        "refiners.Program.clone": t(8, 0.016, 0.016),
    }
    got = spans.readings(setup, window, 4, None)
    assert got == {"program_key_ms": pytest.approx(20.0), "program_launch_ms": pytest.approx(1500.0),
                   "program_first_call_s": 12.5, "program_spans_ms": pytest.approx(1525.0),
                   "encode_ms": pytest.approx(25.0), "to_images_ms": pytest.approx(40.0)}  # fmt: skip
    train = {"refiners.Trainer.step": t(2, 0.4, 0.01), "refiners.Trainer.optimizer_step": t(2, 0.03, 0.02)}
    assert spans.readings({}, train, 2, None)["optimizer_ms"] == pytest.approx(10.0)
    assert spans.readings(setup, window, 0, None) == {}


@pytest.fixture(scope="module")
def checkout() -> Iterator[Path]:
    with tempfile.TemporaryDirectory() as tmp:
        yield tiny.copy_bench(Path(tmp))


@pytest.mark.parametrize("name", ["tiny-sd15-b1", "tiny-sd15-train"])
def test_a_traced_run_reads_the_spans(checkout: Path, name: str) -> None:
    from refiners_tpu_torch.fluxion import tracing

    out = spans.traced(tiny.cell(checkout, name), 2**40 + 3, 0.2, torch.device("cpu"), 0.0)
    json.dumps(out)
    assert not tracing._on
    serving = name != "tiny-sd15-train"
    root = "refiners.TextToImage.call" if serving else "refiners.Trainer.step"
    assert out["window_per_call"][root]["count"] == 1 and out["calls"] >= 1
    assert out["setup_spans"][root]["count"] >= 1
    assert set(out["readings"]) >= {"program_key_ms", "program_launch_ms", "program_first_call_s", "idle_unnamed_share"}
    assert ("encode_ms" in out["readings"]) == ("to_images_ms" in out["readings"]) == serving
    assert ("optimizer_ms" in out["readings"]) != serving
    assert out["readings"]["program_launch_ms"] == 0.0  # the CPU replays nothing
    assert out["idle_ms_per_item"] and out["annotations_ms_per_item"][root] > 0 and set(out["stretch"]) == {"window_s", "busy_s", "items", "gaps"}


def test_a_cost_run_turns_the_tracer_on_in_turns(checkout: Path) -> None:
    from refiners_tpu_torch.fluxion import tracing

    out = spans.cost(tiny.cell(checkout, "tiny-sd15-b1"), 2**40 + 4, 0.1, torch.device("cpu"), 4)
    assert [len(out["rates"][k]) for k in ("off", "on")] == [2, 2]
    rates = out["rates"]["off"] + out["rates"]["on"]
    assert max(rates) < 3 * min(rates)  # each window's own requests, not every window's so far
    assert not tracing._on and tracing.totals() == {}
