"""The harness: a cell found by name, run, reduced to metrics, judged.

Everything that belongs to one configuration, traffic mix, adapter or
metric sits in files of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the mix's parameters, naming its driver,
  ``traffic/<driver>.py``, which builds the system, runs the window and
  the profiled stretch, and compares what the window produced with the
  reference;
- ``workloads/<cell>.json``: the limits of the cell's comparison with the
  reference; a mix's adapters (``adapters/<kind>.py``) are named in its
  traffic file;
- ``metrics/<metric>.py``: a ``read(run)`` that reduces the run to the
  metric's value, or to None where it finds nothing to read.

A cell is added by adding such files and entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "refiners_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file `path` as a module (names may hold dots)."""
    name = f"h100_bench_file_{hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:16]}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One entry of ``workloads`` with everything its names point to."""

    name: str
    chips: int
    config_name: str
    cfg: dict[str, Any]
    mix: dict[str, Any]
    workload: dict[str, Any]
    metrics: dict[str, dict[str, Any]]  # every metric of the manifest that this cell reports, by name
    bench: Path = BENCH

    @classmethod
    def load(cls, name: str, manifest: dict[str, Any], bench: Path = BENCH) -> "Cell":
        entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
        cfg = load_json(bench.parent / config["file"])
        metrics = {m["name"]: {**m, "kind": kind} for kind in ("end_to_end", "per_layer") for m in manifest[kind]
                   if name in m.get("workloads", [name])}  # fmt: skip
        return cls(name=name, chips=entry["chips"], config_name=entry["config"], cfg=cfg,
                   mix=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
                   workload=load_json(bench / "workloads" / f"{name}.json"), metrics=metrics, bench=bench)  # fmt: skip

    def driver(self) -> ModuleType:
        return load_module(self.bench / "traffic" / f"{self.mix['driver']}.py")

    def adapters(self) -> list[tuple[ModuleType, dict[str, Any]]]:
        return [(load_module(self.bench / "adapters" / f"{a['kind']}.py"), a) for a in self.mix.get("adapters", [])]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench / "metrics" / f"{metric}.py")


@dataclass
class Run:
    """What a run measured, for the metrics' readers."""

    cell: Cell
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0  # from the window's start to the end of its last request or step
    items: int = 0  # images or samples completed in the window
    calls: int = 0  # requests or steps in the window
    latencies: list[float] = field(default_factory=list)  # seconds, one per request
    peak_bytes: int = 0
    program_host_s: float = 0.0  # host seconds inside `Program.__call__` over the window (traced runs)
    pool_bytes: int = 0
    stretch: Any = None  # `trace.Stretch` of the traced run
    attempted: int = 0
    failed: int = 0
    notes: list[str] = field(default_factory=list)  # printed before the result's line


def pin_caches(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> list[str]:
    """The modules of `FORBIDDEN` this process has loaded (top-level names compared whole)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def reserved_peak(device: Any) -> int:
    import torch

    return torch.cuda.max_memory_reserved(device) if torch.device(device).type == "cuda" else 0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: Any, t0: float) -> dict[str, Any]:
    """Set up, measure for `seconds`, profile (`trace`), compare: the result's object."""
    import torch

    from h100_bench import trace as tracing

    run = Run(cell=cell, seed=seed)
    driver = cell.driver().Driver(cell, seed, torch.device(device))
    driver.setup()
    run.setup_s = time.perf_counter() - t0
    driver.window(run, seconds)
    run.peak_bytes = reserved_peak(device)
    run.notes.append(f"clocks after the window: {clocks(device)}")
    if run.latencies:
        ordered = sorted(run.latencies)
        run.notes.append(f"latency: median {ordered[len(ordered) // 2]!r} s, max {ordered[-1]!r} s, {len(ordered)} requests")
    if trace:
        run.stretch = tracing.profile(driver.stretch, device)
        run.notes.append(f"device ms by kind per item: {run.stretch.by_kind()}")
    run.pool_bytes = driver.pool_bytes()
    driver.free()
    numbers = driver.check()
    limits = cell.workload["check"]
    correct = run.failed == 0 and all(numbers[k] <= limits[k] for k in limits)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, m in cell.metrics.items():
        if m["kind"] != kind:
            continue
        value = cell.reader(name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    out: dict[str, Any] = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
                           "device": device_record(device, run)}  # fmt: skip
    if trace and run.stretch is not None:
        out["breakdown"] = run.stretch.breakdown()
    out["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for note in run.notes:
        print(f"h100_bench: {note}", flush=True)
    return out


def clocks(device: Any) -> str:
    """The card's SM clock, power draw and limit and temperature (``nvidia-smi``)."""
    import subprocess

    import torch

    if torch.device(device).type != "cuda":
        return "no card"
    query = "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        done = subprocess.run(["nvidia-smi", query, "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as error:
        return f"nvidia-smi failed: {error}"
    return done.stdout.strip()


def device_record(device: Any, run: Run) -> dict[str, Any]:
    import torch

    dev = torch.device(device)
    record: dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": run.peak_bytes,
    }
    if run.stretch is not None:
        record["busy_s"] = run.stretch.busy_s
        record["window_s"] = run.stretch.window_s
    return record
