"""The harness on the CPU: the manifest's names resolve to files, a cell
added as files alone is picked up, the metric arithmetic on synthetic
events, the result's keys, the refusal without a card, and what the
benchmark may import.

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import ast
import json
import tempfile
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from h100_bench import bench, run, trace
from h100_bench.reference import flops
from h100_bench.tests import tiny

MANIFEST = bench.load_json(bench.ROOT / "BENCHMARK.json")
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.fixture(scope="module")
def checkout() -> Path:
    with tempfile.TemporaryDirectory() as tmp:
        yield tiny.copy_bench(Path(tmp))


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_every_name_resolves(name: str) -> None:
    cell = bench.Cell.load(name, MANIFEST)
    assert hasattr(cell.driver(), "Driver")
    for adapter, params in cell.adapters():
        assert callable(adapter.attach) and callable(adapter.reference_weights), params
    assert set(cell.workload["check"])
    assert "setup_s" in cell.metrics and any(m["kind"] == "per_layer" for m in cell.metrics.values())
    assert any(m["kind"] == "end_to_end" and n != "setup_s" for n, m in cell.metrics.items())
    for metric in cell.metrics:
        assert callable(cell.reader(metric).read)


def test_manifest_keeps_the_contract() -> None:
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    for c in MANIFEST["configs"]:
        cfg = bench.load_json(bench.ROOT / c["file"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_a_cell_added_as_files_is_picked_up(checkout: Path) -> None:
    """A new configuration, mix, cell and metric: files and manifest entries only."""
    manifest = bench.load_json(checkout.parent / "BENCHMARK.json")
    (checkout / "metrics" / "requests_seen.py").write_text("def read(run):\n    return float(run.calls)\n")
    manifest["per_layer"].append({"name": "requests_seen", "unit": "1", "better": "higher", "source": "host_clock",
                                  "layer": "device", "moves": "images_per_s", "workloads": ["tiny-sd15-b1"]})  # fmt: skip
    cell = bench.Cell.load("tiny-sd15-b1", manifest, bench=checkout)
    assert cell.cfg["unet"]["block_out_channels"] == [32, 64, 128, 128]
    assert cell.mix["size"] == [64, 64] and "requests_seen" in cell.metrics
    assert cell.reader("requests_seen").read(SimpleNamespace(calls=3)) == 3.0


def _event(name: str, start: int, duration: int, cpu: bool, annotation: bool = False) -> SimpleNamespace:
    from torch.autograd import DeviceType

    kind = DeviceType.CPU if cpu else DeviceType.CUDA
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: duration,
                           device_type=lambda: kind, is_user_annotation=lambda: annotation)  # fmt: skip


def test_idle_share_counts_the_whole_stretch() -> None:
    """Kernels busy 1-3 and 5-6 (ms) in a stretch 0-10 with a host wrapper
    over 4-10: busy 3 ms, idle 7 ms, gaps at both ends counted."""
    ms = 1_000_000
    events = [
        _event(trace.STRETCH, 0, 10 * ms, cpu=True, annotation=True),
        _event("tensor_to_images", 4 * ms, 6 * ms, cpu=True, annotation=True),
        _event("kernel_a", 1 * ms, 2 * ms, cpu=False),
        _event("kernel_a", 2 * ms, 1 * ms, cpu=False),  # overlapping: counted once in busy
        _event("flash_fwd_narrow_kernel<bf16>", 5 * ms, 1 * ms, cpu=False),
        _event("gpu_user_annotation", 0, 10 * ms, cpu=False, annotation=True),  # left out
    ]
    s = trace.reduce(events, items=2)
    assert s.window_s == pytest.approx(0.010) and s.busy_s == pytest.approx(0.003)
    assert s.kernels == {"kernel_a": pytest.approx(0.003), "flash_fwd_narrow_kernel<bf16>": pytest.approx(0.001)}
    assert [n for n, _ in s.gaps] == ["tensor_to_images", "outside the benchmark's wrappers", "outside the benchmark's wrappers"]
    assert [g for _, g in s.gaps] == pytest.approx([0.004, 0.002, 0.001])
    metrics = bench.BENCH / "metrics"
    run_ = SimpleNamespace(stretch=s)
    assert bench.load_module(metrics / "idle_share.serve.py").read(run_) == pytest.approx(70.0)
    assert bench.load_module(metrics / "device_ms_per_image.py").read(run_) == pytest.approx(2.0)


def test_attention_bound_and_mfu() -> None:
    """The kernel table's bound of K1 at (2, 4096, 4096, 10, 64): 0.0869 ms of operations."""
    assert flops.attention_bound_s([(2, 4096, 4096, 10, 64, 1)]) == pytest.approx(8.69e-5, rel=1e-3)
    cfg = bench.load_json(bench.BENCH / "configs" / "sdxl-base-1.0.json")
    assert flops.attention_sites(cfg, (1024, 1024), 2, True) == [
        (2, 4096, 4096, 10, 64, 10), (2, 1024, 1024, 20, 64, 60), (1, 16384, 16384, 1, 512, 1)]  # fmt: skip
    cell = bench.Cell.load("sdxl-1024-b1", MANIFEST)
    image = flops.image_flops(cell.cfg, (1024, 1024))
    assert 3.5e14 < image < 4.5e14
    run_ = SimpleNamespace(cell=cell, items=10, window_s=20.0)
    mfu = cell.reader("mfu.serve").read(run_)
    assert mfu == pytest.approx(100 * image * 0.5 / 989e12)
    kernel_s = 2 * flops.attention_bound_s(flops.attention_sites(cell.cfg, (1024, 1024), 2, False)) * 30
    stretch = SimpleNamespace(items=1, kernels={"void flash_fwd_narrow_kernel<64>": kernel_s, "gemm": 1.0})
    share = cell.reader("attention_roofline.serve").read(SimpleNamespace(cell=cell, stretch=stretch))
    decode = flops.attention_bound_s(flops.attention_sites(cell.cfg, (1024, 1024), 0, True)[-1:])
    assert share == pytest.approx(100 * (kernel_s / 2 + decode) / kernel_s)


def test_result_has_the_contracts_keys(checkout: Path) -> None:
    cell = tiny.cell(checkout, "tiny-sd15-b1")
    plain = bench.run_cell(cell, 2**40 + 1, 0.2, False, torch.device("cpu"), 0.0)
    assert set(plain) == CONTRACT_KEYS and list(plain)[-1] == "check"
    traced = bench.run_cell(cell, 2**40 + 2, 0.2, True, torch.device("cpu"), 0.0)
    assert set(traced) == CONTRACT_KEYS | {"breakdown"} and list(traced)[-1] == "check"
    assert set(traced["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(traced)


def test_run_refuses_without_a_card(capsys: pytest.CaptureFixture[str]) -> None:
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "sdxl-1024-b1", "--seed", str(2**33), "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_what_the_benchmark_imports() -> None:
    """Top-level module names compared whole: `refiners_tpu_torch` is the
    port, `refiners_tpu` the JAX package."""
    for path in bench.BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "refiners_tpu"}, path
    for path in (bench.BENCH / "reference").rglob("*.py"):
        assert "refiners_tpu_torch" not in _imports(path), path
    assert bench.forbidden_modules() == [] or "jax" in bench.forbidden_modules()
