"""A copy of the benchmark with tiny cells, for tests on the CPU: the
published topologies at reduced widths and depths (SD1.5: 32-channel
U-Net; SDXL: 64-channel; text encoders of 3 layers), 64x64 images,
3 DDIM steps, float32."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import Any

from h100_bench import bench

TINY = {
    "tiny-sd15": ("sd15", {"block_out_channels": [32, 64, 128, 128]}),
    "tiny-sdxl": ("sdxl-base-1.0", {"block_out_channels": [64, 128, 256], "attention_head_dim": [1, 2, 4]}),
}


def tiny_config(name: str, dtype: str = "float32") -> dict[str, Any]:
    base, unet = TINY[name]
    cfg = copy.deepcopy(bench.load_json(bench.BENCH / "configs" / f"{base}.json"))
    cfg["unet"].update(unet)
    for encoder in ("text_encoder", "text_encoder_2"):
        if encoder in cfg:
            cfg[encoder]["num_hidden_layers"] = 3
    cfg["solver"]["num_inference_steps"] = 3
    cfg["dtype"] = dtype
    cfg["reduced"] = ["unet", "text_encoder", "text_encoder_2", "solver"]
    return cfg


def copy_bench(tmp: Path) -> Path:
    """The benchmark's folder and manifest copied under `tmp`, with a tiny
    configuration, mix and cell per family; returns the copy's folder."""
    root = tmp / "checkout"
    shutil.copytree(bench.BENCH, root / "h100_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = bench.load_json(bench.ROOT / "BENCHMARK.json")
    for name in TINY:
        (root / "h100_bench" / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name)))
        manifest["configs"].append({"name": name, "source": "test", "file": f"h100_bench/configs/{name}.json",
                                    "reduced": [], "why": "test"})  # fmt: skip
        mix = {"driver": "serve_closed", "size": [64, 64], "num_images": 1, "prompts": "prompts.txt",
               "adapters": [], "warmup_requests": 1, "profiled_requests": 1, "checked_requests": 1}  # fmt: skip
        (root / "h100_bench" / "traffic" / f"{name}-closed.json").write_text(json.dumps(mix))
        (root / "h100_bench" / "workloads" / f"{name}-b1.json").write_text(
            json.dumps({"check": {"latent_rel": 1e-3, "decode_rms": 0.01}})
        )
        manifest["workloads"].append({"name": f"{name}-b1", "config": name, "traffic": f"{name}-closed", "chips": 1,
                                      "why": "test"})  # fmt: skip
    lora = {**mix, "adapters": [{"kind": "lora", "name": "a", "rank": 4, "scale": 1.0},
                                {"kind": "lora", "name": "b", "rank": 4, "scale": 0.5}]}  # fmt: skip
    (root / "h100_bench" / "traffic" / "tiny-sdxl-closed-lora2.json").write_text(json.dumps(lora))
    (root / "h100_bench" / "workloads" / "tiny-sdxl-lora2.json").write_text(
        json.dumps({"check": {"latent_rel": 1e-3, "decode_rms": 0.01}})
    )
    manifest["workloads"].append({"name": "tiny-sdxl-lora2", "config": "tiny-sdxl", "traffic": "tiny-sdxl-closed-lora2",
                                  "chips": 1, "why": "test"})  # fmt: skip
    train = {**bench.load_json(bench.BENCH / "traffic" / "finetune-512-b8.json"), "size": [64, 64], "batch_size": 4}
    (root / "h100_bench" / "traffic" / "tiny-finetune.json").write_text(json.dumps(train))
    (root / "h100_bench" / "workloads" / "tiny-sd15-train.json").write_text(
        json.dumps({"check": {"grad_gap": 1e-3, "change_gap": 1e-3}})
    )
    manifest["workloads"].append({"name": "tiny-sd15-train", "config": "tiny-sd15", "traffic": "tiny-finetune", "chips": 1,
                                  "why": "test"})  # fmt: skip
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root / "h100_bench"


def cell(bench_dir: Path, name: str) -> bench.Cell:
    return bench.Cell.load(name, bench.load_json(bench_dir.parent / "BENCHMARK.json"), bench=bench_dir)
