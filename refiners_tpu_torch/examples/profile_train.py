"""Profile the port's SD1.5 training slice and its kernel build on one NVIDIA card.

    python -m refiners_tpu_torch.examples.profile_train

Three measurements, each printed:

1. build: every ``refiners_tpu_torch/csrc/*.cu`` compiled by ``nvcc``
   one after the other, then all at once as ``ops.build`` does, into
   ``build/refiners_tpu_torch/timing/``; wall seconds of each;
2. first optimizer step: the bf16 Trainer of ``examples.train_unet``
   (full-width `SD1UNet`, batch 2 of 64×64 latents, accumulation 2, AdamW)
   runs one accumulation step, then its first optimizer step under
   ``cProfile``: the Python functions and operators its host time goes to.
   Beside it, the seconds a fresh interpreter takes to import ``torch`` and
   then ``torch._dynamo``;
3. warm steps: two steps (one accumulation, one optimizer step) without a
   profiler, then the same two under ``torch.profiler``: device time by
   kernel kind, and the share of the traced window in which no kernel ran.
"""

from __future__ import annotations

import cProfile
import io
import pstats
import subprocess
import sys
import time
from typing import Any

import torch

CONFIG = """
[training]
duration = "6:step"
gradient_accumulation = "2:step"
dtype = "bfloat16"
device = "cuda"

[optimizer]
optimizer = "AdamW"
learning_rate = 1e-3

[lr_scheduler]
type = "ConstantLR"

[unet]
requires_grad = true
"""

# kernel-name fragments → kind, first match wins
KINDS = [
    ("attention (flash kernels)", ("flash_",)),
    ("fused GroupNorm+SiLU (K5a, K5b)", ("gn_stats_kernel", "gn_apply_kernel")),
    ("int8 quantization (K6 and its row mode)", ("quantize_rows_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "nchwToNhwc", "nhwcToNchw")),
    ("optimizer and other foreach", ("multi_tensor_apply", "foreach")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("softmax", ("softmax",)),
    ("norm statistics and reductions", ("reduce", "welford", "norm")),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
    # PyTorch's arithmetic on operands of one dtype runs as `gpu_kernel_impl_nocast`,
    # whose name holds "cast": matched before the casts
    ("elementwise arithmetic (no cast)", ("_nocast",)),
    ("copies and casts", ("cast",)),
]


def profile_build() -> None:
    from refiners_tpu_torch.ops import build

    out_dir = build.BUILD_DIR / "timing"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()

    def cmd(src: Any, tag: str) -> list[str]:
        return [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"{tag}_{src.stem}.so"), str(src)]

    sources = build._sources()
    start = time.perf_counter()
    for src in sources:
        subprocess.run(cmd(src, "serial"), check=True, capture_output=True)
    serial = time.perf_counter() - start
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd(src, "parallel"), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for src in sources]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("nvcc failed")
    parallel = time.perf_counter() - start
    names = ", ".join(s.name for s in sources)
    print(f"build: {names}: one after the other {serial:.1f} s, all at once {parallel:.1f} s")


def import_seconds() -> str:
    code = (
        "import time; t = time.perf_counter(); import torch; a = time.perf_counter() - t; "
        "t = time.perf_counter(); import torch._dynamo; b = time.perf_counter() - t; "
        "print(f'import torch {a:.2f} s, then import torch._dynamo {b:.2f} s')"
    )
    return subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, text=True).stdout.strip()


def _kind(name: str) -> str:
    for kind, fragments in KINDS:
        if any(f in name for f in fragments):
            return kind
    return "elementwise and other"


def device_breakdown(
    prof: torch.profiler.profile, wall: float, label: str = "warm steps", unit: str = "two steps", top: int = 0
) -> dict[str, Any]:
    """Device time by kernel kind of a traced run (and its `top` kernels by
    name), and its idle share; `wall` is the host-clock seconds of the same
    work unprofiled. Printed, and returned: summed device milliseconds, by
    kind, the kernels by name, and the idle share of the traced window."""
    from torch.autograd import DeviceType

    # kernels only: a range of `record_function` (the optimizer's step) also shows on the device as a user
    # annotation spanning its kernels, which would count them twice and fill the gaps between them
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    by_kind: dict[str, list[float]] = {}
    for e in kernels:
        entry = by_kind.setdefault(_kind(e.name), [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3
        entry[1] += 1
    total = sum(v[0] for v in by_kind.values())
    print(f"{label} under torch.profiler: {len(kernels)} device events, {total:.1f} ms of summed device time")
    for kind, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind}: {ms:.1f} ms ({n} launches)")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3
        entry[1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:.2f} ms ({n}) {name[:160]}")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    window = spans[-1][1] - spans[0][0]
    print(
        f"  traced window {window / 1e3:.1f} ms from the first kernel's start to the last one's end, device busy "
        f"{busy / 1e3:.1f} ms, idle share {1 - busy / window:.3f}; the same {unit} unprofiled: {wall * 1e3:.1f} ms"
    )
    return {"device_ms": total, "by_kind_ms": {k: v[0] for k, v in by_kind.items()},
            "by_name_launches": {k: v[1] for k, v in by_name.items()}, "idle_share": 1 - busy / window}  # fmt: skip


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device; this script runs only on an NVIDIA card")
    from refiners_tpu_torch.examples.train_unet import UnetConfig, UnetTrainer

    profile_build()
    print(f"fresh interpreter: {import_seconds()}")
    dev = torch.device("cuda", 0)
    phases: dict[int, Any] = {}

    class ProfiledTrainer(UnetTrainer):
        def step(self, batch: dict[str, torch.Tensor]) -> None:
            i = self.clock.step
            torch.cuda.synchronize()
            start = time.perf_counter()
            if i == 1:
                dynamo_before = "torch._dynamo" in sys.modules
                profiler = cProfile.Profile()
                profiler.runcall(super().step, batch)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - start
                text = io.StringIO()
                pstats.Stats(profiler, stream=text).sort_stats("cumulative").print_stats(30)
                print(f"first optimizer step: {seconds:.3f} s (torch._dynamo imported before it: {dynamo_before})")
                print(text.getvalue())
                text = io.StringIO()
                pstats.Stats(profiler, stream=text).sort_stats("tottime").print_stats(15)
                print(text.getvalue())
                return
            if i in (4, 5):
                if i == 4:
                    phases["prof"] = torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                    )
                    phases["prof"].__enter__()
                super().step(batch)
                if i == 5:
                    torch.cuda.synchronize()
                    phases["prof"].__exit__(None, None, None)
                return
            super().step(batch)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            phases[i] = seconds
            print(f"step {i}: {seconds:.3f} s, optimizer step {self.clock.num_minibatches_processed == 0}")

    trainer = ProfiledTrainer(UnetConfig.load_from_toml_string(CONFIG), batch_size=2, latent_size=64, num_batches=6)
    trainer.train()
    device_breakdown(phases["prof"], phases[2] + phases[3])
    print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
