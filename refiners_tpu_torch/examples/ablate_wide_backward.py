"""Time variants of the wide flash backward on one NVIDIA card: what holds it.

    python -m refiners_tpu_torch.examples.ablate_wide_backward [--rounds N]

Each variant is a copy of the package under ``build/ablate/<name>/`` whose
``csrc/flash_attention_backward.cu`` has one phase of the wide kernel's tile
loop (`wide_block`) removed or moved. All but "shipped" and "early_refill"
compute wrong gradients: they only time. The variants are built side by
side, then each is timed in turn, every round, in a process of its own: K4a
(the dK/dV entry) and K4b (the dQ entry) at the SD1.5 VAE decoder's
mid-block, (2, 1, 4096, 512) in bf16, as device time of 20 calls queued
behind a stream sleep (median of 3). One JSON line a round; the card's name
and power limit head the output.

- shipped: the kernel as it is;
- no_exchange: the partials of S and dP are not written or read (the
  barriers stay);
- no_gradient: no gradient product (dQ += dS K, dK += dS^T Q, dV += P^T dO);
- one_kstep: S and dP over one 16-column step of each half of d, not all;
- no_loads: no streamed tile is loaded after the first (every tile reuses
  it);
- early_refill: dP committed as a group of its own and the early tile
  refilled as soon as it lands (a warpgroup barrier more a tile).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent / "build" / "ablate"
SOURCE = "csrc/flash_attention_backward.cu"

_EXCHANGE_WRITE = """      #pragma unroll
      for (int i = 0; i < kF4; ++i) {
        mine[i * kWarpgroup] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      }
      if constexpr (kDp) {
        #pragma unroll
        for (int i = 0; i < kF4; ++i) {
          mine[(kF4 + i) * kWarpgroup] = make_float4(dp[4 * i], dp[4 * i + 1], dp[4 * i + 2], dp[4 * i + 3]);
        }
      }
"""
_EXCHANGE_READ = """      #pragma unroll
      for (int i = 0; i < kF4; ++i) {
        const float4 x = theirs[i * kWarpgroup];
        s[4 * i] += x.x;
        s[4 * i + 1] += x.y;
        s[4 * i + 2] += x.z;
        s[4 * i + 3] += x.w;
      }
      if constexpr (kDp) {
        #pragma unroll
        for (int i = 0; i < kF4; ++i) {
          const float4 x = theirs[(kF4 + i) * kWarpgroup];
          dp[4 * i] += x.x;
          dp[4 * i + 1] += x.y;
          dp[4 * i + 2] += x.z;
          dp[4 * i + 3] += x.w;
        }
      }
"""
_PRODUCTS = """      if constexpr (kDp) {
        issue_ss(dp, sown2, searly);  // dP = dO V^T (dQ), dP^T = V dO^T (dK)
        hopper::mbar_wait(late_bar, parity);
        issue_ss(s, sown1, slate);  // S = Q K^T (dQ), S^T = K Q^T (dK)
      } else {
        issue_ss(s, sown1, searly);  // S^T = K Q^T
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
"""
_EARLY_REFILL = "      if (tid == 0 && more) load_early(j + 1);  // the products that read our early half have landed\n"

# variant -> (old, new) edits of the source, each of which must match once
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "shipped": [],
    "no_exchange": [(_EXCHANGE_WRITE, ""), (_EXCHANGE_READ, "")],
    "no_gradient": [("for (int kc = 0; kc < R / 16; ++kc) {\n        hopper::wgmma_rs", "for (int kc = 0; kc < 0; ++kc) {\n        hopper::wgmma_rs")],
    "one_kstep": [("for (int kk = 0; kk < DH / 16; ++kk) {", "for (int kk = 0; kk < 1; ++kk) {")],
    "no_loads": [
        (_EARLY_REFILL, ""),
        ("        if (warp == 0) load_late(j + 1);\n", ""),
        ("      hopper::mbar_wait(early_bar, parity);\n", "      if (j == 0) hopper::mbar_wait(early_bar, parity);\n"),
        ("        hopper::mbar_wait(late_bar, parity);\n        issue_ss(s,", "        if (j == 0) hopper::mbar_wait(late_bar, parity);\n        issue_ss(s,"),
        ("      if constexpr (!kDp) hopper::mbar_wait(late_bar, parity);", "      if (!kDp && j == 0) hopper::mbar_wait(late_bar, parity);"),
    ],
    "early_refill": [
        (_PRODUCTS, _PRODUCTS.replace("  // dP = dO V^T (dQ), dP^T = V dO^T (dK)\n", "  // dP = dO V^T (dQ), dP^T = V dO^T (dK)\n        hopper::wgmma_commit();\n").replace(
            "      hopper::wgmma_commit();\n      hopper::wgmma_wait<0>();\n",
            "      hopper::wgmma_commit();\n      if constexpr (kDp) {\n        hopper::wgmma_wait<1>();  // dP has landed: our early half is free\n"
            "        hopper::bar_sync(6 + g, kWarpgroup);\n        if (tid == 0 && more) load_early(j + 1);\n        __syncwarp();\n      }\n"
            "      hopper::wgmma_wait<0>();\n")),
        (_EARLY_REFILL, _EARLY_REFILL.replace("if (tid == 0 && more)", "if (!kDp && tid == 0 && more)")),
    ],
}

TIMING = """
import json, math, statistics, sys, torch
from refiners_tpu_torch.ops import flash_attention as fa
dev = torch.device("cuda", 0)
gen = torch.Generator(dev).manual_seed(0)
q, k, v, do = (torch.randn((2, 1, 4096, 512), generator=gen, device=dev).bfloat16() for _ in range(4))
scale = 1.0 / math.sqrt(512)
out, lse = fa.flash_attention_forward(q, k, v, with_lse=True)
delta = (do.float() * out.float()).sum(-1)
def queued(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
calls = {"K4a": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, False, scale),
         "K4b": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, False, scale)}
print(json.dumps({name: statistics.median(queued(fn) for _ in range(3)) for name, fn in calls.items()}))
"""


def make_variant(name: str, edits: list[tuple[str, str]]) -> Path:
    """A copy of the package with `edits` applied to the backward source."""
    root = ROOT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
    path = root / PACKAGE.name / SOURCE
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: an edit matches {text.count(old)} times, not once: {old[:80]!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def _run(root: Path, code: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(root)}
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env, stdout=subprocess.PIPE, text=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ablate_wide_backward: no CUDA device; this script runs only on an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )  # fmt: skip
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}")
    roots = {name: make_variant(name, edits) for name, edits in VARIANTS.items()}
    builds = {name: _run(root, "from refiners_tpu_torch.ops import build; build.build_libraries()") for name, root in roots.items()}
    for name, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"ablate_wide_backward: variant {name} did not build")
    for r in range(args.rounds):
        times = {}
        for name, root in roots.items():
            proc = _run(root, TIMING)
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"ablate_wide_backward: variant {name} failed to run")
            times[name] = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"round": r, "shape": [2, 1, 4096, 512], "queued_ms": times}))


if __name__ == "__main__":
    main()
