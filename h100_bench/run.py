"""One run of one cell of the port's H100 benchmark.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m h100_bench.run ...``) from the root of a checkout. It
measures ``refiners_tpu_torch`` on one CUDA card and prints, as its last
line, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with the reference beside its limit, which the last lines
of standard error repeat. Without a card, or with fewer than the cell asks
for, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from h100_bench import bench

    cell = bench.Cell.load(args.workload, bench.load_json(ROOT / "BENCHMARK.json"))
    bench.pin_caches(ROOT)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"h100_bench: {cell.name} needs {cell.chips} CUDA card(s), this machine has {found}", file=sys.stderr)
        return 2
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"h100_bench: the process has loaded {', '.join(loaded)}; the benchmark measures the port alone",
              file=sys.stderr)  # fmt: skip
        return 3
    for name, number in result["check"].items():
        print(f"check {name} {number['value']!r} limit {number['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
