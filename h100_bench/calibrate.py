"""Readings for a cell's comparison limits, on the card, in one process.

    python3 h100_bench/calibrate.py --workload <cell> --seeds <n> ... [--requests N]

For each seed it prints one JSON line: the program's gaps from the
float32 reference, and the control's, the reference computed with every
product's inputs rounded to float8 e4m3 in the program's place. A serving
cell draws each seed's weights into the model loaded for the first seed
(so that its programs replay) and serves `N` requests through the timed
path; a training cell builds a trainer per seed and reads its first steps,
and also reads the half-batch fault. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=1)
    p.add_argument("--control-seeds", type=int, default=None, help="read the control on the first N seeds (default: all)")
    p.add_argument("--decode-only", action="store_true", help="serving: compare the decode stage alone")
    args = p.parse_args()

    import torch

    from h100_bench import bench

    bench.pin_caches(ROOT)
    cell = bench.Cell.load(args.workload, bench.load_json(ROOT / "BENCHMARK.json"))
    device = torch.device("cuda", 0)
    control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    if cell.mix["driver"] == "train_steps":
        train(cell, args.seeds, device, control)
    else:
        serve(cell, args.seeds, args.requests, device, control, not args.decode_only)


def serve(cell: Any, seeds: list[int], requests: int, device: Any, control: int, pipeline: bool) -> None:
    import numpy as np
    import torch

    gaps = cell.driver().gaps
    driver = None
    for n, seed in enumerate(seeds):
        start = time.perf_counter()
        if driver is None:
            driver = cell.driver().Driver(cell, seed, device)
            driver.setup()
        else:
            driver.reseed(seed)
        driver.requests.clear(), driver.images.clear(), driver.latents.clear()
        for _ in range(requests):
            request = driver.next_request()
            driver.images.append(np.asarray(driver.serve(*request)))
            driver.requests.append(request)
        driver.window_latents = driver.latents[:]
        indices = list(range(requests))
        served = [{"latents": z, "decoded": image} for z, image in zip(driver.window_latents, driver.images)]
        line = {"seed": seed, "program_s": time.perf_counter() - start}
        start = time.perf_counter()
        reference = driver.reference(indices, pipeline=pipeline)
        line["reference_s"] = time.perf_counter() - start
        line["program"] = gaps(served, reference, device)
        if n < control:
            start = time.perf_counter()
            line["control"] = gaps(driver.reference(indices, fp8=True, pipeline=pipeline), reference, device)
            line["control_s"] = time.perf_counter() - start
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)


def train(cell: Any, seeds: list[int], device: Any, control: int) -> None:
    """Per seed a new trainer through the first steps; the reference, the
    control and the half-batch fault (planted in the reference, put in the
    program's place) follow the same steps."""
    module = cell.driver()
    for n, seed in enumerate(seeds):
        start = time.perf_counter()
        driver = module.Driver(cell, seed, device)
        driver.setup()
        line = {"seed": seed, "setup_s": time.perf_counter() - start}
        driver.free()
        start = time.perf_counter()
        reference = driver.reference()
        line["reference_s"] = time.perf_counter() - start
        line["program"] = module.gaps(driver.readings, reference)
        if n < control:
            line["control"] = module.gaps(driver.reference(fp8=True), reference)
            line["half_batch"] = module.gaps(driver.reference(rows=slice(0, cell.mix["batch_size"] // 2)), reference)
        line["losses"] = {"program": driver.readings["losses"], "reference": reference["losses"]}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
