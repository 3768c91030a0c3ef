"""Readings that set a cell's correctness limits, on a CUDA device at the cell's
own size:

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 [--seconds 3]

For each seed, one JSON line with the numbers the cell's check compares for
``program``, the program's own run (set-up, a short window of the cell's
load, the check), and for what the driver's ``calibrate()`` puts in the
program's place: ``control``, the reference one precision below the
configuration's, and ``fault_*``, the faults the cell can have.  The
benchmark's own runs never run this.  It needs one CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import torch  # noqa: E402

import cell  # noqa: E402
from drivers import common  # noqa: E402

NO_LIMITS = collections.defaultdict(lambda: float("inf"))


def program(drv, seconds: float) -> dict:
    drv.warmup()
    common.sync(drv.dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        drv.unit(None)
    drv.drain()
    common.sync(drv.dev)
    drv.release()
    return {k: v["value"] for k, v in drv.check(NO_LIMITS).items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cell.benchmark()
    w = cell.workload(bench, args.workload)
    cfg, mix = cell.config(bench, w["config"]), cell.mix(w["traffic"])
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = cell.driver(mix["driver"]).Driver(cfg, mix, seed, dev)
        out = {"program": program(drv, args.seconds), **drv.calibrate()}
        del drv
        torch.cuda.empty_cache()
        print(json.dumps({"workload": w["name"], "seed": seed, **out,
                          "seconds": time.perf_counter() - t0,
                          "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
