"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration file,
traffic mix, driver (named by the mix), check limits and per-layer readers
are files under ``benchmark/``.  A run sets up the driver (the program's
objects, inputs made on the card from the seed, and, for training, the
first steps that the check follows), warms up, and measures for
``--seconds``.  ``--trace 0`` reports the cell's end-to-end metrics; with
``--trace 1`` the window records host spans, and a short stretch after it
runs under ``torch.profiler`` for the trace's metrics.  Then the program's
state is freed and the plain reference judges what the timed path produced.
The last line of standard output is one JSON object; the numbers compared
and their limits close standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BUILD = ROOT / "build" / "bench"
# every build and kernel cache of the run stays at a fixed path in the
# checkout (the port's own nvcc and g++ outputs go to build/kernels and
# build/host beside it)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(BUILD / "cache" / sub)
# one process with few threads: the host paces every cell, so the host's
# own thread pools stay out of the main thread's way
os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path[:0] = [str(ROOT), str(BENCH)]

import cell  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "dismember_tpu"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``dismember_tpu_torch`` is neither)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def window(drv, seconds: float, spans: dict | None) -> dict:
    """Closed loop: units of the driver's work until ``seconds`` have passed;
    the rate is over all the work and all the time, the last unit's end
    included."""
    from drivers.common import sync

    sync(drv.dev)
    t0 = time.perf_counter()
    units = work = 0
    while True:
        work += drv.unit(spans)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    drv.drain()
    sync(drv.dev)
    return {"seconds": time.perf_counter() - t0, "units": units, "work": work}


def main(args) -> int:
    bench = cell.benchmark()
    w = cell.workload(bench, args.workload)
    cfg = cell.config(bench, w["config"])
    mix = cell.mix(w["traffic"])
    cell.driver(mix["driver"])  # a missing part fails before the card is touched

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"run: the cell needs {w['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = measure(bench, w, cfg, mix, cell.limits(w["name"]), args,
                             torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"run: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


def measure(bench: dict, w: dict, cfg: dict, mix: dict, limits: dict, args, dev) -> tuple:
    """Set up, warm up, measure and check one run of cell ``w`` on ``dev``;
    returns (the result object, the checks)."""
    import torch

    from drivers.common import sync

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    drv = cell.driver(mix["driver"]).Driver(cfg, mix, args.seed, dev)
    drv.warmup()
    sync(dev)
    setup_s = time.perf_counter() - T_START

    # the set-up's objects (traffic pools, recorded steps) out of the
    # collector's way, so that its pauses in the window are the program's
    gc.collect()
    gc.freeze()
    spans: dict | None = {} if args.trace else None
    win = window(drv, args.seconds, spans)
    metrics: dict = {}
    extra: dict = {}
    if args.trace:
        from devtrace import profiled, read

        drv.layer_stretch(spans)
        out = BUILD / "traces" / f"{w['name']}.json"
        with profiled(out, cuda):
            units = drv.profile_stretch()
        tr = read(out, units)
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        record = {"cell": w, "config": cfg, "mix": mix, "window": win, "spans": spans,
                  "trace": tr, "bounds": drv.kernel_bounds(), "flops": drv.model_flops(win),
                  "peak_flops": drv.PEAK_FLOPS}
        for m in cell.per_layer(bench, w):
            value = cell.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    else:
        for m in cell.end_to_end(bench, w):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == drv.METRIC:
                metrics[m["name"]] = {"value": win["work"] / win["seconds"], "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": w["chips"],
              "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0, **extra}

    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    try:
        checks = drv.check(limits)
    except Exception:  # a check that cannot finish judges the run incorrect
        traceback.print_exc()
        checks = {"check_ran": {"value": 1, "limit": 0}}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": win["work"], "failed": 0, "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks


if __name__ == "__main__":
    sys.exit(main(parse_args()))
