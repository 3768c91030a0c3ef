"""Finding a cell's parts by name: the workload in ``BENCHMARK.json``, its
configuration file, its traffic mix, the driver the mix names, the limits
of its correctness check, and the reader of each per-layer metric.  A later
cell, mix, driver or metric is a new file and a new entry; nothing here
changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return json.loads((BENCH / "mixes" / f"{name}.json").read_text())


def limits(workload_name: str) -> dict:
    return json.loads((BENCH / "limits" / f"{workload_name}.json").read_text())


def driver(name: str):
    """The driver module ``drivers/<name>.py``."""
    return importlib.import_module(f"drivers.{name}")


def metric_reader(name: str):
    """``read(run)`` of ``layer_metrics/<name>.py``, or, where there is none,
    of the reader named by the part of ``name`` before its first dot (one
    ``mfu.py`` reads ``mfu.serve`` and ``mfu.tdm_train`` alike)."""
    folder = BENCH / "layer_metrics"
    path = folder / f"{name}.py"
    if not path.exists():
        path = folder / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"layer_metrics.{path.stem}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}: {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def end_to_end(bench: dict, w: dict) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or w["name"] in m["workloads"]]


def per_layer(bench: dict, w: dict) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, w)}
    return [m for m in bench["per_layer"]
            if (w["name"] in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
