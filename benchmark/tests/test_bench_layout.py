"""The benchmark's layout: what it imports, that every part of a cell is
found by name, that a new per-layer metric needs no edit of a file, and the
frozen counts against hand counts."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import cell
import flops
from conftest import with_held
import run

BENCH = Path(cell.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dismember_tpu"}
PROGRAM = "dismember_tpu_torch"


def imported_tops(path: Path) -> set[str]:
    """Top-level names of every module a file imports (absolute imports)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        bad = imported_tops(f) & FORBIDDEN
        assert not bad, f"{f.relative_to(BENCH)} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert PROGRAM not in imported_tops(f), f"{f.relative_to(BENCH)} imports the program"


@pytest.mark.parametrize("name, forbidden", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True),
    ("dismember_tpu", True), ("dismember_tpu.train.tdm", True),
    ("dismember_tpu_torch", False), ("dismember_tpu_torch.ops._cuda", False),
    ("jaxtyping", False)])
def test_loaded_module_check_compares_whole_top_level_names(monkeypatch, name, forbidden):
    monkeypatch.setitem(sys.modules, name, sys)
    assert (name in run.forbidden_modules()) == forbidden


@pytest.mark.parametrize("name", [w["name"] for w in with_held()["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(name):
    bench = with_held()
    w = cell.workload(bench, name)
    cfg = cell.config(bench, w["config"])
    mix = cell.mix(w["traffic"])
    drv = cell.driver(mix["driver"]).Driver
    assert callable(drv.check) and callable(drv.calibrate)
    limits = cell.limits(name)
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    assert cfg["name"] == w["config"]
    e2e = {m["name"] for m in cell.end_to_end(bench, w)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell.per_layer(bench, w)
    assert layer
    for m in layer:
        assert callable(cell.metric_reader(m["name"]))
        assert m["moves"] in e2e


def test_benchmark_json_keeps_to_its_limits():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert (BENCH.parent / c["file"]).exists() and len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    layers = {m["layer"] for m in bench["per_layer"]}
    perf = (BENCH.parent / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, f"layer {layer!r} is not in PERF.md's list"


def test_a_new_metric_is_a_new_file_and_a_new_entry(tmp_path):
    """A copy of the benchmark with a dummy per-layer metric added as a file
    and an entry reads it in its cell, no existing file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    w = bench["workloads"][0]["name"]
    bench["per_layer"].append({"name": "dummy.units", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "setup_s", "workloads": [w]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "layer_metrics" / "dummy.units.py").write_text(
        "def read(run):\n    return float(run['window']['units'])\n")
    code = (
        "import cell\n"
        "b = cell.benchmark(); w = cell.workload(b, %r)\n"
        "names = [m['name'] for m in cell.per_layer(b, w)]\n"
        "assert 'dummy.units' in names, names\n"
        "print(cell.metric_reader('dummy.units')({'window': {'units': 7}}))\n" % w)
    out = subprocess.run([sys.executable, "-c", code], cwd=root / "benchmark",
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7.0"


def test_a_metric_split_by_cell_is_read_by_its_stem():
    """``mfu.<cell>`` of a later cell needs no reader of its own."""
    stem = cell.metric_reader("mfu")
    split = cell.metric_reader("mfu.a_later_cell")
    run = {"window": {"seconds": 2.0}, "flops": 3.0, "peak_flops": 100.0}
    assert split(run) == stem(run) == 1.5
    with pytest.raises(FileNotFoundError):
        cell.metric_reader("no_such_metric.serve")


@pytest.mark.parametrize("n, l, e", [(3, 2, 4), (5, 10, 16)])
def test_din_operations_are_the_hand_count(n, l, e):
    mm = n * (2 * l * e + 2 * l * e + 2 * e * e + 2 * (2 * e) * e + 2 * e)
    rest = n * (l + 4 * l + 2 * e + 1)
    assert flops.din_flops(n, l, e) == (mm, rest)
    assert flops.din_model_flops(n, l, e) == mm + rest


@pytest.mark.parametrize("b, u, l, e", [(2, 3, 4, 8), (4096, 40, 10, 16)])
def test_k1_counts_are_the_hand_count(b, u, l, e):
    (fold_mm, rest), (unfold_mm, rest2) = flops.k1_flops(b, u, l, e)
    assert rest == rest2 == b * u * (2 * l + 4 * l + 6 * e + 1)
    assert unfold_mm == 2 * e**3 + b * u * (2 * l * e + 2 * l * e + 2 * 2 * e * e)
    assert fold_mm == 2 * e**3 + b * 2 * l * e * e + b * u * (2 * l * e + 2 * l * e + 2 * e * e)
    weights = e * e + e * 2 * e + e + e + 1
    assert flops.k1_bytes(b, u, l, e) == 4 * (b * u * e + b * l * e + b * l + weights + b * u)
    t, by = flops.k1_bound(b, u, l, e)
    assert t == pytest.approx(max(flops.k1_bytes(b, u, l, e) / flops.HBM_BYTES_PER_S, min(
        fold_mm / flops.TF32X3_FLOP_PER_S + rest / flops.F32_FLOP_PER_S,
        unfold_mm / flops.TF32X3_FLOP_PER_S + rest / flops.F32_FLOP_PER_S)))


@pytest.mark.parametrize("b, beam, l, e, row", [(2, 3, 4, 8, 4), (8192, 20, 10, 16, 4),
                                                 (16, 5, 10, 16, 2)])
def test_k3_bytes_are_the_hand_count(b, beam, l, e, row):
    digits = 2 if row == 4 else 4
    lanes = 2 * e + 2 + 2 * digits  # both children, two exists flags, both ids
    hand = (row * (b * beam * lanes + b * 2 * beam * digits)
            + 4 * (b * beam + b * l * e + b * l + e * e + 2 * e * e + e + e + 1 + b * 2 * beam))
    assert flops.k3_bytes(b, beam, l, e, row) == hand
    mm, rest = flops.din_flops(b * 2 * beam, l, e)
    t, _ = flops.k3_bound(b, beam, l, e, row)
    assert t == pytest.approx(max(hand / flops.HBM_BYTES_PER_S,
                                  mm / flops.BF16_MMA_FLOP_PER_S + rest / flops.F32_FLOP_PER_S))


@pytest.mark.parametrize("n_idx, written, width, add", [(10, 4, 8, False), (8115, 7000, 128, False),
                                                         (100, 60, 16, True)])
def test_row_bound_is_the_hand_count(n_idx, written, width, add):
    n_bytes = 8 * n_idx + written * 4 * width * (3 if add else 2)
    t, _ = flops.row_bound(n_idx, written, width, add)
    ops = written * width / flops.F32_FLOP_PER_S if add else 0.0
    assert t == pytest.approx(max(n_bytes / flops.HBM_BYTES_PER_S, ops))
