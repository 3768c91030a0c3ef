"""The Deep Retrieval serving cell (``dr_ub4m.serve_b8192``): its
configuration against ``configs/deep-retrieval.conf``, its mix, limits and
metric entries; whole runs at a size the CPU holds (2^18 items, the block
route's least catalog): a sound run comes out correct, an answer altered
where the facade produces it and a beam with one path dropped come out not
correct, and the controls of ``calibrate.py`` fail the limits; the frozen
counts against hand counts; and a short run at the cell's own size on the
card."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import calibrate
import cell
import flops
import flops_dr
import run

NAME = "dr_ub4m.serve_b8192"
BENCH = Path(cell.__file__).resolve().parent
CPU = torch.device("cpu")
# the cell's configuration but the catalog, the nodes a layer (50^3 paths:
# ~4 items a path, as the cell's ~8, so every list is full) and the batch;
# the mix's pool, samples and layer stretch cut to match
SMALL = ({"items": 1 << 18, "num_node": 50, "eval_batch_size": 256},
         {"pool_batches": 4, "layer_batches": 8, "check": {"requests": 64, "path_requests": 64}})
CHECKED = {"bad_items", "served_changed", "truncated_paths", "order_gap", "list_miss",
           "path_miss"}


def small() -> tuple[dict, dict, dict, dict]:
    bench = cell.benchmark()
    w = cell.workload(bench, NAME)
    cfg = dict(cell.config(bench, w["config"]), **SMALL[0])
    mix = dict(cell.mix(w["traffic"]), **SMALL[1])
    return bench, w, cfg, mix


def measure(trace: int = 0, seed: int = 2**33 + 7) -> dict:
    bench, w, cfg, mix = small()
    args = argparse.Namespace(seed=seed, seconds=0.3, trace=trace)
    result, _ = run.measure(bench, w, cfg, mix, cell.limits(NAME), args, CPU)
    return result


def test_the_configuration_is_the_conf_unchanged():
    conf = {}
    for line in (BENCH.parent / "configs" / "deep-retrieval.conf").read_text().splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0].startswith("model."):
            conf[parts[0][len("model."):]] = parts[1]
    bench = cell.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "dr_ub4m")
    cfg = cell.config(bench, "dr_ub4m")
    assert entry["reduced"] == cfg["reduced"] == []
    for key in ("num_layer", "num_node", "num_path_per_item", "embed_size", "seq_len",
                "min_seq_len", "beam_size", "topk_number", "eval_batch_size",
                "train_batch_size", "num_sampled", "split_ratio", "learning_rate"):
        assert cfg[key] == json.loads(conf[key]), key
    assert cfg["initialize_mapping"] is (conf["initialize_mapping"] == "true")
    assert cfg["items"] == 4162024


def test_the_mix_limits_and_metrics_belong_to_the_cell():
    bench = cell.benchmark()
    w = cell.workload(bench, NAME)
    assert w["chips"] == 1 and cell.mix(w["traffic"])["driver"] == "dr_serve"
    limits = cell.limits(NAME)
    assert set(limits) == CHECKED
    assert all(limits[k] == 0 for k in ("bad_items", "served_changed", "truncated_paths"))
    mine = [m for m in bench["per_layer"] if NAME in m.get("workloads", ())]
    assert {m["name"] for m in mine} == {
        "dr_serving.recommend_p95_ms", "path_beam.issue_ms", "dr_serving.wait_ms",
        "dr_serve.device_ops_per_batch", "device_idle_pct.dr_serve", "mfu.dr_serve",
        "dr_serve_roofline"}
    assert all(m["workloads"] == [NAME] and m["moves"] == "serve_qps" for m in mine)
    assert {m["name"] for m in cell.end_to_end(bench, w)} == {"serve_qps", "setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    result = measure(trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == CHECKED
    bench = cell.benchmark()
    names = {m["name"] for m in cell.per_layer(bench, cell.workload(bench, NAME))}
    if trace:  # on the CPU the trace's metrics have nothing to read
        assert {"dr_serving.recommend_p95_ms", "path_beam.issue_ms", "dr_serving.wait_ms",
                "mfu.dr_serve"} <= set(result["metrics"]) <= names
        assert all(v["value"] > 0 for v in result["metrics"].values())
    else:
        assert set(result["metrics"]) == {"serve_qps", "setup_s"}


def _alter_answers(monkeypatch):
    """Every served list's first item replaced by another catalog item,
    where the facade produces it."""
    from dismember_tpu_torch.serving import DRServing

    real = DRServing.recommend_batch_device

    def altered(self, *args, **kw):
        ids = real(self, *args, **kw).copy()
        ids[:, 0] = (ids[:, 0] + 7919) % self._trainer.data.num_items
        return ids

    monkeypatch.setattr(DRServing, "recommend_batch_device", altered)
    return ("list_miss", "order_gap")


def _drop_a_path(monkeypatch):
    """The beam's last path replaced by a copy of its first, which the
    closure then counts once: a beam of beam - 1 paths."""
    from dismember_tpu_torch.retrieval import dr_serve

    real = dr_serve.path_beam_search

    def dropped(*args, **kw):
        paths, probs = real(*args, **kw)
        paths = paths.clone()
        paths[:, -1] = paths[:, 0]
        return paths, probs

    monkeypatch.setattr(dr_serve, "path_beam_search", dropped)
    return ("path_miss",)


@pytest.mark.parametrize("fault", [_alter_answers, _drop_a_path])
def test_a_broken_timed_path_fails_its_number(monkeypatch, fault):
    names = fault(monkeypatch)
    result = measure()
    assert not result["correct"]
    checks = result["checks"]
    assert any(checks[n]["value"] > checks[n]["limit"] for n in names), checks


def test_the_controls_fail_the_limits():
    """The reference on float8 operands in the program's place and each
    planted fault fail one of the cell's numbers; the program does not."""
    _, _, cfg, mix = small()
    drv = cell.driver(mix["driver"]).Driver(cfg, mix, 2**32 + 13, CPU)
    out = {"program": calibrate.program(drv, 0.3), **drv.calibrate()}
    limits = cell.limits(NAME)
    fails = lambda numbers: any(v > limits[k] for k, v in numbers.items())  # noqa: E731
    assert not fails(out.pop("program"))
    assert set(out) == {"control", "fault_altered_answer", "fault_dropped_path"}
    for stand_in, numbers in out.items():
        assert fails(numbers), (stand_in, numbers)
    assert out["fault_dropped_path"]["path_miss"] > limits["path_miss"]


def test_the_frozen_counts_are_the_hand_count():
    s = {"l": 10, "e": 16, "k": 100, "depth": 3, "beam": 20, "topk": 10, "j": 2,
         "items": 4162024}
    cands = 20 * 2 * 4162024 / 100**3
    assert flops_dr.candidates(s) == pytest.approx(cands)
    window = 3 * 2 * 10 * 16 * 100 + 2 * 10 * 16 * 16 + 16
    beam = (0 + 100 + 300) + 20 * (2 * 16 * 100 + 100 + 300 + 100) + 20 * (
        2 * 2 * 16 * 100 + 100 + 300 + 100)
    assert flops_dr.window_flops(s) == window and flops_dr.beam_flops(s) == beam
    assert flops_dr.model_flops(s) == pytest.approx(window + beam + cands * 33)
    b, c = 8192, 10
    stage_bytes = (b * (80 + 8 * c + 640) + 4 * (3 * 100 * 160 + 16 * 160 + 16),
                   4 * (0 + 100 + 1600 + 100 + 3200 + 100 + 200 * 16) + 8 * b * 20 * 3,
                   b * 20 * 4 + b * cands * (34 + 4) + b * 10 * 12)
    ops = (b * window, b * beam, b * cands * 33)
    want = sum(max(n / flops.HBM_BYTES_PER_S, f / flops.F32_FLOP_PER_S)
               for n, f in zip(stage_bytes, ops))
    assert flops_dr.serve_bound(s, b, c) == pytest.approx(want)


@pytest.mark.card
def test_the_cell_runs_on_the_card(card):
    """One short run of the cell at its own size on the card."""
    bench = cell.benchmark()
    w = cell.workload(bench, NAME)
    args = argparse.Namespace(seed=2**31 + 9, seconds=2.0, trace=0)
    result, _ = run.measure(bench, w, cell.config(bench, w["config"]), cell.mix(w["traffic"]),
                            cell.limits(NAME), args, card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert np.isfinite(result["metrics"]["serve_qps"]["value"])
