"""Whole runs of each cell at a size the CPU holds, past the harness's look
for a card: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell can
have; and the controls of ``calibrate.py`` fail their cell's limits."""

from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch

import calibrate
import cell
import run
from conftest import small_cell, with_held

CPU = torch.device("cpu")
SERVE, TDM, OTM = ("tdm_din_ub4m.serve_b8192", "tdm_din_ub4m.train_resident",
                   "otm_din_ub4m.train")


def measure(name: str, trace: int = 0, seed: int = 2**33 + 3) -> dict:
    bench, w, cfg, mix = small_cell(name)
    args = argparse.Namespace(seed=seed, seconds=0.3, trace=trace)
    result, _ = run.measure(bench, w, cfg, mix, cell.limits(name), args, CPU)
    return result


@pytest.mark.parametrize("name", [SERVE, TDM, OTM])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(name, trace):
    result = measure(name, trace)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    bench = with_held()
    w = cell.workload(bench, name)
    if trace:  # on the CPU only the host's metrics have something to read
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer(bench, w)}
        assert any(k.startswith("mfu.") for k in result["metrics"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end(bench, w)}


def _alter_answers(monkeypatch):
    """Every served list's first item replaced by another catalog item,
    where the host filter produces it."""
    import dismember_tpu_torch.serving as serving

    real = serving.filter_topk

    def altered(*args, **kw):
        out = real(*args, **kw)
        return [np.concatenate([[x[0] % 1000 + 1], x[1:]]) if len(x) else x for x in out]

    monkeypatch.setattr(serving, "filter_topk", altered)


def _misscore_a_level(monkeypatch):
    """K3's plain version scores a few per cent of the live candidates of
    every third level 3 logits too high."""
    from dismember_tpu_torch.ops import packed_level_kernel as k3

    real, calls = k3.packed_level_plain, [0]

    def wrong(*args, **kw):
        scores, ids = real(*args, **kw)
        calls[0] += 1
        if calls[0] % 3 == 1:
            g = torch.Generator().manual_seed(calls[0])
            hit = (torch.rand(scores.shape, generator=g) < 0.03) & (scores > -1e30)
            scores = torch.where(hit, scores + 3.0, scores)
        return scores, ids

    monkeypatch.setattr(k3, "packed_level_plain", wrong)


def _narrow_beam(monkeypatch):
    """The beam keeps 18 of its 20 nodes at every level."""
    from dismember_tpu_torch.retrieval import packed_beam

    real = packed_beam.select_top

    def narrow(frontier, scores, beam):
        top, alive = real(frontier, scores, beam)
        alive = alive.clone()
        alive[:, beam - 2:] = False
        return top, alive

    monkeypatch.setattr(packed_beam, "select_top", narrow)


def _state_unchanged(monkeypatch):
    """Every step returns the trainer's state as it found it."""
    from dismember_tpu_torch.train import row_step, sparse_adam

    monkeypatch.setattr(row_step.RowStepTrainer, "_adam_step", lambda self, p, g: None)
    monkeypatch.setattr(sparse_adam, "pmv_apply_rows", lambda state, *a, **k: state)


def _half_batch(monkeypatch):
    """Every step leaves out the second half of its batch and takes the mean
    over the rest."""
    from dismember_tpu_torch.train import row_step

    real = row_step.RowStepTrainer.step_from_samples

    def half(self, seq, codes, labels, weights):
        h = codes.shape[0] // 2
        return real(self, seq[:h], codes[:h], labels[:h], weights[:h])

    monkeypatch.setattr(row_step.RowStepTrainer, "step_from_samples", half)


@pytest.mark.parametrize("name, fault", [
    (SERVE, _alter_answers), (SERVE, _misscore_a_level), (SERVE, _narrow_beam),
    (TDM, _state_unchanged), (TDM, _half_batch),
    (OTM, _state_unchanged), (OTM, _half_batch)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = measure(name)
    assert not result["correct"], result["checks"]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.parametrize("name", [SERVE, TDM, OTM])
def test_the_controls_fail_the_cells_limits(name):
    """The reference in the program's place one precision below, and each
    planted fault, fail one of the cell's numbers; the program does not."""
    bench, w, cfg, mix = small_cell(name)
    seed = 2**32 + 11
    drv = cell.driver(mix["driver"]).Driver(cfg, mix, seed, CPU)
    out = {"program": calibrate.program(drv, 0.3), **drv.calibrate()}
    limits = cell.limits(name)
    assert not _fails(out.pop("program"), limits)
    assert out
    for stand_in, numbers in out.items():
        assert _fails(numbers, limits), (stand_in, numbers)


@pytest.mark.card
@pytest.mark.parametrize("name", [SERVE, TDM, OTM])
def test_a_cell_runs_on_the_card(card, name):
    """One short run of the cell at its own size on the card."""
    bench = with_held()
    w = cell.workload(bench, name)
    args = argparse.Namespace(seed=2**31 + 5, seconds=2.0, trace=0)
    result, _ = run.measure(bench, w, cell.config(bench, w["config"]), cell.mix(w["traffic"]),
                            cell.limits(name), args, card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
