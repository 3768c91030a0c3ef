"""Test set-up of the benchmark's own tests: its folder and the repository
root on the path, the ``card`` marker for tests that need a CUDA device,
and small stand-ins of the cells' configurations that the CPU can hold.

Run: ``python -m pytest benchmark/tests -q`` (CPU; the ``card`` tests skip
there and run where a CUDA device is present)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import cell  # noqa: E402

# every cell at a size the CPU holds: its configuration's keys but the
# catalog, the users and the batches; each still takes its cell's route
# (pmv for the trainers needs at least ~2^20 table rows)
SMALL = {
    "tdm_din_ub4m.serve_b8192": ({"items": 65536, "categories": 97,
                                  "total_eval_batch_size": 256},
                                 {"pool_batches": 4, "check": {"requests": 128, "level_requests": 64}}),
    "tdm_din_ub4m.train_resident": ({"items": 300000, "categories": 97, "users": 2000,
                                     "total_batch_size": 2048},
                                    {"chunk": 4, "call_chunks": 2, "sample_steps": 2,
                                     "profile_steps": 2}),
    "otm_din_ub4m.train": ({"items": 600000},
                           {"pool_batches": 8, "warmup_batches": 1, "profile_batches": 1}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def with_held() -> dict:
    """``BENCHMARK.json`` with the held cells of ``held.json`` (built and
    checked, not yet benchmarked) added, so that their parts stay tested."""
    bench = cell.benchmark()
    held = json.loads((BENCH / "held.json").read_text())
    return {k: v + held[k] if isinstance(v, list) and k in held else v for k, v in bench.items()}


def small_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(bench, workload, config, mix) of a cell, held ones included, cut to
    the CPU's size."""
    bench = with_held()
    w = cell.workload(bench, name)
    cfg_over, mix_over = SMALL[name]
    cfg = dict(cell.config(bench, w["config"]), **cfg_over)
    mix = dict(cell.mix(w["traffic"]), **mix_over)
    return bench, w, cfg, mix
