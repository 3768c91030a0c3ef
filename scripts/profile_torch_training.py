#!/usr/bin/env python3
"""Where the time of the port's TDM train step goes on one GPU.

For three cells, chip_smoke.py's trainers, prints one JSON line each:
- ``example_dense``: configs/tdm.conf's trainer on the example catalog (auto
  route: dense);
- ``deep_pmv``: bench.py's trainer on the 1M catalog (auto route: pmv, one
  K2 launch a step);
- ``deep_dense``: the same with ``sparse_embed_update=False``.
Each line holds the host-clock split of a step (sampling, then the step
from the samples, each ended by a synchronize; mean of 10 steps after 3
warm-up steps) and, from ``torch.profiler`` over 3 steps, the device time by
kernel (top 12), the number of device kernels a step, and the device's busy
share of the profiled wall time.  Chrome traces go to
``build/profile/profile_train_<cell>.json``.

Usage: python3 scripts/profile_torch_training.py   (one GPU)
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dismember_tpu_torch.index.arraytree import ArrayTree  # noqa: E402
from dismember_tpu_torch.train.tdm import TDMTrainer  # noqa: E402

OUT = ROOT / "build" / "profile"
WARM, STEPS, PROFILED = 3, 10, 3


def _device_us(evt) -> float:
    if evt.device_type == torch.autograd.DeviceType.CPU:
        return 0.0
    return float(evt.self_device_time_total)


def batches(tr: TDMTrainer, seqs: np.ndarray, targets: np.ndarray, n: int):
    """``n`` consecutive batches of (seq codes, target codes) on the card."""
    b = tr.num_targets_per_batch
    codes = lambda ids: torch.as_tensor(tr.tree.ids_to_codes(ids), dtype=torch.long,  # noqa: E731
                                        device=tr.device)
    return [(codes(seqs[i * b:(i + 1) * b]), codes(targets[i * b:(i + 1) * b]))
            for i in range(n)]


def profile(name: str, tr: TDMTrainer, seqs: np.ndarray, targets: np.ndarray) -> dict:
    data = batches(tr, seqs, targets, WARM + STEPS + PROFILED)
    for sc, tc in data[:WARM]:
        tr._train_step(tc, sc)
    acc = np.zeros(2)
    for sc, tc in data[WARM:WARM + STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = tr.sample(tc)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.step_from_samples(sc, *batch)
        torch.cuda.synchronize()
        acc += np.diff([t0, t1, time.perf_counter()])
    ms = acc / STEPS * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for sc, tc in data[WARM + STEPS:]:
            tr._train_step(tc, sc)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    OUT.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(OUT / f"profile_train_{name}.json"))
    events = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
    events = [e for e in events if e[2] > 0]
    device_us = sum(e[2] for e in events)
    top = sorted(events, key=lambda e: -e[2])[:12]
    return {
        "route": "pmv" if tr._pmv else ("sparse" if tr._sparse else "dense"),
        "targets_per_step": tr.num_targets_per_batch, "unit": tr.sampler.unit,
        "sample_ms": ms[0], "step_from_samples_ms": ms[1], "step_ms": float(ms.sum()),
        "profiled_steps": PROFILED, "wall_ms_per_step": wall_us / 1e3 / PROFILED,
        "device_ms_per_step": device_us / 1e3 / PROFILED if device_us else "not measured",
        "device_busy_share": device_us / wall_us if device_us else "not measured",
        "device_ops_per_step": sum(e[1] for e in events) / PROFILED,
        "top_device_ms_per_step": [{"name": k[:80], "count": c / PROFILED,
                                    "ms": us / 1e3 / PROFILED} for k, c, us in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_training: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cs.OUT.mkdir(parents=True, exist_ok=True)
    tree_path, _, _, _, samples = cs.example_data()
    tree = ArrayTree.from_file(tree_path)
    tr = TDMTrainer(tree=tree, seed=cs.SEED, device=dev, **cs.TDM_CONF)
    print(json.dumps({"profile": "example_dense", "card": smi, **profile(
        "example_dense", tr, samples.train_seqs, samples.train_targets)}), flush=True)
    deep, _, _ = cs.deep_catalog(dev)
    neg = ",".join(str(min(i, 2**i - 1)) for i in range(deep.tree.max_level + 1))
    rng = np.random.default_rng(cs.SEED + 6)
    n = 35 * (WARM + STEPS + PROFILED)
    targets = rng.integers(1, cs.DEEP_ITEMS + 1, size=n)
    seqs = rng.integers(1, cs.DEEP_ITEMS + 1, size=(n, cs.SEQ_LEN))
    deep_tree = deep.tree
    del deep
    for name, kw in (("deep_pmv", {}), ("deep_dense", {"sparse_embed_update": False})):
        tr = TDMTrainer(tree=deep_tree, embed_size=cs.E, layer_neg_counts=neg, seed=cs.SEED,
                        device=dev, **kw)
        print(json.dumps({"profile": name, "card": smi,
                          **profile(name, tr, seqs, targets)}), flush=True)
        del tr
    return 0


if __name__ == "__main__":
    sys.exit(main())
