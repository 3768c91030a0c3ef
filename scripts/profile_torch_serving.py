#!/usr/bin/env python3
"""Where the time of the port's TDM serving goes on one GPU.

For ``recommend_batch(4096)`` on the 1M-item catalog (packed route, K3 per
level) and on the example catalog's classic route (K1 per level), prints one
JSON line each with
- the host-clock split of a call into its layers: id -> code conversion and
  upload, the beam loop (ended by a synchronize), the download, and the
  host-side top-k filter;
- from ``torch.profiler`` over one call: device time by kernel (top 12), the
  device's busy share of the call's wall time, and K1/K3's share.
The catalogs, weights and queries are chip_smoke.py's.  Chrome traces go to
``chiprun_out/profile_<name>.json``.

Usage: python3 scripts/profile_torch_serving.py   (one GPU)
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
from dismember_tpu_torch.retrieval.tree_beam import filter_topk  # noqa: E402
from dismember_tpu_torch.serving import TDMServing  # noqa: E402

OUT = ROOT / "chiprun_out"


def _device_us(evt) -> float:
    """Device time of a kernel or copy event; 0 for host-side ops, whose
    device time repeats that of the kernels they launch."""
    if evt.device_type == torch.autograd.DeviceType.CPU:
        return 0.0
    return float(evt.self_device_time_total)


def layers(serv: TDMServing, seqs: np.ndarray, reps: int = 5) -> dict:
    """Mean host-clock ms of each layer of recommend_batch."""
    fn = serv._beam_fn(serv.candidate_num)
    acc = np.zeros(4)
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = serv._codes(seqs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ids, scores = fn(serv.params, codes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        t3 = time.perf_counter()
        filter_topk(ids, scores, serv.topk)
        t4 = time.perf_counter()
        acc += np.diff([t0, t1, t2, t3, t4])
    ms = acc / reps * 1e3
    return {"codes_upload_ms": ms[0], "beam_loop_ms": ms[1], "download_ms": ms[2],
            "filter_topk_ms": ms[3], "total_ms": float(ms.sum())}


def profile(name: str, serv: TDMServing, seqs: np.ndarray) -> dict:
    serv.recommend_batch(seqs)  # warm: pair table, kernels, allocator
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serv.recommend_batch(seqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    OUT.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT / f"profile_{name}.json"))
    events = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
    events = [e for e in events if e[2] > 0]
    device_us = sum(e[2] for e in events)
    kernel_us = sum(e[2] for e in events
                    if "din_score_kernel" in e[0] or "packed_level_kernel" in e[0])
    top = sorted(events, key=lambda e: -e[2])[:12]
    return {
        "wall_ms": wall_us / 1e3,
        "device_ms": device_us / 1e3 if device_us else "not measured",
        "device_busy_share": device_us / wall_us if device_us else "not measured",
        "k1_k3_share_of_device": kernel_us / device_us if device_us else "not measured",
        "top_device_ms": [{"name": k[:80], "count": c, "ms": us / 1e3} for k, c, us in top],
        "layers": layers(serv, seqs),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serving: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cs.OUT.mkdir(parents=True, exist_ok=True)
    deep, deep_seqs, _ = cs.deep_catalog(torch.device("cuda", 0))
    print(json.dumps({"profile": "deep_1m_packed", "card": smi,
                      **profile("deep_1m_packed", deep, deep_seqs)}), flush=True)
    tree_path, ckpt, seqs, _, _ = cs.example_data()
    classic = TDMServing.load(ckpt, tree_path, topk=cs.TOPK, candidate_num=cs.BEAM,
                              packed=False)
    packed = TDMServing.load(ckpt, tree_path, topk=cs.TOPK, candidate_num=cs.BEAM)
    print(json.dumps({"profile": "example_classic", "card": smi,
                      **profile("example_classic", classic, seqs)}), flush=True)
    print(json.dumps({"profile": "example_packed", "card": smi,
                      **profile("example_packed", packed, seqs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
