#!/usr/bin/env python3
"""K2 and K3 of two kernel sources, and probes of this tree's, timed in
turns on one GPU.

Builds ``dismember_tpu_torch/csrc`` (``new``) and, with ``--base DIR``, the
``*.cu`` of another version (``base``, e.g. the parent commit's ``csrc``)
into separate libraries with the port's nvcc flags, then times their raw
launches on the same inputs in the order base, new, new, base:
- K3 ``packed_level_bf16`` at the serving shapes (chip_smoke.py phase 3's
  inputs), warm in L2 and after a 256 MB flush (cold);
- K2 ``write_rows_f32`` on a commit shaped as the 1M trainer's pmv commit
  (the scratch row, 6,600 sorted distinct rows, 2,103 repeats of the scratch
  row, into a [1048577, 128] table), on its distinct-row prefix, on one row
  (the timer's floor for a launch) and at the width-128 spike's shape, each
  after the flush.
With ``--base`` it also compares the SASS of the kernels this tree did not
redesign (K1 ``din_score_kernel``, the row add) between the two libraries.

``--probe`` adds variants of this tree's K3, built with edits of its
source, to split its time: ``empty`` (returns at once: the timer's floor
at K3's grid), ``stage_only`` (stages its inputs and stores, no m-tile),
``no_softmax`` (the softmax skipped), ``no_exp`` (expf skipped),
``no_cvt`` (bf16 rounding replaced by truncation) and ``div`` (a division
per probability instead of one reciprocal a row); all but ``div`` compute
wrong scores and only split the time.

Every time is the median (p10, p90) of chip_smoke.py's per-call CUDA
events.  One JSON line per measurement; the card's name and power limit
first.

Usage: python3 scripts/compare_torch_kernels.py [--base DIR] [--probe]   (one GPU)
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dismember_tpu_torch.models.din import params_from_numpy  # noqa: E402
from dismember_tpu_torch.ops import _cuda  # noqa: E402

OUT = ROOT / "build" / "compare"
B, BEAM, L, E, ROW = cs.BATCH, cs.BEAM, cs.SEQ_LEN, cs.E, 128
P_ROWS, DISTINCT, TAIL = 1_048_577, 6_600, 2_103  # the 1M trainer's pmv commit
# K3 source edits of the probes: (old, new) pairs applied to din_kernels.cu
PROBES = {
    "empty": [("  extern __shared__ float4 smem4[];\n  const int lane",
               "  extern __shared__ float4 smem4[];\n  if (B > 0) return;\n  const int lane")],
    "stage_only": [("for (int m0 = 0; m0 < U; m0 += 16) {",
                    "for (int m0 = 0; m0 < 0; m0 += 16) {")],
    "no_softmax": [("#pragma unroll\n    for (int h = 0; h < 2; ++h) {\n      float mx",
                    "#pragma unroll\n    for (int h = 0; h < 0; ++h) {\n      float mx")],
    "no_exp": [("          s = expf(s - mx);", "          s = s - mx;")],
    "no_cvt": [("  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
                "  return *reinterpret_cast<const uint32_t*>(&v);",
                "  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);"),
               ("  return __bfloat162float(__float2bfloat16_rn(x));",
                "  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);")],
    "div": [("const float inv = rcp(quad_sum(sum));", "const float sum_q = quad_sum(sum);"),
            ("for (int i = 0; i < 2; ++i) acc[j][2 * h + i] *= inv;",
             "for (int i = 0; i < 2; ++i) acc[j][2 * h + i] /= sum_q;")],
}


def build(label: str, sources: dict[str, str]) -> subprocess.Popen:
    d = OUT / label
    d.mkdir(parents=True, exist_ok=True)
    for name, text in sources.items():
        (d / name).write_text(text)
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(d / "lib.so"),
           *[str(d / n) for n in sources]]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(label: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(OUT / label / "lib.so"))
    lib.packed_level_bf16.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.write_rows_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                           ctypes.c_int, ctypes.c_void_p]
    return lib


def sass(label: str) -> dict[str, list[str]]:
    """Each kernel's SASS instructions, addresses and constants masked."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(OUT / label / "lib.so")], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        ins = [re.sub(r"0x[0-9a-f]+", "X", ln.split("*/", 1)[1].split(";")[0]).strip()
               for ln in body.splitlines() if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
        out[name.strip()] = ins
    return out


def k3_inputs(dev):
    """chip_smoke.py phase 3's K3 inputs (its seeds and fractions)."""
    g = torch.Generator().manual_seed(cs.SEED + 1)
    seq_e = torch.randn(B, L, E, generator=g) * cs.EMB_STD
    pad = (torch.rand(B, L, generator=g) < 0.3).float()
    pad[0] = 1.0
    seq_e[pad > 0] = 0.0
    rows = torch.zeros(B, BEAM, ROW)
    rows[..., : 2 * E] = torch.randn(B, BEAM, 2 * E, generator=g) * cs.EMB_STD
    rows[..., 2 * E : 2 * E + 2] = (torch.rand(B, BEAM, 2, generator=g) < 0.85).float()
    alive = (torch.rand(B, BEAM, generator=g) < 0.9).float()
    weights = tuple(t.detach() for t in params_from_numpy(
        cs.seed_params(7, np.random.default_rng(cs.SEED + 4)), device=dev).scorer_weights())
    return [t.to(dev) for t in (rows, alive, seq_e, pad)], weights


def k2_commit(dev):
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    scratch = P_ROWS - 1
    table = torch.randn(P_ROWS, ROW, generator=g, device=dev)
    d = torch.sort(torch.randperm(scratch, generator=g, device=dev)[:DISTINCT]).values
    idx = torch.cat([torch.tensor([scratch], device=dev), d,
                     torch.full((TAIL,), scratch, device=dev)])
    rows = torch.randn(idx.numel(), ROW, generator=g, device=dev)
    rows[idx == scratch] = 0.0
    return table, idx, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="directory holding another version's *.cu")
    ap.add_argument("--probe", action="store_true", help="time K3 probe variants too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_kernels: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    new_src = {p.name: p.read_text() for p in _cuda.SOURCES}
    sources = {"new": new_src}
    if args.base:
        sources["base"] = {p.name: p.read_text() for p in sorted(args.base.glob("*.cu"))}
    if args.probe:
        for name, edits in PROBES.items():
            text = new_src["din_kernels.cu"]
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"probe {name}: source edit does not apply: {old!r}")
                text = text.replace(old, new)
            sources[name] = {**new_src, "din_kernels.cu": text}
    procs = {label: build(label, src) for label, src in sources.items()}
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
    libs = {label: load(label) for label in sources}

    if args.base:
        old, new = sass("base"), sass("new")
        pick = lambda fs, *keys: next(v for n, v in fs.items() if any(k in n for k in keys))  # noqa: E731
        for name, keys_old, keys_new in (
                ("din_score_kernel", ("din_score_kernel",), ("din_score_kernel",)),
                ("add", ("rows_kernelILb1", "add_kernel"), ("add_kernel",))):
            a, b = pick(old, *keys_old), pick(new, *keys_new)
            cs.emit({"sass_identical": name, "equal": a == b, "instructions": [len(a), len(b)]})

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(64 << 20, device=dev)
    (rows, alive, seq_e, pad), weights = k3_inputs(dev)
    scores = torch.empty(B, 2 * BEAM, device=dev)
    hilo = torch.empty(B, 2 * BEAM, 2, device=dev)
    k3_args = [t.data_ptr() for t in (rows, alive, seq_e, pad, *weights)]
    table, idx, krows = k2_commit(dev)
    n_distinct = cs.distinct_prefix(idx)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    spike_v = cs.SPIKE_TABLE_FLOATS // ROW
    spike = (torch.randn(spike_v, ROW, generator=g, device=dev),
             torch.randperm(spike_v, generator=g, device=dev)[:cs.SPIKE_ROWS],
             torch.randn(cs.SPIKE_ROWS, ROW, generator=g, device=dev))

    def k3(lib):
        return lambda: _cuda.check_launch("packed_level", lib.packed_level_bf16(
            *k3_args, scores.data_ptr(), hilo.data_ptr(), B, BEAM, ROW, L, E, stream))

    def k2(lib, t, i, r, n):
        return lambda: _cuda.check_launch("write_rows", lib.write_rows_f32(
            t.data_ptr(), i.data_ptr(), r.data_ptr(), t.shape[0], n, t.shape[1], stream))

    ref = None
    order = ["base", "new", "new", "base"] if args.base else ["new", "new"]
    order += [p for p in PROBES if args.probe]
    for label in order:
        lib = libs[label]
        k3(lib)()
        torch.cuda.synchronize()
        if ref is None:
            ref = scores.clone()
        elif label in ("base", "new", "div"):
            # each version lies within K3's tolerance of the plain version
            atol, rtol = cs.TOL["packed_level"]
            cs.check(bool(((scores - ref).abs() <= 2 * (atol + rtol * ref.abs())).all()),
                     f"{label}: K3 scores differ from the first version's")
        cs.emit({"kernel": "packed_level", "version": label, **cs.time_ms(k3(lib)),
                 **cs.time_ms(k3(lib), "cold_", flush=flush)})
        if label in PROBES:
            continue
        for case, args_ in (("pmv_commit", (table, idx, krows, idx.numel())),
                            ("pmv_commit_distinct", (table, idx, krows, n_distinct)),
                            ("one_row", (table, idx, krows, 1)),
                            ("spike_w128", (*spike, cs.SPIKE_ROWS))):
            cs.emit({"kernel": "write_rows", "version": label, "case": case,
                     **cs.time_ms(k2(lib, *args_), flush=flush)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
