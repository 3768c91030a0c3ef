#!/usr/bin/env python3
"""The port's kernels of two kernel sources, and probes of this tree's,
timed in turns on one GPU.

Builds ``dismember_tpu_torch/csrc`` (``new``) and, with ``--base DIR``, the
``*.cu`` of another version (``base``, e.g. the parent commit's ``csrc``)
into separate libraries with the port's nvcc flags, then times their raw
launches on the same inputs in the order base, new, new, base:
- K1 ``din_score_f32`` at the serving shape (B=4096, U=40, L=10, E=16,
  chip_smoke.py phase 3's seeds and fractions), warm in L2 and after a
  256 MB flush (cold);
- K3 ``packed_level_bf16`` at the serving shapes, warm and cold;
- K2 ``write_rows_f32`` on a commit shaped as the 1M trainer's pmv commit
  (the scratch row, 6,600 sorted distinct rows, 2,103 repeats of the scratch
  row, into a [1048577, 128] table), on its distinct-row prefix, on one row
  (the timer's floor for a launch) and at the width-128 spike's shape, each
  after the flush;
- the row add ``add_rows_f32`` at the mv step's shape (9,100 rows, 3,436 of
  them live, the rest aimed past the table, into [8191, 16]) and at the
  width-128 spike's shape, each after the flush.
Before any timed call, K1 and K3 of each version (and the ``div`` probe's
K3) must lie within twice their tolerance of the first version's scores,
and the add must agree with the first version's bit for bit.  Each
library's ptxas registers and spills of K1 and K3 are printed.  With
``--base`` it also says whether the SASS of K2 ``write_kernel`` and of K3
``packed_level_kernel`` (its one-tile instance, where it has two) is
equal between the two libraries.

``--probe`` adds variants of this tree's K1 and K3, built with edits of
their source, to split their time.  K1: ``k1_empty`` (returns at once: the
timer's floor at K1's grid), ``k1_loads_only`` (its copies into shared
memory, then a return: no prologue arithmetic, no scoring),
``k1_no_ctx`` (ctx not computed: no M . seq products), ``k1_stage_only``
(copies and prologue, no scoring), ``k1_regs48`` (the kernel under a
48-register launch bound), ``k1_head_unroll2`` (h's loop unrolled twice)
and ``k1_fast_exp`` (``__expf`` for ``expf``: not K1's arithmetic).  K3:
``empty``, ``stage_only`` (stages its inputs and stores, no m-tile),
``no_softmax`` (the softmax skipped), ``no_exp`` (expf skipped),
``no_cvt`` (bf16 rounding replaced by truncation) and ``div`` (a division
per probability instead of one reciprocal a row).  The probes other than
``div``, ``k1_regs48`` and ``k1_head_unroll2`` compute wrong scores and
only split the time.

``--wide`` instead times K3 at E = 64, 96 and 128 (f32 rows at beam 20
and 110, L = 10, and beam 20 at L = 24; bf16 rows at beam 20; chip_smoke.py's
inputs and weights at each width) for this tree and ``k3_one_pass_grid``, the
tree with its persistent grid off (one block a group of query rows, as
before; the same scores), and ``base`` where given, in turns, after
checking each version against K3's plain version and the scores and digits
bit for bit against the tree's.

Every time is the median (p10, p90) of chip_smoke.py's per-call CUDA
events.  One JSON line per measurement; the card's name and power limit
first.

Usage: python3 scripts/compare_torch_kernels.py [--base DIR] [--probe | --wide]   (one GPU)
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
MV_P, MV_ROWS, MV_LIVE = 8_191, 9_100, 3_436  # the example catalog's mv table update
K1_SHORT = "    logit = din_score_short<E, S>(item, seq, ctx, ma, tl.lp, w);"
K1_TRIVIAL = "    logit = dot<E>(item, w.m);"
K1_SYNC = "  __syncthreads();\n\n  // a real position scores"
# source edits of the probes: (old, new) pairs applied to din_kernels.cu
PROBES = {
    "k1_empty": [("  const K1Tiles tl(L, E);\n  float* s_items",
                  "  if (B > 0) return;\n  const K1Tiles tl(L, E);\n  float* s_items")],
    "k1_loads_only": [(K1_SYNC, "  asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
                                "  __syncthreads();\n  return;\n\n  // a real position scores"),
                      (K1_SHORT, K1_TRIVIAL)],
    "k1_no_ctx": [("      s_ctx[r * tl.ctx_stride + i * tl.lp + l] = dot<E>(x, w.m + i * RM);",
                   "      s_ctx[r * tl.ctx_stride + i * tl.lp + l] = x[0];")],
    "k1_stage_only": [(K1_SHORT, K1_TRIVIAL)],
    "k1_regs48": [("constexpr int kK1Regs = E <= 16 ? 64 : 128;",
                   "constexpr int kK1Regs = E <= 16 ? 48 : 128;")],
    "k1_head_unroll2": [("#pragma unroll 1\n  for (const float* c = ctx;",
                         "#pragma unroll 2\n  for (const float* c = ctx;")],
    "k1_fast_exp": [("    x[l] = expf(x[l] - mx);", "    x[l] = __expf(x[l] - mx);")],
    "empty": [("  extern __shared__ float4 smem4[];\n  float* smem",
               "  extern __shared__ float4 smem4[];\n  if (B > 0) return;\n  float* smem")],
    "stage_only": [("for (int m0 = 0; m0 < U; m0 += 16) {",
                    "for (int m0 = 0; m0 < 0; m0 += 16) {")],
    "no_softmax": [("#pragma unroll\n      for (int h = 0; h < 2; ++h) {\n        float mx",
                    "#pragma unroll\n      for (int h = 0; h < 0; ++h) {\n        float mx")],
    "no_exp": [("            x = expf(x - mx);", "            x = x - mx;")],
    "no_cvt": [("  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
                "  return *reinterpret_cast<const uint32_t*>(&v);",
                "  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);"),
               ("  return __bfloat162float(__float2bfloat16_rn(x));",
                "  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);")],
    "div": [("const float inv = rcp(quad_sum(sum));", "const float sum_q = quad_sum(sum);"),
            ("for (int i = 0; i < 2; ++i) s[j][2 * h + i] *= inv;",
             "for (int i = 0; i < 2; ++i) s[j][2 * h + i] /= sum_q;")],
}
# --wide's variant: K3 at E >= 64 without its persistent grid
WIDE_PROBES = {"k3_one_pass_grid": [("constexpr bool kPersistentLevel = E >= 64;",
                                     "constexpr bool kPersistentLevel = false;")]}
# --wide's K3 cases: (E, row dtype, batch, beam, L)
WIDE_CASES = [(e, dt, B, beam, l) for e in (64, 96, 128)
              for dt, beam, l in ((torch.float32, 20, 10), (torch.float32, 110, 10),
                                  (torch.float32, 20, 24), (torch.bfloat16, 20, 10))]


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
    for fn in (lib.packed_level_bf16, lib.packed_level_bf16_bf16rows):
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    # a library whose K1 takes a scratch pointer after `out` (built for E >= 64)
    n_ptr = 10 if hasattr(lib, "din_score_scratch_floats") else 9
    lib.din_score_f32.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for fn in (lib.write_rows_f32, lib.add_rows_f32):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
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


def serving_inputs(dev):
    """chip_smoke.py phase 3's K1 and K3 inputs (its seeds and fractions)."""
    g = torch.Generator().manual_seed(cs.SEED + 1)
    seq_e = torch.randn(B, L, E, generator=g) * cs.EMB_STD
    pad = (torch.rand(B, L, generator=g) < 0.3).float()
    pad[0] = 1.0
    seq_e[pad > 0] = 0.0
    item_e = torch.randn(B, 2 * BEAM, E, generator=g) * cs.EMB_STD
    item_e[torch.rand(B, 2 * BEAM, generator=g) < 0.1] = 0.0
    rows = torch.zeros(B, BEAM, ROW)
    rows[..., : 2 * E] = torch.randn(B, BEAM, 2 * E, generator=g) * cs.EMB_STD
    rows[..., 2 * E : 2 * E + 2] = (torch.rand(B, BEAM, 2, generator=g) < 0.85).float()
    alive = (torch.rand(B, BEAM, generator=g) < 0.9).float()
    weights = tuple(t.detach() for t in params_from_numpy(
        cs.seed_params(7, np.random.default_rng(cs.SEED + 4)), device=dev).scorer_weights())
    return [t.to(dev) for t in (item_e, rows, alive, seq_e, pad)], weights


def mv_update(dev):
    """An add shaped as the mv step's table update: the padding segment (aimed
    past the table), the sorted live rows, then empty slots (also past it)."""
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    table = torch.randn(MV_P, E, generator=g, device=dev)
    live = torch.sort(torch.randperm(MV_P, generator=g, device=dev)[:MV_LIVE]).values
    idx = torch.full((MV_ROWS,), MV_P, device=dev)
    idx[1 : 1 + MV_LIVE] = live
    return table, idx, torch.randn(MV_ROWS, E, generator=g, device=dev)


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


def wide(libs: dict) -> None:
    """--wide: K3 at WIDE_CASES for each library, checked, then timed in
    turns (each version, then the same in reverse)."""
    from dismember_tpu_torch.ops import packed_level_kernel as plk

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(cs.SEED + 8)
    labels = list(libs)
    for e, dt, b, beam, l in WIDE_CASES:
        weights = tuple(t.detach() for t in params_from_numpy(
            cs.seed_params(7, np.random.default_rng(cs.SEED + 40 + e), e), device=dev)
            .scorer_weights())
        rows, alive = cs.k3_rows(g, b, beam, dev, dt, e)
        seq_e, pad = cs.seq_inputs(g, b, l, dev, e)
        ps, ph = plk.packed_level_plain(rows, alive, seq_e, pad, *weights, e)
        live = ps > cs.NEG_INF / 2
        alive_f = alive.float()
        launches, outs = {}, {}
        for label in labels:
            sc = torch.empty(b, 2 * beam, device=dev)
            hl = torch.empty(b, 2 * beam, plk.ID_DIGITS[dt], dtype=dt, device=dev)
            lib = libs[label]
            fn = lib.packed_level_bf16_bf16rows if dt == torch.bfloat16 else lib.packed_level_bf16
            args = [t.data_ptr() for t in (rows, alive_f, seq_e, pad, *weights, sc, hl)]
            launches[label] = (lambda fn=fn, args=args: _cuda.check_launch(
                "packed_level", fn(*args, b, beam, rows.shape[2], l, e, stream)))
            launches[label]()
            torch.cuda.synchronize()
            cs.check(torch.equal(cs.bits(hl), cs.bits(ph)), f"{label}: id lanes differ")
            a = cs.agreement("packed_level", sc[live], ps[live], e)
            cs.check(a["ok"], f"{label}: K3 at E={e} against its plain version: {a}")
            outs[label] = (sc, hl)
        first = outs[labels[0]]
        same = {label: torch.equal(o[0], first[0]) and torch.equal(cs.bits(o[1]), cs.bits(first[1]))
                for label, o in outs.items()}
        case = {"e": e, "rows": "bf16" if dt == torch.bfloat16 else "f32",
                "shape": [b, beam, rows.shape[2], l, e], "bitwise_equal_to_" + labels[0]: same}
        for label in labels + labels[::-1]:
            cs.emit({"kernel": "packed_level", "version": label, **case,
                     **cs.time_ms(launches[label])})
        del rows, alive, seq_e, pad, ps, ph, outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="directory holding another version's *.cu")
    ap.add_argument("--probe", action="store_true", help="time K1 and K3 probe variants too")
    ap.add_argument("--wide", action="store_true",
                    help="time K3 at E = 64, 96 and 128 against its one-pass grid instead")
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
    for name, edits in (PROBES.items() if args.probe else
                        WIDE_PROBES.items() if args.wide else ()):
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
        cs.emit({"ptxas": label, **{k: cs.ptxas_usage(log, f"din_score_kernel{k}")
                                    for k in ("", "ILi16ELi10E", "ILi16ELi0E")},
                 **{f"k3{k}": cs.ptxas_usage(log, f"packed_level_kernel{k}")
                    for k in ("", "ILb1E", "ILb0E", "ILb1EfE", "ILb1E13__nv_bfloat16E",
                              "ILb1EfLi16EE", "ILb1E13__nv_bfloat16Li16EE")}})
    libs = {label: load(label) for label in sources}
    if args.wide:
        wide(libs)
        return 0

    if args.base:
        old, new = sass("base"), sass("new")
        pick = lambda fs, *keys: next(v for n, v in fs.items() if any(k in n for k in keys))  # noqa: E731
        # the write: the plain kernel of a parent, write_kernel<false> (f32)
        # here; K3's one-tile instance over f32 rows
        for name, keys in (("write_kernel", ("write_kernelE", "write_kernelILb0EEv",
                                             "write_kernelILb0EfE")),
                           ("packed_level_kernel", ("packed_level_kernelE",
                                                    "packed_level_kernelILb1EEv",
                                                    "packed_level_kernelILb1EfE",
                                                    "packed_level_kernelILb1EfLi16EE"))):
            a, b = pick(old, *keys), pick(new, *keys)
            cs.emit({"sass_identical": name, "equal": a == b, "instructions": [len(a), len(b)]})

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(64 << 20, device=dev)
    (item_e, rows, alive, seq_e, pad), weights = serving_inputs(dev)
    logits = torch.empty(B, 2 * BEAM, device=dev)
    k1_args = [t.data_ptr() for t in (item_e, seq_e, pad, *weights)]
    scores = torch.empty(B, 2 * BEAM, device=dev)
    hilo = torch.empty(B, 2 * BEAM, 2, device=dev)
    k3_args = [t.data_ptr() for t in (rows, alive, seq_e, pad, *weights)]
    mv = mv_update(dev)
    table, idx, krows = k2_commit(dev)
    n_distinct = cs.distinct_prefix(idx)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    spike_v = cs.SPIKE_TABLE_FLOATS // ROW
    spike = (torch.randn(spike_v, ROW, generator=g, device=dev),
             torch.randperm(spike_v, generator=g, device=dev)[:cs.SPIKE_ROWS],
             torch.randn(cs.SPIKE_ROWS, ROW, generator=g, device=dev))

    def k1(lib):
        scratch = (None,) if hasattr(lib, "din_score_scratch_floats") else ()  # none at E = 16
        return lambda: _cuda.check_launch("din_score", lib.din_score_f32(
            *k1_args, logits.data_ptr(), *scratch, B, 2 * BEAM, L, E, stream))

    def k3(lib):
        return lambda: _cuda.check_launch("packed_level", lib.packed_level_bf16(
            *k3_args, scores.data_ptr(), hilo.data_ptr(), B, BEAM, ROW, L, E, stream))

    def rows_fn(lib, name, t, i, r, n):
        return lambda: _cuda.check_launch(name, getattr(lib, f"{name}_f32")(
            t.data_ptr(), i.data_ptr(), r.data_ptr(), t.shape[0], n, t.shape[1], stream))

    def within(name, got, ref, label):
        # each version lies within its tolerance of the plain version
        atol, rtol = cs.TOL[name]
        cs.check(bool(((got - ref).abs() <= 2 * (atol + rtol * ref.abs())).all()),
                 f"{label}: {name} differs from the first version's")

    # every version against the first, on inputs no timed call has touched
    ref = {}
    adds = {"mv_table_add": mv, "spike_w128": spike}
    for label in [v for v in ("base", "new", "div") if v in libs]:
        lib = libs[label]
        for key, launch, out in (("k1", k1(lib), logits), ("k3", k3(lib), scores)):
            if key == "k1" and label == "div":
                continue
            launch()
            torch.cuda.synchronize()
            if key not in ref:
                ref[key] = out.clone()
            else:
                within("din_score" if key == "k1" else "packed_level", out, ref[key], label)
        for case, (t, i, r) in adds.items():
            if label == "div":
                continue
            got = t.clone()
            rows_fn(lib, "add_rows", got, i, r, i.numel())()
            torch.cuda.synchronize()
            got = got.view(torch.int32)
            ref.setdefault(case, got)
            cs.check(torch.equal(got, ref[case]),
                     f"{label}: add_rows on {case} differs from the first version's")
            del got
    del ref

    order = ["base", "new", "new", "base"] if args.base else ["new", "new"]
    order += [p for p in PROBES if args.probe]
    for label in order:
        lib = libs[label]
        probe = label in PROBES
        if not probe or label.startswith("k1_"):
            cs.emit({"kernel": "din_score", "version": label, **cs.time_ms(k1(lib)),
                     **cs.time_ms(k1(lib), "cold_", flush=flush)})
        if probe and label.startswith("k1_"):
            continue
        cs.emit({"kernel": "packed_level", "version": label, **cs.time_ms(k3(lib)),
                 **cs.time_ms(k3(lib), "cold_", flush=flush)})
        if probe:
            continue
        for case, args_ in (("pmv_commit", (table, idx, krows, idx.numel())),
                            ("pmv_commit_distinct", (table, idx, krows, n_distinct)),
                            ("one_row", (table, idx, krows, 1)),
                            ("spike_w128", (*spike, cs.SPIKE_ROWS))):
            cs.emit({"kernel": "write_rows", "version": label, "case": case,
                     **cs.time_ms(rows_fn(lib, "write_rows", *args_), flush=flush)})
        for case, (t, i, r) in adds.items():
            cs.emit({"kernel": "add_rows", "version": label, "case": case,
                     **cs.time_ms(rows_fn(lib, "add_rows", t, i, r, i.numel()), flush=flush)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
