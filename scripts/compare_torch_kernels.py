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
``--base`` it also asserts that the SASS of every kernel instance both
libraries have (K1, K3, K2's ``write_kernel``, the write and the add, and
the DR rerank) is equal; an instance of one library only is not compared.

``--probe`` adds variants of this tree's K1 and K3, built with edits of
their source, to split their time.  K1: ``k1_empty`` (returns at once: the
timer's floor at K1's grid), ``k1_loads_only`` (its copies into shared
memory, then a return: no prologue arithmetic, no scoring),
``k1_no_ctx`` (ctx not computed: no M . seq products), ``k1_stage_only``
(copies and prologue, no scoring), ``k1_regs48`` (the kernel under a
48-register launch bound), ``k1_head_unroll2`` (h's loop unrolled twice)
and ``k1_fast_exp`` (``__expf`` for ``expf``: not K1's arithmetic).  K3:
``no_softmax`` (the softmax skipped), ``no_exp`` (expf skipped),
``no_cvt`` (bf16 rounding replaced by truncation) and ``div`` (a division
per probability instead of one reciprocal a row); ``--narrow`` splits
K3's time further.  The probes other than ``div``, ``k1_regs48`` and
``k1_head_unroll2`` compute wrong scores and only split the time.

``--wide`` instead times K3's warpgroup plan at E = 32, 64, 96 and 128
(WIDE_CASES: f32 and bf16 rows at [4096, 20, L 10], beam 110 and L = 24;
chip_smoke.py's inputs and weights at each width) for ``base`` where given
and this tree, in turns, warm and cold, after checking each against K3's
plain version (K3's tolerance and flip share, id digits and the dead mask
bit for bit; ``bitwise_equal_to_...`` says whether the scores equal the
first version's), then this tree's variants (WIDE_PROBES: design steps
and E = 32's block sizes, checked as the versions are, and probes that
split the time), warm, and each case's bound.  With ``--base`` it first
asserts that the SASS of K1 (every width), of K3 at E <= 16 and of K2
(``write_kernel``, the write and the add) equals the base's; it prints the
warpgroup plan's K3 instances' HMMA and HGMMA counts.

``--narrow`` does the same for K3 at E = 8 and 16 (NARROW_CASES: f32 and
bf16 rows at [4096, 20, L 10], beam 110 and L = 24), each version's
scores also counted against the first's where they differ
(``differing_scores``); its variants (NARROW_PROBES) are the launch
shapes at E <= 16 (``k3n_g<G>b<M>``: G warpgroups a block, the register
cap set for M blocks an SM on one sequence tile; ``k3n_tiles_b<M>``: M
blocks an SM past one tile), checked as the versions are, and
``--wide``'s probes that split the time.  With ``--base`` it first
asserts that the SASS of K1, of K3 from E = 32 on, of K2 and of the DR
rerank equals the base's.

``--wide-k1`` instead times K1 at E = 64, 96 and 128 (WIDE_K1_CASES: the
serving shape [4096, 40], the JTM sweep's [8192, 4] and L = 24;
chip_smoke.py's inputs and weights at each width) for ``base`` where given
and this tree, in turns, warm and cold, after checking each within K1's
tolerance of ``din_score_plain``; then this tree's probes (WIDE_K1_PROBES:
``k1w_empty``, the prologue and a kernel that returns at once;
``k1w_attention_only``, the product warps skipping the product;
``k1w_product_only``, the attention warps skipping the attention pass;
``k1w_no_split``, the product without its splits; ``k1w_two_mma``, two
mma a k-step instead of three; ``k1w_ldg_items``, candidates read
through L1; ``k1w_fast_exp``, ``__expf``; ``k1w_no_shfl``, no shuffle
sums;
``k1w_12warps``, eight attention warps; ``k1w_span5`` and ``k1w_span8``,
five and eight positions at once;
``k1w_buffers4``, four buffers where they fit; ``k1w_chunk32``, h's sums
restarted every 32 k: the last five compute K1, the others only split its
time) and
``torch.matmul`` of the product alone, [B*U, 2E] @ [2E, E] in f32 (TF32
off), a yardstick of the product's pace that computes no part of K1.  With
``--base`` it first asserts that the SASS of K1 at E <= 32, of every K3
instance and of K2 (``write_kernel``, the write and the add) equals the
base's.

``--narrow-k1`` instead times K1 at E = 8 and 32 (NARROW_K1_CASES: the
serving shape [4096, 40], the JTM sweep's [8192, 4] and L = 24;
chip_smoke.py's inputs and weights at each width) for ``base`` where given
and this tree, in turns, warm and cold, after checking each within K1's
tolerance of ``din_score_plain`` (``bitwise_equal_to_...`` says whether
its logits equal the first version's); then this tree's variants
(NARROW_K1_PROBES: the plans at each width taken back or varied, checked
as the versions are, and probes that split the time) and the base's own
split (FOLD_PROBES: PROBES' K1 edits on the base's source), warm and
cold.  With ``--base`` it first asserts that the SASS of every kernel of
the base (K1's ``din_score_kernel`` at E = 8, 16 and 32, the wide K1 past
E = 32, every K3 instance and K2) equals the base's.

``--k3-e32-draws N`` instead holds this tree's K3 at E = 32 on f32 rows
against its plain version over N fresh draws of the serving shape [4096,
20] and of beam 1,000 ([256, 1000], one launch), with the scorer's
weights at N(0, 0.5) and at N(0, 0.5 sqrt(16 / 32)): per weight scale the
largest error, the largest share beyond K1's tolerance, the largest error
over K3's tolerance, the largest error by |logit| band, the logits' std,
and the f32-scorer control's share (which must fail K3's check).

Every time is the median (p10, p90) of chip_smoke.py's per-call CUDA
events.  One JSON line per measurement; the card's name and power limit
first.

Usage: python3 scripts/compare_torch_kernels.py [--base DIR]
           [--probe | --wide | --narrow | --wide-k1 | --narrow-k1 | --k3-e32-draws N]
           (one GPU)
"""

from __future__ import annotations

import argparse
import collections
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
    "no_softmax": [("#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    float mx",
                    "#pragma unroll\n  for (int h = 0; h < 0; ++h) {\n    float mx")],
    "no_exp": [("        x = expf(x - mx);", "        x = x - mx;")],
    "no_cvt": [("  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
                "  return *reinterpret_cast<const uint32_t*>(&v);",
                "  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);"),
               ("  return __bfloat162float(__float2bfloat16_rn(x));",
                "  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);")],
    "div": [("const float inv = rcp(quad_sum(sum));", "const float sum_q = quad_sum(sum);"),
            ("for (int i = 0; i < 2; ++i) s[j][2 * h + i] *= inv;",
             "for (int i = 0; i < 2; ++i) s[j][2 * h + i] /= sum_q;")],
}
# --wide's variants of this tree's K3 at E >= 32 (packed_level_wgmma_kernel).
# Design steps taken back, computing K3 and checked as the versions are:
# k3w_wg2, two warpgroups a block at every width; k3w_att_scalar, att's B
# fragments read a lane at a time (no att_k order); k3w_e32_g<G>b<M>, E =
# 32's block at G warpgroups with its register cap set for M blocks an SM
# (timed at E = 32 only; this tree's is g3b1 on one sequence tile, g2b1
# past it).  Probes that
# only split the time (wrong scores): k3w_empty, the weights filled and no
# tile; k3w_loads_only, the tiles' loads and stores without the per-query
# part or the weight products; k3w_no_attention, without the per-query
# part (att zero, no sequence read); k3w_no_wgmma, without the weight
# products (h zero).
K3W_GROUPS = ("    kOneTile && (E == 32 || E == 96 || E == 128 && sizeof(Row) == 2) || "
              "E == 64 && !kOneTile\n        ? 3\n        : 2;")
K3W_MIN_BLOCKS = "constexpr int kWgMinBlocks = E <= 16 && kOneTile ? 2 : 1;"
# the warpgroup kernel's bias load (K1's direct kernel loads b2 alike)
K3W_BIAS2 = ("  const float* bw = reinterpret_cast<const float*>(w + 3 * wg_matrix_bytes<E>());\n"
             "  const float bias2 = __ldg(b2);\n")
K3W_ATTENTION = ("    tile_attention<kOneTile, E>(acc, a_item, seq_e + (size_t)b * L * E, "
                 "pad + (size_t)b * L, L,\n                                g, t);")
K3W_PRODUCTS = "    wg_products<E>(h, ae, a_item, w);"
K3W_NO_PRODUCTS = ("    zero(h);\n    h[0][0] = __uint_as_float(ae[0][0] ^ ae[kK - 1][3] ^ "
                   "a_item[0][0] ^ a_item[kK - 1][3]);")
WIDE_PROBES = {
    "k3w_wg2": [(K3W_GROUPS, "    2;")],
    "k3w_att_scalar": [
        ("        const float* p = att_w + n * E + kc / 2 * 16 + kc % 2;\n#pragma unroll\n"
         "        for (int q = 0; q < 8; ++q) v[q] = __ldg(p + 2 * q);",
         "        for (int q = 0; q < 8; ++q) v[q] = __ldg(att_w + n * E + 8 * kc + q);"),
        ("#pragma unroll\n    for (int s = 0; s < Dims<E>::kK; ++s) {\n"
         "      const float2 a = at(l0, s), b = at(l0 + 1, s), "
         "c = at(l0 + 8, s), d = at(l0 + 9, s);\n"
         "      f.at[2 * s] = make_uint2(bf16x2(a.x, b.x), bf16x2(c.x, d.x));\n"
         "      f.at[2 * s + 1] = make_uint2(bf16x2(a.y, b.y), bf16x2(c.y, d.y));\n    }",
         "    const auto at1 = [&](int l, int n) { return l < L ? __ldg(seq + l * E + n) : 0.f; };"
         "\n#pragma unroll\n    for (int j = 0; j < Dims<E>::kN; ++j) {\n"
         "      const int n = 8 * j + g;\n"
         "      f.at[j] = make_uint2(bf16x2(at1(l0, n), at1(l0 + 1, n)), "
         "bf16x2(at1(l0 + 8, n), at1(l0 + 9, n)));\n    }")],
    "k3w_empty": [(K3W_BIAS2, K3W_BIAS2 + "  if (B > 0) return;\n")],
    "k3w_loads_only": [(K3W_ATTENTION, "    zero(acc);"), (K3W_PRODUCTS, K3W_NO_PRODUCTS)],
    "k3w_no_attention": [(K3W_ATTENTION, "    zero(acc);")],
    "k3w_no_wgmma": [(K3W_PRODUCTS, K3W_NO_PRODUCTS)],
    **{f"k3w_e32_g{gr}b{mb}": [
        (K3W_GROUPS, f"    E == 32 ? {gr} :{K3W_GROUPS[3:]}"),
        (K3W_MIN_BLOCKS, K3W_MIN_BLOCKS.replace(" = E <= 16", f" = E == 32 ? {mb} : E <= 16"))]
       for gr, mb in ((2, 1), (2, 2), (3, 1), (3, 2), (2, 3), (4, 1), (4, 2), (2, 4))},
}
# the design steps among them, held to K3's tolerance like the versions
WIDE_CHECKED = ("k3w_wg2", "k3w_att_scalar",
                *(p for p in WIDE_PROBES if p.startswith("k3w_e32_")))
# --narrow's variants of this tree's K3 at E = 8 and 16 (the row walk).
# Design steps taken back, computing K3 and checked as the versions are:
# k3n_g2b4, two warpgroups a block and four blocks an SM on one tile (this
# tree's is g4b2); k3n_tiles_in_order, a row's tiles walked in block order,
# not its halves alternating; k3n_ahead_always and k3n_ahead_never, the
# next tile's items, flags and digits loaded ahead at every row length or
# at none (this tree's from kRowAheadFrom tiles on); k3n_keep0, past one
# tile no scores kept from the softmax's first pass to its second;
# k3n_no_seq_cache, past one tile no fragments kept in shared memory;
# k3n_seq_per_tile, one tile's sequence fragments read again for every
# m16 tile; k3n_tile_walk, the walk of E >= 32 (four consecutive m16
# tiles a warpgroup).  Probes that split the time (wrong scores):
# k3n_empty, the weights filled and no tile; k3n_loads_only, k3n_no_attention
# and k3n_no_wgmma, as --wide's.
K3N_GROUPS = "    E <= 16 ? 4 :"
K3N_ATTENTION = ("      if constexpr (kOneTile)\n"
                 "        tile_attention_loaded<E>(acc, items[0], f);\n"
                 "      else\n"
                 "        tiles_attention<E, 2>(  // L > 16: two tiles or more")
K3N_PRODUCTS = "      wg_products<E>(h, ae, items[0], w);"
K3N_NO_PRODUCTS = ("      zero(h);\n      h[0][0] = __uint_as_float(ae[0][0] ^ ae[kK - 1][3] ^ "
                   "items[0][0][0] ^ items[0][kK - 1][3]);")
# the attention call of the row walk skipped: its first line becomes a
# zeroing and the call a discarded lambda pair
K3N_NO_ATTENTION = [(K3N_ATTENTION, "      zero(acc);\n      if constexpr (false)\n"
                                    "        tiles_attention<E, 2>(")]
NARROW_PROBES = {
    "k3n_g2b4": [(K3N_GROUPS, "    E <= 16 ? 2 :"),
                 (K3W_MIN_BLOCKS, K3W_MIN_BLOCKS.replace("? 2 : 1", "? 4 : 1"))],
    "k3n_tiles_in_order": [("  return k >= T ? T : k & 1 ? (T + 1) / 2 + k / 2 : k / 2;",
                            "  return k >= T ? T : k;")],
    "k3n_ahead_always": [("constexpr int kRowAheadFrom = 5;", "constexpr int kRowAheadFrom = 1;")],
    "k3n_ahead_never": [("constexpr int kRowAheadFrom = 5;",
                         "constexpr int kRowAheadFrom = 1 << 30;")],
    "k3n_keep0": [("        tiles_attention<E, 2>(  // L > 16: two tiles or more",
                   "        tiles_attention<E, 0>(")],
    "k3n_no_seq_cache": [("constexpr int kSeqCacheTiles = 4;", "constexpr int kSeqCacheTiles = 0;")],
    "k3n_seq_per_tile": [("        tile_attention_loaded<E>(acc, items[0], f);",
                          "        tile_attention<true, E>(acc, items[0], seq, pd, L, g, t);")],
    "k3n_tile_walk": [("constexpr bool kRowWalk = E <= 16;", "constexpr bool kRowWalk = false;")],
    "k3n_empty": WIDE_PROBES["k3w_empty"],
    "k3n_loads_only": K3N_NO_ATTENTION + [(K3N_PRODUCTS, K3N_NO_PRODUCTS)],
    "k3n_no_attention": K3N_NO_ATTENTION,
    "k3n_no_wgmma": [(K3N_PRODUCTS, K3N_NO_PRODUCTS)],
}
NARROW_CHECKED = tuple(p for p in NARROW_PROBES if p not in (
    "k3n_empty", "k3n_loads_only", "k3n_no_attention", "k3n_no_wgmma"))
# --wide-k1's probes: this tree's wide K1 with a pass taken out
WIDE_K1_PROBES = {
    "k1w_empty": [("  constexpr int kW = wide_weight_floats<E>(), R = kWideRow<E>, NB",
                   "  if (N > 0) return;\n"
                   "  constexpr int kW = wide_weight_floats<E>(), R = kWideRow<E>, NB")],
    "k1w_attention_only": [("      wide_product<E>(sA + buf",
                            "      if (N < 0) wide_product<E>(sA + buf")],
    "k1w_product_only": [("      wide_attention<E>(sA + buf",
                          "      if (N < 0) wide_attention<E>(sA + buf")],
    # the product without its splits (each operand's bits as both parts)
    "k1w_no_split": [("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                      "  small = __float_as_uint(x - __uint_as_float(big));",
                      "  big = small = __float_as_uint(x);")],
    # the product with two mma a k-step, not three (small(A) . big(B) left out)
    "k1w_two_mma": [("for (int o = 0; o < NT; ++o) mma_tf32(acc[i][o], as[i], bb[o][0], bb[o][1]);",
                     "for (int o = 0; o < NT; ++o) {}")],
    # the attention pass's candidates through L1, its exponentials by
    # __expf, its score sums without shuffles (the last two not K1's
    # arithmetic: they only split the attention pass's time)
    "k1w_ldg_items": [("      it[v] = __ldcs(reinterpret_cast<const float4*>(item_e",
                       "      it[v] = __ldg(reinterpret_cast<const float4*>(item_e")],
    "k1w_fast_exp": [("      const float a = expf(mx - m);", "      const float a = __expf(mx - m);"),
                     ("        const float p = expf(x[i] - m);",
                      "        const float p = __expf(x[i] - m);")],
    "k1w_no_shfl": [("        d += __shfl_xor_sync(0xffffffffu, d, 1);\n"
                     "        d += __shfl_xor_sync(0xffffffffu, d, 2);\n"
                     "        d += __shfl_xor_sync(0xffffffffu, d, 4);\n"
                     "        x[i] = l0 + i >= L",
                     "        x[i] = l0 + i >= L")],
    # eight attention warps beside the four product warps (384 threads)
    "k1w_12warps": [("constexpr int kWideThreads = 256;", "constexpr int kWideThreads = 384;")],
    # five positions at once in the attention pass (two spans at L = 10)
    "k1w_span5": [("constexpr int kWideSpan = 4;", "constexpr int kWideSpan = 5;")],
    # eight positions at once in the attention pass, not four
    "k1w_span8": [("constexpr int kWideSpan = 4;", "constexpr int kWideSpan = 8;")],
    # four buffers of [item | att] where they fit (E <= 96)
    "k1w_buffers4": [("constexpr int kWideBuffers = 2;",
                      "constexpr int kWideBuffers = E <= 96 ? 4 : 2;")],
    # h's partial sums restarted every 32 k, not 16 (half the adds)
    "k1w_chunk32": [("constexpr int kWideChunk = 16;", "constexpr int kWideChunk = 32;")],
}
# --wide-k1's K1 cases: (E, batch, candidates a row, L)
WIDE_K1_CASES = [(e, b, u, l) for e in (64, 96, 128)
                 for b, u, l in ((B, 2 * BEAM, L), (cs.SWEEP_ROWS, cs.SWEEP_U, L),
                                 (B, 2 * BEAM, 24))]
# --narrow-k1's K1 cases: E = 8 and 32 at the serving shape [4096, 40], the
# JTM sweep's [8192, 4] and [4096, 40] at L = 24 (past the unrolled kernels'
# L = 10)
NARROW_K1_CASES = [(e, b, u, l) for e in cs.WIDTHS
                   for b, u, l in ((B, 2 * BEAM, L), (cs.SWEEP_ROWS, cs.SWEEP_U, L),
                                   (B, 2 * BEAM, 24))]
# --narrow-k1's split of the base's K1 (din_score_kernel, the folded plan E
# = 8 and 32 had at every shape): PROBES' edits applied to the base's source (this
# tree's without --base), each library labelled "base_<probe>"
FOLD_PROBES = ("k1_empty", "k1_loads_only", "k1_no_ctx", "k1_stage_only")
K1W_MIN_BLOCKS = "constexpr int kK1WideMinBlocks = E == 32 ? 4 :"
# --narrow-k1's variants of this tree.  Design steps taken back or varied,
# computing K1 and checked as the versions are: k1n_e32_wide_all, E = 32 on
# the wide kernel at every U (L <= 10 too); k1n_e32_wide_b3, the wide
# kernel's register cap at E = 32 set for three blocks an SM, not four
# (five and six spill).  Probes that only split the time (wrong scores):
# k1n_direct_empty, a return at the direct kernel's start;
# k1n_direct_loads, its loads and B, no arithmetic; and --wide-k1's
# k1w_empty, k1w_attention_only and k1w_product_only on the wide kernel
# (E = 32 at U <= L or L > 10).
NARROW_K1_PROBES = {
    "k1n_e32_wide_all": [("constexpr bool kWideK1 = E >= 64;", "constexpr bool kWideK1 = E >= 32;")],
    "k1n_e32_wide_b3": [(K1W_MIN_BLOCKS, K1W_MIN_BLOCKS.replace("? 4 :", "? 3 :"))],
    "k1n_direct_empty": [("  __shared__ alignas(16) float sB[E * R];\n",
                          "  __shared__ alignas(16) float sB[E * R];\n  if (N > 0) return;\n")],
    "k1n_direct_loads": [("out[n] = direct_score<E, S>(it, q, pd, sB, R) + bias2;",
                          "out[n] = it[0].x + q[S - 1][V - 1].w + pd[S - 1] + sB[t % (E * R)];")],
    **{k: WIDE_K1_PROBES[k] for k in ("k1w_empty", "k1w_attention_only", "k1w_product_only")},
}
NARROW_K1_CHECKED = tuple(p for p in NARROW_K1_PROBES if p.startswith("k1n_e32_"))
# --k3-e32-draws: chip_smoke.k3_wide_cases's widest beam (one launch from E =
# 32 on) and the |logit| bands the largest errors are read in
K3_DRAW_PAST, K3_DRAW_BANDS = (256, 1000), (0.0, 1.0, 2.0, 5.0, 10.0, float("inf"))
# --wide's and --narrow's K3 cases: (E, row dtype, batch, beam, L)
WIDE_CASES = [(e, dt, B, beam, l) for e in (32, *cs.WIDE) for dt in (torch.float32, torch.bfloat16)
              for beam, l in ((20, 10), (110, 10), (20, 24))]
NARROW_CASES = [(e, dt, B, beam, l) for e in (8, 16) for dt in (torch.float32, torch.bfloat16)
                for beam, l in ((20, 10), (110, 10), (20, 24))]


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
    if n_ptr == 10:
        lib.din_score_scratch_floats.argtypes = [ctypes.c_int]
    lib.din_score_f32.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for fn in (lib.write_rows_f32, lib.add_rows_f32):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
    return lib


def sass(label: str) -> dict[str, list[str]]:
    """Each kernel's SASS instructions, addresses and constants masked and
    its branch labels numbered from 0 (cuobjdump numbers them across the
    whole library, so one kernel's branches shift every later kernel's),
    keyed by its mangled name from the kernel's own name on (nvcc names a
    file's anonymous namespace after the file)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(OUT / label / "lib.so")], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        ins = [re.sub(r"0x[0-9a-f]+", "X", ln.split("*/", 1)[1].split(";")[0]).strip()
               for ln in body.splitlines() if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
        labels: dict[str, str] = {}
        m = re.search(r"(din_score_kernel|din_score_direct_kernel|"
                      r"din_score_wide_kernel|din_prologue_kernel|"
                      r"packed_level_wgmma_kernel|write_kernel|dr_rerank_kernel)\w*", name)
        out[m[0] if m else name.strip()] = [re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
            m[0], f".L_{len(labels)}"), i) for i in ins]
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


def wide(libs: dict, cases: list, probes: dict, checked: tuple) -> None:
    """--wide and --narrow: K3 at ``cases`` for each library, the versions
    and the design steps (``checked``) checked (K3's tolerance against its
    plain version, digits and the dead mask bit for bit; each one's scores
    counted where they differ from the first version's), then timed: the
    versions in turns (each, then the same in reverse), warm and cold, the
    variants (``probes``) warm after."""
    from dismember_tpu_torch.ops import packed_level_kernel as plk

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(64 << 20, device=dev)
    g = torch.Generator().manual_seed(cs.SEED + 8)
    versions = [v for v in ("base", "new") if v in libs]
    for e, dt, b, beam, l in cases:
        variants = [v for v in libs if v in probes
                    and (e == 32 or not v.startswith("k3w_e32_"))]
        weights = tuple(t.detach() for t in params_from_numpy(
            cs.seed_params(7, np.random.default_rng(cs.SEED + 40 + e), e), device=dev)
            .scorer_weights())
        rows, alive = cs.k3_rows(g, b, beam, dev, dt, e)
        seq_e, pad = cs.seq_inputs(g, b, l, dev, e)
        ps, ph = plk.packed_level_plain(rows, alive, seq_e, pad, *weights, e)
        live = ps > cs.NEG_INF / 2
        alive_f = alive.float()
        case = {"e": e, "rows": "bf16" if dt == torch.bfloat16 else "f32",
                "shape": [b, beam, rows.shape[2], l, e]}
        launches, outs = {}, {}
        for label in versions + variants:
            sc = torch.empty(b, 2 * beam, device=dev)
            hl = torch.empty(b, 2 * beam, plk.ID_DIGITS[dt], dtype=dt, device=dev)
            lib = libs[label]
            fn = lib.packed_level_bf16_bf16rows if dt == torch.bfloat16 else lib.packed_level_bf16
            args = [t.data_ptr() for t in (rows, alive_f, seq_e, pad, *weights, sc, hl)]
            launches[label] = (lambda fn=fn, args=args: _cuda.check_launch(
                "packed_level", fn(*args, b, beam, rows.shape[2], l, e, stream)))
            launches[label]()
            torch.cuda.synchronize()
            if label in versions or label in checked:
                cs.check(torch.equal(cs.bits(hl), cs.bits(ph)), f"{label}: id lanes differ")
                cs.check(torch.equal(sc > cs.NEG_INF / 2, live)
                         and bool((sc[~live] == ps[~live]).all()), f"{label}: dead mask differs")
                a = cs.agreement("packed_level", sc[live], ps[live], e)
                cs.check(a["ok"], f"{label}: K3 at {case} against its plain version: {a}")
                outs[label] = sc
                cs.emit({"kernel": "packed_level", "version": label, "check": a, **case})
        first = outs[versions[0]]
        case["bitwise_equal_to_" + versions[0]] = {k: torch.equal(o, first)
                                                   for k, o in outs.items()}
        case["differing_scores"] = {k: int((cs.bits(o) != cs.bits(first)).sum())
                                    for k, o in outs.items()}
        for label in versions + versions[::-1]:
            cs.emit({"kernel": "packed_level", "version": label, **case,
                     **cs.time_ms(launches[label]),
                     **cs.time_ms(launches[label], "cold_", flush=flush)})
        for label in variants:
            cs.emit({"kernel": "packed_level", "version": label, **case,
                     **cs.time_ms(launches[label])})
        by, op = cs.k3_bound(b, beam, l, e, dt)
        cs.emit({"bound": "packed_level", **case, "bound_ms": by, "bound_by": op})
        del rows, alive, seq_e, pad, ps, ph, outs, launches


def sass_equal_outside(old: dict, new: dict, redesigned: str = "", widths: tuple = ()) -> bool:
    """Whether every kernel of the base library (K1, K3, K2's write_kernel,
    the write and the add, and the DR rerank) but the redesigned instances
    (``redesigned``, "K1" or "K3", at ``widths``) has the same SASS in the
    new one; the first differing instruction of each that differs is
    printed.  A base kernel that instance_name does not name (a K3 plan
    this tree no longer has) is not compared."""
    groups, diffs = {}, {}
    for name, ins in old.items():
        inst = cs.instance_name(name)
        parts = inst.split() if inst else []
        if redesigned and inst and inst.startswith(redesigned) and int(parts[1][2:]) in widths:
            continue
        group = (inst.split()[0] if inst else "K2" if "write_kernel" in name
                 else "DR" if "dr_rerank_kernel" in name else None)
        if group is None:
            continue
        other = new.get(name)
        groups.setdefault(group, []).append(other == ins)
        if other != ins and other is not None:
            i = next((i for i, (a, b) in enumerate(zip(ins, other)) if a != b),
                     min(len(ins), len(other)))
            diffs[name] = {"at": i, "lengths": [len(ins), len(other)],
                           "base": ins[i:i + 2], "new": other[i:i + 2]}
    same = set(groups) >= {"K1", "K3", "K2"} and all(all(v) for v in groups.values())
    cs.emit({"sass_identical": {g: all(v) for g, v in groups.items()}, "all": same,
             "outside": f"{redesigned} at E = {widths}" if redesigned else "nothing",
             "functions": {g: len(v) for g, v in groups.items()},
             "first_diffs": dict(list(diffs.items())[:4])})
    return same


def wide_k1(libs: dict, cases: list = WIDE_K1_CASES, probes: tuple = tuple(WIDE_K1_PROBES),
            checked: tuple = (), matmul: bool = True) -> None:
    """--wide-k1 and --narrow-k1: K1 at ``cases`` for each library, the
    versions and the variants in ``checked`` checked against its plain
    version, then the versions timed in turns, warm and cold, the variants
    (``probes``) after, warm and cold, and (``matmul``) the product's
    matmul."""
    from dismember_tpu_torch.ops.din_kernel import din_score_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # the matmul yardstick in f32
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(64 << 20, device=dev)
    versions = [v for v in ("base", "new") if v in libs]
    probes = [v for v in libs if v in probes]
    for e, b, u, l in cases:
        g = torch.Generator().manual_seed(cs.SEED + 40 + e)
        weights = tuple(t.detach() for t in params_from_numpy(
            cs.seed_params(7, np.random.default_rng(cs.SEED + 40 + e), e), device=dev)
            .scorer_weights())
        item_e = torch.randn(b, u, e, generator=g) * cs.EMB_STD
        item_e[torch.rand(b, u, generator=g) < 0.1] = 0.0
        item_e = item_e.to(dev)
        seq_e, pad = cs.seq_inputs(g, b, l, dev, e)
        ref = din_score_plain(item_e, seq_e, pad, *weights)
        case = {"e": e, "shape": [b, u, l, e]}
        launches, outs = {}, {}
        for label in versions + probes:
            lib = libs[label]
            out = torch.empty(b, u, device=dev)
            scratch = torch.empty(lib.din_score_scratch_floats(e), device=dev)
            args = [t.data_ptr() for t in (item_e, seq_e, pad, *weights, out, scratch)]
            launches[label] = (lambda lib=lib, args=args: _cuda.check_launch(
                "din_score", lib.din_score_f32(*args, b, u, l, e, stream)))
            launches[label]()
            torch.cuda.synchronize()
            if label in versions or label in checked:
                a = cs.agreement("din_score", out, ref, e)
                cs.check(a["ok"], f"{label}: K1 at {case['shape']} against its plain version: {a}")
                outs[label] = out
                cs.emit({"kernel": "din_score", "version": label, "check": a, **case})
        first = outs[versions[0]]
        case["bitwise_equal_to_" + versions[0]] = {k: torch.equal(o, first)
                                                   for k, o in outs.items()}
        for label in versions + versions[::-1]:
            cs.emit({"kernel": "din_score", "version": label, **case, **cs.time_ms(launches[label]),
                     **cs.time_ms(launches[label], "cold_", flush=flush)})
        for label in probes:
            cs.emit({"kernel": "din_score", "version": label, **case,
                     **cs.time_ms(launches[label]),
                     **cs.time_ms(launches[label], "cold_", flush=flush)})
        if matmul:
            a2 = torch.randn(b * u, 2 * e, device=dev)
            b2 = torch.randn(2 * e, e, device=dev)
            cs.emit({"kernel": "matmul_f32", "version": "torch.matmul [B*U, 2E] @ [2E, E]",
                     **case, **cs.time_ms(lambda: torch.matmul(a2, b2))})
            del a2, b2
        n_bytes = cs.nbytes(item_e, seq_e, pad, *weights, ref)
        by, op = cs.k1_bound(n_bytes, b, u, l, e)
        cs.emit({"bound": "din_score", **case, "bound_ms": by, "bound_by": op,
                 "f32_core_bound_ms": cs.bound(n_bytes, cs.din_folded_flops(b, u, l, e))[0]})
        del item_e, seq_e, pad, ref, launches, outs


def k3_e32_draws(n: int) -> None:
    """--k3-e32-draws: K3 at E = 32 on f32 rows over ``n`` fresh draws a
    weight scale, through its wrapper (beam 1,000 in one launch), against
    its plain version."""
    from dismember_tpu_torch.ops import packed_level_kernel as plk
    from dismember_tpu_torch.ops.din_kernel import din_score

    dev, e = torch.device("cuda", 0), 32
    k1_atol, k1_rtol = cs.TOL["din_score"]
    atol, rtol = cs.TOL["packed_level"]
    for std in (cs.W_STD, cs.W_STD * (16 / e) ** 0.5):
        worst = {"max_abs_err": 0.0, "max_share_beyond_f32_tol": 0.0, "max_err_over_tol": 0.0,
                 "bands": [0.0] * (len(K3_DRAW_BANDS) - 1), "logit_std": [],
                 "control_min_share": 1.0, "fails": 0}
        for d in range(n):
            rng = np.random.default_rng(cs.SEED + 1000 + d)
            params = cs.seed_params(7, rng, e)
            for k, v in (("att_linear", "weight"), ("mlp1", "weight"), ("mlp1", "bias"),
                         ("mlp2", "weight"), ("mlp2", "bias")):
                params[k][v] = (rng.standard_normal(params[k][v].shape) * std).astype(np.float32)
            weights = tuple(t.detach() for t in params_from_numpy(params, device=dev)
                            .scorer_weights())
            g = torch.Generator().manual_seed(cs.SEED + 1000 + d)
            for bb, beam in ((B, BEAM), K3_DRAW_PAST):
                rows, alive = cs.k3_rows(g, bb, beam, dev, torch.float32, e)
                seq_e, pad = cs.seq_inputs(g, bb, L, dev, e)
                ks, _ = plk.packed_level(rows, alive, seq_e, pad, *weights, e)
                ps, _ = plk.packed_level_plain(rows, alive, seq_e, pad, *weights, e)
                live = ps > cs.NEG_INF / 2
                got, ref = ks[live], ps[live]
                err = (got - ref).abs()
                a = cs.agreement("packed_level", got, ref, e)
                worst["fails"] += not a["ok"]
                worst["max_abs_err"] = max(worst["max_abs_err"], a["max_abs_err"])
                worst["max_share_beyond_f32_tol"] = max(worst["max_share_beyond_f32_tol"],
                                                        a["share_beyond_f32_tol"])
                worst["max_err_over_tol"] = max(worst["max_err_over_tol"],
                                                (err / (atol + rtol * ref.abs())).max().item())
                for i, (lo, hi) in enumerate(zip(K3_DRAW_BANDS, K3_DRAW_BANDS[1:])):
                    band = (ref.abs() >= lo) & (ref.abs() < hi)
                    if band.any():
                        worst["bands"][i] = max(worst["bands"][i], err[band].max().item())
                worst["logit_std"].append(ref.std().item())
                if beam == BEAM:  # K1's f32 scorer in K3's place must fail K3's check
                    blk = torch.cat([rows[..., :e], rows[..., e:2 * e]], dim=1).contiguous()
                    c = din_score(blk, seq_e, pad, *weights)[live]
                    share = ((c - ref).abs() > k1_atol + k1_rtol * ref.abs()).float().mean().item()
                    worst["control_min_share"] = min(worst["control_min_share"], share)
                del rows, alive, seq_e, pad, ks, ps
        stds = worst.pop("logit_std")
        cs.emit({"k3_e32_draws": n, "weight_std": std, "shapes": [[B, BEAM, L], [*K3_DRAW_PAST, L]],
                 "tolerance": cs.TOL["packed_level"], "flip_share": cs.FLIP_SHARE[e],
                 "bands": list(zip(K3_DRAW_BANDS, K3_DRAW_BANDS[1:])),
                 "logit_std_mean": float(np.mean(stds)), "logit_std_max": float(np.max(stds)),
                 **worst})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="directory holding another version's *.cu")
    ap.add_argument("--probe", action="store_true", help="time K1 and K3 probe variants too")
    ap.add_argument("--wide", action="store_true",
                    help="time K3 at E = 32, 64, 96 and 128 and its variants instead")
    ap.add_argument("--narrow", action="store_true",
                    help="time K3 at E = 8 and 16 and its variants instead")
    ap.add_argument("--wide-k1", action="store_true",
                    help="time K1 at E = 64, 96 and 128 and its probes instead")
    ap.add_argument("--narrow-k1", action="store_true",
                    help="time K1 at E = 8 and 32, the base's probes and this tree's variants "
                         "instead")
    ap.add_argument("--k3-e32-draws", type=int, metavar="N",
                    help="hold K3 at E = 32 over N fresh draws a weight scale instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_kernels: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    if args.k3_e32_draws:
        _cuda.library()
        k3_e32_draws(args.k3_e32_draws)
        return 0
    new_src = {p.name: p.read_text() for p in _cuda.SOURCES}
    sources = {"new": new_src}
    if args.base:
        sources["base"] = {p.name: p.read_text() for p in sorted(args.base.glob("*.cu"))}
    for name, edits in (PROBES.items() if args.probe else WIDE_PROBES.items() if args.wide
                        else NARROW_PROBES.items() if args.narrow
                        else WIDE_K1_PROBES.items() if args.wide_k1
                        else NARROW_K1_PROBES.items() if args.narrow_k1 else ()):
        text = new_src["din_kernels.cu"]
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"probe {name}: source edit does not apply: {old!r}")
            text = text.replace(old, new)
        sources[name] = {**new_src, "din_kernels.cu": text}
    if args.narrow_k1:
        for name in FOLD_PROBES:
            src = sources.get("base", new_src)
            text = src["din_kernels.cu"]
            for old, new in PROBES[name]:
                if old not in text:
                    raise RuntimeError(f"probe {name}: source edit does not apply to the base: "
                                       f"{old!r}")
                text = text.replace(old, new)
            sources[f"base_{name}"] = {**src, "din_kernels.cu": text}
    procs = {label: build(label, src) for label, src in sources.items()}
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        cs.emit({"ptxas": label, **{k: cs.ptxas_usage(log, f"din_score_kernel{k}")
                                    for k in ("", "ILi16ELi10E", "ILi16ELi0E")},
                 **cs.instance_usage(log)})
    libs = {label: load(label) for label in sources}
    if args.wide or args.narrow:
        widths = (8, 16) if args.narrow else (32, *cs.WIDE)
        tc = {k: v for k, v in cs.mma_counts(OUT / "new" / "lib.so").items()
              if k.startswith("K3") and int(k.split()[1][2:]) in widths}
        cs.emit({"sass_mma": "new", **tc})
        same = sass_equal_outside(sass("base"), sass("new"), "K3", widths) if args.base else True
        if args.narrow:
            wide(libs, NARROW_CASES, NARROW_PROBES, NARROW_CHECKED)
        else:
            wide(libs, WIDE_CASES, WIDE_PROBES, WIDE_CHECKED)
        cs.check(same, f"SASS outside K3 at E = {widths} differs from the base's")
        return 0
    if args.narrow_k1:
        # nothing redesigned in place: the base's K1 instances at E = 8 and
        # 32 (din_score_kernel) stay, and the new kernels are not in the base
        same = sass_equal_outside(sass("base"), sass("new"), "K1", ()) if args.base else True
        wide_k1(libs, NARROW_K1_CASES, (*NARROW_K1_PROBES, *(f"base_{p}" for p in FOLD_PROBES)),
                NARROW_K1_CHECKED, matmul=False)
        cs.check(same, "SASS of a kernel of the base differs from the base's")
        return 0
    if args.wide_k1:
        ops = {}
        for name, ins in sass("new").items():
            m = re.match(r"din_score_wide_kernelILi(\d+)E", name)
            if m:
                ops[m[1]] = dict(collections.Counter(
                    i.split()[i.startswith("@")].split(".")[0] for i in ins if i).most_common())
        cs.emit({"sass_opcodes": "din_score_wide_kernel", **ops})
        same = (sass_equal_outside(sass("base"), sass("new"), "K1", cs.WIDE) if args.base
                else True)
        wide_k1(libs)
        cs.check(same, "SASS outside the wide K1 differs from the base's")
        return 0

    same = sass_equal_outside(sass("base"), sass("new")) if args.base else True

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
    cs.check(same, "SASS of a kernel both libraries have differs from the base's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
