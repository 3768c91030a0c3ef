#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dismember_tpu_torch``) on one GPU.

Phases, one JSON line each; any failed check raises and fails the run:
  1. environment: CUDA required; the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
  2. build: the kernels of ``dismember_tpu_torch/csrc`` with nvcc for sm_90a,
     and the port's host library (``csrc/host_ops.cc``) with g++ (a missing
     one fails the run: no Python fallback here);
     ptxas's registers and spills of every K1 and K3 instance (E = 8, 16,
     32, 64, 96 and 128; K3 one-tile and multi-tile over f32 and bf16 rows;
     K1 past E = 32 its wide kernel with its prologue) against its
     register cap (REG_CAPS), and of the row add on an f32 or a bf16 table
     against 64 (past its cap or spilling fails the run), and each K3
     instance's and each wide K1's (E >= 64) tensor-core instructions
     (HMMA and HGMMA) counted in ``cuobjdump -sass`` of the library (none
     fails the run, and so does a K3 instance of the warpgroup plan, all
     but E = 8 on bf16 rows, without HGMMA);
  3. kernels: K1 and K3 against their plain PyTorch versions on the card at
     the serving shapes (batch 4096, beam 20, L=10, E=16; K1 also at
     ``predict``'s one row of every catalog item, at L=24 on the kernel
     for sequences past 10 positions, and at a JTM sweep batch's shapes
     [8192, 4] and [8192, 2]), O(1)-scale inputs and biases, with
     an all-padding row, a ragged last block, dead parents and missing
     children; K3 also at beams 65, 110, 128, 1,000 and 1,500 (one launch
     each) and at L = 17, 24 and 40 (K3_WIDE, k3_wide_cases; beam 110, 1,000
     and L = 24 also on bf16 rows); a control (K1's f32 scorer in K3's
     place) that must fail K3's check; kernel and plain times from CUDA
     events (K1 and K3 both warm in L2, as the serving loop leaves their
     inputs, and cold; K3 also at beam 110 and L = 24); then K1 and K3 at
     E = 8 and 32 (``kernels_at_width``: K1 at [4096, 40], [8192, 4],
     [8192, 2], predict's row and L = 24, K3 at [4096, 20] on f32 and bf16 rows
     with the control at each width, also beam 110, beam 1,000 in one
     launch and L = 24), timed as at E = 16;
  4. example-data serving (the main path): CSV -> windows -> category tree
     -> DIN checkpoint from seeded numpy params -> ``TDMServing.load`` on the
     card -> ``recommend_batch`` of 4096 windows on the packed route (K3) and
     the classic route (K1), ``recommend`` of the heaviest user (210 items
     consumed: beam 110, packed route), and ``predict`` (K1); each route's
     top-10 against the same route with the plain versions on the card,
     ``predict`` on its logits;
  5. deep catalog: a 1M-item synthetic tree (20 levels) built in memory, an
     f32 pair table, ``recommend_batch(4096)``: QPS, K3 launches, ids;
  example_training (after 5): ``TDMTrainer`` at configs/tdm.conf's settings
     on the example catalog (auto route: dense), 200 iterations; loss falls,
     ``evaluate`` on 512 eval windows and ``recommend``, with every K1 call
     held against its plain version at the shape it was given, same-seed
     determinism, and dense/mv/pmv agreement on one sampled batch;
  deep_training: the 1M catalog's trainer (bench.py's, auto route: pmv),
     a warm-up step and 50 timed steps, one K2 launch each, the packed
     state against a rerun with K2's plain version, serving the trained
     table (K3), and 10 timed dense steps at the same catalog for the route
     comparison;
  row_kernels: K2 ``write_rows`` and ``add_rows`` against their plain
     versions bit for bit on tensors taken from the training phases (the
     last pmv commit of the 1M rerun, the same commit cut to its distinct
     rows and with three rows aimed out of range, the last mv table update
     of the example catalog's route comparison) and at the spikes' shapes
     (57,344 unique rows into 640 MB tables of widths 16/32/64/128); kernel,
     plain and library (``index_copy_`` / ``index_add_``) times from CUDA
     events, each after a 256 MB flush, and a bytes bound;
  workflow: the port's CLI in process on the example catalog, from a copy of
     configs/tdm.conf and configs/jtm.conf (``model.iteration_number`` cut
     to 300): tdm-initialize-tree -> tdm-train-deep-model -> tdm-cluster-tree
     -> tdm-train-deep-model on the clustered tree -> jtm-tree-learning, with
     every K1 call of the sweep held against its plain version and every add
     bit for bit; the clustered tree against the same clustering on the CPU;
     the sweep repeated (bitwise-equal projection) and run with both plain
     versions (near ties only); the learned tree served on both routes;
  jtm_deep: a JTM sweep over a 2^19-item catalog (the cut is explained at
     JTM_DEEP_ITEMS) on 2^20 rows with deep_training's model, per level
     score and rebalance seconds and launches, every K1 call and add of its
     one-chain-level step ([8192, 2], the add's 2 columns padded to 4) held
     against the plain versions; tree_cluster on the 1M catalog's leaf
     embeddings, its seconds split into the device 2-means and the rest;
  otm_example: the port's OTM CLI in process from a copy of configs/otm.conf
     (``model.epoch_num`` cut to 1): otm-train-deep-model -> otm-construct-
     tree (every sweep K1 call and add audited; the mapping a bijection onto
     leaves) -> otm-train-deep-model under the learned mapping ->
     ``OTMServing.load`` and ``recommend_batch`` of 4096 windows (K3); then
     ``evaluate`` with every K3 call audited, one batch's frozen forwards
     with every K1 call audited, three same-seed batches bitwise equal, the
     dense/mv/pmv agreement on one batch, and the ms of a batch, none of
     them in the phase's launch counts (the CLI path's alone);
  otm_deep: OTM at 1M synthetic items (20 levels, 16 level steps a batch of
     256, auto route pmv: 16 K2 launches a batch), a warm-up and 20 timed
     batches, the packed state against a rerun with K2's plain version,
     then ``batch_beam_search`` of 4096 windows (16 K3 levels) timed and
     once more with every K3 call audited;
  dr_example: the port's Deep Retrieval CLI in process from a copy of
     configs/deep-retrieval.conf (``model.epoch_num`` cut to 1):
     dr-train-deep-model -> dr-coordinate-descent -> dr-train-deep-model
     under the learned mapping -> ``DRServing.load`` and 4096 windows on the
     exact (auto), packed and block routes, each top-10 equal to the host
     route's but for score or beam near ties (the block route's lists also
     equal to those of its rerank kernel's plain chain); ``evaluate``; then dense and
     pmv trainers on one repeated batch (losses and params within the
     dense tolerances, the first pmv E-step's three K2 calls audited) and
     timed E-steps of each route; the CLI path (dense) launches no kernel;
     coordinate descent's greedy route, which must be the native select;
  dr_deep: bench.py's DR cells: 1M items served on the block route (auto),
     one rerank kernel launch a batch, ms a 4096-window call, the top-10
     overlap with the exact route on 256 queries and the lists equal to the
     rerank's plain chain's; the E-step at 10M items (auto route pmv, three K2
     launches a step, the first step's calls audited), 2 warm-up and 10
     timed steps, the mirror sync, then K2 on that step's three commits
     against its plain version and timed beside ``index_copy_``;
  dr_rerank: the block rerank kernel (``ops/dr_rerank.py``) at the DR
     serving cell's shape (DR_CELL: 4,162,024 items, 3 layers of 100
     nodes, 2 paths an item, E 16, beam 20, top-10, 8192 rows, 10 consumed
     ids a row): against its plain chain on the card (scores bit for bit,
     ids but for ties at the k-th place), twice equal, timed warm and cold
     beside the plain chain, with its byte bound (the kept paths' items) and
     the bound of reading their whole rows; ptxas's registers of each width's
     instance (no spill allowed);
  tdm_10m: bench.py's 10M-item TDM cell (24 levels): ``train_resident``
     over ``ResidentWindows`` of synthetic users (auto route pmv, one K2
     launch a step), 2 chunks of 16 timed steps, chunk 8 against chunk 16
     bitwise; ``TDMServing`` on the trained model (auto pair-table dtype:
     bf16), ``recommend_batch(4096)`` timed with its levels on K3 over bf16
     rows and audited against the plain level; K3 over a bf16 table against
     K3 over the f32 table of the same bf16-grid embedding on the 1M
     catalog, bit for bit; K3 on bf16 rows against its plain version at the
     serving shape, timed; step resume on the card (example catalog, dense
     and pmv) against an uninterrupted run, bitwise; a bf16 embedding table
     (example catalog, mv) for DIN and for DeepFM, each twice from one
     seed, bitwise, with every bf16 add checked against its plain version,
     one ``add_rows_bf16`` and one K2 launch a step, and the last add timed
     beside ``index_add_``;
  native: the port's host library against the Python forms, host time on
     the card machine's CPU: bench.py's index-learning cell (100k items,
     400k rows, streaming coordinate descent) with the native and the
     Python greedy on one trainer, equal paths, each run's wall and the
     greedy's share; the tree codec (the example catalog's tree and a
     2^17-item synthetic one, native and Python writers byte-equal, both
     readers' arrays equal; the native write and read of the 1M and 10M
     catalogs' trees timed); example_data.csv through both parsers (equal
     fields and interactions); the co-occurrence pass against numpy's
     ``reduceat`` at 200k items x 32, then timed at 1M;
  widths: DIN at E = 32 on the 1M catalog (``recommend_batch(4096)`` on
     the packed route from an f32 and a bf16 pair table, equal lists, every
     K3 level of the f32 route audited, ``predict`` over the catalog; then
     bench.py's trainer at E = 32, pmv, a K2 launch a step), a JTM sweep at
     E = 32 over the example catalog (K1's [8192, 4] batches on its wide
     kernel, every K1 call and add audited) and at E = 8 on
     the example catalog (200 dense steps, ``evaluate`` and ``recommend``
     with every K1 call audited, the same serving as at E = 32);
  deepfm: configs/tdm.conf and jtm.conf with ``model.deep_model DeepFM``
     through the CLI (iterations cut as in workflow): init -> train ->
     cluster -> retrain -> jtm-tree-learning (adds audited), then
     ``TDMServing.load`` on the packed and the classic route, lists equal
     up to near ties; configs/otm.conf with DeepFM (epoch cut as in
     otm_example): train -> construct -> retrain -> ``OTMServing``; DeepFM
     at 1M items (pmv, every K2 commit of the audited steps bit for bit,
     the packed route on the f32 table, timed), then on a bf16 embedding
     table (auto route mv: every K2 commit and bf16 add of the audited
     steps bit for bit, one of each a step; served on the packed route
     over an f32 pair table against the classic route up to near ties,
     timed; the commit and the add timed warm and cold beside
     ``index_copy_`` / ``index_add_``); no K1 or K3 launch;
  reference_recall: ROADMAP item 5's check, scripts/sparse_quality_check.py's
     protocol (tdm.conf's trainer, 2000 dense iterations, E = 16, category
     tree, the whole eval split) for DIN and DeepFM at seeds 0-2: each
     model's mean recall@10 within RECALL_BAND of the JAX package's
     (JAX_RECALL, measured on the CPU);
  wide: K1 and K3 at E = 64, 96 and 128 (scripts/quality_push.py's
     widths; weights' std scaled as w_std says) against their plain
     versions, uncounted: K1 at [4096, 40], [8192, 4], [8192, 2], predict's
     row and [4096, 40] at L = 24, K3 on f32 and bf16 rows at [4096, 20]
     with the f32-scorer control failing, beam 110, L = 24 and beam 1,000
     in one launch (kernels_at_width); then, counted, the recipe through
     scripts/quality_push_torch.py at each width (WIDE_ITERS iterations a
     stage: category tree -> re-cluster -> retrain -> JTM -> retrain, every
     K1 call audited), the learned tree served on the packed route from f32
     and bf16 pair tables (K3 audited, lists up to near ties), the 1M
     catalog served at E = 64 and 128 from both tables, and item 5's
     protocol at E = 64 (stage 1 of e64x6k, 2000 dense steps, seeds 0-2)
     within RECALL_BAND of the JAX package's mean (JAX_RECALL_E64);
  mesh: the multi-device paths (``core/mesh.py``, ``train/spmd*.py``).
     (a) In this process, world size 1 over nccl, mesh (1, 1): bench.py's
     1M trainer with ``mesh=`` (the sharded mv route; its model keeps no
     table beside the shard) against the single-device mv route from the
     same weights on the same negatives, bit for bit (the first step's K2
     commit and add audited), then a
     warm-up and MESH_STEPS timed steps of each; ``make_sharded_tree_
     serving_fn`` on 4096 windows over the 1M catalog's f32 pair table
     (16 K3 levels, timed), lists equal to ``TDMServing``'s packed route,
     one batch again with every K3 level audited.  (b) Two ranks spawned
     on the one card over gloo (nccl refuses two ranks on one card; gloo
     stages CUDA buffers through host memory), meshes (1, 2) and (2, 1):
     the sharded mv step on the example catalog against the single-device
     mv route on the shards' own negatives (bit for bit at (1, 2), within
     the dense tolerances at (2, 1); the first step's K2 commit and add
     audited on each rank), sharded packed serving on the 1M catalog
     (lists equal to ``TDMServing``'s), a mesh JTM sweep on the example
     catalog (every K1 call on the rank's score rows and every add
     audited; projection equal to the single-device sweep's) and,
     at (1, 2), ``DRTrainer(mesh=)``'s E-step bit for bit against the
     single-device pmv E-step with its three K2 commits audited, and the
     step snapshots of a (1, 2) mv trainer: a run killed after a snapshot
     and resumed equals the uninterrupted one bit for bit, and rank 0's
     snapshot equals the single-device trainer's at the same step.  Each
     rank's launches, ms a step and a serving batch, the transport;
  trace (after every timed phase, so that whatever the profiler leaves
     behind reaches no other number): one more 1M ``recommend_batch
     (4096)`` inside ``core.profiling.trace(chiprun_out/trace_torch)``,
     whose Chrome trace must name K3's kernel; the batch and the host's
     launch rate timed just before and just after it;
  6. the ``{"kernels": [...]}`` summary: every instance, E = 8, 32, 64, 96
     and 128 among them;
  7. last line ``{"ok": true, "device": {...}}``.

Times are medians (with p10/p90, min/max) of one pair of CUDA events
around each of 100 calls; a pair around an empty launch reads ~5 us on an
H100, which every such time includes.

Usage: python3 chip_smoke.py   (from the repo root or anywhere; one GPU)
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from dismember_tpu_torch.cli.main import main as cli_main  # noqa: E402
from dismember_tpu_torch.core.checkpoint import (  # noqa: E402
    flatten,
    load_meta,
    load_pytree,
    save_pytree,
)
from dismember_tpu_torch.core import mesh as meshlib, multihost  # noqa: E402
from dismember_tpu_torch.core import profiling  # noqa: E402
from dismember_tpu_torch.data import native as host  # noqa: E402
from dismember_tpu_torch.data.dr_dataset import DRData, build_dr_data  # noqa: E402
from dismember_tpu_torch.data.ingest import (  # noqa: E402
    read_csv,
    unique_items_with_category,
    user_interactions,
)
from dismember_tpu_torch.data.otm_dataset import OTMData, load_mapping, upper_log2  # noqa: E402
from dismember_tpu_torch.data.tdm_dataset import (  # noqa: E402
    generate_split_samples,
    read_train_file,
)
from dismember_tpu_torch.index import cluster  # noqa: E402
from dismember_tpu_torch.index.arraytree import ArrayTree  # noqa: E402
from dismember_tpu_torch.index.cluster import read_embeddings_csv, tree_cluster  # noqa: E402
from dismember_tpu_torch.index.paths import PathIndex  # noqa: E402
from dismember_tpu_torch.index.tree_io import (  # noqa: E402
    build_tree,
    category_sorted_codes,
    read_tree,
    sink_leaf_codes,
    write_tree,
)
from dismember_tpu_torch.models import din as din_model  # noqa: E402
from dismember_tpu_torch.models.din import DIN, params_from_numpy  # noqa: E402
from dismember_tpu_torch.models import dr_models  # noqa: E402
from dismember_tpu_torch.models.dr_models import rerank_user_vector  # noqa: E402
from dismember_tpu_torch.models.embedding import embed_lookup  # noqa: E402
from dismember_tpu_torch.ops import (  # noqa: E402
    _cuda,
    din_kernel,
    dr_rerank,
    packed_level_kernel,
    row_writer,
)
from dismember_tpu_torch.ops.din_kernel import (  # noqa: E402
    KERNEL_WIDTHS,
    din_score,
    din_score_plain,
)
from dismember_tpu_torch.ops.packed_level_kernel import (  # noqa: E402
    NEG_INF,
    packed_level,
    packed_level_plain,
    pair_row_width,
)
from dismember_tpu_torch.retrieval.packed_beam import (  # noqa: E402
    PackedTree,
    beam_search_packed,
    make_packed_beam_fn,
    make_packed_tree,
)
from dismember_tpu_torch.retrieval.dr_serve import (  # noqa: E402
    DevicePathMap,
    make_dr_serving_fn,
)
from dismember_tpu_torch.retrieval.path_beam import path_beam_search  # noqa: E402
from dismember_tpu_torch.retrieval.tree_beam import (  # noqa: E402
    filter_topk,
    make_beam_fn,
    make_config,
)
from dismember_tpu_torch.serving import DRServing, OTMServing, TDMServing  # noqa: E402
from dismember_tpu_torch.train import multiproc, spmd, spmd_sparse  # noqa: E402
from dismember_tpu_torch.train import otm as otm_train  # noqa: E402
from dismember_tpu_torch.train import sparse_adam  # noqa: E402
from dismember_tpu_torch.train.dr import DRTrainer  # noqa: E402
from dismember_tpu_torch.train.dr_coordinate import coordinate_descent  # noqa: E402
from dismember_tpu_torch.train.jtm import TreeLearner  # noqa: E402
from dismember_tpu_torch.train.otm import OTMTrainer  # noqa: E402
from dismember_tpu_torch.train.tdm import (  # noqa: E402
    ResidentWindows,
    TDMTrainer,
    build_model,
    packed_fns,
    serving_fns,
)
import quality_push_torch  # noqa: E402  (scripts/)

SEED = 0
BATCH, BEAM, TOPK, SEQ_LEN, E = 4096, 20, 10, 10, 16  # configs/tdm.conf, bench.py
DEEP_ITEMS = 1_000_000
# weights and embeddings at O(1) scale (embeddings N(0, 1), weights and
# biases N(0, 0.5)): logits of a few units and a softmax far from uniform,
# so a kernel that dropped a scale, a bias or a rounding would show.  Past E
# = 16 the weights' std scales as sqrt(16 / E) (w_std: 0.354, 0.25, 0.204 and
# 0.177 at E = 32, 64, 96 and 128), so the E-deep sums keep E = 16's scale
# (logit std ~3 at E = 128).  At E = 32 and std 0.5 K3's check (below) is
# marginal: over 100 fresh draws of [4096, 20] and beam 1,000 on an H100
# (NVIDIA H100 80GB HBM3, 700 W; scripts/compare_torch_kernels.py
# --k3-e32-draws) 8 of 200 calls failed it, largest error 0.212 (1.37x the
# tolerance), K3's errors growing with the logits' scale (std 8.4); at
# 0.354 none failed, largest 0.089 (0.53x), logit std 3.4.  Past E = 32, at
# 0.5 they grow with E (logit std ~54 at E = 128), and
# even at sqrt(32 / E) (~8) the f32 plain version itself misses its float64
# value by more than K1's tolerance on a few candidates near a zero logit
# at E = 128 (din_score_plain in float32 against float64 on the CPU), a
# tolerance no f32 kernel could then hold; at sqrt(16 / E) none does.
EMB_STD, W_STD = 1.0, 0.5
# Every candidate: |kernel - plain| <= ATOL + RTOL*|plain|.  K1 is f32
# throughout and differs from its plain version only in summation order.  K3
# rounds the same operands to bf16 as its plain version; a last-bit
# difference before one of its rounding points moves that operand by one
# bf16 ulp on a few candidates, and at most FLIP_SHARE[E] of K3's candidates
# may lie beyond K1's tolerance.  On an H100 (NVIDIA H100 80GB HBM3, 700 W)
# K3's largest error over ~3.5M audited candidates at E = 16 was 0.044 and
# its share beyond K1's tolerance at most 6.7e-5; K3's bound is about twice
# that error.  E = 32 rounds twice as many operands a candidate (K = 32 and
# 64 products): its share reached 8.6e-4 at L = 24 (E = 8: 1.3e-4) on the
# same H100, so its share is held to 5e-3.  Past E = 32 (w_std's weights)
# the share grows with the roundings a candidate: at most 1.5e-3 at E = 64,
# 2.9e-3 at 96 and 4.7e-3 at 128 over every K3 check and audit of a probe of
# the wide phase on the same H100, held to 5e-3, 1e-2 and 1e-2.  K1's
# f32 scorer in K3's place puts 96-97% of candidates beyond K1's tolerance at
# every width (phase 3's and the wide phase's controls), so it fails.
TOL = {"din_score": (1e-5, 2e-4), "packed_level": (1e-1, 1e-2)}
FLIP_SHARE = {8: 1e-3, 16: 1e-3, 32: 5e-3, 64: 5e-3, 96: 1e-2, 128: 1e-2}
# the H100 SXM's published peaks (NVIDIA H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_MMA_FLOP_PER_S = 989e12  # dense
# f32-accurate products on the tensor cores: 3xTF32 (three TF32 products a
# product, K1's split at E >= 64) at a third of the dense TF32 rate
TF32X3_FLOP_PER_S = 495e12 / 3
SLEEP_CYCLES = 10_000_000  # ~5 ms at the H100's clock: time_ms's head start
OUT = ROOT / "build" / "chip_smoke"
# configs/tdm.conf's trainer settings
TDM_CONF = dict(embed_size=E, learning_rate=1e-4, total_batch_size=8192,
                total_eval_batch_size=8192, seq_len=SEQ_LEN, topk=TOPK, beam_size=BEAM,
                layer_neg_counts="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200")
# tests/test_tdm_train.py:178's dense-vs-sparse tolerances
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-4, 2e-6
TRAIN_ITERS, DEEP_STEPS, DENSE_STEPS = 200, 50, 10
SPIKE_ROWS, SPIKE_TABLE_FLOATS = 57_344, 10_000_000 * 16  # scripts/spike_pallas_scatter*.py
# the workflow phase runs configs/tdm.conf and configs/jtm.conf as they are
# but for this one cut (2000 and 1000 in the files)
WORKFLOW_ITERS = 300
SWEEP_ROWS, SWEEP_U = 8192, 4  # a JTM sweep batch: score_batch_rows, 2^gap candidates
JTM_DEEP_ROWS = 1 << 20  # synthetic (window, target) rows of the deep sweep
# The deep sweep's catalog, cut from DEEP_ITEMS: the greedy rebalance is a
# host loop over every item of an over-capacity segment, and a model's
# argmax overfills segments at every level, so a level costs ~14 us of host
# time an item (13.7 on an H100 machine's host at 2^19 items: jtm_deep's
# rebalance_us_per_item_level); at 1M items the ten levels would take ~140 s
# against the phase's ~90 s.  2^19 (~76 s) is the largest power of two that
# fits.  The clustering runs on the whole 1M catalog.
JTM_DEEP_ITEMS = 1 << 19
# configs/otm.conf's cut for the otm_example phase: one epoch (5 in the file)
OTM_EPOCHS = 1
# the otm_deep phase (scripts/bench_otm_deep.py's shapes): rows a batch,
# timed batches after one warm-up, labels a row
OTM_DEEP_BATCH, OTM_DEEP_BATCHES, OTM_LABELS = 256, 20, 5
# configs/deep-retrieval.conf's trainer settings; the dr_example phase runs
# the file as it is but for model.epoch_num, cut to DR_EPOCHS (5 in the file)
DR_CONF = dict(num_layers=3, num_nodes=100, num_paths_per_item=2, embed_size=E,
               learning_rate=3e-3, train_batch_size=8192, eval_batch_size=8192, num_sampled=1,
               topk=TOPK, beam_size=BEAM, seq_len=SEQ_LEN)
DR_EPOCHS = 1
# the DR serving cell's shape (benchmark/configs/dr_ub4m.json and its
# traffic): the block rerank kernel's case
DR_CELL = dict(items=4_162_024, num_nodes=100, depth=3, j=2, e=16, beam=20, k=10, rows=8192,
               consumed=10)
# dr_example's pmv trainer: steps on one repeated batch (where lazy and dense
# Adam agree), then timed batches of the pmv and dense routes
DR_PMV_STEPS, DR_TIMED_BATCHES = 3, 10
# A served top-10 may differ from the host route's only on near ties: every
# item of the difference scores (in f32, on the host) within
# NEAR_TIE[route] * (|w|.|u| + |b|) of the host list's last score, for both
# items; bf16 rounds each operand by at most 2^-9, so 2^-7 holds the routes
# that round w, b and u.  The block route also takes its beam from bf16
# sequence embeddings, so a window may also differ by a beam near tie
# (dr_block_beam_ties).
NEAR_TIE = {"exact": 2.0**-20, "packed": 2.0**-7, "block": 2.0**-7}
# the dr_deep phase: bench.py's DR configuration (bench.py:253-330), the
# serving catalog, the E-step catalog, negatives a row, the E-step's untimed
# and timed steps, the queries of the block-against-exact agreement and its
# least share
DR_SERVE_ITEMS, DR_TRAIN_ITEMS, DR_SAMPLED = 1_000_000, 10_000_000, 8
DR_WARMUP_STEPS, DR_TIMED_STEPS, DR_SERVE_CALLS = 2, 10, 10
DR_AGREE_QUERIES, DR_MIN_AGREEMENT = 256, 0.95
# K3 past the serving shape at E = 16, checked beside k3_wide_cases (beam
# 110, timed; 1,000; L = 24, timed): (batch, beam, L).  Beams 65, 128 and
# 1,500 (one launch at any beam); L = 17 and 40 take two and three
# sequence tiles.
K3_WIDE = ((1024, 65, SEQ_LEN), (1024, 128, SEQ_LEN), (256, 1500, SEQ_LEN),
           (1024, BEAM, 17), (1024, BEAM, 40))
# the tdm_10m phase: bench.py's 10M-item catalog (_deep_tree, _deep_trainer);
# ResidentWindows over synthetic users of RES_STREAM items each, targets at
# positions [RES_T_LO, RES_STREAM): 3M windows, a 16 MB upload; the timed
# run's chunks; the example catalog's resume (iterations, snapshot period,
# the killed run's length) and bf16-table runs
TDM_10M_ITEMS = 10_000_000
RES_USERS, RES_STREAM, RES_T_LO = 100_000, 40, 10
RES_CHUNK, RES_CHUNKS, RES_TWIN_CHUNK = 16, 2, 8
RESUME_ITERS, RESUME_EVERY, RESUME_KILLED_AT = 40, 10, 25
BF16_ITERS = 30
# the widths K1 and K3 are built for beside E (8: the JAX package's kernel
# and beam tests; 32: scripts/quality_1m.py's; 64, 96 and 128:
# scripts/quality_push.py's, the wide phase's), the widths with K1's wide
# kernel (E = 32 where U <= L or L > 10, past it at every U), and the
# registers a thread of each instance may use (their launch bounds): K1 64
# at E = 8 and 16, 128 at E = 32 (its wide kernel 64: four blocks of 256
# threads an SM);
# K1's direct kernel at E = 8 128 (it holds a candidate's L sequence rows
# in registers); the wide K1 128 at E = 64 (two blocks of 256 threads an
# SM) and 255 past it (one block an SM, by its shared memory: 135 and 211
# KB at E = 96 and 128); K3 on one sequence tile 64 at E = 8 and 16 (two
# blocks of four warpgroups an SM), past one tile 255 there; K3 168 where a
# block holds three warpgroups (one sequence tile at E = 32, 96 and, on
# bf16 rows, 128; more at E = 64), else 255 (two warpgroups a block); a key
# with the row type overrides one without
WIDTHS = (8, 32)
WIDE = (64, 96, 128)
K1_WIDE = (32, *WIDE)
REG_CAPS = {("K1", 8): 64, ("K1", 16): 64, ("K1", 32): 128, ("K1", 8, "direct"): 128,
            ("K1", 64): 128, ("K1", 96): 255, ("K1", 128): 255,
            **{("one-tile", e): 64 if e <= 16 else 168 if e in (32, 96) else 255
               for e in (8, 16, 32, *WIDE)},
            ("one-tile", 128, "bf16"): 168,
            **{("tiles", e): 168 if e == 64 else 255 for e in (8, 16, 32, *WIDE)}}
WIDTH_STEPS = 10  # the E = 32 trainer's timed pmv steps at 1M items
# the deepfm phase's 1M trainer: timed pmv steps, then steps whose every K2
# commit is audited; the relative score gap a near tie between DeepFM's
# routes may have (both score in f32 plain ops, in another candidate order)
DEEPFM_STEPS, DEEPFM_AUDITED_STEPS, DEEPFM_NEAR_TIE = 20, 5, 1e-5
# ROADMAP item 5's check (scripts/sparse_quality_check.py's protocol): the
# JAX package's mean recall@10 over seeds 0, 1 and 2 on the CPU (its
# TDMTrainer, dense, 2000 iterations, E = 16, the whole eval split: DIN
# 0.008608, 0.009702, 0.016661; DeepFM 0.014503, 0.015472, 0.015484; from
# scripts/jax_reference_recall.py), and the seed band of BASELINE.md:151
JAX_RECALL = {"din": 0.011657156652161813, "deepfm": 0.015153125451413693}
RECALL_BAND, RECALL_SEEDS, RECALL_ITERS = 0.003, (0, 1, 2), 2000
# the wide phase: (c) each wide width's recipe (scripts/quality_push_torch.py,
# scripts/quality_push.py's e64x6k, e96x6k and e128x6k), its 6000 iterations
# a stage cut to WIDE_ITERS; (d) 1M-item serving at WIDE_DEEP; (e) item 5's
# protocol at E = 64: stage 1 of e64x6k (category tree, lr 3e-3, batch 8192,
# the conf's negatives, dense) cut to RECALL_ITERS, seeds 0-2, against the
# JAX package's mean on the CPU (0.018326, 0.018747, 0.019742;
# scripts/jax_reference_recall.py --embed 64 --lr 3e-3 --models din)
WIDE_RECIPES = {64: "e64x6k", 96: "e96x6k", 128: "e128x6k"}
WIDE_ITERS, WIDE_DEEP = 300, (64, 128)
JAX_RECALL_E64 = 0.018937993223878267
# the mesh phase: (a) bench.py's 1M trainer on a (1, 1) mesh over nccl,
# steps on the same negatives as the single-device mv route (the first
# audited), then timed steps; sharded serving calls a measurement; (b) the
# sharded mv steps on the example catalog and the DR E-steps timed on the
# two gloo ranks; the two ranks' time limit
MESH_PARITY_STEPS, MESH_STEPS, MESH_SERVE_CALLS = 3, 20, 3
MESH_EXAMPLE_STEPS, MESH_DR_STEPS, MESH_TIMEOUT_S = 5, 5, 600
# (b)'s step snapshots: a (1, 2) mv run on the example catalog killed after
# its snapshot at MESH_SNAP_EVERY steps and resumed
MESH_SNAP_ITERS, MESH_SNAP_KILL, MESH_SNAP_EVERY = 12, 9, 6
# the native phase: bench.py's index-learning cell (bench.py:387-405: 100k
# items, 400k rows, 20 candidate paths, batch 8192, streaming); a synthetic
# 2^17-item tree for the codec's byte check; the co-occurrence pass at
# scripts/cooc_recall_200k.py's 200k items x 32 (held to the JAX package's
# test's rtol 1e-4, atol 1e-5: sequential against pairwise sums), then
# timed at 1M items, on uniform edges, 16 an item
CD_ITEMS, CD_ROWS, CD_CANDIDATES = 100_000, 400_000, 20
CODEC_ITEMS = 1 << 17
COOC_ITEMS, COOC_TIMED_ITEMS, COOC_DIM, COOC_EDGES_PER_ITEM = 200_000, 1_000_000, 32, 16
COOC_RTOL, COOC_ATOL = 1e-4, 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def w_std(e: int) -> float:
    """The std of the scorer's weights at width ``e``: W_STD up to E = 16,
    W_STD * sqrt(16 / e) past it."""
    return W_STD if e <= 16 else W_STD * (16 / e) ** 0.5


def seed_params(num_index: int, rng: np.random.Generator, e: int = E) -> dict:
    """DIN params pytree of width ``e`` from numpy at O(1) scale (EMB_STD,
    w_std(e))."""
    f = lambda std, *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    w = w_std(e)
    return {
        "embedding": f(EMB_STD, num_index, e),
        "att_linear": {"weight": f(w, e, e)},
        "mlp1": {"weight": f(w, e, 2 * e), "bias": f(w, e)},
        "mlp2": {"weight": f(w, 1, e), "bias": f(w, 1)},
    }


def agreement(name: str, got: torch.Tensor, ref: torch.Tensor, e: int = E) -> dict:
    """``name``'s check of kernel outputs ``got`` against plain ``ref`` at
    embedding width ``e``."""
    atol, rtol = TOL[name]
    err = (got - ref).abs()
    ok = bool((err <= atol + rtol * ref.abs()).all())
    out = {"max_abs_err": err.max().item()}
    if name == "packed_level":
        f32_atol, f32_rtol = TOL["din_score"]
        share = (err > f32_atol + f32_rtol * ref.abs()).float().mean().item()
        ok = ok and share <= FLIP_SHARE[e]
        out["share_beyond_f32_tol"] = share
    return {"ok": ok, **out}


def within(name: str, got: torch.Tensor, ref: torch.Tensor, e: int = E) -> dict:
    a = agreement(name, got, ref, e)
    check(a["ok"], f"{name}: kernel against plain version out of tolerance: {a}")
    return a


def time_ms(fn, prefix: str = "", iters: int = 100, warmup: int = 5,
            flush: torch.Tensor | None = None) -> dict:
    """Per-call times from a pair of CUDA events around each of ``iters``
    calls: ``{prefix}ms`` is the median, ``{prefix}ms_p10``/``_p90``/``_min``
    /``_max`` the spread.  Without ``flush`` a sleep kernel queued first lets
    the host enqueue ahead of the card, so each pair brackets one call on a
    busy stream, its inputs warm in L2 as the previous call left them; with
    ``flush`` (a buffer larger than the 50 MB L2) the buffer is rewritten
    before each call, so each finds L2 cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    if flush is None:
        torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in pairs:
        if flush is not None:
            flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    t = np.array([a.elapsed_time(b) for a, b in pairs])
    stats = {"": np.median(t), "_p10": np.percentile(t, 10), "_p90": np.percentile(t, 90),
             "_min": t.min(), "_max": t.max()}
    return {f"{prefix}ms{k}": float(v) for k, v in stats.items()}


def bound(bytes_moved: int, f32_flops: int = 0, mma_flops: int = 0,
          tf32x3_flops: int = 0) -> tuple[float, str]:
    """The least time in ms for moving ``bytes_moved`` through HBM and doing
    ``f32_flops`` on the CUDA cores, ``mma_flops`` on the bf16 tensor cores
    and ``tf32x3_flops`` f32-accurate on the tensor cores (3xTF32), and
    which of bytes and operations sets it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = (f32_flops / F32_FLOP_PER_S + mma_flops / BF16_MMA_FLOP_PER_S
             + tf32x3_flops / TF32X3_FLOP_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def din_flops(n_candidates: int, l: int, e: int) -> tuple[int, int]:
    """Operations of DIN scores as (matmul, rest): the matmuls are scores
    2LE + probs.seq 2LE + att Linear 2E^2 + mlp1 4E^2 + mlp2 2E; the rest is
    the scale L + softmax 4L + bias/ReLU 2E + the last bias 1."""
    return (n_candidates * (4 * l * e + 6 * e * e + 2 * e),
            n_candidates * (5 * l + 2 * e + 1))


def din_folded_flops(b: int, u: int, l: int, e: int) -> int:
    """Operations of K1's folded DIN scores over [b, u] candidates: M =
    w1[:, E:] @ att_w once (2E^3) and ctx_l = M . seq_l per query row
    (2LE^2); per candidate the scores 2LE and their padding terms 2L, the
    softmax 4L, sum_l x_l ctx_l 2LE, w1[:, :E] . item 2E^2, h's reciprocal
    term, bias and ReLU 4E, w2 2E and the last bias 1."""
    return (2 * e**3 + b * 2 * l * e * e
            + b * u * (4 * l * e + 6 * l + 2 * e * e + 6 * e + 1))


def k1_flops(b: int, u: int, l: int, e: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """K1's operations over [b, u] candidates in its two orders, each as
    (products, rest): folded (din_folded_flops: M once, ctx_l = M . seq_l a
    query row, per candidate the scores, sum_l x_l ctx_l and w1[:, :E] .
    item) and unfolded (M once, per candidate the scores 2LE, att = sum_l
    p_l seq_l 2LE and h = [item | att] . [w1[:, :E] | M]^T 4E^2).  The rest
    is the same in both: padding and scale 2L, softmax 4L, att's
    normalisation, bias and ReLU 4E, w2 2E and the last bias 1.  Both
    compute the same function; the fold is less work when U > L."""
    rest = b * u * (6 * l + 6 * e + 1)
    folded = 2 * e**3 + b * 2 * l * e * e + b * u * (4 * l * e + 2 * e * e)
    unfolded = 2 * e**3 + b * u * (4 * l * e + 4 * e * e)
    return (folded, rest), (unfolded, rest)


def k1_bound(n_bytes: int, b: int, u: int, l: int, e: int) -> tuple[float, str]:
    """K1's bound over [b, u] candidates moving ``n_bytes``: its products
    f32-accurate on the tensor cores (TF32X3_FLOP_PER_S), the rest at the
    f32 rate, in whichever order (k1_flops) takes less time."""
    return min((bound(n_bytes, f32_flops=rest, tf32x3_flops=mm)
                for mm, rest in k1_flops(b, u, l, e)), key=lambda t: t[0])


def k3_bound(b: int, beam: int, l: int, e: int,
             row_dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """K3's bound on [b, beam] pair rows: of each row the lanes it needs
    (f32 rows: 2E+6 = 38 lanes; bf16 rows: 2E+10 = 42 lanes of 2 bytes),
    the alive mask, the sequence tiles and padding, the weights, its f32
    scores and its id digits (2 f32 or 4 bf16 a candidate); its matmuls at
    the bf16 tensor-core rate (their operands are bf16), the rest at the
    f32 rate."""
    u = 2 * beam
    k = packed_level_kernel.ID_DIGITS[row_dtype]
    lane = torch.tensor([], dtype=row_dtype).element_size()
    n_bytes = (lane * (b * beam * (2 * e + 2 + 2 * k) + b * u * k)
               + 4 * (b * beam + b * l * e + b * l + 3 * e * e + 2 * e + 1 + b * u))
    mm, rest = din_flops(b * u, l, e)
    return bound(n_bytes, f32_flops=rest, mma_flops=mm)


def row_bound(idx: torch.Tensor, n_table_rows: int, width: int,
              add: bool, elem_bytes: int = 4) -> tuple[int, float, str]:
    """(rows written, bound ms, bound_by) of a row write or add: the indices,
    one payload row per distinct destination in [0, n_table_rows) (repeats
    carry equal payloads, dropped rows are never read), each destination
    written once and, by the add, read once more; the add does one f32 add
    per lane of each destination."""
    kept = idx[(idx >= 0) & (idx < n_table_rows)]
    written = int(torch.unique(kept).numel())
    row_b = elem_bytes * width
    by, op = bound(nbytes(idx) + written * row_b * (3 if add else 2),
                   f32_flops=written * width if add else 0)
    return written, by, op


def ptxas_usage(log: str, kernel: str) -> dict:
    """Registers and spill bytes (stores + loads) that ``nvcc -Xptxas=-v``
    reported for the entry functions whose name holds ``kernel``."""
    out, name = {"registers": 0, "spill_bytes": 0}, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif kernel in name and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out["spill_bytes"] += nums[1] + nums[2]  # stack, stores, loads
        elif kernel in name and "registers" in ln:
            regs = int(ln.split("Used ")[1].split()[0])
            out["registers"] = max(out["registers"], regs)
    return out


def instance_name(mangled: str) -> str | None:
    """The K1 or K3 instance a mangled kernel name belongs to: "K1 E=16"
    (every L of a width together; at E >= 32 the wide kernel and its
    prologue with it), "K1 E=8 direct" (the direct kernel), "K3 E=32 bf16
    one-tile", ...; None for other kernels."""
    m = re.search(r"din_score_(direct_)?kernelILi(\d+)ELi\d+EE|"
                  r"din_(?:score_wide|prologue)_kernelILi(\d+)EE", mangled)
    if m:
        return f"K1 E={m[2] or m[3]}" + (" direct" if m[1] else "")
    m = re.search(r"packed_level_wgmma_kernelILb([01])E(f|13__nv_bfloat16)Li(\d+)EE", mangled)
    if m:
        return (f"K3 E={m[3]} {'f32' if m[2] == 'f' else 'bf16'} "
                f"{'one-tile' if m[1] == '1' else 'tiles'}")
    return None


def instance_usage(log: str) -> dict:
    """Registers (the most) and spill bytes (summed) that ``nvcc
    -Xptxas=-v`` reported for each K1 and K3 instance (instance_name)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = instance_name(ln)
            if name:
                out.setdefault(name, {"registers": 0, "spill_bytes": 0})
        elif name and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[name]["spill_bytes"] += nums[1] + nums[2]  # stack, stores, loads
        elif name and "registers" in ln:
            regs = int(ln.split("Used ")[1].split()[0])
            out[name]["registers"] = max(out[name]["registers"], regs)
    return out


def reg_cap(instance: str) -> int:
    """REG_CAPS of an instance_name."""
    parts = instance.split()
    if parts[0] == "K1":
        return REG_CAPS["K1", int(parts[1][2:]), *parts[2:]]
    key = (parts[-1], int(parts[1][2:]))
    return REG_CAPS.get((*key, parts[2]), REG_CAPS[key])


def mma_counts(lib_path: Path) -> dict:
    """Tensor-core instructions in each kernel's SASS in the built library,
    from ``cuobjdump -sass``: {"HMMA": n, "HGMMA": n} (mma.sync's, and
    Hopper's warpgroup wgmma's) keyed by K1's and K3's instance names and the
    other kernels' plain names."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        mangled, body = part.split("\n", 1)
        name = instance_name(mangled) or next(
            (k for k in ("write_kernel",) if k in mangled), mangled.strip())
        n = out.setdefault(name, {"HMMA": 0, "HGMMA": 0})
        n["HMMA"] += body.count("HMMA")
        n["HGMMA"] += body.count("HGMMA")
    return out


def tensor_core_gate(counts: dict) -> list[str]:
    """The instances that fail the build's tensor-core gate (mma_counts):
    every K1 with the wide kernel (K1_WIDE, its h product in 3xTF32) must
    hold HMMA or HGMMA, and every K3 instance (the warpgroup plan, at every
    width and row type) HGMMA (its weight products on wgmma)."""
    expected = {f"K3 E={e} {r} {t}" for e in KERNEL_WIDTHS for r in ("f32", "bf16")
                for t in ("one-tile", "tiles")} | {f"K1 E={e}" for e in K1_WIDE}
    none = {"HMMA": 0, "HGMMA": 0}
    return sorted(n for n in expected
                  if not sum(counts.get(n, none).values())
                  or n.startswith("K3") and not counts.get(n, none)["HGMMA"])


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- phase 3
def kernels_vs_plain(dev, weights, n_items: int) -> dict:
    g = torch.Generator().manual_seed(SEED + 1)
    b, u, l = BATCH, 2 * BEAM, SEQ_LEN
    seq_e = torch.randn(b, l, E, generator=g) * EMB_STD
    pad = (torch.rand(b, l, generator=g) < 0.3).float()
    pad[0] = 1.0  # an all-padding row
    seq_e[pad > 0] = 0.0
    seq_e, pad = seq_e.to(dev), pad.to(dev)
    results = {}

    # K1: 4096 rows of 40 candidates; 128 // 40 = 3 rows a block, so the
    # last block is ragged (4096 = 3 * 1365 + 1); 10% invalid (zero) rows
    item_e = torch.randn(b, u, E, generator=g) * EMB_STD
    item_e[torch.rand(b, u, generator=g) < 0.1] = 0.0
    item_e = item_e.to(dev)
    k1 = din_score(item_e, seq_e, pad, *weights)
    p1 = din_score_plain(item_e, seq_e, pad, *weights)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k1).all()), "din_score: non-finite output")
    agree1 = within("din_score", k1, p1)
    # predict's shape: one row of every catalog item, wider than a block
    # (one row a block, in blockIdx.y chunks of 128 candidates); checked,
    # not timed
    wide = torch.randn(1, n_items, E, generator=g).to(dev) * EMB_STD
    ctx = (seq_e[2:3].contiguous(), pad[2:3].contiguous())
    agree_wide = within("din_score", din_score(wide, *ctx, *weights),
                        din_score_plain(wide, *ctx, *weights))
    # sequences of 24 positions: the chunked kernel, six chunks of 4 each
    # rescaling the running sums; checked, not timed
    seq24 = torch.randn(b, 24, E, generator=g) * EMB_STD
    pad24 = (torch.rand(b, 24, generator=g) < 0.3).float()
    pad24[0] = 1.0
    seq24[pad24 > 0] = 0.0
    seq24, pad24 = seq24.to(dev), pad24.to(dev)
    agree24 = within("din_score", din_score(item_e, seq24, pad24, *weights),
                     din_score_plain(item_e, seq24, pad24, *weights))
    del seq24, pad24
    # warm: the inputs lie in L2 as on the serving path, whose gather has
    # just written them; cold: after a 256 MB flush
    flush = torch.empty(64 << 20, device=dev)
    results["din_score"] = dict(
        **agree1, **k1_times(item_e, seq_e, pad, weights, flush),
        # the direct formula's operations, K1's bound before the fold
        bound_direct_ms=bound(nbytes(item_e, seq_e, pad, *weights, k1),
                              sum(din_flops(b * u, l, E)))[0],
        shape=[b, u, l, E],
        wide={**agree_wide, "shape": list(wide.shape)},
        l24={**agree24, "shape": [b, u, 24, E]},
    )
    # K1 at a JTM sweep batch's shape: 8192 training rows, each scoring its
    # item's 4 chain candidates (gap 2), checked and timed as above
    sb, su = SWEEP_ROWS, SWEEP_U
    s_item = (torch.randn(sb, su, E, generator=g) * EMB_STD).to(dev)
    s_seq = torch.randn(sb, l, E, generator=g) * EMB_STD
    s_pad = (torch.rand(sb, l, generator=g) < 0.3).float()
    s_seq[s_pad > 0] = 0.0
    s_seq, s_pad = s_seq.to(dev), s_pad.to(dev)
    agree_s = within("din_score", din_score(s_item, s_seq, s_pad, *weights),
                     din_score_plain(s_item, s_seq, s_pad, *weights))
    results["din_score"]["sweep"] = dict(
        **agree_s, **k1_times(s_item, s_seq, s_pad, weights, flush), shape=[sb, su, l, E])
    # the sweep's step of one chain level (an odd max_level): 2 candidates a
    # row, another block plan; checked, not timed
    s2 = s_item[:, :2].contiguous()
    results["din_score"]["sweep_u2"] = dict(
        **within("din_score", din_score(s2, s_seq, s_pad, *weights),
                 din_score_plain(s2, s_seq, s_pad, *weights)),
        shape=[sb, 2, l, E])
    del s_item, s_seq, s_pad, s2

    # K3: 4096 rows x 20 parents of 128-lane pair rows; 15% missing
    # children, 10% dead parents and one row with every parent dead
    rows, alive = k3_rows(g, b, BEAM, dev)
    ks, _, ps, agree3 = k3_check(rows, alive, seq_e, pad, weights)
    # control: K1's f32 scorer on the same candidates (block order) must
    # fail K3's check, or the check cannot tell a K3 that skips its roundings
    live = ps > NEG_INF / 2
    blk = torch.cat([rows[..., :E], rows[..., E : 2 * E]], dim=1).contiguous()
    control = agreement("packed_level", din_score(blk, seq_e, pad, *weights)[live], ps[live])
    check(not control["ok"], f"control: an f32 scorer passes K3's check: {control}")
    # warm: the serving loop's gather has just written the rows; cold: after
    # the flush
    results["packed_level"] = dict(
        **agree3, **k3_times(rows, alive, seq_e, pad, weights, flush),
        shape=[b, BEAM, rows.shape[2], l, E], control_f32_scorer=control,
    )
    del rows, alive, ks, ps, blk
    # K3 at wider beams (each in one launch) and longer sequences
    # (16-position tiles), each against its plain version; k3_wide_cases on
    # both row types (beam 110 and L = 24 also timed)
    wide = {}
    for bb, beam, ll in K3_WIDE:
        rows, alive = k3_rows(g, bb, beam, dev)
        s_e, s_pad = seq_inputs(g, bb, ll, dev)
        n0 = packed_level_kernel.launches
        agree = k3_check(rows, alive, s_e, s_pad, weights)[3]
        wide[f"beam{beam}_l{ll}"] = dict(**agree, shape=[bb, beam, rows.shape[2], ll, E],
                                         launches=packed_level_kernel.launches - n0)
        del rows, alive, s_e, s_pad
    check(wide["beam1500_l10"]["launches"] == 1, f"beam 1500 takes more than one launch: {wide}")
    results["packed_level"]["wide"] = {
        **wide, **k3_wide_cases(dev, g, E, torch.float32, weights, flush)["wide"]}
    results["packed_level_bf16_rows"] = k3_wide_cases(dev, g, E, torch.bfloat16, weights, flush)
    del flush
    torch.cuda.synchronize()
    return results


def seq_inputs(g: torch.Generator, b: int, l: int, dev,
               e: int = E) -> tuple[torch.Tensor, torch.Tensor]:
    """[b, l, e] sequence embeddings with 30% padding (zero rows) and one
    all-padding row, and the padding mask."""
    seq_e = torch.randn(b, l, e, generator=g) * EMB_STD
    pad = (torch.rand(b, l, generator=g) < 0.3).float()
    pad[0] = 1.0
    seq_e[pad > 0] = 0.0
    return seq_e.to(dev), pad.to(dev)


def k3_rows(g: torch.Generator, b: int, beam: int, dev, dtype: torch.dtype = torch.float32,
            e: int = E) -> tuple[torch.Tensor, torch.Tensor]:
    """[b, beam] pair rows of width ``e`` (``pair_row_width`` lanes: 128
    up to E = 32; 15% missing children, random id digits: 2 base-4096
    digits a child in f32 rows, 4 base-256 in bf16 rows) and their parents'
    alive mask (10% dead, row 1 all dead)."""
    k = packed_level_kernel.ID_DIGITS[dtype]
    base = 4096 if dtype == torch.float32 else 256
    rows = torch.zeros(b, beam, pair_row_width(e, dtype))
    rows[..., : 2 * e] = torch.randn(b, beam, 2 * e, generator=g) * EMB_STD
    rows[..., 2 * e : 2 * e + 2] = (torch.rand(b, beam, 2, generator=g) < 0.85).float()
    if k == 2:
        used = 2 * e + 6
        rows[..., 2 * e + 2 : used : 2] = torch.randint(0, 256, (b, beam, 2), generator=g).float()
        rows[..., 2 * e + 3 : used : 2] = torch.randint(0, base, (b, beam, 2), generator=g).float()
    else:
        for side in range(2):
            lo = 2 * e + 2 + k * side
            rows[..., lo] = torch.randint(0, 128, (b, beam), generator=g).float()  # top digit
            rows[..., lo + 1 : lo + k] = torch.randint(0, base, (b, beam, k - 1),
                                                       generator=g).float()
    alive = torch.rand(b, beam, generator=g) < 0.9
    alive[1] = False
    return rows.to(dtype).to(dev), alive.to(dev)


def k3_check(rows, alive, seq_e, pad, weights, e: int = E) -> tuple[torch.Tensor, ...]:
    """K3 through its wrapper against its plain version at width ``e``: id
    lanes bit for bit, the dead mask and dead scores equal, live scores
    within K3's tolerance.  Returns (kernel scores, kernel ids, plain
    scores, agreement)."""
    ks, kh = packed_level(rows, alive, seq_e, pad, *weights, e)
    ps, ph = packed_level_plain(rows, alive, seq_e, pad, *weights, e)
    torch.cuda.synchronize()
    check(kh.dtype == rows.dtype and torch.equal(bits(kh), bits(ph)),
          "packed_level: id lanes not bit-exact")
    live = ps > NEG_INF / 2
    check(torch.equal(ks > NEG_INF / 2, live), "packed_level: dead mask differs")
    check(bool((ks[~live] == ps[~live]).all()), "packed_level: dead scores differ")
    return ks, kh, ps, within("packed_level", ks[live], ps[live], e)


def k1_times(item_e, seq_e, pad, weights, flush) -> dict:
    """The raw K1 launch warm and cold, its plain version, and the bound
    (k1_bound; ``f32_core_bound_ms``: the folded operations all on the CUDA
    cores, K1's earlier bound), at the inputs' width."""
    b, u, e = item_e.shape
    l = seq_e.shape[1]
    out = torch.empty(b, u, device=item_e.device)
    scratch = _cuda.din_scratch(e, item_e.device)
    lib, stream = _cuda.library(), _cuda.stream_handle(item_e.device)
    args = [t.data_ptr() for t in (item_e, seq_e, pad, *weights, out)]
    args.append(None if scratch is None else scratch.data_ptr())
    launch = lambda: _cuda.check_launch("din_score", lib.din_score_f32(  # noqa: E731
        *args, b, u, l, e, stream))
    n_bytes = nbytes(item_e, seq_e, pad, *weights, out)
    by, op = k1_bound(n_bytes, b, u, l, e)
    return dict(**time_ms(launch), **time_ms(launch, "cold_", flush=flush),
                **time_ms(lambda: din_score_plain(item_e, seq_e, pad, *weights), "plain_"),
                bound_ms=by, bound_by=op,
                f32_core_bound_ms=bound(n_bytes, din_folded_flops(b, u, l, e))[0])


def k3_times(rows, alive, seq_e, pad, weights, flush, e: int = E) -> dict:
    """The raw K3 launch warm and cold, the plain version, and the bound, at
    width ``e``."""
    b, beam, rw = rows.shape
    l = seq_e.shape[1]
    alive_f = alive.float()
    sc = torch.empty(b, 2 * beam, device=rows.device)
    hl = torch.empty(b, 2 * beam, packed_level_kernel.ID_DIGITS[rows.dtype], dtype=rows.dtype,
                     device=rows.device)
    lib, stream = _cuda.library(), _cuda.stream_handle(rows.device)
    fn = lib.packed_level_bf16_bf16rows if rows.dtype == torch.bfloat16 else lib.packed_level_bf16
    args = [t.data_ptr() for t in (rows, alive_f, seq_e, pad, *weights, sc, hl)]
    launch = lambda: _cuda.check_launch("packed_level", fn(  # noqa: E731
        *args, b, beam, rw, l, e, stream))
    by, op = k3_bound(b, beam, l, e, rows.dtype)
    return dict(**time_ms(launch), **time_ms(launch, "cold_", flush=flush),
                **time_ms(lambda: packed_level_plain(rows, alive, seq_e, pad, *weights, e),
                          "plain_"),
                bound_ms=by, bound_by=op)


# ---------------------------------------------------------------- phase 4
class NearTieAudit:
    """Replays a route with the kernel and its plain version scoring the same
    candidates at every level.  Each kernel score must lie within the
    kernel's tolerance of the plain one; then wherever the two would choose
    differently (the next level's top-beam, the final top-k), the plain
    scores of the two choices differ by at most twice that: a near tie."""

    def __init__(self, name: str, n_levels: int, beam: int = BEAM, e: int = E):
        self.name, self.n_levels, self.beam, self.e = name, n_levels, beam, e
        self.level, self.max_err, self.max_share = 0, 0.0, 0.0
        self.max_gap, self.near_ties = 0.0, 0

    def record(self, ks: torch.Tensor, ps: torch.Tensor, live: torch.Tensor) -> None:
        a = within(self.name, ks[live], ps[live], self.e)
        self.max_err = max(self.max_err, a["max_abs_err"])
        self.max_share = max(self.max_share, a.get("share_beyond_f32_tol", 0.0))
        self.level += 1
        k = TOPK if self.level == self.n_levels else self.beam
        ks, ps = torch.where(live, ks, NEG_INF), torch.where(live, ps, NEG_INF)
        chosen = torch.gather(ps, 1, torch.topk(ks, k, dim=1).indices)
        gap = (torch.topk(ps, k, dim=1).values - chosen).abs()
        # both choices lie within this level's error of the plain scores
        limit = 2 * a["max_abs_err"] + 1e-6 * (1 + ps[live].abs().max().item())
        check(bool((gap <= limit).all()),
              f"{self.name}: a choice differs beyond a near tie ({gap.max().item():.3e})")
        self.max_gap = max(self.max_gap, gap.max().item())
        self.near_ties += int((gap > 0).any(dim=1).sum())

    def summary(self) -> dict:
        check(self.level == self.n_levels, f"{self.name}: audited {self.level} levels")
        return {"levels": self.level, "max_abs_err": self.max_err,
                "max_share_beyond_f32_tol": self.max_share, "max_choice_gap": self.max_gap,
                "row_levels_with_near_ties": self.near_ties}


def topk_lists(fn, model, codes) -> list:
    ids, scores = fn(model, codes)
    return filter_topk(ids.cpu().numpy(), scores.cpu().numpy(), TOPK)


def compare_lists(got: list, ref: list) -> int:
    """Number of rows whose top-k lists differ."""
    check(len(got) == len(ref), "row count differs")
    return sum(not np.array_equal(a, b) for a, b in zip(got, ref))


def audit_packed(model: DIN, packed: PackedTree, codes, kernel_lists: list) -> dict:
    """The packed route (K3) against the same route with K3's plain version."""
    plain = topk_lists(make_packed_beam_fn(packed, DIN.precompute_seq, packed_level_plain),
                       model, codes)
    audit = NearTieAudit("packed_level", packed.cfg.max_level - packed.cfg.start_level,
                         packed.cfg.beam, packed.embed_size)

    def audited_level(rows, alive, seq_e, pad, *w):
        ks, kh = packed_level(rows, alive, seq_e, pad, *w)
        ps, _ = packed_level_plain(rows, alive, seq_e, pad, *w)
        audit.record(ks, ps, ps > NEG_INF / 2)
        return ks, kh

    audited = topk_lists(make_packed_beam_fn(packed, DIN.precompute_seq, audited_level),
                         model, codes)
    check(compare_lists(audited, kernel_lists) == 0, "packed route is not deterministic")
    return {"rows_differing_from_plain": compare_lists(kernel_lists, plain), **audit.summary()}


def plain_apply(model: DIN, items, ctx):
    return din_score_plain(embed_lookup(model.embedding, items), *ctx, *model.scorer_weights())


def audit_classic(model: DIN, tree: ArrayTree, codes, kernel_lists: list) -> dict:
    """The classic route (K1) against the same route with K1's plain version."""
    plain = topk_lists(make_beam_fn(DIN.forward, tree, BEAM, DIN.precompute_seq,
                                    plain_apply, device=codes.device), model, codes)
    cfg = make_config(tree, BEAM)
    audit = NearTieAudit("din_score", cfg.max_level - cfg.start_level)

    def audited_apply(m, items, ctx):
        item_e = embed_lookup(m.embedding, items)
        ks = din_score(item_e, *ctx, *m.scorer_weights())
        audit.record(ks, din_score_plain(item_e, *ctx, *m.scorer_weights()), items >= 0)
        return ks

    audited = topk_lists(make_beam_fn(DIN.forward, tree, BEAM, DIN.precompute_seq,
                                      audited_apply, device=codes.device), model, codes)
    check(compare_lists(audited, kernel_lists) == 0, "classic route is not deterministic")
    return {"rows_differing_from_plain": compare_lists(kernel_lists, plain), **audit.summary()}


def check_lists(lists: list, tree: ArrayTree) -> None:
    """topk distinct real items in every row."""
    for row in lists:
        check(len(row) == TOPK, f"a row returned {len(row)} items")
        check(len(set(row.tolist())) == len(row), "repeated item in a row")
    check(bool(np.isin(np.concatenate(lists), tree.item_ids).all()),
          "returned id is not an item")


def example_data():
    """The example catalog's tree file, a DIN checkpoint from seeded numpy
    params, 4096 query windows, facts, the train/eval windows and the
    heaviest user's items."""
    raw = read_csv(str(ROOT / "data" / "example_data.csv"))
    samples = generate_split_samples(user_interactions(raw), SEQ_LEN, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sid, codes = category_sorted_codes(ids, cats)
    tree_path = str(OUT / "example_tree.bin")
    write_tree(tree_path, sid, codes, stat=samples.stat)
    n_codes = (1 << (int(np.log2(codes.max() + 1)) + 1)) - 1
    ckpt = str(OUT / "example_din")
    save_pytree(ckpt, seed_params(n_codes, np.random.default_rng(SEED)),
                meta={"model": "din", "embed_size": E, "seq_len": SEQ_LEN})
    # every eval window, then train windows up to the batch
    seqs = np.concatenate([samples.eval_seqs, samples.train_seqs])[:BATCH]
    check(len(seqs) == BATCH, "not enough windows")
    # the user with the most interactions (210): its last window, and all
    # its items as the consumed list, widen recommend's beam to 110
    users = user_interactions(raw)
    heavy = max(users, key=lambda u: len(users[u]))
    return tree_path, ckpt, seqs, {"eval_windows": int(len(samples.eval_seqs)),
                                   "catalog_items": int(len(sid))}, samples, users[heavy]


# ---------------------------------------------------------------- phase 5
def deep_catalog(dev) -> tuple[TDMServing, np.ndarray, dict]:
    """A 1M-item catalog (bench.py's: ids % 97 categories), built in memory."""
    t0 = time.perf_counter()
    ids = np.arange(1, DEEP_ITEMS + 1)
    sid, codes = category_sorted_codes(ids, ids % 97)
    tree = ArrayTree.from_loaded(build_tree(sid, codes))
    pre, app = serving_fns("din")
    _, app_emb = packed_fns("din")
    num_index = (1 << (tree.max_level + 1)) - 1  # train.tdm.build_model's
    model = params_from_numpy(seed_params(num_index, np.random.default_rng(SEED + 2)),
                              device=dev)
    serv = TDMServing(model, DIN.forward, tree, precompute=pre, apply=app,
                      apply_emb=app_emb, model_type="din", topk=TOPK, candidate_num=BEAM)
    rng = np.random.default_rng(SEED + 3)
    seqs = rng.integers(1, DEEP_ITEMS + 1, size=(BATCH, SEQ_LEN))
    seqs[:, :3] = np.where(rng.random((BATCH, 3)) < 0.3, 0, seqs[:, :3])  # padding
    return serv, seqs, {"items": DEEP_ITEMS, "max_level": tree.max_level,
                        "setup_s": time.perf_counter() - t0}


# K3's per-width counters by row dtype, under their instance names
K3_ROWS = {torch.float32: "packed_level", torch.bfloat16: "packed_level_bf16_rows"}


def zero_launches() -> None:
    din_kernel.launches = packed_level_kernel.launches = dr_rerank.launches = 0
    packed_level_kernel.launches_bf16_rows = 0
    din_kernel.launches_by_width.update(dict.fromkeys(din_kernel.launches_by_width, 0))
    packed_level_kernel.launches_by_width.update(
        dict.fromkeys(packed_level_kernel.launches_by_width, 0))
    row_writer.launches.update({k: 0 for k in row_writer.launches})


def read_launches() -> dict:
    """Each kernel instance's count: K1 and K3 at E = 16 under their names
    ("din_score", "packed_level", "packed_level_bf16_rows"), at the other
    widths with the width appended ("din_score_e8", ...), and the row
    kernels'."""
    out = {f"din_score{'' if e == E else f'_e{e}'}": n
           for e, n in din_kernel.launches_by_width.items()}
    out.update({f"{K3_ROWS[dt]}{'' if e == E else f'_e{e}'}": n
                for (e, dt), n in packed_level_kernel.launches_by_width.items()})
    return {**out, **row_writer.launches, "dr_rerank": dr_rerank.launches}


@contextlib.contextmanager
def uncounted():
    """Within the block, kernel launches leave the counts as they were: for
    the calls made only to compare a kernel with its plain version."""
    totals = (din_kernel.launches, packed_level_kernel.launches,
              packed_level_kernel.launches_bf16_rows, dr_rerank.launches)
    widths = (dict(din_kernel.launches_by_width), dict(packed_level_kernel.launches_by_width))
    rows = dict(row_writer.launches)
    try:
        yield
    finally:
        (din_kernel.launches, packed_level_kernel.launches,
         packed_level_kernel.launches_bf16_rows, dr_rerank.launches) = totals
        din_kernel.launches_by_width.update(widths[0])
        packed_level_kernel.launches_by_width.update(widths[1])
        row_writer.launches.update(rows)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


# ---------------------------------------------------------------- row kernels
def row_case(name: str, table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
             flush: torch.Tensor, warm: bool = False) -> dict:
    """``name`` ("write_rows" or "add_rows") against its plain version bit
    for bit on copies of ``table``, then the raw launch's, the plain
    version's and the one-call library version's times on ``table``, each
    from a cold L2 (a step's rows land anywhere in a table far larger than
    L2); ``warm`` adds the raw launch's time warm in L2 (``warm_ms``)."""
    add = name == "add_rows"
    wrapper, plain = ((row_writer.add_rows, row_writer.add_rows_plain) if add else
                      (row_writer.write_rows, row_writer.write_rows_plain))
    got = wrapper(table.clone(), idx, rows)
    ref = plain(table.clone(), idx, rows)
    torch.cuda.synchronize()
    exact = torch.equal(bits(got), bits(ref))
    check(exact, f"{name}: kernel differs from its plain version at {tuple(table.shape)}")
    err = (got.float() - ref.float()).abs().max().item()
    del got, ref
    fn = getattr(_cuda.library(), f"{name}_{'bf16' if table.dtype == torch.bfloat16 else 'f32'}")
    args = (table.data_ptr(), idx.data_ptr(), rows.data_ptr(), table.shape[0], idx.shape[0],
            table.shape[1], _cuda.stream_handle(table.device))
    keep = (idx >= 0) & (idx < table.shape[0])
    kept, kept_rows = idx[keep], rows[keep]  # the library calls refuse the rest
    written, by, op = row_bound(idx, table.shape[0], table.shape[1], add, table.element_size())
    library = ((lambda: table.index_add_(0, kept, kept_rows)) if add else
               (lambda: table.index_copy_(0, kept, kept_rows)))
    launch = lambda: _cuda.check_launch(name, fn(*args))  # noqa: E731
    t = time_ms(launch, flush=flush)
    return {"table": list(table.shape), "rows": idx.shape[0], "rows_written": written,
            "bit_exact": exact, "max_abs_err": err, **t,
            **(time_ms(launch, "warm_") if warm else {}),
            "ns_per_row": t["ms"] * 1e6 / idx.shape[0],
            **time_ms(lambda: plain(table, idx, rows), "plain_", flush=flush),
            **time_ms(library, "library_", flush=flush), "bound_ms": by, "bound_by": op}


def dropped(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``idx`` with its first, a middle and its last entry aimed out of
    range (below 0 and past the table): K2 must drop them."""
    out = idx.clone()
    out[0], out[len(out) // 2], out[-1] = -1, table.shape[0], table.shape[0] + 7
    return out


def distinct_prefix(idx: torch.Tensor) -> int:
    """Length of a pmv commit's distinct-row prefix: ``_merge_slots`` hands
    K2 the distinct physical rows (the scratch row first when the step had
    padding), then a tail that repeats the scratch row."""
    a = idx.cpu().numpy()
    _, first = np.unique(a, return_index=True)
    repeats = np.setdiff1d(np.arange(len(a)), first)
    n = int(repeats[0]) if len(repeats) else len(a)
    check(bool((a[n:] == a[-1]).all()),
          "the pmv commit is not distinct rows followed by one repeated row")
    return n


@contextlib.contextmanager
def capturing(name: str, inner=None):
    """Within the block, ``row_writer.<name>`` runs ``inner`` (by default
    itself) and keeps the table of its last call and copies of that call's
    indices and rows: the tensors a trainer really hands the kernel."""
    saved = getattr(row_writer, name)
    inner = inner or saved
    last = {}

    def wrapped(table, idx, rows):
        last.update(table=table, idx=idx.clone(), rows=rows.clone())
        return inner(table, idx, rows)

    setattr(row_writer, name, wrapped)
    try:
        yield last
    finally:
        setattr(row_writer, name, saved)


def row_kernels(dev, pmv_commit: dict, mv_table_add: dict) -> dict:
    """The row kernels on the training phases' captured calls, then at the
    spikes' shapes."""
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    flush = torch.empty(64 << 20, device=dev)  # 256 MB, five times the L2
    # the commit cut to its distinct rows: what the repeated scratch-row
    # writes of the tail cost
    n = distinct_prefix(pmv_commit["idx"])
    out = {"pmv_commit": row_case("write_rows", flush=flush, **pmv_commit),
           "pmv_commit_distinct": row_case("write_rows", pmv_commit["table"],
                                           pmv_commit["idx"][:n], pmv_commit["rows"][:n],
                                           flush),
           "pmv_commit_dropped": row_case("write_rows", pmv_commit["table"],
                                          dropped(pmv_commit["idx"], pmv_commit["table"]),
                                          pmv_commit["rows"], flush),
           "mv_table_add": row_case("add_rows", flush=flush, **mv_table_add)}
    # the spikes: 57,344 unique rows into a 640 MB table at each width
    for w in (16, 32, 64, 128):
        v = SPIKE_TABLE_FLOATS // w
        table = torch.randn(v, w, generator=g, device=dev)
        idx = torch.randperm(v, generator=g, device=dev)[:SPIKE_ROWS]
        rows = torch.randn(SPIKE_ROWS, w, generator=g, device=dev)
        out[f"spike_w{w}"] = {"write": row_case("write_rows", table, idx, rows, flush),
                              "add": row_case("add_rows", table, idx, rows, flush)}
        del table, idx, rows
    torch.cuda.synchronize()
    return out


def row_errors(rk: dict, key: str) -> float:
    cases = ([rk["pmv_commit"], rk["pmv_commit_distinct"], rk["pmv_commit_dropped"]]
             if key == "write" else
             [rk["mv_table_add"]])
    cases += [v[key] for k, v in rk.items() if k.startswith("spike_")]
    return max(c["max_abs_err"] for c in cases)


# ---------------------------------------------------------------- training
def param_gap(got: TDMTrainer, ref: TDMTrainer) -> float:
    """Largest |got - ref| / (PARAM_ATOL + PARAM_RTOL * |ref|) over every
    parameter: at most 1 within the tolerance."""
    gap = 0.0
    for a, b in zip(got.model.parameters(), ref.model.parameters()):
        a, b = a.detach(), b.detach()
        gap = max(gap, ((a - b).abs() / (PARAM_ATOL + PARAM_RTOL * b.abs())).max().item())
    return gap


def same_params(a: TDMTrainer, b: TDMTrainer) -> bool:
    return all(torch.equal(bits(x.detach()), bits(y.detach()))
               for x, y in zip(a.model.parameters(), b.model.parameters()))


def route_agreement(make, tree: ArrayTree, samples, dev) -> tuple[dict, dict]:
    """Dense, mv and pmv trainers from one seed take three steps on one
    sampled batch (tests/test_tdm_train.py:178 on the card); returns the
    facts and the last mv table update (the only ``add_rows`` caller)."""
    trs = {"dense": make(sparse_embed_update=False),
           "mv": make(sparse_embed_update=True, sparse_format="mv"),
           "pmv": make(sparse_embed_update=True, sparse_format="pmv")}
    check(trs["pmv"]._pmv and not trs["mv"]._pmv, "sparse formats did not resolve")
    n = trs["dense"].num_targets_per_batch
    codes = lambda ids: torch.as_tensor(tree.ids_to_codes(ids), dtype=torch.long, device=dev)  # noqa: E731
    sc, tc = codes(samples.train_seqs[:n]), codes(samples.train_targets[:n])
    batch = trs["dense"].sample(tc)
    loss_gap = 0.0
    with capturing("add_rows") as mv_table_add:
        for _ in range(3):
            losses = {m: float(t.step_from_samples(sc, *batch)) for m, t in trs.items()}
            for m in ("mv", "pmv"):
                loss_gap = max(loss_gap, abs(losses[m] - losses["dense"]) / abs(losses["dense"]))
    trs["pmv"]._sync_mirrors()
    out = {"steps": 3, "max_loss_rel_diff": loss_gap,
           "param_gap": {m: param_gap(trs[m], trs["dense"]) for m in ("mv", "pmv")}}
    check(loss_gap <= LOSS_RTOL, f"dense/mv/pmv losses disagree: {out}")
    check(max(out["param_gap"].values()) <= 1.0, f"dense/mv/pmv params disagree: {out}")
    check("table" in mv_table_add and
          mv_table_add["table"].data_ptr() == trs["mv"].model.embedding.data_ptr(),
          "the mv table update was not captured")
    return out, mv_table_add


@contextlib.contextmanager
def k1_audited():
    """Within the block, every K1 call DIN makes (``models.din.din_score``)
    is held against ``din_score_plain`` on the same inputs at K1's
    tolerance; yields the [B, U] shapes seen and the largest error."""
    seen = {"shapes": [], "calls": 0, "max_abs_err": 0.0}

    def audited(item_e, seq_e, pad, *w):
        got = din_score(item_e, seq_e, pad, *w)
        a = within("din_score", got, din_score_plain(item_e, seq_e, pad, *w))
        seen["calls"] += 1
        seen["max_abs_err"] = max(seen["max_abs_err"], a["max_abs_err"])
        if list(item_e.shape[:2]) not in seen["shapes"]:
            seen["shapes"].append(list(item_e.shape[:2]))
        return got

    din_model.din_score = audited
    try:
        yield seen
    finally:
        din_model.din_score = din_score


def example_training(dev, tree_path: str, samples) -> tuple[dict, dict]:
    """The dense trainer at configs/tdm.conf's settings on the example
    catalog; the caller zeroes and reads the launch counts around it.
    Returns the facts and the route comparison's last mv table update."""
    tree = ArrayTree.from_file(tree_path)
    make = lambda **kw: TDMTrainer(tree=tree, seed=SEED, device=dev, **TDM_CONF, **kw)  # noqa: E731
    trainer = make()
    check(not trainer._sparse, "example catalog: the auto route is not dense")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.train(samples.train_seqs, samples.train_targets, TRAIN_ITERS,
                         progress_interval=100)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [lg["train_loss"] for lg in logs]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")
    windows = (samples.eval_seqs[:512], samples.eval_labels[:512], samples.eval_users[:512])
    consumed = samples.user_consumed[int(samples.eval_users[0])]
    # K1 at the shapes these two give it: the eval loss's [91, 90] batches
    # and the beam levels at the widened candidate widths
    with k1_audited() as k1_audit:
        ev = trainer.evaluate(windows, samples.user_consumed)
        k1 = din_kernel.launches
        rec = trainer.recommend(samples.eval_seqs[0], consumed=consumed)
        k1_recommend = din_kernel.launches - k1
    check(k1_audit["calls"] > 0, "evaluate and recommend made no K1 call")
    metrics = {k: getattr(ev, k) / ev.count for k in ("loss", "precision", "recall", "ndcg")}
    check(ev.count == 512 and np.isfinite(metrics["loss"]), f"evaluate: {metrics}")
    check(all(0.0 <= metrics[k] <= 1.0 for k in ("precision", "recall", "ndcg")),
          f"metrics out of [0, 1]: {metrics}")
    check_lists([rec], tree)
    check(not np.isin(rec, consumed).any(), "recommend returned a consumed item")
    check(k1_recommend > 0, "recommend did not launch K1")
    # same seed, same run: bitwise (tests/test_tdm_train.py:151)
    twin = make()
    twin.train(samples.train_seqs, samples.train_targets, TRAIN_ITERS, progress_interval=100)
    check(same_params(trainer, twin), "same-seed training is not bitwise deterministic")
    lists = trainer.recommend_batch(windows[0])
    check(compare_lists(twin.recommend_batch(windows[0]), lists) == 0,
          "same-seed trainers recommend differently")
    del twin
    routes, mv_table_add = route_agreement(make, tree, samples, dev)
    return {"items": tree.num_items, "max_level": tree.max_level,
            "auto_route": "dense", "unit": trainer.sampler.unit,
            "targets_per_step": trainer.num_targets_per_batch, "iterations": TRAIN_ITERS,
            "train_s": train_s, "ms_per_step": train_s / TRAIN_ITERS * 1e3,
            "losses": losses, "eval_windows": 512, "eval": metrics,
            "recommend_k1_launches": k1_recommend, "k1_vs_plain": k1_audit,
            "deterministic": True, "routes_one_batch": routes}, mv_table_add


def deep_training(dev, tree: ArrayTree, serve_seqs: np.ndarray) -> tuple[dict, dict, DIN]:
    """bench.py's 1M-catalog trainer (auto route: pmv, one K2 launch a
    step); the caller zeroes and reads the launch counts around it.
    Returns the facts, the last commit of the plain-writer rerun (the same
    tensors as the trainer's last K2 launch, the states being equal) and
    the trained model."""
    neg = ",".join(str(min(i, 2**i - 1)) for i in range(tree.max_level + 1))
    make = lambda **kw: TDMTrainer(tree=tree, embed_size=E, layer_neg_counts=neg,  # noqa: E731
                                   topk=TOPK, beam_size=BEAM, seed=SEED, device=dev, **kw)
    trainer = make()
    check(trainer._sparse and trainer._pmv, "1M catalog: the auto route is not pmv")
    b, unit = trainer.num_targets_per_batch, trainer.sampler.unit
    rng = np.random.default_rng(SEED + 6)
    targets = rng.integers(1, DEEP_ITEMS + 1, size=b * DEEP_STEPS)
    seqs = rng.integers(1, DEEP_ITEMS + 1, size=(b * DEEP_STEPS, SEQ_LEN))
    seqs[:, :3] = np.where(rng.random((len(seqs), 3)) < 0.3, 0, seqs[:, :3])

    def timed(tr: TDMTrainer, steps: int) -> tuple[float, list]:
        """``steps`` timed steps after one untimed warm-up step."""
        tr.train(seqs, targets, 1, progress_interval=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = tr.train(seqs, targets, steps, progress_interval=steps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logs

    k2 = row_writer.launches["write_rows"]
    elapsed, logs = timed(trainer, DEEP_STEPS)
    k2 = row_writer.launches["write_rows"] - k2
    check(k2 == DEEP_STEPS + 1, f"{k2} K2 launches in {DEEP_STEPS + 1} pmv steps")
    check(np.isfinite(logs[-1]["train_loss"]), "deep training loss is not finite")
    # the trained table serves through the packed route (K3)
    pre, app = serving_fns("din")
    serv = TDMServing(trainer.model, DIN.forward, tree, precompute=pre, apply=app,
                      apply_emb=packed_fns("din")[1], model_type="din", topk=TOPK,
                      candidate_num=BEAM)
    k3 = packed_level_kernel.launches
    check_lists(serv.recommend_batch(serve_seqs), tree)
    k3 = packed_level_kernel.launches - k3
    cfg = make_config(tree, BEAM)
    check(k3 == cfg.max_level - cfg.start_level, f"serving the trained table: {k3} K3 launches")
    del serv
    # the same run with K2's plain version on the card: bit for bit
    with capturing("write_rows", row_writer.write_rows_plain) as commit:
        twin = make()
        timed(twin, DEEP_STEPS)
    check(torch.equal(bits(trainer.emb_state["pmv"]), bits(twin.emb_state["pmv"]))
          and same_params(trainer, twin), "pmv state differs from the plain-writer rerun")
    check(commit["table"] is twin.emb_state["pmv"], "the pmv commit was not captured")
    pmv_gb = trainer.emb_state["pmv"].numel() * 4 / 1e9
    model = trainer.model  # the jtm_deep phase's scorer
    del trainer, twin
    dense = make(sparse_embed_update=False)
    dense_s, _ = timed(dense, DENSE_STEPS)
    del dense
    return {"items": DEEP_ITEMS, "max_level": tree.max_level, "auto_route": "pmv",
            "pmv_slots": sparse_adam.pmv_slots(E), "pmv_table_gb": pmv_gb, "unit": unit,
            "targets_per_step": b, "steps_run": DEEP_STEPS + 1, "timed_steps": DEEP_STEPS,
            "k2_launches": k2,
            "ms_per_step": elapsed / DEEP_STEPS * 1e3,
            "expanded_rows_per_s": DEEP_STEPS * b * unit / elapsed,
            "final_loss": logs[-1]["train_loss"], "pmv_equals_plain_writer_rerun": True,
            "serving_k3_launches": k3,
            "dense_timed_steps": DENSE_STEPS,
            "dense_ms_per_step": dense_s / DENSE_STEPS * 1e3}, commit, model


# ---------------------------------------------------------------- workflow
class LevelLog(logging.Handler):
    """Within the block, collects the tree learner's per-level records
    (``train/jtm.py`` logs each level's seconds as record fields) with the
    K1 and add launches since the previous level."""

    def __init__(self):
        super().__init__()
        self.levels: list[dict] = []
        self.logger = logging.getLogger("dismember_tpu_torch.jtm")

    def __enter__(self):
        self._mark = read_launches()
        self._level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self._level)

    def emit(self, record):
        if not hasattr(record, "score_s"):
            return
        now = read_launches()
        self.levels.append({
            "level": record.level, "score_s": record.score_s,
            "rebalance_s": record.rebalance_s, "segments": record.segments,
            "k1_launches": now["din_score"] - self._mark["din_score"],
            "add_launches": now["add_rows"] - self._mark["add_rows"]})
        self._mark = now


@contextlib.contextmanager
def adds_audited():
    """Within the block, every ``row_writer.add_rows`` call runs the kernel
    in place and is held bit for bit against ``add_rows_plain`` on a copy of
    the same table; yields the number of calls."""
    saved = row_writer.add_rows
    seen = {"calls": 0}

    def audited(table, idx, rows):
        ref = row_writer.add_rows_plain(table.clone(), idx, rows)
        saved(table, idx, rows)
        check(torch.equal(bits(table), bits(ref)),
              f"add_rows: the kernel differs from its plain version at {tuple(table.shape)}")
        seen["calls"] += 1
        return table

    row_writer.add_rows = audited
    try:
        yield seen
    finally:
        row_writer.add_rows = saved


@contextlib.contextmanager
def plain_versions():
    """Within the block, DIN scores through ``din_score_plain`` and the row
    add runs ``add_rows_plain``, on the card."""
    saved = row_writer.add_rows
    din_model.din_score, row_writer.add_rows = din_score_plain, row_writer.add_rows_plain
    try:
        yield
    finally:
        din_model.din_score, row_writer.add_rows = din_score, saved


def with_model(lines: list[str], model: str) -> list[str]:
    """A conf's lines with ``model.deep_model`` and ``tree.deep_model`` set
    to ``model`` (the files name DIN)."""
    out = [ln.replace("DIN", model) if ln.startswith(("model.deep_model", "tree.deep_model"))
           else ln for ln in lines]
    check(model == "DIN" or out != lines, f"no deep_model to set to {model}")
    return out


def workflow_dir(name: str = "workflow", model: str = "DIN") -> Path:
    """A fresh working directory holding configs/tdm.conf and configs/jtm.conf
    (``model.iteration_number`` cut to WORKFLOW_ITERS; the deep model
    ``model``) and the example data at the confs' ``data/`` paths."""
    wd = OUT / name
    shutil.rmtree(wd, ignore_errors=True)
    (wd / "data").mkdir(parents=True)
    shutil.copy(ROOT / "data" / "example_data.csv", wd / "data")
    for conf in ("tdm.conf", "jtm.conf"):
        lines = (ROOT / "configs" / conf).read_text().splitlines(keepends=True)
        cut = [f"model.iteration_number          {WORKFLOW_ITERS}\n"
               if ln.startswith("model.iteration_number") else ln for ln in lines]
        check(cut != lines, f"{conf}: no model.iteration_number to cut")
        (wd / conf).write_text("".join(with_model(cut, model)))
    return wd


def check_projection(proj: dict, tree: ArrayTree) -> None:
    """Total, leaf-bounded, bijective (tests/test_jtm.py:37-52)."""
    check(set(proj) == set(tree.item_ids.tolist()), "the projection is not total")
    codes = np.asarray(list(proj.values()))
    lo = (1 << tree.max_level) - 1
    check(bool(((codes >= lo) & (codes < 2 * lo + 1)).all()), "a code is not a leaf")
    check(len(np.unique(codes)) == len(codes), "the projection is not bijective")


def sweep(dev, tree_path: str, model_path: str, train_path: str) -> dict:
    """jtm-tree-learning's sweep, in process: the same tree, model and rows."""
    tree = ArrayTree.from_file(tree_path)
    meta = load_meta(model_path)
    model = build_model(meta["model"], tree.max_level, meta["embed_size"], meta["seq_len"],
                        device=dev)
    model.load_numpy(load_pytree(model_path, model.param_tree()))
    seqs, targets = read_train_file(train_path)
    return TreeLearner(tree=tree, model=model, train_seqs=seqs, train_targets=targets, gap=2,
                       device=dev).optimize()


def workflow(dev, serve_seqs: np.ndarray) -> dict:
    """The port's CLI in process on the example catalog, as README.md's
    workflow runs it: tdm-initialize-tree -> tdm-train-deep-model ->
    tdm-cluster-tree -> tdm-train-deep-model on the clustered tree ->
    jtm-tree-learning (every K1 call and add audited), then serving the
    learned tree on both routes.  The caller zeroes and reads the launch
    counts around it."""
    wd = workflow_dir()
    stages: dict[str, float] = {}

    def run(stage: str, command: str, conf: str) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(cli_main([command, "--conf", conf]) == 0, f"{command} failed")
        torch.cuda.synchronize()
        stages[stage] = time.perf_counter() - t0

    facts: dict = {"cut": f"model.iteration_number {WORKFLOW_ITERS} in tdm.conf and jtm.conf "
                          "(2000 and 1000 in the files); nothing else changed"}
    with contextlib.chdir(wd):
        run("tdm-initialize-tree", "tdm-initialize-tree", "tdm.conf")
        category = ArrayTree.from_file("data/tdm_tree.bin")
        run("tdm-train-deep-model", "tdm-train-deep-model", "tdm.conf")
        embed_ids, embeds = read_embeddings_csv("data/embed.csv")
        run("tdm-cluster-tree", "tdm-cluster-tree", "tdm.conf")
        clustered = ArrayTree.from_file("data/tdm_tree.bin")
        check(set(clustered.item_ids.tolist()) == set(category.item_ids.tolist()),
              "the clustered tree holds another item set")
        check(len(np.unique(clustered.item_codes)) == clustered.num_items,
              "the clustered tree repeats a leaf code")
        lo = (1 << clustered.max_level) - 1
        check(bool((clustered.item_codes >= lo).all()), "a clustered code is not a leaf")
        # the same clustering, on the card again and on the CPU
        _, gpu = tree_cluster(embed_ids, embeds, 10, "kmeans", device=dev)
        _, cpu = tree_cluster(embed_ids, embeds, 10, "kmeans", device="cpu")
        check(np.array_equal(sink_leaf_codes(gpu, clustered.max_level),
                             clustered.ids_to_codes(embed_ids)),
              "tree_cluster on the card is not deterministic")
        facts["cluster"] = {"items": len(embed_ids), "max_level": clustered.max_level,
                            "share_equal_to_cpu": float((gpu == cpu).mean())}
        run("tdm-train-deep-model (clustered tree)", "tdm-train-deep-model", "tdm.conf")
        # jtm.conf's tree stage learns from the round just trained: its model
        # and the clustered tree, at jtm.conf's tree.model_path and
        # tree.tree_protobuf_path
        for src, dst in (("tdm_model.bin.npz", "jtm_model.bin.npz"),
                         ("tdm_model.bin.meta.json", "jtm_model.bin.meta.json"),
                         ("tdm_tree.bin", "jtm_tree.bin"), ("tdm_tree.bin", "sweep_input.bin")):
            shutil.copy(Path("data") / src, Path("data") / dst)
        with LevelLog() as lv, k1_audited() as k1_audit, adds_audited() as add_audit:
            run("jtm-tree-learning", "jtm-tree-learning", "jtm.conf")
        learned = ArrayTree.from_file("data/jtm_tree.bin")
        proj = dict(zip(learned.item_ids.tolist(), learned.item_codes.tolist()))
        check_projection(proj, learned)
        check(k1_audit["calls"] > 0 and add_audit["calls"] > 0, "the sweep made no K1 or add call")
        inputs = ("data/sweep_input.bin", "data/jtm_model.bin", "data/train_data.csv")
        check(sweep(dev, *inputs) == proj, "a second sweep on the card gives another projection")
        with plain_versions():
            plain = sweep(dev, *inputs)
        n_diff = sum(proj[k] != plain[k] for k in proj)
        check(n_diff <= max(2, len(proj) // 50),
              f"the sweep with the plain versions moves {n_diff} of {len(proj)} items")
        routes = {}
        for route, packed in (("packed", None), ("classic", False)):
            serv = TDMServing.load("data/jtm_model.bin", "data/jtm_tree.bin", device=dev,
                                   topk=TOPK, candidate_num=BEAM, packed=packed)
            check_lists(serv.recommend_batch(serve_seqs), serv.tree)
            routes[route] = len(serve_seqs)
    facts.update(
        stage_seconds=stages, total_seconds=sum(stages.values()), levels=lv.levels,
        sweep={"items": len(proj), "max_level": learned.max_level, "gap": 2,
               "k1_vs_plain": k1_audit, "adds_bit_exact": add_audit["calls"],
               "repeat_bitwise_equal": True, "items_moved_by_plain_versions": n_diff},
        served_windows=routes)
    return facts


def jtm_deep(dev, tree: ArrayTree, model: DIN) -> dict:
    """One JTM sweep (gap 2) over a JTM_DEEP_ITEMS catalog (ids % 97
    categories, as the 1M catalog) on JTM_DEEP_ROWS synthetic (window,
    target) rows from the seed, scored by the deep_training phase's model
    (its weights, and its table cut to the smaller tree's codes); then
    tree_cluster (k-means, 10 iterations) on that model's leaf embeddings of
    the whole 1M catalog ``tree``.  The caller zeroes and reads the launch
    counts around it."""
    t_phase = t0 = time.perf_counter()
    ids = np.arange(1, JTM_DEEP_ITEMS + 1)
    sub_tree = ArrayTree.from_loaded(build_tree(*category_sorted_codes(ids, ids % 97)))
    params = model.params_numpy()
    params["embedding"] = params["embedding"][: sub_tree.total_codes]
    scorer = params_from_numpy(params, device=dev)
    rng = np.random.default_rng(SEED + 7)
    targets = rng.integers(1, JTM_DEEP_ITEMS + 1, size=JTM_DEEP_ROWS)
    seqs = rng.integers(1, JTM_DEEP_ITEMS + 1, size=(JTM_DEEP_ROWS, SEQ_LEN))
    seqs[:, :3] = np.where(rng.random((JTM_DEEP_ROWS, 3)) < 0.3, 0, seqs[:, :3])
    learner = TreeLearner(tree=sub_tree, model=scorer, train_seqs=seqs, train_targets=targets,
                          gap=2, device=dev)
    check(sub_tree.max_level % 2 == 1, "the deep tree has no step of one chain level")
    setup_s = time.perf_counter() - t0
    # the step of one chain level (the last, max_level being odd) gives K1
    # [8192, 2] and the add 2 columns padded to 4: each of its calls is held
    # against the plain versions (its score seconds include the audit)
    accumulate, audit = learner._accumulate_device, {}

    def step_audited(proj, old_level, level):
        if level - old_level > 1:
            return accumulate(proj, old_level, level)
        with k1_audited() as k1_audit, adds_audited() as add_audit:
            acc = accumulate(proj, old_level, level)
        audit.update(level=level, k1_vs_plain=k1_audit, adds_bit_exact=add_audit["calls"])
        return acc

    learner._accumulate_device = step_audited
    with LevelLog() as lv:
        t0 = time.perf_counter()
        proj = learner.optimize()
        sweep_s = time.perf_counter() - t0
    check_projection(proj, sub_tree)
    check(audit.get("k1_vs_plain", {}).get("shapes") == [[SWEEP_ROWS, 2]]
          and audit["adds_bit_exact"] == audit["k1_vs_plain"]["calls"] > 0,
          f"the one-chain-level step was not audited: {audit}")
    del learner, scorer
    with torch.no_grad():
        leaf = model.embedding[torch.as_tensor(tree.item_codes.astype(np.int64), device=dev)]
    leaf = leaf.cpu().numpy()
    # the clustering's seconds in the device 2-means of each tree level
    # (ended by a synchronize), the rest being host numpy and transfers
    two_means, two_means_s = cluster._sorted_two_means_rank, [0.0]

    def timed_two_means(*args):
        t = time.perf_counter()
        out = two_means(*args)
        torch.cuda.synchronize()
        two_means_s[0] += time.perf_counter() - t
        return out

    cluster._sorted_two_means_rank = timed_two_means
    try:
        t0 = time.perf_counter()
        _, codes = tree_cluster(tree.item_ids, leaf, 10, "kmeans", device=dev)
        cluster_s = time.perf_counter() - t0
    finally:
        cluster._sorted_two_means_rank = two_means
    check(len(np.unique(codes)) == len(codes), "the 1M clustering repeats a code")
    rebalance_s = sum(x["rebalance_s"] for x in lv.levels)
    return {"sweep": {"items": JTM_DEEP_ITEMS, "max_level": sub_tree.max_level,
                      "cut": f"{JTM_DEEP_ITEMS} of the {DEEP_ITEMS} items: the host rebalance "
                             "costs ~14 us an item a level, ~140 s at 1M (see JTM_DEEP_ITEMS)",
                      "rows": JTM_DEEP_ROWS, "gap": 2, "batch_rows": SWEEP_ROWS,
                      "setup_s": setup_s, "seconds": sweep_s,
                      "score_s": sum(x["score_s"] for x in lv.levels),
                      "rebalance_s": rebalance_s,
                      "rebalance_us_per_item_level": rebalance_s / len(lv.levels)
                      / JTM_DEEP_ITEMS * 1e6,
                      "levels": lv.levels, "audited_step": audit},
            "cluster": {"items": tree.num_items, "max_level": tree.max_level,
                        "cluster_iter": 10, "seconds": cluster_s,
                        "device_two_means_s": two_means_s[0],
                        "host_and_transfers_s": cluster_s - two_means_s[0]},
            "total_seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------- OTM
def otm_dir(name: str = "otm", model: str = "DIN") -> Path:
    """A fresh working directory holding configs/otm.conf (``model.epoch_num``
    cut to OTM_EPOCHS; the deep model ``model``) and the example data at the
    conf's ``data/`` paths."""
    wd = OUT / name
    shutil.rmtree(wd, ignore_errors=True)
    (wd / "data").mkdir(parents=True)
    shutil.copy(ROOT / "data" / "example_data.csv", wd / "data")
    lines = (ROOT / "configs" / "otm.conf").read_text().splitlines(keepends=True)
    cut = [f"model.epoch_num                 {OTM_EPOCHS}\n"
           if ln.startswith("model.epoch_num") else ln for ln in lines]
    check(cut != lines, "otm.conf: no model.epoch_num to cut")
    (wd / "otm.conf").write_text("".join(with_model(cut, model)))
    return wd


@contextlib.contextmanager
def k3_audited():
    """Within the block, the packed loops that ``OTMTrainer`` builds score
    every level through K3 held against its plain version on the same
    inputs (``k3_check``); yields the calls and the largest error and share
    beyond K1's tolerance.  The trainer's cached loop must be dropped
    first."""
    seen = {"calls": 0, "max_abs_err": 0.0, "max_share_beyond_f32_tol": 0.0}
    saved = otm_train.make_packed_beam_fn

    def level(rows, alive, seq_e, pad, *w):
        ks, kh, _, a = k3_check(rows, alive, seq_e, pad, w[:-1], w[-1])
        seen["calls"] += 1
        seen["max_abs_err"] = max(seen["max_abs_err"], a["max_abs_err"])
        seen["max_share_beyond_f32_tol"] = max(seen["max_share_beyond_f32_tol"],
                                               a["share_beyond_f32_tol"])
        return ks, kh

    otm_train.make_packed_beam_fn = lambda packed, pre: saved(packed, pre, level)
    try:
        yield seen
    finally:
        otm_train.make_packed_beam_fn = saved


def otm_routes(make, seqs, targets) -> dict:
    """Dense, mv and pmv trainers from one seed take one batch (configs/
    otm.conf's n_levels level steps).  Losses agree at every level.  Lazy
    and dense Adam differ by design on a row a level step leaves untouched
    after an earlier one moved it (dense Adam moves it again by its
    momentum), so dense is held against mv on the scorer weights and on the
    embedding rows no earlier level left behind: rows of the last level's
    nodes, of the sequences, and untouched rows; mv against pmv on every
    parameter, the rows earlier levels' K2 commits wrote included."""
    trs = {"dense": make(sparse_embed_update=False),
           "mv": make(sparse_embed_update=True, sparse_format="mv"),
           "pmv": make(sparse_embed_update=True, sparse_format="pmv")}
    with uncounted():  # the batch's trajectory, as every route will take it
        _, _, nodes = trs["mv"]._targets_and_trajectory(seqs, targets)
    left = torch.zeros(trs["mv"].model.embedding.shape[0], dtype=torch.bool,
                       device=seqs.device)
    left[nodes[:-1][nodes[:-1] >= 0]] = True
    left[nodes[-1][nodes[-1] >= 0]] = False
    left[seqs[seqs >= 0]] = False
    losses = {m: t._train_batch(seqs, targets) for m, t in trs.items()}
    trs["pmv"]._sync_mirrors()
    rel = max(((losses[m] - losses["dense"]).abs() / losses["dense"].abs()).max().item()
              for m in ("mv", "pmv"))
    pmv_gap = param_gap(trs["pmv"], trs["mv"])
    with torch.no_grad():  # the rows left behind leave the dense comparison
        trs["dense"].model.embedding[left] = trs["mv"].model.embedding[left]
    out = {"levels": trs["mv"].n_levels, "max_loss_rel_diff": rel, "rows_left_behind": int(left.sum()),
           "param_gap": {"dense_vs_mv": param_gap(trs["dense"], trs["mv"]),
                         "pmv_vs_mv": pmv_gap}}
    check(rel <= LOSS_RTOL, f"dense/mv/pmv losses disagree: {out}")
    check(max(out["param_gap"].values()) <= 1.0, f"dense/mv/pmv params disagree: {out}")
    return out


def otm_example(dev) -> dict:
    """The port's OTM CLI in process on the example catalog, from a copy of
    configs/otm.conf: otm-train-deep-model -> otm-construct-tree (every
    sweep K1 call and add audited) -> otm-train-deep-model under the learned
    mapping -> OTMServing.load and recommend_batch of 4096 windows; then, on
    the served model, evaluate with every K3 call audited, one batch's
    frozen forwards with every K1 call audited, same-seed determinism, the
    dense/mv/pmv agreement and the ms of a batch.  The caller zeroes and
    reads the launch counts around it; they count the CLI path alone (the
    audits, checks and timing after it leave them as they were)."""
    wd = otm_dir()
    stages: dict[str, float] = {}

    def run(stage: str, command: str) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(cli_main([command, "--conf", "otm.conf"]) == 0, f"{command} failed")
        torch.cuda.synchronize()
        stages[stage] = time.perf_counter() - t0

    with contextlib.chdir(wd):
        run("otm-train-deep-model", "otm-train-deep-model")
        first = load_mapping("data/otm_mapping.txt")[0]
        with LevelLog() as lv, k1_audited() as k1_sweep, adds_audited() as add_sweep:
            run("otm-construct-tree", "otm-construct-tree")
        learned = load_mapping("data/otm_mapping.txt")[0]
        codes = np.asarray(list(learned.values()))
        lo = (1 << upper_log2(len(learned))) - 1
        check(learned.keys() == first.keys() and len(np.unique(codes)) == len(codes)
              and bool(((codes >= lo) & (codes < 2 * lo + 1)).all()),
              "the learned mapping is not a bijection onto leaves")
        check(k1_sweep["calls"] > 0 and add_sweep["calls"] > 0,
              "the construction made no K1 or add call")
        conf = Path("otm.conf").read_text()
        off = conf.replace("model.initialize_mapping        true",
                           "model.initialize_mapping        false")
        check(off != conf, "otm.conf: no model.initialize_mapping to turn off")
        Path("otm.conf").write_text(off)
        run("otm-train-deep-model (learned mapping)", "otm-train-deep-model")
        check(load_mapping("data/otm_mapping.txt")[0] == learned, "the retrain moved the mapping")
        t0 = time.perf_counter()
        serv = OTMServing.load("data/otm_model.bin", "data/otm_mapping.txt",
                               "data/example_data.csv", device=dev)
        stages["OTMServing.load"] = time.perf_counter() - t0
    tr = serv._trainer
    d = tr.data
    windows = np.concatenate([d.eval_seqs, d.train_seqs])[:BATCH]
    k3 = packed_level_kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lists = tr.recommend_batch(windows)
    stages["recommend_batch(4096)"] = time.perf_counter() - t0
    k3_serve = packed_level_kernel.launches - k3
    check(k3_serve == tr.n_levels, f"recommend_batch: {k3_serve} K3 launches")
    check(all(len(r) == TOPK and len(np.unique(r)) == TOPK and np.isin(r, list(learned)).all()
              for r in lists), "recommend_batch: a list is short, repeats or holds a non-item")
    with uncounted(), k3_audited() as k3_eval:  # the CLI path ends here
        tr._packed_cache = None
        ev = tr.evaluate()
    tr._packed_cache = None
    n_eval = -(-len(d.eval_seqs) // tr.eval_batch_size)
    check(k3_eval["calls"] == tr.n_levels * n_eval, f"evaluate: {k3_eval}")
    check(all(0.0 <= getattr(ev, k) <= 1.0 for k in ("precision", "recall", "ndcg"))
          and np.isfinite(ev.loss), f"evaluate: {ev}")
    bs = tr.train_batch_size
    batch = [tr._codes(a[i * bs : (i + 1) * bs]) for i in range(3)
             for a in (d.train_seqs, d.train_labels)]
    with uncounted(), k1_audited() as k1_frozen:  # a repeat of the batch's frozen part
        tr._targets_and_trajectory(batch[0], batch[1])
    check(k1_frozen["calls"] == 3 * tr.n_levels - 2, f"one batch's frozen forwards: {k1_frozen}")
    make = lambda **kw: OTMTrainer(d, embed_size=E, learning_rate=3e-3,  # noqa: E731
                                   beam_size=BEAM, topk=TOPK, seq_len=SEQ_LEN, seed=SEED,
                                   device=dev, **kw)
    with uncounted():
        a, b = make(), make()
        check(not a._sparse, "example catalog: the auto route is not dense")
        for i in range(0, 6, 2):
            a._train_batch(batch[i], batch[i + 1])
            b._train_batch(batch[i], batch[i + 1])
        check(same_params(a, b), "same-seed OTM batches are not bitwise deterministic")
        n_timed = 20
        timed = [tr._codes(x[: n_timed * bs].reshape(n_timed, bs, -1))
                 for x in (d.train_seqs, d.train_labels)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_timed):
            a._train_batch(timed[0][i], timed[1][i])
        torch.cuda.synchronize()
        ms_batch = (time.perf_counter() - t0) / n_timed * 1e3
        routes = otm_routes(make, batch[0], batch[1])
    return {"cut": f"model.epoch_num {OTM_EPOCHS} in otm.conf (5 in the file); nothing else "
                   "changed",
            "items": d.num_items, "leaf_level": tr.leaf_level, "n_levels": tr.n_levels,
            "train_windows": int(len(d.train_seqs)), "batch_rows": bs,
            "auto_route": "dense", "stage_seconds": stages,
            "total_seconds": sum(stages.values()), "ms_per_batch": ms_batch,
            "construction": {"levels": lv.levels, "k1_vs_plain": k1_sweep,
                             "adds_bit_exact": add_sweep["calls"],
                             "items_moved": int(sum(first[k] != learned[k] for k in first))},
            "serving": {"windows": BATCH, "k3_launches": k3_serve},
            "eval": {"windows": int(len(d.eval_seqs)), "loss": ev.loss,
                     "precision": ev.precision, "recall": ev.recall, "ndcg": ev.ndcg,
                     "k3_vs_plain": k3_eval},
            "frozen_k1_vs_plain": k1_frozen, "deterministic_batches": 3,
            "routes_one_batch": routes}


def otm_deep(dev) -> dict:
    """OTM at DEEP_ITEMS synthetic items (scripts/bench_otm_deep.py's data:
    leaf codes from the seed, sequences of 10, 5 labels): 20 levels, start
    level 4, 16 level steps a batch of OTM_DEEP_BATCH rows, auto route pmv
    (one K2 launch a level step).  A warm-up batch and OTM_DEEP_BATCHES timed
    ones; the packed state against a rerun with K2's plain version; then
    batch_beam_search of 4096 windows (16 K3 levels), timed, and once more
    with every K3 call audited.  The caller zeroes and reads the launch
    counts around it."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 8)
    leaf_level = upper_log2(DEEP_ITEMS)
    lo = (1 << leaf_level) - 1
    n = OTM_DEEP_BATCH * (OTM_DEEP_BATCHES + 1)
    data = OTMData(
        item_to_code={}, code_to_item={}, leaf_level=leaf_level, num_items=DEEP_ITEMS,
        all_nodes=np.empty(0, bool),
        train_seqs=rng.integers(lo, lo + DEEP_ITEMS, size=(n, SEQ_LEN)),
        train_labels=rng.integers(lo, lo + DEEP_ITEMS, size=(n, OTM_LABELS)),
        train_users=np.zeros(n, np.int64), eval_seqs=np.empty((0, SEQ_LEN), np.int64),
        eval_labels=np.empty((0, OTM_LABELS), np.int64), eval_users=np.empty(0, np.int64),
        user_consumed={}, label_num=OTM_LABELS)
    make = lambda: OTMTrainer(data, embed_size=E, beam_size=BEAM, seed=SEED,  # noqa: E731
                              total_train_batch_size=OTM_DEEP_BATCH * 2 * BEAM, device=dev)
    tr = make()
    check(tr._pmv and tr.n_levels == 16 and tr.train_batch_size == OTM_DEEP_BATCH,
          f"1M OTM: route pmv {tr._pmv}, {tr.n_levels} levels, batch {tr.train_batch_size}")
    batches = [(tr._codes(data.train_seqs[i::OTM_DEEP_BATCHES + 1]),
                tr._codes(data.train_labels[i::OTM_DEEP_BATCHES + 1]))
               for i in range(OTM_DEEP_BATCHES + 1)]
    setup_s = time.perf_counter() - t0
    k2 = row_writer.launches["write_rows"]
    tr._train_batch(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bt in batches[1:]:
        losses = tr._train_batch(*bt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k2 = row_writer.launches["write_rows"] - k2
    check(k2 == tr.n_levels * len(batches), f"{k2} K2 launches in {len(batches)} batches")
    check(bool(torch.isfinite(losses).all()), "1M OTM losses are not finite")
    with uncounted(), capturing("write_rows", row_writer.write_rows_plain):
        twin = make()
        for bt in batches:
            twin._train_batch(*bt)
    check(torch.equal(bits(tr.emb_state["pmv"]), bits(twin.emb_state["pmv"]))
          and same_params(tr, twin), "1M OTM: pmv state differs from the plain-writer rerun")
    pmv_gb = tr.emb_state["pmv"].numel() * 4 / 1e9
    del twin
    windows = rng.integers(lo, lo + DEEP_ITEMS, size=(BATCH, SEQ_LEN))
    windows[:, :3] = np.where(rng.random((BATCH, 3)) < 0.3, -1, windows[:, :3])  # padding
    k3 = packed_level_kernel.launches
    t1 = time.perf_counter()
    ids, scores = tr.batch_beam_search(windows)  # syncs the mirror, builds the pair table
    first_s = time.perf_counter() - t1
    calls = 3
    t1 = time.perf_counter()
    for _ in range(calls):
        ids, scores = tr.batch_beam_search(windows)
    search_s = time.perf_counter() - t1
    k3 = packed_level_kernel.launches - k3
    check(k3 == tr.n_levels * (calls + 1), f"1M OTM serving: {k3} K3 launches")
    check(ids.shape == (BATCH, 2 * BEAM) and bool((ids >= lo).all())
          and bool(np.isfinite(scores).all()), "1M OTM serving: a candidate is not a live leaf")
    with uncounted(), k3_audited() as k3_audit:
        tr._packed_cache = None
        audited_ids, _ = tr.batch_beam_search(windows)
    tr._packed_cache = None
    check(k3_audit["calls"] == tr.n_levels and np.array_equal(audited_ids, ids),
          f"1M OTM serving audit: {k3_audit}")
    return {"items": DEEP_ITEMS, "leaf_level": leaf_level, "start_level": tr.start_level,
            "n_levels": tr.n_levels, "batch_rows": OTM_DEEP_BATCH, "auto_route": "pmv",
            "pmv_state": list(tr.emb_state["pmv"].shape), "pmv_state_gb": pmv_gb,
            "setup_s": setup_s, "timed_batches": OTM_DEEP_BATCHES,
            "ms_per_batch": elapsed / OTM_DEEP_BATCHES * 1e3,
            "samples_per_s": OTM_DEEP_BATCHES * OTM_DEEP_BATCH / elapsed,
            "k2_launches": k2, "k2_launches_per_batch": k2 // len(batches),
            "final_level_losses": losses.tolist(), "pmv_equals_plain_writer_rerun": True,
            "serving": {"windows": BATCH, "first_call_s": first_s, "calls": calls,
                        "ms_per_batch": search_s / calls * 1e3, "qps": BATCH * calls / search_s,
                        "k3_launches": k3, "k3_vs_plain": k3_audit}}


# ---------------------------------------------------------------- Deep Retrieval
def dr_dir() -> Path:
    """A fresh working directory holding configs/deep-retrieval.conf
    (``model.epoch_num`` cut to DR_EPOCHS) and the example data at the
    conf's ``data/`` paths."""
    wd = OUT / "dr"
    shutil.rmtree(wd, ignore_errors=True)
    (wd / "data").mkdir(parents=True)
    shutil.copy(ROOT / "data" / "example_data.csv", wd / "data")
    lines = (ROOT / "configs" / "deep-retrieval.conf").read_text().splitlines(keepends=True)
    cut = [f"model.epoch_num                 {DR_EPOCHS}\n"
           if ln.startswith("model.epoch_num") else ln for ln in lines]
    check(cut != lines, "deep-retrieval.conf: no model.epoch_num to cut")
    (wd / "dr.conf").write_text("".join(cut))
    return wd


@contextlib.contextmanager
def writes_audited():
    """Within the block, every ``row_writer.write_rows`` call runs K2 in
    place and is held bit for bit against ``write_rows_plain`` on a copy of
    the same table; yields the calls (table, and copies of the indices and
    rows), for timing them afterwards."""
    saved = row_writer.write_rows
    calls = []

    def audited(table, idx, rows):
        ref = row_writer.write_rows_plain(table.clone(), idx, rows)
        saved(table, idx, rows)
        check(torch.equal(bits(table), bits(ref)),
              f"write_rows: K2 differs from its plain version at {tuple(table.shape)}")
        del ref
        calls.append({"table": table, "idx": idx.clone(), "rows": rows.clone()})
        return table

    row_writer.write_rows = audited
    try:
        yield calls
    finally:
        row_writer.write_rows = saved


@torch.no_grad()
def dr_block_beam_ties(tr: DRTrainer, fn, seqs: np.ndarray) -> np.ndarray:
    """[B] bool: the block route's beam (its sequence side from the bf16
    pack) first departs from the f32 beam at a near tie.  bf16 moves layer
    d's sequence logits by at most eps_d = 2^-8 * max_k |seq| . |W_d[k]|
    and a depth-t prefix's log-probability by at most 2 * sum_{d<t} eps_d,
    so at the first depth where the kept prefixes differ, every prefix in
    the difference must lie within twice that of the f32 beam's last."""
    lp, n, k = tr.layer_params, tr.data.num_items, tr.num_nodes
    q = tr._ids(seqs)
    b, le = q.shape[0], q.shape[1] * tr.embed_size
    seq_abs = embed_lookup(lp["embedding"], q).reshape(b, le).abs()
    eps = [2.0**-8 * (seq_abs @ h["weight"][:, :le].abs().T).max(-1).values
           for h in lp["heads"]]
    packed = (fn._seq_pack[q.clamp_min(0)].float() * (q >= 0)[:, :, None])[:, :, : tr.embed_size]
    parts = [packed.reshape(b, le) @ h["weight"][:, :le].T for h in lp["heads"]]

    def logp(paths):  # f32 log-probabilities of prefixes [B, W, t]
        t = paths.shape[2]
        logits = dr_models.layer_forward_training(
            {"embedding": lp["embedding"], "heads": lp["heads"][:t]}, q, paths, n, k)
        return sum(torch.log_softmax(lg, -1).gather(-1, paths[:, :, d : d + 1])[..., 0]
                   for d, lg in enumerate(logits))

    decided = np.zeros(b, bool)
    out = np.zeros(b, bool)
    for t in range(1, tr.num_layers + 1):
        f32 = path_beam_search(lp, q, tr.beam, n, k, t)[0]
        bf = path_beam_search(lp, q, tr.beam, n, k, t, seq_parts=parts[:t])[0]
        lf, lb = logp(f32), logp(bf)
        reach = (4 * sum(eps[:t]))[:, None]
        last = lf.min(-1).values[:, None]
        near_f = ((lf - last).abs() <= reach).cpu().numpy()
        near_b = ((lb - last).abs() <= reach).cpu().numpy()
        f32, bf = f32.cpu().numpy(), bf.cpu().numpy()
        for i in np.flatnonzero(~decided):
            a, c = {tuple(x) for x in f32[i]}, {tuple(x) for x in bf[i]}
            if a == c:
                continue
            decided[i] = True
            out[i] = (all(near_f[i][j] for j, x in enumerate(f32[i]) if tuple(x) not in c)
                      and all(near_b[i][j] for j, x in enumerate(bf[i]) if tuple(x) not in a))
    return out


@torch.no_grad()
def dr_route_vs_host(ids: np.ndarray, host: list, tr: DRTrainer, seqs: np.ndarray,
                     rel: float, beam_ties: np.ndarray | None = None) -> dict:
    """A served route's top-10 lists against the host route's: windows that
    differ, those whose difference is a near tie (see NEAR_TIE; for the
    block route, whose ``beam_ties`` are given, widened by its bf16 user
    vector's reach) or comes from a beam near tie, the rest, and the mean
    overlap."""
    rp = tr.rerank_params
    q = tr._ids(seqs)
    uv = rerank_user_vector(rp, q).cpu().numpy()
    sw, sb = rp["softmax_w"].cpu().numpy(), rp["softmax_b"].cpu().numpy()
    # the block route's user vector comes from bf16 item embeddings: each
    # of its lanes moves by at most 2^-8 * |W| . |x|
    du = np.zeros_like(uv)
    if beam_ties is not None:
        x = embed_lookup(rp["embedding"], q).reshape(len(seqs), -1).abs()
        du = (2.0**-8 * x @ rp["linear"]["weight"].abs().T).cpu().numpy()
    differ = near = beam_near = 0
    overlap = 0.0
    for i, want in enumerate(host):
        got = ids[i][ids[i] >= 0]
        overlap += len(set(got.tolist()) & set(want.tolist())) / max(len(want), 1)
        if set(got.tolist()) == set(want.tolist()):
            continue
        differ += 1
        score = lambda x: float(sw[x] @ uv[i] + sb[x])  # noqa: E731
        tol = lambda x: (rel * (float(np.abs(sw[x]) @ np.abs(uv[i])) + abs(float(sb[x])))  # noqa: E731
                         + float(np.abs(sw[x]) @ du[i]))
        last = want[-1]
        if all(abs(score(x) - score(last)) <= tol(x) + tol(last)
               for x in set(got.tolist()) ^ set(want.tolist())):
            near += 1
        elif beam_ties is not None and beam_ties[i]:
            beam_near += 1
    return {"windows": len(host), "differ": differ, "score_near_ties": near,
            "beam_near_ties": beam_near, "other": differ - near - beam_near,
            "overlap": overlap / len(host)}


def dr_estep_batch(tr: DRTrainer, seqs: np.ndarray, targets: np.ndarray):
    """(seqs, paths, labels) of one E-step batch on the trainer's device."""
    return tr._ids(seqs), tr._ids(tr.path_index.item_paths[targets]), tr._ids(targets)


def dr_routes_one_batch(dev, data, path_index) -> dict:
    """Dense and pmv trainers from one seed take DR_PMV_STEPS E-steps on
    one batch with the same negatives (lazy and dense Adam agree there);
    losses and params within tests/test_tdm_train.py:178's tolerances, the
    first pmv step's three K2 calls audited.  Then DR_TIMED_BATCHES timed
    E-steps of each route on the following batches."""
    make = lambda **kw: DRTrainer(data, path_index=path_index, seed=SEED, device=dev,  # noqa: E731
                                  **DR_CONF, **kw)
    dense, pmv = make(sparse_embed_update=False), make(sparse_embed_update=True)
    check(pmv._pmv and not dense._sparse, "the DR routes did not resolve to dense and pmv")
    b = pmv.num_targets_per_batch
    seqs, paths, labels = dr_estep_batch(pmv, data.train_seqs[:b], data.train_targets[:b])
    negs = pmv.sample_negatives(labels)
    loss_gap = 0.0
    for step in range(DR_PMV_STEPS):
        with writes_audited() if step == 0 else contextlib.nullcontext([]) as audit:
            lp, rp = pmv._estep_fused(seqs, paths, labels, negs)
        if step == 0:
            calls = audit
        ld, rd = dense._estep_fused(seqs, paths, labels, negs)
        loss_gap = max(loss_gap, ((lp - ld).abs() / ld.abs()).max().item(),
                       abs(rp.item() - rd.item()) / abs(rd.item()))
    pmv._sync_mirrors()
    gap = 0.0
    for a, r in ((pmv.layer_params, dense.layer_params), (pmv.rerank_params, dense.rerank_params)):
        ref = flatten(r)
        for n, t in flatten(a).items():
            gap = max(gap, ((t - ref[n]).abs() / (PARAM_ATOL + PARAM_RTOL * ref[n].abs()))
                      .max().item())
    check(len(calls) == 3, f"one pmv E-step made {len(calls)} K2 calls, not 3")
    check(loss_gap <= LOSS_RTOL and gap <= 1.0,
          f"dense/pmv E-steps disagree: loss {loss_gap}, params {gap}")
    ms = {}
    for name, tr in (("pmv", pmv), ("dense", dense)):
        batches = [dr_estep_batch(tr, data.train_seqs[i * b : (i + 1) * b],
                                  data.train_targets[i * b : (i + 1) * b])
                   for i in range(1, DR_TIMED_BATCHES + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s, p, lab in batches:
            tr._estep_fused(s, p, lab, tr.sample_negatives(lab))
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / DR_TIMED_BATCHES * 1e3
    return {"steps_on_one_batch": DR_PMV_STEPS, "max_loss_rel_diff": loss_gap,
            "param_gap": gap, "audited_k2_calls": [[list(c["table"].shape), len(c["idx"])]
                                                   for c in calls],
            "targets_per_batch": b, "timed_batches": DR_TIMED_BATCHES,
            "ms_per_batch": ms}


def canonical_ids(ids: torch.Tensor, scores: torch.Tensor) -> np.ndarray:
    """[B, k] ids in (score descending, id ascending) order, row by row."""
    i = ids.cpu().numpy()
    return np.take_along_axis(i, np.lexsort((i, -scores.cpu().numpy()), axis=1), 1)


def dr_block_vs_plain(fn, lp, rp, q: torch.Tensor, consumed=None) -> dict:
    """A block closure's lists with the rerank kernel against the same
    closure with the kernel's plain chain in its place: scores bit for bit,
    ids in (score, id) order; uncounted."""
    real = dr_rerank.block_rerank_topk
    with uncounted():
        ids, scores = fn(lp, rp, q, consumed)
        dr_rerank.block_rerank_topk = dr_rerank.block_rerank_topk_plain
        try:
            plain_ids, plain_scores = fn(lp, rp, q, consumed)
        finally:
            dr_rerank.block_rerank_topk = real
    check(torch.equal(bits(scores), bits(plain_scores)),
          "DR block serving: the kernel's scores differ from the plain chain's")
    differ = int((canonical_ids(ids, scores)
                  != canonical_ids(plain_ids, plain_scores)).any(1).sum())
    check(differ == 0, f"DR block serving: {differ} lists differ from the plain chain's")
    return {"rows": int(q.shape[0]), "consumed": consumed is not None, "lists_differ": differ}


def dr_example(dev) -> dict:
    """The port's DR CLI in process on the example catalog, from a copy of
    configs/deep-retrieval.conf: dr-train-deep-model (random mapping) ->
    dr-coordinate-descent -> dr-train-deep-model under the learned mapping
    -> DRServing.load and 4096 windows on each serving route (exact, the
    auto route here, packed and block) against the host route; then the
    pmv route on the same data (K2, three launches an E-step).  The caller
    zeroes and reads the launch counts around it: the CLI path (dense at
    3,325 items) launches no kernel, the pmv steps launch K2."""
    wd = dr_dir()
    stages: dict[str, float] = {}

    def run(stage: str, command: str) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(cli_main([command, "--conf", "dr.conf"]) == 0, f"{command} failed")
        torch.cuda.synchronize()
        stages[stage] = time.perf_counter() - t0

    with contextlib.chdir(wd):
        run("dr-train-deep-model", "dr-train-deep-model")
        first, ids = PathIndex.read("data/dr_mapping.bin", DR_CONF["num_nodes"])
        with log_lines("dismember_tpu_torch.dr_cd") as lines:
            run("dr-coordinate-descent", "dr-coordinate-descent")
        cd = cd_walls(lines)
        check(cd["greedy_route"] == "native",
              f"dr-coordinate-descent: greedy 'auto' took the {cd['greedy_route']} select")
        learned, ids2 = PathIndex.read("data/dr_mapping.bin", DR_CONF["num_nodes"])
        ip = learned.item_paths
        check(ids2 == ids and ip.shape == first.item_paths.shape
              and bool(((ip >= 0) & (ip < DR_CONF["num_nodes"])).all()),
              "coordinate descent did not give a J-path mapping of every item")
        conf = Path("dr.conf").read_text()
        off = conf.replace("model.initialize_mapping        true",
                           "model.initialize_mapping        false")
        check(off != conf, "dr.conf: no model.initialize_mapping to turn off")
        Path("dr.conf").write_text(off)
        run("dr-train-deep-model (learned mapping)", "dr-train-deep-model")
        check(np.array_equal(PathIndex.read("data/dr_mapping.bin",
                                            DR_CONF["num_nodes"])[0].item_paths, ip),
              "the retrain moved the mapping")
        t0 = time.perf_counter()
        serv = DRServing.load("data/dr_model.bin", "data/dr_mapping.bin",
                              "data/example_data.csv", device=dev)
        stages["DRServing.load"] = time.perf_counter() - t0
    tr = serv._trainer
    d = tr.data
    windows = np.concatenate([d.eval_seqs, d.train_seqs])[:BATCH]
    t0 = time.perf_counter()
    host = tr.recommend_batch(windows, path_to_items=serv._p2i)
    host_s = time.perf_counter() - t0
    routes = {}
    for route in ("exact", "packed", "block"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn = (serv.device_serving_fn(topk=TOPK) if route == "exact" else
              make_dr_serving_fn(tr, topk=TOPK, rerank_table=route))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(fn.route == route, f"{route}: the closure took the {fn.route} route")
        q = tr._ids(windows)
        fn(tr.layer_params, tr.rerank_params, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, scores = fn(tr.layer_params, tr.rerank_params, q)
        got = got.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        check(got.shape == (BATCH, TOPK) and bool(np.isfinite(scores.cpu().numpy()).all()),
              f"{route}: lists of the wrong shape or scores not finite")
        check(all(len(np.unique(r[r >= 0])) == (r >= 0).sum() for r in got),
              f"{route}: a list repeats an item")
        ties = dr_block_beam_ties(tr, fn, windows) if route == "block" else None
        vs = dr_route_vs_host(got, host, tr, windows, NEAR_TIE[route], ties)
        routes[route] = {"build_s": build_s, "ms_per_batch": ms, "vs_host": vs}
        check(vs["other"] == 0, f"{route}: top-10 differs from the host route: {vs}")
        if route == "block":
            routes[route]["kernel_vs_plain"] = dr_block_vs_plain(
                fn, tr.layer_params, tr.rerank_params, q, q)
    ev = tr.evaluate()
    check(all(0.0 <= getattr(ev, k) <= 1.0 for k in ("precision", "recall", "ndcg"))
          and np.isfinite(ev.rerank_loss), f"evaluate: {ev}")
    pmv_facts = dr_routes_one_batch(dev, d, tr.path_index)
    return {"cut": f"model.epoch_num {DR_EPOCHS} in deep-retrieval.conf (5 in the file); "
                   "nothing else changed",
            "items": d.num_items, "train_windows": int(len(d.train_seqs)),
            "eval_windows": int(len(d.eval_seqs)), "auto_route": "dense",
            "stage_seconds": stages, "total_seconds": sum(stages.values()),
            "coordinate_descent": cd,
            "items_moved_by_cd": int((first.item_paths != ip).any(axis=(1, 2)).sum()),
            "serving": {"windows": BATCH, "host_route_s": host_s, **routes},
            "eval": {"layer_loss": ev.layer_loss, "rerank_loss": ev.rerank_loss,
                     "precision@10": ev.precision, "recall@10": ev.recall,
                     "ndcg@10": ev.ndcg},
            "pmv": pmv_facts}


@torch.no_grad()
def dr_o1_params(tr: DRTrainer, seed: int) -> None:
    """Replace the trainer's init (N(0, 0.05)) by seeded O(1)-scale
    weights: embeddings N(0, EMB_STD), the rest N(0, W_STD), so beams and
    top-k lists are far from ties."""
    g = torch.Generator(device=tr.device).manual_seed(seed)
    for tree in (tr.layer_params, tr.rerank_params):
        for name, t in flatten(tree).items():
            std = EMB_STD if name == "embedding" else W_STD
            t.copy_(torch.randn(t.shape, generator=g, device=t.device) * std)


def dr_data(n_items: int, rows: int, rng: np.random.Generator) -> DRData:
    """bench.py's synthetic DR catalog: uniform windows and targets."""
    return DRData(item_to_id={}, id_to_item={}, num_items=n_items,
                  train_seqs=rng.integers(0, n_items, size=(rows, SEQ_LEN)),
                  train_targets=rng.integers(0, n_items, size=rows),
                  eval_seqs=np.empty((0, SEQ_LEN), np.int64),
                  eval_labels=np.empty((0, 1), np.int64), eval_users=np.empty(0, np.int64),
                  user_consumed={})


def dr_deep(dev) -> dict:
    """bench.py's DR cells: serving at DR_SERVE_ITEMS items (auto route:
    block), ms of a 4096-window call on the host clock and the block route
    against the exact route on DR_AGREE_QUERIES queries; the E-step at
    DR_TRAIN_ITEMS items (auto route: pmv, three K2 launches a step), the
    first step's K2 calls audited, ms a step, then the mirror sync.  The
    caller zeroes and reads the launch counts around it.  Returns the facts
    and the audited K2 calls of one E-step (for the kernel table)."""
    rng = np.random.default_rng(SEED + 9)
    shape = {k: DR_CONF[k] for k in ("num_layers", "num_nodes", "num_paths_per_item",
                                     "embed_size", "seq_len", "topk", "beam_size")}
    t0 = time.perf_counter()
    tr = DRTrainer(dr_data(DR_SERVE_ITEMS, BATCH, rng), train_batch_size=2 * BATCH,
                   num_sampled=DR_SAMPLED, seed=SEED, device=dev, **shape)
    dr_o1_params(tr, SEED + 10)
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = make_dr_serving_fn(tr, beam=BEAM, topk=TOPK)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    check(fn.route == "block", f"1M DR serving: the auto route is {fn.route}, not block")
    q = tr._ids(tr.data.train_seqs)
    lp, rp = tr.layer_params, tr.rerank_params
    ids, _ = fn(lp, rp, q)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DR_SERVE_CALLS):
        ids, scores = fn(lp, rp, q)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
    # a list is short when the beam's paths hold fewer than 10 items (a
    # path is empty with probability e^-2 at 2M assignments over 1M paths)
    check(bool(((ids >= -1) & (ids < DR_SERVE_ITEMS)).all())
          and all(len(np.unique(r[r >= 0])) == (r >= 0).sum() for r in ids)
          and bool(np.isfinite(scores[ids >= 0]).all()) and (ids >= 0).any(1).all(),
          "1M DR serving: a list repeats an item, holds a non-item or is empty")
    exact = make_dr_serving_fn(tr, beam=BEAM, topk=TOPK, rerank_table="exact")
    ref = exact(lp, rp, q[:DR_AGREE_QUERIES])[0].cpu().numpy()
    agree = float(np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max((b >= 0).sum(), 1)
                           for a, b in zip(ids[:DR_AGREE_QUERIES], ref)]))
    check(agree >= DR_MIN_AGREEMENT, f"1M DR serving: block agrees with exact on {agree}")
    kernel_vs_plain = dr_block_vs_plain(fn, lp, rp, q, q)
    serving = {"items": DR_SERVE_ITEMS, "route": "block", "geometry": list(fn._geometry),
               "paths": int(fn._dmap.path_items.shape[0]),
               "items_per_path": int(fn._dmap.path_items.shape[1]),
               "block_table_gb": fn._block_tab.numel() * 2 / 1e9,
               "trainer_setup_s": trainer_s, "path_map_and_tables_s": tables_s,
               "windows": BATCH, "calls": DR_SERVE_CALLS,
               "ms_per_batch": serve_s / DR_SERVE_CALLS * 1e3,
               "qps": BATCH * DR_SERVE_CALLS / serve_s,
               "short_lists": int((ids < 0).any(1).sum()),
               "block_vs_exact_top10_overlap": agree, "agreement_queries": DR_AGREE_QUERIES,
               "kernel_vs_plain": kernel_vs_plain}
    del tr, fn, exact, q, lp, rp

    steps = DR_WARMUP_STEPS + DR_TIMED_STEPS
    t0 = time.perf_counter()
    data = dr_data(DR_TRAIN_ITEMS, BATCH * steps, rng)
    tr = DRTrainer(data, train_batch_size=2 * BATCH, num_sampled=DR_SAMPLED, seed=SEED,
                   device=dev, **shape)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(tr._pmv, "10M DR E-step: the auto route is not pmv")
    batches = [dr_estep_batch(tr, data.train_seqs[i * BATCH : (i + 1) * BATCH],
                              data.train_targets[i * BATCH : (i + 1) * BATCH])
               for i in range(steps)]
    k2 = row_writer.launches["write_rows"]
    with writes_audited() as calls:
        s, p, lab = batches[0]
        tr._estep_fused(s, p, lab, tr.sample_negatives(lab))
    check(len(calls) == 3, f"10M DR E-step: {len(calls)} K2 calls in one step")
    for s, p, lab in batches[1:DR_WARMUP_STEPS]:
        tr._estep_fused(s, p, lab, tr.sample_negatives(lab))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s, p, lab in batches[DR_WARMUP_STEPS:]:
        losses, rloss = tr._estep_fused(s, p, lab, tr.sample_negatives(lab))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k2 = row_writer.launches["write_rows"] - k2
    check(k2 == 3 * steps, f"10M DR E-step: {k2} K2 launches in {steps} steps, not 3 a step")
    check(bool(torch.isfinite(losses).all()) and bool(torch.isfinite(rloss)),
          "10M DR E-step losses are not finite")
    t0 = time.perf_counter()
    tr._sync_mirrors()
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    check(bool(torch.isfinite(tr.rerank_params["softmax_w"]).all()), "10M DR mirrors")
    states = {"layer_embedding": tr.layer_opt_state[1], "rerank_embedding": tr.rerank_opt_state[1],
              "softmax_wb": tr.rerank_opt_state[2]}
    estep = {"items": DR_TRAIN_ITEMS, "route": "pmv", "num_sampled": DR_SAMPLED,
             "targets_per_step": BATCH, "expanded_rows_per_step": 2 * BATCH,
             "pmv_states": {k: list(v["pmv"].shape) for k, v in states.items()},
             "pmv_states_gb": sum(v["pmv"].numel() for v in states.values()) * 4 / 1e9,
             "setup_s": setup_s, "warmup_steps": DR_WARMUP_STEPS,
             "timed_steps": DR_TIMED_STEPS, "ms_per_step": elapsed / DR_TIMED_STEPS * 1e3,
             "expanded_rows_per_s": 2 * BATCH * DR_TIMED_STEPS / elapsed,
             "k2_launches": k2, "k2_launches_per_step": k2 // steps,
             "audited_k2_calls": [[list(c["table"].shape), len(c["idx"])] for c in calls],
             "final_losses": [*losses.tolist(), rloss.item()], "mirror_sync_s": sync_s}
    return {"serving_1m": serving, "estep_10m": estep}, (tr, calls)


def dr_commits(estep) -> dict:
    """K2 on the 10M E-step's three commits of one step (layer embedding,
    rerank embedding, w|b), against its plain version and timed, beside
    ``index_copy_``, after a 256 MB flush each."""
    tr, calls = estep
    flush = torch.empty(64 << 20, device=tr.device)
    names = ("layer_embedding", "rerank_embedding", "softmax_wb")
    with uncounted():
        out = {n: row_case("write_rows", c["table"], c["idx"], c["rows"], flush)
               for n, c in zip(names, calls)}
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------- dr_rerank
def dr_rerank_case(dev, flush: torch.Tensor) -> dict:
    """The block rerank kernel at the DR serving cell's shape (DR_CELL):
    the cell's mapping drawn as ``PathIndex.random_init`` draws it, N(0, 1)
    softmax rows and user vectors, biases N(0, 0.5), uniform beams, 10
    consumed ids a row (3 of them ids the row would serve, 2 pads).  The
    kernel against its plain chain on the card (scores bit for bit, ids in
    (score, id) order wherever the k-th and (k+1)-th distinct scores
    differ), twice equal; warm and cold (after a 256 MB flush) per-call
    times beside the plain chain's; the bound of the bytes the kernel needs
    (each kept path's table entry and its items' used planes, 2(E + 6)
    bytes a slot, the beams, user vectors and consumed ids in, the lists
    out) and of reading the kept paths' whole rows."""
    c = DR_CELL
    kn, e, k, b = c["num_nodes"], c["e"], c["k"], c["rows"]
    t0 = time.perf_counter()
    index = PathIndex.random_init(c["items"], c["depth"], kn, c["j"], seed=SEED + 24)
    dmap = DevicePathMap.build(index, device=dev)
    planes, m_pad = dr_rerank.block_geometry(e, dmap.path_items.shape[1])
    g = torch.Generator(device=dev).manual_seed(SEED + 25)
    w = torch.randn(c["items"], e, generator=g, device=dev)
    bias = torch.randn(c["items"], generator=g, device=dev) * 0.5
    block_tab = dr_rerank.build_block_table(w, bias, dmap.path_items.long(), planes, m_pad)
    del w, bias
    paths = torch.randint(0, kn, (b, c["beam"], c["depth"]), generator=g, device=dev)
    user_vec = torch.randn(b, e, generator=g, device=dev)
    args = [paths, dmap.path_table, block_tab, user_vec, None, kn, e, k, c["j"]]
    with uncounted():
        served, _ = dr_rerank.block_rerank_topk(*args)
        cons = torch.randint(0, c["items"], (b, c["consumed"]), generator=g, device=dev)
        cons[:, :3] = served[:, :3]
        cons[:, -2:] = -1
        args[4] = cons
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        ids, scores = dr_rerank.block_rerank_topk(*args)
        ids2, scores2 = dr_rerank.block_rerank_topk(*args)
        plain_ids, plain_scores = dr_rerank.block_rerank_topk_plain(*args)
        kth1 = dr_rerank.block_rerank_topk_plain(*args[:7], k + 1, c["j"])[1][:, -1]
        check(torch.equal(ids, ids2) and torch.equal(bits(scores), bits(scores2)),
              "dr_rerank: two calls differ")
        check(torch.equal(bits(scores), bits(plain_scores)),
              "dr_rerank: scores differ from the plain chain's")
        both = (scores > NEG_INF / 2) & (plain_scores > NEG_INF / 2)
        err = float((scores - plain_scores).abs()[both].max()) if bool(both.any()) else 0.0
        clear = (scores[:, -1] != kth1) | (scores[:, -1] == NEG_INF)
        clear_np = clear.cpu().numpy()
        check(bool(np.array_equal(canonical_ids(ids, scores)[clear_np],
                                  canonical_ids(plain_ids, plain_scores)[clear_np])),
              "dr_rerank: ids differ from the plain chain's away from ties")
        check(not bool(((ids[:, :, None] == cons[:, None, :]) & (ids[:, :, None] >= 0)).any()),
              "dr_rerank: a consumed id was served")
        kernel = functools.partial(dr_rerank.block_rerank_topk, *args)
        times = {**time_ms(kernel), **time_ms(kernel, "cold_", flush=flush),
                 **time_ms(functools.partial(dr_rerank.block_rerank_topk_plain, *args),
                           "plain_", iters=20)}
    keys, first = dr_rerank.path_keys_and_dedup(paths, kn)
    rows = dmap.path_table[keys].long()
    kept = rows[(rows >= 0) & first]
    items = int((dmap.path_items[kept] >= 0).sum())
    io = (nbytes(paths, user_vec, cons, ids, scores) + 4 * paths.shape[0] * paths.shape[1])
    need = bound(io + items * 2 * (e + 6), f32_flops=items * (2 * e + 1))
    rows_ms = bound(io + kept.numel() * planes * m_pad * 2, f32_flops=items * (2 * e + 1))
    return {"shape": {**c, "planes": planes, "m_pad": m_pad,
                      "paths": int(dmap.path_items.shape[0]),
                      "block_table_gb": block_tab.numel() * 2 / 1e9},
            "setup_s": setup_s, "kept_paths": int(kept.numel()), "items_scored": items,
            "rows_without_tie_at_k": float(clear.float().mean()),
            "short_rows": int((ids[:, -1] < 0).sum()), "max_abs_err": err, **times,
            "bound_ms": need[0], "bound_by": need[1], "rows_bound_ms": rows_ms[0],
            "library_ms": None}


# ---------------------------------------------------------------- tdm_10m
def deep_tree(n_items: int) -> ArrayTree:
    """bench.py's ``_deep_tree``: ids 1..n in ``ids % 97`` categories,
    built in memory."""
    ids = np.arange(1, n_items + 1)
    sid, codes = category_sorted_codes(ids, ids % 97)
    return ArrayTree.from_loaded(build_tree(sid, codes))


def deep_trainer(tree: ArrayTree, dev, **kw) -> TDMTrainer:
    """bench.py's ``_deep_trainer`` (negatives min(i, 2^i - 1) a level)."""
    neg = ",".join(str(min(i, 2**i - 1)) for i in range(tree.max_level + 1))
    return TDMTrainer(tree=tree, model_type="din", embed_size=E, layer_neg_counts=neg,
                      topk=TOPK, beam_size=BEAM, seed=SEED, device=dev, **kw)


def resident_training(dev, tree: ArrayTree, rng: np.random.Generator) -> tuple[dict, DIN]:
    """``train_resident`` at the deep catalog: RES_CHUNKS chunks of
    RES_CHUNK steps timed on the host clock (the trainer and the upload are
    set-up), then a twin from the same seed in chunks of RES_TWIN_CHUNK,
    uncounted, bit for bit the same after the mirror sync.  Returns the
    facts and the trained model."""
    t0 = time.perf_counter()
    items = rng.integers(1, tree.num_items + 1, size=(RES_USERS, RES_STREAM))
    windows = ResidentWindows.from_items(tree, items, SEQ_LEN, RES_T_LO, RES_STREAM)
    windows_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = deep_trainer(tree, dev)
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    check(trainer._sparse and trainer._pmv, "10M catalog: the auto route is not pmv")
    b, unit = trainer.num_targets_per_batch, trainer.sampler.unit
    steps = RES_CHUNK * RES_CHUNKS
    k2 = row_writer.launches["write_rows"]
    # every operation that makes the host wait for the card warns: the
    # loop's only ones should be its loss reads, one a chunk
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            logs = trainer.train_resident(windows, steps, chunk=RES_CHUNK,
                                          progress_interval=RES_CHUNK)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message).lower()]
    k2 = row_writer.launches["write_rows"] - k2
    check(k2 == steps, f"10M resident training: {k2} K2 launches in {steps} pmv steps")
    losses = [lg["train_loss"] for lg in logs]
    check(len(losses) == RES_CHUNKS and all(np.isfinite(losses)),
          f"10M resident training losses: {losses}")
    # the one wait that repeats is the loss read, once a chunk; the rest
    # (the mode switch, the dataset's and the labels' uploads) happen once,
    # where a wait in the step would repeat once a step
    repeated = {site: n for site, n in collections.Counter(syncs).items() if n > 1}
    check(len(repeated) <= 1 and all(n == RES_CHUNKS for n in repeated.values()),
          f"10M resident training: host waits {syncs} in {RES_CHUNKS} chunks")
    with uncounted():  # the twin only checks that the chunk size changes no bit
        twin = deep_trainer(tree, dev)
        twin.train_resident(windows, steps, chunk=RES_TWIN_CHUNK, progress_interval=steps)
        same = (torch.equal(bits(trainer.emb_state["pmv"]), bits(twin.emb_state["pmv"]))
                and same_params(trainer, twin))
    check(same, f"10M resident training: chunk {RES_TWIN_CHUNK} differs from chunk {RES_CHUNK}")
    facts = {"users": RES_USERS, "stream": RES_STREAM, "t_lo": RES_T_LO,
             "windows": len(windows), "upload_mb": windows.item_codes.nbytes / 1e6,
             "auto_route": "pmv", "pmv_state_gb": trainer.emb_state["pmv"].numel() * 4 / 1e9,
             "mirror_gb": trainer.model.embedding.numel() * 4 / 1e9,
             "unit": unit, "targets_per_step": b, "steps": steps, "chunk": RES_CHUNK,
             "windows_s": windows_s, "trainer_setup_s": trainer_s, "train_s": train_s,
             "ms_per_step": train_s / steps * 1e3,
             "expanded_rows_per_s": steps * b * unit / train_s, "losses": losses,
             "k2_launches": k2, "host_waits": syncs,
             "chunk_invariant": {"twin_chunk": RES_TWIN_CHUNK,
                                                    "bit_equal": same}}
    model = trainer.model
    del trainer, twin
    torch.cuda.empty_cache()
    return facts, model


def bf16_rows_vs_f32_rows(dev, deep: TDMServing, deep_seqs: np.ndarray) -> dict:
    """K3 over a bf16 pair table against K3 over the f32 table of the same
    embedding rounded to the bf16 grid, on the 1M catalog: the beam's ids
    and scores, and the served top-10, bit for bit (uncounted)."""
    codes = torch.as_tensor(deep.tree.ids_to_codes(deep_seqs), dtype=torch.long, device=dev)
    emb = deep.params.embedding.detach().to(torch.bfloat16).float()
    out = {}
    with uncounted():
        for dt in (torch.float32, torch.bfloat16):
            packed = make_packed_tree(deep.tree, emb, BEAM, dtype=dt)
            ids, scores = beam_search_packed(deep.params, codes, packed, DIN.precompute_seq)
            out[dt] = (ids, scores, filter_topk(ids.cpu().numpy(), scores.cpu().numpy(), TOPK))
            del packed
    (i32, s32, l32), (i16, s16, l16) = out[torch.float32], out[torch.bfloat16]
    same = torch.equal(i32, i16) and torch.equal(bits(s32), bits(s16))
    check(same and compare_lists(l16, l32) == 0,
          "1M catalog: K3 over the bf16 table differs from K3 over the f32 table")
    return {"items": DEEP_ITEMS, "batch": BATCH, "ids_and_scores_bit_equal": same,
            "top10_rows_differing": 0}


def k3_bf16_rows(dev, weights, flush) -> dict:
    """K3 on bf16 pair rows at the serving shape, O(1)-scale inputs as in
    phase 3 (K3's f32 case), against its plain version (uncounted) and
    against K3 on the same values as f32 lanes (bit for bit: bf16 rows
    score as f32 rows of the same values); timed warm and cold with the
    raw launch."""
    g = torch.Generator().manual_seed(SEED + 12)
    rows, alive = k3_rows(g, BATCH, BEAM, dev, torch.bfloat16)
    seq_e, pad = seq_inputs(g, BATCH, SEQ_LEN, dev)
    f32_rows = torch.zeros(BATCH, BEAM, 128, device=dev)
    f32_rows[..., : 2 * E + 2] = rows[..., : 2 * E + 2].float()
    with uncounted():
        ks, kd, ps, agree = k3_check(rows, alive, seq_e, pad, weights)
        ks32, _ = packed_level(f32_rows, alive, seq_e, pad, *weights, E)
    torch.cuda.synchronize()
    same = torch.equal(bits(ks), bits(ks32))
    check(same, "K3 on bf16 rows scores differently from K3 on the same values as f32 lanes")
    return dict(**agree, **k3_times(rows, alive, seq_e, pad, weights, flush),
                shape=[BATCH, BEAM, rows.shape[2], SEQ_LEN, E], row_dtype="bfloat16",
                used_lanes=2 * E + 10, scores_equal_k3_f32_rows=same)


def tdm_10m_serving(dev, model: DIN, tree: ArrayTree, rng) -> dict:
    """TDMServing on the trained 10M model: the auto rule's pair-table
    dtype (bf16), the table build, ``recommend_batch(4096)`` timed (mean
    of 5 calls after a warm-up) with its K3 launches over bf16 rows
    counted, and the route audited against the plain level (uncounted)."""
    pre, app = serving_fns("din")
    serv = TDMServing(model, DIN.forward, tree, precompute=pre, apply=app,
                      apply_emb=packed_fns("din")[1], model_type="din", topk=TOPK,
                      candidate_num=BEAM)
    dtype = serv.pair_table_dtype()
    check(dtype == torch.bfloat16, f"10M catalog: the auto rule picked {dtype}, not bf16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serv._beam_fn(BEAM)  # builds the pair table
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    table = serv._pair_table
    seqs = rng.integers(1, tree.num_items + 1, size=(BATCH, SEQ_LEN))
    seqs[:, :3] = np.where(rng.random((BATCH, 3)) < 0.3, 0, seqs[:, :3])  # padding
    serv.recommend_batch(seqs)  # warm-up
    calls = 5
    k3 = packed_level_kernel.launches_bf16_rows
    t0 = time.perf_counter()
    for _ in range(calls):
        lists = serv.recommend_batch(seqs)
    elapsed = time.perf_counter() - t0
    k3 = packed_level_kernel.launches_bf16_rows - k3
    cfg = make_config(tree, BEAM)
    levels = cfg.max_level - cfg.start_level
    check(k3 == levels * calls, f"10M serving: {k3} K3 launches over bf16 rows in {calls} "
                                f"batches of {levels} levels")
    check_lists(lists, tree)
    codes = torch.as_tensor(tree.ids_to_codes(seqs), dtype=torch.long, device=dev)
    with uncounted():
        audit = audit_packed(model, PackedTree(pair_table=table, embed_size=E, cfg=cfg),
                             codes, lists)
    facts = {"items": tree.num_items, "max_level": tree.max_level, "levels": levels,
             "auto_pair_table_dtype": "bfloat16", "pair_table": list(table.shape),
             "pair_table_gb": table.numel() * table.element_size() / 1e9,
             "f32_table_would_be_gb": table.shape[0] * 128 * 4 / 1e9,
             "table_build_s": table_s, "batch": BATCH, "calls": calls,
             "ms_per_batch": elapsed / calls * 1e3, "qps": BATCH * calls / elapsed,
             "k3_bf16_row_launches_per_batch": k3 // calls, "vs_plain": audit}
    del serv, table
    torch.cuda.empty_cache()
    return facts


def resume_on_card(dev, tree_path: str, samples) -> dict:
    """Step resume on the card (example catalog, configs/tdm.conf's
    trainer, dense and pmv): a run killed after its last snapshot and
    resumed in a fresh trainer equals an uninterrupted one bit for bit."""
    tree = ArrayTree.from_file(tree_path)
    out = {}
    for route, kw in (("dense", {}), ("pmv", dict(sparse_embed_update=True,
                                                  sparse_format="pmv"))):
        make = lambda: TDMTrainer(tree=tree, seed=SEED, device=dev, **TDM_CONF, **kw)  # noqa: E731
        ckpt = OUT / f"resume_{route}"
        (OUT / f"resume_{route}.npz").unlink(missing_ok=True)
        data = (samples.train_seqs, samples.train_targets)
        ref = make()
        ref.train(*data, RESUME_ITERS, progress_interval=RESUME_ITERS)
        part = make()
        part.train(*data, RESUME_KILLED_AT, progress_interval=RESUME_ITERS,
                   checkpoint_path=str(ckpt), checkpoint_every=RESUME_EVERY)
        check((OUT / f"resume_{route}.npz").exists(), "no step snapshot was written")
        del part
        res = make()
        res.train(*data, RESUME_ITERS, progress_interval=RESUME_ITERS,
                  checkpoint_path=str(ckpt), checkpoint_every=RESUME_EVERY)
        same = same_params(ref, res) and all(
            torch.equal(bits(ref.adam[k][n]), bits(res.adam[k][n]))
            for k in ("mu", "nu") for n in ref.adam[k])
        if route == "pmv":
            same = same and torch.equal(bits(ref.emb_state["pmv"]), bits(res.emb_state["pmv"]))
        check(same, f"{route}: the resumed run differs from the uninterrupted one")
        out[route] = {"iterations": RESUME_ITERS, "snapshot_every": RESUME_EVERY,
                      "killed_at": RESUME_KILLED_AT,
                      "snapshot_mb": (OUT / f"resume_{route}.npz").stat().st_size / 1e6,
                      "bit_equal": same}
    return out


def bf16_tables(dev, tree_path: str, samples, flush, model_type: str = "din") -> dict:
    """A bf16 embedding table of ``model_type``'s scorer on the example
    catalog (sparse, auto format: mv), trained twice from one seed: bitwise
    equal; every bf16 add of the first run checked bit for bit against its
    plain version on a copy of its table, one ``add_rows_bf16`` and one K2
    launch a step, then the last add timed beside ``index_add_``."""
    tree = ArrayTree.from_file(tree_path)
    make = lambda: TDMTrainer(tree=tree, seed=SEED, device=dev,  # noqa: E731
                              model_type=model_type, embed_dtype=torch.bfloat16,
                              sparse_embed_update=True, **TDM_CONF)
    a = make()
    check(a._sparse and not a._pmv and a.model.embedding.dtype == torch.bfloat16,
          f"bf16 {model_type} table: the auto format is not mv")
    seen = {"calls": 0, "max_abs_err": 0.0}
    kernel = row_writer.add_rows

    def checked(table, idx, rows):
        before = table.clone()
        got = kernel(table, idx, rows)
        check(table.dtype == torch.bfloat16, "the bf16 route added into a non-bf16 table")
        with uncounted():
            ref = row_writer.add_rows_plain(before, idx, rows)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(ref)), "bf16 add differs from its plain version")
        seen["calls"] += 1
        seen.update(table=table, idx=idx.clone(), rows=rows.clone())
        return got

    row_writer.add_rows = checked
    before = dict(row_writer.launches)
    try:
        t0 = time.perf_counter()
        logs = a.train(samples.train_seqs, samples.train_targets, BF16_ITERS,
                       progress_interval=BF16_ITERS // 2)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        row_writer.add_rows = kernel
    runs = {k: row_writer.launches[k] - before[k] for k in ("add_rows_bf16", "write_rows")}
    check(seen["calls"] == runs["add_rows_bf16"] == runs["write_rows"] == BF16_ITERS,
          f"{model_type}: {seen['calls']} bf16 adds audited, launches {runs} in "
          f"{BF16_ITERS} mv steps")
    losses = [lg["train_loss"] for lg in logs]
    check(all(np.isfinite(losses)), f"bf16 {model_type} losses: {losses}")
    b = make()
    b.train(samples.train_seqs, samples.train_targets, BF16_ITERS,
            progress_interval=BF16_ITERS // 2)
    same = same_params(a, b) and torch.equal(bits(a.emb_state["mv"]), bits(b.emb_state["mv"]))
    check(same, f"bf16 {model_type} table: same-seed runs differ")
    with uncounted():
        add = row_case("add_rows", seen["table"], seen["idx"], seen["rows"], flush)
    return {"model": model_type, "items": tree.num_items, "route": "mv",
            "iterations": BF16_ITERS, "ms_per_step": train_s / BF16_ITERS * 1e3,
            "losses": losses, "adds_checked": seen["calls"], "launches_first_run": runs,
            "same_seed_bit_equal": same, "mv_table_add": add}


def tdm_10m(dev, deep: TDMServing, deep_seqs: np.ndarray, tree_path: str, samples,
            weights) -> tuple[dict, ArrayTree]:
    """The 10M-item phase and its tree; the caller zeroes and reads the
    launch counts around it.  ``weights``: phase 3's O(1)-scale scorer
    weights."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(SEED + 11)
    t0 = time.perf_counter()
    tree = deep_tree(TDM_10M_ITEMS)
    tree_s = time.perf_counter() - t0
    training, model = resident_training(dev, tree, rng)
    serving = tdm_10m_serving(dev, model, tree, rng)
    del model
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, device=dev)
    out = {"items": TDM_10M_ITEMS, "max_level": tree.max_level, "tree_build_s": tree_s,
           "training": training, "serving": serving, "peak_allocated_gb": peak_gb,
           "k3_bf16_rows": k3_bf16_rows(dev, weights, flush),
           "k3_bf16_vs_f32_table_1m": bf16_rows_vs_f32_rows(dev, deep, deep_seqs),
           "resume": resume_on_card(dev, tree_path, samples),
           "bf16_tables": bf16_tables(dev, tree_path, samples, flush),
           "bf16_tables_deepfm": bf16_tables(dev, tree_path, samples, flush, "deepfm")}
    out["seconds"] = time.perf_counter() - t_phase
    return out, tree


# ---------------------------------------------------------------- widths
def kernels_at_width(dev, e: int, n_items: int, flush: torch.Tensor) -> dict:
    """K1 and K3 at width ``e`` against their plain versions on the card,
    with O(1)-scale inputs (padding, an all-padding row, zero candidates,
    dead parents, missing children): K1 at the serving shape [4096, 40],
    the sweep's [8192, 4] and [8192, 2], predict's one row of every
    catalog item and [4096, 40] at L = 24; K3 at [4096, 20] on f32 and bf16
    rows, each with the f32-scorer control, which must fail K3's check;
    k3_wide_cases on both row types.  The serving and sweep shapes and L =
    24 are timed warm and cold, beside the plain version and the bound."""
    g = torch.Generator().manual_seed(SEED + 40 + e)
    weights = tuple(t.detach() for t in params_from_numpy(
        seed_params(7, np.random.default_rng(SEED + 40 + e), e), device=dev).scorer_weights())
    b, u, l = BATCH, 2 * BEAM, SEQ_LEN
    seq_e, pad = seq_inputs(g, b, l, dev, e)
    k1 = {}
    cases = [("serving", (b, u, l)), ("sweep", (SWEEP_ROWS, SWEEP_U, l)),
             ("sweep_u2", (SWEEP_ROWS, 2, l)), ("predict", (1, n_items, l)),
             ("l24", (b, u, 24))]
    for case, (bb, uu, ll) in cases:
        item_e = torch.randn(bb, uu, e, generator=g) * EMB_STD
        item_e[torch.rand(bb, uu, generator=g) < 0.1] = 0.0
        item_e = item_e.to(dev)
        s_e, s_pad = ((seq_e[2:3].contiguous(), pad[2:3].contiguous()) if case == "predict"
                      else seq_inputs(g, bb, ll, dev, e))
        got = din_score(item_e, s_e, s_pad, *weights)
        k1[case] = dict(**within("din_score", got, din_score_plain(item_e, s_e, s_pad, *weights)),
                        shape=[bb, uu, ll, e])
        check(bool(torch.isfinite(got).all()), f"din_score at E={e}: non-finite output")
        if case in ("serving", "sweep", "l24"):
            k1[case].update(k1_times(item_e, s_e, s_pad, weights, flush))
    k3 = {}
    for dt, name in K3_ROWS.items():
        rows, alive = k3_rows(g, b, BEAM, dev, dt, e)
        _, _, ps, agree = k3_check(rows, alive, seq_e, pad, weights, e)
        live = ps > NEG_INF / 2
        blk = torch.cat([rows[..., :e], rows[..., e : 2 * e]], dim=1).float().contiguous()
        control = agreement("packed_level", din_score(blk, seq_e, pad, *weights)[live], ps[live], e)
        check(not control["ok"], f"control at E={e}: an f32 scorer passes K3's check: {control}")
        k3[name] = dict(**agree, **k3_times(rows, alive, seq_e, pad, weights, flush, e),
                        shape=[b, BEAM, rows.shape[2], l, e], control_f32_scorer=control)
        del rows, alive, blk
    for dt, name in K3_ROWS.items():
        k3[name].update(k3_wide_cases(dev, g, e, dt, weights, flush))
    torch.cuda.synchronize()
    return {"din_score": k1, **k3}


def k3_wide_cases(dev, g: torch.Generator, e: int, dt: torch.dtype, weights,
                  flush: torch.Tensor) -> dict:
    """K3 at width ``e`` on ``dt`` rows past the serving shape, against its
    plain version: beam 110 (the example catalog's widest recommend) and L =
    24 (two sequence tiles), both timed, and beam 1,000 at [256, 1000] in
    one launch (the warpgroup plan's shared memory does not grow with the
    beam)."""
    past = 1000
    wide = {}
    for bb, beam, ll, timed in ((BATCH, 110, SEQ_LEN, True), (256, past, SEQ_LEN, False),
                                (BATCH, BEAM, 24, True)):
        rows, alive = k3_rows(g, bb, beam, dev, dt, e)
        s_e, s_pad = seq_inputs(g, bb, ll, dev, e)
        n0 = packed_level_kernel.launches_by_width[e, dt]
        agree = k3_check(rows, alive, s_e, s_pad, weights, e)[3]
        wide[f"beam{beam}_l{ll}"] = dict(
            **agree, shape=[bb, beam, rows.shape[2], ll, e],
            launches=packed_level_kernel.launches_by_width[e, dt] - n0,
            **(k3_times(rows, alive, s_e, s_pad, weights, flush, e) if timed else {}))
        del rows, alive, s_e, s_pad
    launches = wide[f"beam{past}_l{SEQ_LEN}"]["launches"]
    check(launches == 1, f"beam {past} at E={e}: {launches} launches, not one")
    return {"wide": wide}


def example_width_8(dev, tree_path: str, samples, seqs: np.ndarray) -> dict:
    """DIN at E = 8 on the example catalog: configs/tdm.conf's trainer at
    that width (auto route dense), TRAIN_ITERS steps; ``evaluate`` on 512
    eval windows and ``recommend`` with every K1 call held against its plain
    version; then the trained model served through TDMServing on the packed
    route from an f32 and a bf16 pair table (equal lists), the f32 table's
    every K3 level audited."""
    e = 8
    tree = ArrayTree.from_file(tree_path)
    trainer = TDMTrainer(tree=tree, seed=SEED, device=dev, **{**TDM_CONF, "embed_size": e})
    check(not trainer._sparse, "E=8 example catalog: the auto route is not dense")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.train(samples.train_seqs, samples.train_targets, TRAIN_ITERS,
                         progress_interval=100)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [lg["train_loss"] for lg in logs]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"E=8: loss did not fall: {losses}")
    windows = (samples.eval_seqs[:512], samples.eval_labels[:512], samples.eval_users[:512])
    consumed = samples.user_consumed[int(samples.eval_users[0])]
    with k1_audited() as k1_audit:
        ev = trainer.evaluate(windows, samples.user_consumed)
        rec = trainer.recommend(samples.eval_seqs[0], consumed=consumed)
    check(k1_audit["calls"] > 0, "E=8: evaluate and recommend made no K1 call")
    metrics = {k: getattr(ev, k) / ev.count for k in ("loss", "precision", "recall", "ndcg")}
    check(all(0.0 <= metrics[k] <= 1.0 for k in ("precision", "recall", "ndcg"))
          and np.isfinite(metrics["loss"]), f"E=8 evaluate: {metrics}")
    check_lists([rec], tree)
    serving = width_serving(dev, trainer.model, tree, seqs, packed=True)
    return {"items": tree.num_items, "iterations": TRAIN_ITERS, "train_s": train_s,
            "ms_per_step": train_s / TRAIN_ITERS * 1e3, "losses": losses, "eval_windows": 512,
            "eval": metrics, "k1_vs_plain": k1_audit, "serving": serving}


def width_serving(dev, model: DIN, tree: ArrayTree, seqs: np.ndarray, **kw) -> dict:
    """``recommend_batch`` of the windows on the packed route through
    TDMServing from an f32 and then a bf16 pair table (``packed_dtype``; K3
    rounds f32 lanes to the bf16 values, so the lists are equal), a warm-up
    call and 3 timed ones each; the f32 table's every K3 level audited."""
    pre, app = serving_fns("din")
    _, app_emb = packed_fns("din")
    codes = torch.as_tensor(tree.ids_to_codes(seqs), dtype=torch.long, device=dev)
    out, lists = {}, {}
    for dtype in ("float32", "bfloat16"):
        serv = TDMServing(model, DIN.forward, tree, precompute=pre, apply=app, apply_emb=app_emb,
                          model_type="din", topk=TOPK, candidate_num=BEAM, packed_dtype=dtype,
                          **kw)
        check(serv._use_packed(BEAM), "the width's serving is not on the packed route")
        t0 = time.perf_counter()
        serv.recommend_batch(seqs)  # builds the pair table
        first_s = time.perf_counter() - t0
        calls = 3
        t0 = time.perf_counter()
        for _ in range(calls):
            lists[dtype] = serv.recommend_batch(seqs)
        elapsed = time.perf_counter() - t0
        check_lists(lists[dtype], tree)
        out[dtype] = {"windows": len(seqs), "first_call_s": first_s, "calls": calls,
                      "ms_per_batch": elapsed / calls * 1e3, "qps": len(seqs) * calls / elapsed,
                      "pair_table_gb": serv._pair_table.numel()
                      * serv._pair_table.element_size() / 1e9}
        if dtype == "float32":
            # predict (K1) over every catalog item for the first window
            items = tree.item_ids.astype(np.int64)
            pred = serv.predict(seqs[0], items)
            with uncounted(), torch.inference_mode():
                out[dtype]["vs_plain"] = audit_packed(model, PackedTree(
                    serv._pair_table, model.embed_size, make_config(tree, BEAM)), codes,
                    lists[dtype])
                item_codes = serv._codes(items[None])
                logits = model(item_codes, codes[:1])[0]
                check(np.array_equal(torch.sigmoid(logits).cpu().numpy(), pred),
                      "predict is not the sigmoid of K1's logits")
                out[dtype]["predict_vs_plain"] = within(
                    "din_score", logits, plain_apply(model, item_codes,
                                                     model.precompute_seq(codes[:1]))[0])
            out[dtype]["predict_items"] = len(items)
        del serv
    check(compare_lists(lists["bfloat16"], lists["float32"]) == 0,
          f"E={model.embed_size}: the bf16 pair table serves other lists than the f32 one")
    return out


def deep_width_32(dev, tree: ArrayTree, seqs: np.ndarray) -> dict:
    """DIN at E = 32 (scripts/quality_1m.py's width) on the 1M catalog:
    ``recommend_batch(4096)`` on the packed route from seeded O(1)-scale
    weights (width_serving), then bench.py's trainer at E = 32 (auto route
    pmv, one K2 launch a step): a warm-up step and WIDTH_STEPS timed."""
    e = 32
    t0 = time.perf_counter()
    num_index = (1 << (tree.max_level + 1)) - 1
    model = params_from_numpy(seed_params(num_index, np.random.default_rng(SEED + 50), e),
                              device=dev)
    setup_s = time.perf_counter() - t0
    serving = width_serving(dev, model, tree, seqs)
    del model
    neg = ",".join(str(min(i, 2**i - 1)) for i in range(tree.max_level + 1))
    trainer = TDMTrainer(tree=tree, embed_size=e, layer_neg_counts=neg, topk=TOPK,
                         beam_size=BEAM, seed=SEED, device=dev)
    check(trainer._pmv, "E=32 at 1M: the auto route is not pmv")
    b = trainer.num_targets_per_batch
    rng = np.random.default_rng(SEED + 51)
    targets = rng.integers(1, DEEP_ITEMS + 1, size=b * WIDTH_STEPS)
    train_seqs = rng.integers(1, DEEP_ITEMS + 1, size=(b * WIDTH_STEPS, SEQ_LEN))
    k2 = row_writer.launches["write_rows"]
    trainer.train(train_seqs, targets, 1, progress_interval=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.train(train_seqs, targets, WIDTH_STEPS, progress_interval=WIDTH_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k2 = row_writer.launches["write_rows"] - k2
    check(k2 == WIDTH_STEPS + 1, f"E=32 at 1M: {k2} K2 launches in {WIDTH_STEPS + 1} pmv steps")
    check(np.isfinite(logs[-1]["train_loss"]), "E=32 at 1M: the loss is not finite")
    return {"items": DEEP_ITEMS, "max_level": tree.max_level, "embed_size": e,
            "setup_s": setup_s, "serving": serving,
            "training": {"auto_route": "pmv", "pmv_state": list(trainer.emb_state["pmv"].shape),
                         "steps_run": WIDTH_STEPS + 1, "timed_steps": WIDTH_STEPS,
                         "k2_launches": k2, "ms_per_step": elapsed / WIDTH_STEPS * 1e3,
                         "final_loss": logs[-1]["train_loss"]}}


def sweep_width_32(dev, tree_path: str, samples) -> dict:
    """One JTM sweep (train/jtm.py, gap 2) at E = 32 over the example
    catalog from seeded O(1)-scale weights (w_std) on its train windows:
    its score batches ([8192, 4], and [8192, 2] at a last odd level) take
    K1's wide kernel (U <= L); every K1 call and add held against the plain
    versions, the projection a bijection onto leaves.  The caller zeroes
    and reads the launch counts around it."""
    e = 32
    tree = ArrayTree.from_file(tree_path)
    num_index = (1 << (tree.max_level + 1)) - 1
    model = params_from_numpy(seed_params(num_index, np.random.default_rng(SEED + 52), e),
                              device=dev)
    learner = TreeLearner(tree=tree, model=model, train_seqs=samples.train_seqs,
                          train_targets=samples.train_targets, gap=2, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with k1_audited() as k1_audit, adds_audited() as add_audit:
        proj = learner.optimize()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_projection(proj, tree)
    check([SWEEP_ROWS, SWEEP_U] in k1_audit["shapes"] and add_audit["calls"] > 0,
          f"the E=32 sweep: K1 shapes {k1_audit['shapes']}, {add_audit['calls']} adds")
    return {"items": len(proj), "max_level": tree.max_level, "embed_size": e, "gap": 2,
            "rows": len(samples.train_targets), "seconds": seconds,
            "k1_vs_plain": k1_audit, "adds_bit_exact": add_audit["calls"]}


# ---------------------------------------------------------------- DeepFM
def route_lists(serv: TDMServing, packed: bool, seqs: np.ndarray) -> dict:
    """One route's raw beam output (ids, scores [B, 2*beam] on the host) and
    top-10 lists for ``seqs``, with the ms of the call (a warm-up first)."""
    serv.packed = packed
    fn = serv._beam_fn(BEAM)
    codes = serv._codes(seqs)
    fn(serv.params, codes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores = fn(serv.params, codes)
    ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    serv._beam_fns.clear()
    return {"ids": ids, "scores": scores, "lists": filter_topk(ids, scores, TOPK), "ms": ms}


def lists_up_to_near_ties(a: dict, b: dict, tol: float) -> dict:
    """Two routes' top-10 lists agree but for near ties: in a row that
    differs, every item on one list and not the other scores, in the route
    that lists it, within tol * (1 + |s|) of that route's 10th score s, and
    lists holding the same items have the same scores within that
    tolerance."""
    rows, worst = 0, 0.0
    for i, (x, y) in enumerate(zip(a["lists"], b["lists"])):
        if np.array_equal(x, y):
            continue
        rows += 1
        for r, lst in ((a, x), (b, y)):
            score = dict(zip(r["ids"][i].tolist(), r["scores"][i].tolist()))
            kth = score[int(lst[-1])]
            for item in set(x.tolist()) ^ set(y.tolist()):
                if item in lst:
                    gap = abs(score[item] - kth) / (1 + abs(kth))
                    worst = max(worst, gap)
                    check(gap <= tol, f"row {i}: item {item} differs beyond a near tie ({gap:.3e})")
        if set(x.tolist()) == set(y.tolist()):
            sx = sorted(dict(zip(a["ids"][i].tolist(), a["scores"][i].tolist()))[k] for k in x)
            sy = sorted(dict(zip(b["ids"][i].tolist(), b["scores"][i].tolist()))[k] for k in y)
            check(np.allclose(sx, sy, rtol=tol, atol=tol), f"row {i}: tied lists score apart")
    return {"rows": len(a["lists"]), "rows_differing": rows, "max_relative_gap": worst}


def deepfm_workflow(dev, seqs: np.ndarray) -> dict:
    """configs/tdm.conf and configs/jtm.conf with ``model.deep_model DeepFM``
    through the port's CLI (``model.iteration_number`` cut to
    WORKFLOW_ITERS, as in ``workflow``): init -> train -> cluster -> retrain
    -> jtm-tree-learning (every add audited); then ``TDMServing.load``
    serves the windows on the packed and the classic route, whose lists
    agree up to near ties."""
    wd = workflow_dir("workflow_deepfm", "DeepFM")
    stages: dict[str, float] = {}
    with contextlib.chdir(wd):
        for stage, command, conf in (
                ("tdm-initialize-tree", "tdm-initialize-tree", "tdm.conf"),
                ("tdm-train-deep-model", "tdm-train-deep-model", "tdm.conf"),
                ("tdm-cluster-tree", "tdm-cluster-tree", "tdm.conf"),
                ("tdm-train-deep-model (clustered tree)", "tdm-train-deep-model", "tdm.conf")):
            stages[stage] = cli_stage(command, conf)
        check(load_meta("data/tdm_model.bin")["model"] == "deepfm", "the checkpoint is no DeepFM")
        for src, dst in (("tdm_model.bin.npz", "jtm_model.bin.npz"),
                         ("tdm_model.bin.meta.json", "jtm_model.bin.meta.json"),
                         ("tdm_tree.bin", "jtm_tree.bin")):
            shutil.copy(Path("data") / src, Path("data") / dst)
        with adds_audited() as add_audit:
            stages["jtm-tree-learning"] = cli_stage("jtm-tree-learning", "jtm.conf")
        learned = ArrayTree.from_file("data/jtm_tree.bin")
        check_projection(dict(zip(learned.item_ids.tolist(), learned.item_codes.tolist())),
                         learned)
        check(add_audit["calls"] > 0, "the DeepFM sweep made no add call")
        t0 = time.perf_counter()
        serv = TDMServing.load("data/jtm_model.bin", "data/jtm_tree.bin", device=dev, topk=TOPK,
                               candidate_num=BEAM)
        stages["TDMServing.load"] = time.perf_counter() - t0
    check(serv.model_type == "deepfm" and serv._use_packed(BEAM)
          and serv.pair_table_dtype() == torch.float32,
          "DeepFM serving: not on the packed route over an f32 table")
    packed, classic = route_lists(serv, True, seqs), route_lists(serv, False, seqs)
    for lists in (packed["lists"], classic["lists"]):
        check_lists(lists, learned)
    return {"cut": f"model.iteration_number {WORKFLOW_ITERS} in tdm.conf and jtm.conf, "
                   "model.deep_model and tree.deep_model DeepFM; nothing else changed",
            "stage_seconds": stages, "total_seconds": sum(stages.values()),
            "sweep_adds_bit_exact": add_audit["calls"],
            "serving": {"windows": len(seqs), "packed_ms": packed["ms"],
                        "classic_ms": classic["ms"],
                        "packed_vs_classic": lists_up_to_near_ties(packed, classic,
                                                                   DEEPFM_NEAR_TIE)}}


def deepfm_otm(dev) -> dict:
    """configs/otm.conf with ``model.deep_model DeepFM`` through the port's
    CLI (``model.epoch_num`` cut to OTM_EPOCHS, as in ``otm_example``):
    otm-train-deep-model -> otm-construct-tree (every add audited) ->
    otm-train-deep-model under the learned mapping -> OTMServing.load and
    ``recommend_batch`` of 4096 windows."""
    wd = otm_dir("otm_deepfm", "DeepFM")
    stages: dict[str, float] = {}
    with contextlib.chdir(wd):
        stages["otm-train-deep-model"] = cli_stage("otm-train-deep-model", "otm.conf")
        check(load_meta("data/otm_model.bin")["model"] == "deepfm", "the checkpoint is no DeepFM")
        with adds_audited() as add_audit:
            stages["otm-construct-tree"] = cli_stage("otm-construct-tree", "otm.conf")
        learned = load_mapping("data/otm_mapping.txt")[0]
        conf = Path("otm.conf").read_text()
        Path("otm.conf").write_text(conf.replace("model.initialize_mapping        true",
                                                 "model.initialize_mapping        false"))
        stages["otm-train-deep-model (learned mapping)"] = cli_stage("otm-train-deep-model",
                                                                     "otm.conf")
        check(load_mapping("data/otm_mapping.txt")[0] == learned, "the retrain moved the mapping")
        serv = OTMServing.load("data/otm_model.bin", "data/otm_mapping.txt",
                               "data/example_data.csv", device=dev)
    tr = serv._trainer
    check(tr.model.model_type == "deepfm" and add_audit["calls"] > 0,
          f"DeepFM OTM: model {tr.model.model_type}, {add_audit['calls']} adds")
    windows = np.concatenate([tr.data.eval_seqs, tr.data.train_seqs])[:BATCH]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lists = tr.recommend_batch(windows)
    stages["recommend_batch(4096)"] = time.perf_counter() - t0
    check(all(len(r) == TOPK and len(np.unique(r)) == TOPK and np.isin(r, list(learned)).all()
              for r in lists), "DeepFM OTM: a list is short, repeats or holds a non-item")
    return {"cut": f"model.epoch_num {OTM_EPOCHS} in otm.conf, model.deep_model and "
                   "tree.deep_model DeepFM; nothing else changed",
            "items": tr.data.num_items, "n_levels": tr.n_levels, "stage_seconds": stages,
            "total_seconds": sum(stages.values()), "construction_adds_bit_exact": add_audit["calls"],
            "serving_windows": len(windows)}


def deepfm_1m_trainer(dev, tree: ArrayTree, **kw) -> tuple[TDMTrainer, np.ndarray, np.ndarray]:
    """bench.py's 1M trainer with model_type deepfm (``kw``: embed_dtype)
    and the windows of its steps: a warm-up, DEEPFM_STEPS timed and
    DEEPFM_AUDITED_STEPS audited steps of random items."""
    neg = ",".join(str(min(i, 2**i - 1)) for i in range(tree.max_level + 1))
    trainer = TDMTrainer(tree=tree, model_type="deepfm", embed_size=E, layer_neg_counts=neg,
                         topk=TOPK, beam_size=BEAM, seed=SEED, device=dev, **kw)
    n = trainer.num_targets_per_batch * (DEEPFM_STEPS + DEEPFM_AUDITED_STEPS)
    rng = np.random.default_rng(SEED + 60)
    targets = rng.integers(1, DEEP_ITEMS + 1, size=n)
    train_seqs = rng.integers(1, DEEP_ITEMS + 1, size=(n, SEQ_LEN))
    return trainer, train_seqs, targets


def deepfm_1m_serving(trainer: TDMTrainer, tree: ArrayTree) -> TDMServing:
    """The trained DeepFM through TDMServing, on the packed route (its
    levels in plain ops) over an f32 pair table."""
    pre, app = serving_fns("deepfm")
    serv = TDMServing(trainer.model, type(trainer.model).forward, tree, precompute=pre,
                      apply=app, apply_emb=packed_fns("deepfm")[1], model_type="deepfm",
                      topk=TOPK, candidate_num=BEAM)
    check(serv._use_packed(BEAM) and serv.pair_table_dtype() == torch.float32,
          "DeepFM at 1M: not on the packed route over an f32 table")
    return serv


def timed_batches(serv: TDMServing, seqs: np.ndarray, tree: ArrayTree, calls: int = 3) -> dict:
    """``recommend_batch(seqs)``: the first call (it builds the pair table),
    then ``calls`` timed calls, whose lists must be top-10s of items."""
    t1 = time.perf_counter()
    serv.recommend_batch(seqs)
    first_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for _ in range(calls):
        lists = serv.recommend_batch(seqs)
    search_s = time.perf_counter() - t1
    check_lists(lists, tree)
    return {"windows": len(seqs), "pair_table": "float32", "first_call_s": first_s,
            "calls": calls, "ms_per_batch": search_s / calls * 1e3,
            "qps": len(seqs) * calls / search_s}


def deepfm_deep(dev, tree: ArrayTree, seqs: np.ndarray, flush: torch.Tensor) -> dict:
    """DeepFM on the 1M catalog: bench.py's trainer with model_type deepfm
    (auto route pmv, one K2 launch a step), a warm-up and DEEPFM_STEPS timed
    steps, then DEEPFM_AUDITED_STEPS more with every K2 commit held bit for
    bit against its plain version; the trained model served through
    TDMServing on the packed route (its levels in plain ops) from an f32
    pair table, timed.  Then the same on a bf16 table (``deepfm_deep_bf16``)."""
    trainer, train_seqs, targets = deepfm_1m_trainer(dev, tree)
    check(trainer._pmv, "DeepFM at 1M: the auto route is not pmv")
    k2 = row_writer.launches["write_rows"]
    trainer.train(train_seqs, targets, 1, progress_interval=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.train(train_seqs, targets, DEEPFM_STEPS, progress_interval=DEEPFM_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    with writes_audited() as commits:
        trainer.train(train_seqs, targets, DEEPFM_AUDITED_STEPS, progress_interval=1)
    k2 = row_writer.launches["write_rows"] - k2
    steps = 1 + DEEPFM_STEPS + DEEPFM_AUDITED_STEPS
    check(k2 == steps and len(commits) == DEEPFM_AUDITED_STEPS,
          f"DeepFM at 1M: {k2} K2 launches in {steps} pmv steps, {len(commits)} audited")
    check(np.isfinite(logs[-1]["train_loss"]), "DeepFM at 1M: the loss is not finite")
    serving = timed_batches(deepfm_1m_serving(trainer, tree), seqs, tree)
    out = {"items": DEEP_ITEMS, "auto_route": "pmv", "unit": trainer.sampler.unit,
           "targets_per_step": trainer.num_targets_per_batch, "timed_steps": DEEPFM_STEPS,
           "ms_per_step": elapsed / DEEPFM_STEPS * 1e3, "k2_launches": k2,
           "k2_commits_bit_exact": len(commits), "final_loss": logs[-1]["train_loss"],
           "serving": serving}
    del trainer, commits
    torch.cuda.empty_cache()
    out["bf16_mv"] = deepfm_deep_bf16(dev, tree, seqs, flush)
    return out


def deepfm_deep_bf16(dev, tree: ArrayTree, seqs: np.ndarray, flush: torch.Tensor) -> dict:
    """DeepFM on a bf16 embedding table at 1M items, the deployment bf16
    tables exist for: bench.py's trainer with model_type deepfm and
    embed_dtype bf16 (auto route mv, as pmv needs an f32 table), a warm-up
    and DEEPFM_STEPS timed steps, then DEEPFM_AUDITED_STEPS more with every
    K2 commit of the packed m|v state and every bf16 table add held bit for
    bit against its plain version; one K2 and one ``add_rows_bf16`` launch
    a step.  Served through TDMServing on the packed route over an f32 pair
    table, its lists against the classic route's up to near ties and
    ``recommend_batch(4096)`` timed; last, the last step's commit and add
    timed warm and cold beside ``index_copy_`` / ``index_add_`` (on the
    trained state, which nothing reads after)."""
    trainer, train_seqs, targets = deepfm_1m_trainer(dev, tree, embed_dtype=torch.bfloat16)
    check(trainer._sparse and not trainer._pmv and "mv" in trainer.emb_state
          and trainer.model.embedding.dtype == torch.bfloat16,
          "bf16 DeepFM at 1M: the auto route is not mv on a bf16 table")
    before = dict(row_writer.launches)
    trainer.train(train_seqs, targets, 1, progress_interval=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.train(train_seqs, targets, DEEPFM_STEPS, progress_interval=DEEPFM_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    with writes_audited() as commits, adds_audited() as adds, capturing("add_rows") as last_add:
        trainer.train(train_seqs, targets, DEEPFM_AUDITED_STEPS, progress_interval=1)
    runs = {k: row_writer.launches[k] - before[k] for k in ("write_rows", "add_rows_bf16")}
    steps = 1 + DEEPFM_STEPS + DEEPFM_AUDITED_STEPS
    check(runs == {"write_rows": steps, "add_rows_bf16": steps}
          and len(commits) == adds["calls"] == DEEPFM_AUDITED_STEPS,
          f"bf16 DeepFM at 1M: launches {runs} in {steps} mv steps, {len(commits)} commits "
          f"and {adds['calls']} adds audited")
    check(np.isfinite(logs[-1]["train_loss"]), "bf16 DeepFM at 1M: the loss is not finite")
    serv = deepfm_1m_serving(trainer, tree)
    serving = timed_batches(serv, seqs, tree)
    packed, classic = route_lists(serv, True, seqs), route_lists(serv, False, seqs)
    serving["packed_vs_classic"] = lists_up_to_near_ties(packed, classic, DEEPFM_NEAR_TIE)
    serving["packed_ms"], serving["classic_ms"] = packed["ms"], classic["ms"]
    del serv, packed, classic
    commit = commits[-1]
    with uncounted():
        k2 = row_case("write_rows", flush=flush, warm=True, **commit)
        add = row_case("add_rows", flush=flush, warm=True, **last_add)
    return {"items": DEEP_ITEMS, "auto_route": "mv", "table": "bfloat16",
            "table_mb": trainer.model.embedding.numel() * 2 / 1e6,
            "mv_state_mb": trainer.emb_state["mv"].numel() * 4 / 1e6,
            "unit": trainer.sampler.unit, "targets_per_step": trainer.num_targets_per_batch,
            "timed_steps": DEEPFM_STEPS, "ms_per_step": elapsed / DEEPFM_STEPS * 1e3,
            "launches": runs, "k2_commits_bit_exact": len(commits),
            "adds_bit_exact": adds["calls"], "final_loss": logs[-1]["train_loss"],
            "serving": serving, "mv_commit": k2, "table_add": add}


def cli_stage(command: str, conf: str) -> float:
    """Seconds of one CLI command in process, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(cli_main([command, "--conf", conf]) == 0, f"{command} failed")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---------------------------------------------------------------- mesh
def mesh_trainer_1m(dev, tree: ArrayTree, mesh) -> dict:
    """(a)'s training leg: bench.py's 1M trainer on the mesh (auto route:
    the sharded mv state) against the single-device mv route from the same
    weights on the same negatives, bit for bit, the first step's K2 commit
    and adds audited; then a warm-up and MESH_STEPS timed steps of each."""
    tr = deep_trainer(tree, dev, mesh=mesh)
    check(tr._sparse and not tr._pmv and set(tr.emb_state) == {"mv", "count"},
          "the 1M mesh trainer did not take the sharded mv route")
    check(tr.model.embedding.numel() == 0 and tr._shard.shape[0] == tr._table_rows,
          "the 1M mesh trainer keeps a table beside its shard")
    ref = deep_trainer(tree, dev, sparse_format="mv")
    init = multihost.gather_to_host(tr.params)
    v = ref.model.embedding.shape[0]
    ref.model.load_numpy(dict(init, embedding=init["embedding"][:v]))
    b = tr.num_targets_per_batch
    rng = np.random.default_rng(SEED + 40)
    targets = rng.integers(1, DEEP_ITEMS + 1, size=b * (MESH_STEPS + MESH_PARITY_STEPS + 1))
    seqs = rng.integers(1, DEEP_ITEMS + 1, size=(len(targets), SEQ_LEN))
    seqs[:, :3] = np.where(rng.random((len(seqs), 3)) < 0.3, 0, seqs[:, :3])
    tc_all, sc_all = tree.ids_to_codes(targets), tree.ids_to_codes(seqs)
    batch = lambda i: (tr._codes(tc_all[i * b : (i + 1) * b]),  # noqa: E731
                       tr._codes(sc_all[i * b : (i + 1) * b]))
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    for i in range(MESH_PARITY_STEPS):
        tc, sc = batch(i)
        samples = tr.sampler.sample(gen, tc)
        with (writes_audited() if i == 0 else contextlib.nullcontext([])) as writes, \
                (adds_audited() if i == 0 else contextlib.nullcontext({})) as adds:
            loss = tr.step_from_samples(sc, *samples)
        if i == 0:
            audited = {"k2_calls": len(writes), "add_calls": adds["calls"]}
        with uncounted():
            check(loss.item() == ref.step_from_samples(sc, *samples).item(),
                  f"mesh 1M: step {i}'s loss differs from the single-device mv step's")
    check(audited == {"k2_calls": 1, "add_calls": 1}, f"mesh 1M: the audited step {audited}")
    named = ref._named_params()
    for n, p in flatten(tr.params).items():
        check(torch.equal(bits(p[:v] if n == "embedding" else p), bits(named[n])),
              f"mesh 1M: {n} differs from the single-device mv route's")
    check(torch.equal(bits(tr.emb_state["mv"]), bits(ref.emb_state["mv"])),
          "mesh 1M: the m|v state differs from the single-device mv route's")

    def timed(t: TDMTrainer) -> float:
        t._train_step(*batch(MESH_PARITY_STEPS))  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MESH_STEPS):
            t._train_step(*batch(MESH_PARITY_STEPS + 1 + i))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / MESH_STEPS * 1e3

    k2 = row_writer.launches["write_rows"]
    ms = timed(tr)
    k2 = row_writer.launches["write_rows"] - k2
    check(k2 == MESH_STEPS + 1, f"mesh 1M: {k2} K2 launches in {MESH_STEPS + 1} steps")
    with uncounted():
        ref_ms = timed(ref)
    held = sum(t.numel() * t.element_size() for t in (tr.model.embedding, tr._shard,
                                                      tr.emb_state["mv"]))
    return {"items": DEEP_ITEMS, "route": "sharded mv", "targets_per_step": b,
            "table_and_state_bytes_held": held,
            "parity_steps": MESH_PARITY_STEPS, "equals_single_device_mv": True,
            "first_step_audited": audited, "timed_steps": MESH_STEPS,
            "ms_per_step": ms, "single_device_mv_ms_per_step": ref_ms}


def mesh_serving_1m(dev, deep: TDMServing, deep_seqs: np.ndarray, deep_lists: list,
                    mesh) -> dict:
    """(a)'s serving leg: ``make_sharded_tree_serving_fn`` over the 1M
    catalog's f32 pair table, 4096 windows, lists equal to ``TDMServing``'s
    packed route's; one batch again with every K3 level audited."""
    model, tree = deep.params, deep.tree
    fn, route = spmd.make_sharded_tree_serving_fn(model, tree, BEAM, mesh)
    check(route == "packed", f"the 1M catalog served on the {route} route")
    codes = meshlib.local_rows(torch.as_tensor(tree.ids_to_codes(deep_seqs), dtype=torch.long,
                                               device=dev), mesh, meshlib.DATA_AXIS)
    k3 = packed_level_kernel.launches
    fn(codes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_SERVE_CALLS):
        ids, scores = fn(codes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / MESH_SERVE_CALLS * 1e3
    k3 = packed_level_kernel.launches - k3
    cfg = make_config(tree, BEAM)
    levels = cfg.max_level - cfg.start_level
    check(k3 == levels * (MESH_SERVE_CALLS + 1), f"mesh serving: {k3} K3 launches")
    lists = filter_topk(ids.cpu().numpy(), scores.cpu().numpy(), TOPK)
    check([r.tolist() for r in lists] == [r.tolist() for r in deep_lists],
          "mesh serving: the lists differ from TDMServing's packed route")
    # the unsharded packed loop of TDMServing, timed the same way (device
    # results, no host top-k)
    unsharded = deep._beam_fn(BEAM)
    with uncounted():
        unsharded(model, codes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_SERVE_CALLS):
            unsharded(model, codes)
        torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / MESH_SERVE_CALLS * 1e3
    seen = {"calls": 0, "max_abs_err": 0.0}

    def level(rows, alive, seq_e, pad, *w):
        ks, kh, _, a = k3_check(rows, alive, seq_e, pad, w[:-1], w[-1])
        seen["calls"] += 1
        seen["max_abs_err"] = max(seen["max_abs_err"], a["max_abs_err"])
        return ks, kh

    audited = spmd.make_sharded_packed_beam_fn(make_packed_tree(tree, model.embedding, BEAM),
                                               mesh, DIN.precompute_seq, level_fn=level)
    with uncounted():
        a_ids, _ = audited(model, codes)
    check(seen["calls"] == levels and torch.equal(a_ids, ids),
          f"mesh serving: the audited batch {seen}")
    return {"batch": BATCH, "levels": levels, "calls": MESH_SERVE_CALLS, "k3_launches": k3,
            "ms_per_batch": ms, "single_device_ms_per_batch": single_ms,
            "lists_equal_tdmserving": True, "k3_audit": seen}


def mesh_nccl(dev, deep: TDMServing, deep_seqs: np.ndarray, deep_lists: list) -> dict:
    """(a): world size 1 over nccl, mesh (1, 1), in this process."""
    store = OUT / "mesh_nccl.store"
    store.unlink(missing_ok=True)
    meshlib.init_distributed(f"file://{store}", 1, 0, device="cuda")
    try:
        mesh = meshlib.make_mesh(1, 1)
        return {"mesh": [1, 1], "transport": meshlib.backend(mesh),
                "training": mesh_trainer_1m(dev, deep.tree, mesh),
                "serving": mesh_serving_1m(dev, deep, deep_seqs, deep_lists, mesh)}
    finally:
        dist.destroy_process_group()


def mesh_tdm_example(dev, tree: ArrayTree, samples, mesh, rank: int) -> dict:
    """(b): the sharded sparse (mv) TDM step on the example catalog, each
    data shard's negatives from its own stream; rank 0 feeds the union of
    the shards' draws to the single-device mv route from the same weights:
    bit for bit at (1, 2), within the dense tolerances at (2, 1)."""
    kw = dict(TDM_CONF, sparse_embed_update=True, sparse_format="mv", seed=SEED, device=dev)
    tr = TDMTrainer(tree=tree, mesh=mesh, **kw)
    init = multihost.gather_to_host(tr.params)
    n_data = meshlib.axis_size(mesh, meshlib.DATA_AXIS)
    b, h = tr.num_targets_per_batch, tr.num_targets_per_batch // n_data
    tc_all = tree.ids_to_codes(samples.train_targets)
    sc_all = tree.ids_to_codes(samples.train_seqs)
    local = lambda t: meshlib.local_rows(t, mesh, meshlib.DATA_AXIS)  # noqa: E731
    steps = []
    for i in range(MESH_EXAMPLE_STEPS):
        tc, sc = tr._codes(tc_all[i * b : (i + 1) * b]), tr._codes(sc_all[i * b : (i + 1) * b])
        draws = [tr.sampler.sample(spmd_sparse.shard_generator(SEED, i, d, dev),
                                   tc[d * h : (d + 1) * h]) for d in range(n_data)]
        steps.append((sc, *(torch.cat(x) for x in zip(*draws))))
    # the warm-up step, untimed, with its K2 commit and add audited
    with writes_audited() as writes, adds_audited() as adds:
        losses = [tr.step_from_samples(*(local(t) for t in steps[0]))]
    audited = {"k2_calls": len(writes), "add_calls": adds["calls"]}
    check(audited == {"k2_calls": 1, "add_calls": 1},
          f"mesh ({n_data}, {2 // n_data}): the audited step {audited}")
    del writes
    torch.cuda.synchronize()
    dist.barrier()  # both ranks start the timed steps together
    t0 = time.perf_counter()
    losses += [tr.step_from_samples(*(local(t) for t in s)) for s in steps[1:]]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (len(steps) - 1) * 1e3
    got = flatten(tr.params)  # gathered on every rank
    out = {"targets_per_step": b, "steps": len(steps), "timed_steps": len(steps) - 1,
           "ms_per_step": ms, "losses": [x.item() for x in losses],
           "first_step_audited": audited}
    if rank == 0:
        with uncounted():
            ref = TDMTrainer(tree=tree, **kw)
            v = ref.model.embedding.shape[0]
            ref.model.load_numpy(dict(init, embedding=init["embedding"][:v]))
            ref_losses = [ref.step_from_samples(*s).item() for s in steps]
        named = ref._named_params()
        gap = max(((p[:v] if n == "embedding" else p) - named[n]).abs().div(
            PARAM_ATOL + PARAM_RTOL * named[n].abs()).max().item()
            for n, p in got.items())
        exact = n_data == 1
        if exact:
            check(out["losses"] == ref_losses and all(
                torch.equal(bits(p[:v] if n == "embedding" else p), bits(named[n]))
                for n, p in got.items()),
                "mesh (1, 2): the sharded mv step differs from the single-device step")
        else:
            check(np.allclose(out["losses"], ref_losses, rtol=LOSS_RTOL, atol=0) and gap <= 1.0,
                  f"mesh (2, 1): the sharded mv step is not within the dense tolerances: {gap}")
        out.update(bit_exact=exact, param_gap=gap, single_device_losses=ref_losses)
    return out


def snapshot_leaves(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def same_leaves(a: dict, b: dict) -> bool:
    """Key for key, dtype, shape and bit for bit."""
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.atleast_1d(a[k]).tobytes() == np.atleast_1d(b[k]).tobytes() for k in a)


def mesh_snapshots(dev, tree: ArrayTree, samples, mesh, rank: int) -> dict:
    """(b) at (1, 2): the sharded mv trainer's step snapshots.  A run killed
    after its snapshot at MESH_SNAP_EVERY steps and resumed in a fresh
    trainer ends bit for bit where an uninterrupted run ends; rank 0 holds
    the snapshot against the single-device mv trainer's at the same step
    (from the mesh trainer's init, drawing the (1, 2) mesh's negatives:
    data shard 0's stream draws the whole batch), key for key and bit for
    bit."""
    kw = dict(TDM_CONF, sparse_embed_update=True, sparse_format="mv", seed=SEED, device=dev)
    seqs, targets = samples.train_seqs, samples.train_targets
    ckpt = str(OUT / "mesh_snapshot")

    def train(tr, iters, path=None):
        tr.train(seqs, targets, iterations=iters, progress_interval=10**9,
                 checkpoint_path=path, checkpoint_every=MESH_SNAP_EVERY if path else 0)
        return tr

    full = train(TDMTrainer(tree=tree, mesh=mesh, **kw), MESH_SNAP_ITERS)
    init = copy.deepcopy(multihost.gather_to_host(TDMTrainer(tree=tree, mesh=mesh, **kw).params))
    if rank == 0:
        Path(ckpt + ".npz").unlink(missing_ok=True)
    dist.barrier()
    t0 = time.perf_counter()
    train(TDMTrainer(tree=tree, mesh=mesh, **kw), MESH_SNAP_KILL, ckpt)
    kill_s = time.perf_counter() - t0
    kept = snapshot_leaves(Path(ckpt + ".npz"))
    resumed = train(TDMTrainer(tree=tree, mesh=mesh, **kw), MESH_SNAP_ITERS, ckpt)
    got, want = flatten(resumed.params), flatten(full.params)  # gathered on every rank
    check(sorted(got) == sorted(want) and all(torch.equal(bits(got[n]), bits(want[n]))
                                               for n in got),
          "mesh (1, 2): the resumed run differs from the uninterrupted one")
    check(resumed.adam["count"] == full.adam["count"] and resumed.emb_state["count"]
          == full.emb_state["count"], "mesh (1, 2): the resumed run's step counts differ")
    out = {"iterations": MESH_SNAP_ITERS, "killed_after": MESH_SNAP_KILL,
           "snapshot_every": MESH_SNAP_EVERY, "snapshot_keys": len(kept),
           "snapshot_mb": sum(v.nbytes for v in kept.values()) / 1e6,
           "killed_run_s": kill_s, "resumed_equals_uninterrupted": True}
    dist.barrier()
    if rank == 0:
        with uncounted():
            ref = TDMTrainer(tree=tree, **kw)
            v = ref.model.embedding.shape[0]
            ref.model.load_numpy(dict(init, embedding=init["embedding"][:v]))
            step = [0]

            def sample(target_codes):
                g = spmd_sparse.shard_generator(SEED, step[0], 0, dev)
                step[0] += 1
                return ref.sampler.sample(g, target_codes)

            ref.sample = sample
            single = OUT / "single_snapshot"
            Path(str(single) + ".npz").unlink(missing_ok=True)
            train(ref, MESH_SNAP_KILL, str(single))
        check(same_leaves(kept, snapshot_leaves(Path(str(single) + ".npz"))),
              "mesh (1, 2): rank 0's snapshot differs from the single-device trainer's")
        out["equals_single_device_snapshot"] = True
    return out


def mesh_serving_deep(dev, tree: ArrayTree, model: DIN, seqs: np.ndarray, mesh) -> dict:
    """(b): sharded packed serving of 4096 windows on the 1M catalog; the
    lists go to the parent, which holds them against TDMServing's."""
    fn, route = spmd.make_sharded_tree_serving_fn(model, tree, BEAM, mesh)
    codes = meshlib.local_rows(torch.as_tensor(tree.ids_to_codes(seqs), dtype=torch.long,
                                               device=dev), mesh, meshlib.DATA_AXIS)
    fn(codes)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(MESH_SERVE_CALLS):
        ids, scores = fn(codes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / MESH_SERVE_CALLS * 1e3
    got = multihost.gather_to_host({"ids": ids, "scores": scores}, mesh, meshlib.DATA_AXIS)
    return {"route": route, "ms_per_batch": ms,
            "lists": [r.tolist() for r in filter_topk(got["ids"], got["scores"], TOPK)]}


def mesh_sweep_example(dev, tree: ArrayTree, samples, model: DIN, mesh, rank: int) -> dict:
    """(b): a mesh JTM sweep on the example catalog, every K1 call of its
    sharded scoring (this rank's rows of each score batch) and every add
    of its accumulation held against the plain versions; rank 0 holds its
    projection against the single-device sweep's."""
    t0 = time.perf_counter()
    with k1_audited() as k1_audit, adds_audited() as add_audit:
        proj = TreeLearner(tree, model, samples.train_seqs, samples.train_targets, mesh=mesh,
                           device=dev).optimize()
    check(k1_audit["calls"] > 0 and add_audit["calls"] > 0,
          f"mesh sweep: audited {k1_audit['calls']} K1 calls and {add_audit['calls']} adds")
    out = {"seconds": time.perf_counter() - t0, "items": len(proj), "k1_audit": k1_audit,
           "add_audit": add_audit}
    if rank == 0:
        with uncounted():
            ref = TreeLearner(tree, model, samples.train_seqs, samples.train_targets,
                              device=dev).optimize()
        check(proj == ref, "mesh sweep: the projection differs from the single-device sweep's")
        out["equals_single_device"] = True
    return out


def mesh_dr_example(dev, data: DRData, mesh, rank: int) -> dict:
    """(b) at (1, 2): DRTrainer(mesh=)'s E-step on the example data, its
    three K2 commits audited; rank 0 holds it bit for bit against the
    single-device pmv E-step from the same seed on the same negatives."""
    tr = DRTrainer(data, seed=SEED, mesh=mesh, device=dev, **DR_CONF)
    b = tr.num_targets_per_batch
    seqs, paths, labels = dr_estep_batch(tr, data.train_seqs[:b], data.train_targets[:b])
    negs = tr.sample_negatives(labels)
    with writes_audited() as calls:
        lm, rm = tr._estep_fused(seqs, paths, labels, negs)
    check(len(calls) == 3, f"mesh DR: one E-step made {len(calls)} K2 calls, not 3")
    check(tr.rerank_params["embedding"].numel() == 0 and tr.layer_params["embedding"].numel() == 0,
          "mesh DR: the trainer keeps whole tables beside its slices")
    out = {"targets_per_step": b, "audited_k2_calls": [[list(c["table"].shape), len(c["idx"])]
                                                       for c in calls]}
    with tr.whole_table():  # gathered on every rank
        got = [flatten(tr.layer_params), flatten(tr.rerank_params)]
    if rank == 0:
        with uncounted():
            ref = DRTrainer(data, seed=SEED, sparse_embed_update=True, device=dev, **DR_CONF)
            check(ref._pmv, "the single-device DR trainer is not pmv")
            lr_, rr = ref._estep_fused(seqs, paths, labels, negs)
            ref._sync_mirrors()
        check(torch.equal(lm, lr_) and torch.equal(rm, rr), "mesh DR: the losses differ")
        for a, r in zip(got, (ref.layer_params, ref.rerank_params)):
            refs = flatten(r)
            for n, t in a.items():
                check(torch.equal(bits(t.contiguous()), bits(refs[n].contiguous())),
                      f"mesh DR: {n} differs from the single-device pmv E-step's")
        out["equals_single_device_pmv"] = True
    del got
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(MESH_DR_STEPS):
        tr._estep_fused(seqs, paths, labels, negs)
    torch.cuda.synchronize()
    out["ms_per_estep"] = (time.perf_counter() - t0) / MESH_DR_STEPS * 1e3
    return out


def mesh_ranks(dev, tree_path: str, seqs_path: str) -> dict:
    """(b): one of two ranks sharing the card over gloo; both meshes of the
    two-rank world, (1, 2) and (2, 1).  Counts its own launches around its
    legs, the single-device comparisons uncounted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    meshes = {s: meshlib.make_mesh(*s, device=dev.type) for s in ((1, 2), (2, 1))}
    tree = ArrayTree.from_file(tree_path)
    raw = read_csv(str(ROOT / "data" / "example_data.csv"))
    samples = generate_split_samples(user_interactions(raw), SEQ_LEN, 2, 0.8)
    model = params_from_numpy(seed_params((1 << (tree.max_level + 1)) - 1,
                                          np.random.default_rng(SEED)), device=dev)
    deep = deep_tree(DEEP_ITEMS)
    deep_model = params_from_numpy(seed_params((1 << (deep.max_level + 1)) - 1,
                                               np.random.default_rng(SEED + 2)), device=dev)
    dr_data = build_dr_data(str(ROOT / "data" / "example_data.csv"), SEQ_LEN, 2, 0.8)
    out = {"rank": rank, "transport": meshlib.backend(meshes[(1, 2)])}
    zero_launches()
    for shape, mesh in meshes.items():
        out[str(list(shape))] = {
            "tdm_example": mesh_tdm_example(dev, tree, samples, mesh, rank),
            "serving_1m": mesh_serving_deep(dev, deep, deep_model, np.load(seqs_path), mesh),
            "jtm_sweep": mesh_sweep_example(dev, tree, samples, model, mesh, rank)}
    out["dr_example_1x2"] = mesh_dr_example(dev, dr_data, meshes[(1, 2)], rank)
    out["snapshots_1x2"] = mesh_snapshots(dev, tree, samples, meshes[(1, 2)], rank)
    out["launches"] = read_launches()
    return out


def mesh(dev, deep: TDMServing, deep_seqs: np.ndarray, deep_lists: list, tree_path: str,
         smi: str) -> dict:
    """The mesh phase: (a) in this process, (b) on two spawned ranks; each
    rank's launches and the sum over (a) and (b)."""
    zero_launches()
    t0 = time.perf_counter()
    a = mesh_nccl(dev, deep, deep_seqs, deep_lists)
    a["launches"] = read_launches()
    a["seconds"] = time.perf_counter() - t0
    seqs_path = OUT / "mesh_deep_seqs.npy"
    np.save(seqs_path, deep_seqs)
    t0 = time.perf_counter()
    ranks = multiproc.spawn(mesh_ranks, 2, (tree_path, str(seqs_path)), device="cuda",
                            backend="gloo", timeout=MESH_TIMEOUT_S)
    for r in ranks:
        check(r["transport"] == "gloo", f"rank {r['rank']}: transport {r['transport']}")
        for shape in ("[1, 2]", "[2, 1]"):
            serve = r[shape]["serving_1m"]
            check(serve["route"] == "packed", f"rank {r['rank']} {shape}: {serve['route']}")
            check(serve.pop("lists") == [x.tolist() for x in deep_lists],
                  f"rank {r['rank']} {shape}: the sharded lists differ from TDMServing's")
            serve["lists_equal_tdmserving"] = True
    launches = {k: a["launches"][k] + sum(r["launches"][k] for r in ranks)
                for k in a["launches"]}
    return {"nvidia_smi": smi, "nccl_world_1": a,
            "gloo_two_ranks": {"seconds": time.perf_counter() - t0,
                               "transport": "gloo (CUDA buffers staged through host memory)",
                               "ranks": ranks},
            "launches": launches}


# ---------------------------------------------------------------- native
class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def log_lines(name: str):
    """The messages logger ``name`` emits at INFO and up inside the block."""
    logger, handler = logging.getLogger(name), _Lines()
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield handler.lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def cd_walls(lines: list[str]) -> dict:
    """coordinate_descent's phase walls and greedy route, from its log line."""
    m = re.search(r"collect\(beam\+aggregate\) ([\d.]+)s, greedy\[(\w+)\] ([\d.]+)s",
                  "\n".join(lines))
    check(m is not None, f"coordinate descent logged no phase walls: {lines}")
    return {"collect_s": float(m[1]), "greedy_route": m[2], "greedy_s": float(m[3])}


@contextlib.contextmanager
def python_forms():
    """The host library switched off (``DISMEMBER_NO_NATIVE``, read on
    every ``get_lib`` call): the callers take their Python forms."""
    old = os.environ.get("DISMEMBER_NO_NATIVE")
    os.environ["DISMEMBER_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DISMEMBER_NO_NATIVE"]
        else:
            os.environ["DISMEMBER_NO_NATIVE"] = old


def host_seconds(fn):
    """(fn(), host seconds)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def native_cd(dev) -> dict:
    """bench.py's index-learning cell through the port: streaming
    coordinate descent on one untrained trainer, once with the native
    greedy and once with the Python loop; equal paths."""
    data = dr_data(CD_ITEMS, CD_ROWS, np.random.default_rng(SEED))
    tr = DRTrainer(data, num_layers=3, num_nodes=100, num_paths_per_item=2, embed_size=E,
                   train_batch_size=8192, num_sampled=DR_SAMPLED, seed=SEED, device=dev)
    runs, paths = {}, {}
    for greedy in ("native", "python"):
        with log_lines("dismember_tpu_torch.dr_cd") as lines:
            torch.cuda.synchronize()
            idx, wall = host_seconds(lambda: coordinate_descent(  # noqa: B023
                tr, data.train_seqs, data.train_targets, num_candidate_path=CD_CANDIDATES,
                batch_size=8192, mode="streaming", seed=SEED, greedy=greedy))
        walls = cd_walls(lines)
        check(walls["greedy_route"] == greedy, f"greedy={greedy!r} ran {walls}")
        runs[greedy] = {"wall_s": wall, **walls, "greedy_share": walls["greedy_s"] / wall}
        paths[greedy] = idx.item_paths
    check(np.array_equal(paths["native"], paths["python"]),
          "coordinate descent: the native greedy's paths differ from the Python loop's")
    return {"items": CD_ITEMS, "rows": CD_ROWS, "candidates": CD_CANDIDATES,
            "mode": "streaming", "paths_equal": True, **runs}


def codec_case(name: str, ids: np.ndarray, codes: np.ndarray, stat) -> dict:
    """One tree through the native and the Python codec: equal bytes, then
    equal arrays read back."""
    paths = {r: OUT / f"codec_{name}_{r}.bin" for r in ("native", "python")}
    out = {"items": int(len(ids))}
    write = lambda r: write_tree(str(paths[r]), ids, codes, stat)  # noqa: E731
    _, out["native_write_s"] = host_seconds(lambda: write("native"))
    with python_forms():
        _, out["python_write_s"] = host_seconds(lambda: write("python"))
    check(paths["native"].read_bytes() == paths["python"].read_bytes(),
          f"codec {name}: the native writer's bytes differ from the Python codec's")
    got, out["native_read_s"] = host_seconds(lambda: read_tree(str(paths["native"])))
    with python_forms():
        ref, out["python_read_s"] = host_seconds(lambda: read_tree(str(paths["native"])))
    check(got.max_level == ref.max_level and all(
        np.array_equal(getattr(got, f), getattr(ref, f))
        for f in ("item_ids", "leaf_codes", "node_codes", "node_ids", "node_probs",
                  "node_is_leaf")), f"codec {name}: the native reader's arrays differ")
    out["file_mb"] = paths["native"].stat().st_size / 1e6
    for p in paths.values():
        p.unlink()
    return dict(out, bytes_equal=True, arrays_equal=True)


def codec_timed(name: str, tree: ArrayTree) -> dict:
    """The native write and read of a catalog's tree (its leaves as they
    sit), the read-back checked against the tree."""
    path = OUT / f"codec_{name}.bin"
    _, write_s = host_seconds(lambda: write_tree(str(path), tree.item_ids, tree.item_codes))
    got, read_s = host_seconds(lambda: read_tree(str(path)))
    check(got.max_level == tree.max_level
          and np.array_equal(np.sort(got.item_ids), tree.item_ids.astype(np.int64)),
          f"codec {name}: the tree read back differs")
    out = {"items": tree.num_items, "native_write_s": write_s, "native_read_s": read_s,
           "file_mb": path.stat().st_size / 1e6}
    path.unlink()
    return out


def native_csv() -> dict:
    """data/example_data.csv through the native parser and the Python one:
    equal fields, equal per-user interactions."""
    path = str(ROOT / "data" / "example_data.csv")
    got, native_s = host_seconds(lambda: read_csv(path))
    ui, ui_native_s = host_seconds(lambda: user_interactions(got))
    with python_forms():
        ref, python_s = host_seconds(lambda: read_csv(path))
        ui_ref, ui_python_s = host_seconds(lambda: user_interactions(ref))
    check(all(np.array_equal(getattr(got, f), getattr(ref, f)) and
              getattr(got, f).dtype == getattr(ref, f).dtype
              for f in ("user", "item", "category", "label", "timestamp"))
          and got.category_names == ref.category_names, "csv: the native parser's fields differ")
    check(list(ui) == list(ui_ref) and all(np.array_equal(ui[u], ui_ref[u]) for u in ui),
          "csv: the native user_interactions differ")
    return {"rows": int(len(got.user)), "users": len(ui), "native_parse_s": native_s,
            "python_parse_s": python_s, "native_interactions_s": ui_native_s,
            "python_interactions_s": ui_python_s, "fields_equal": True,
            "interactions_equal": True}


def cooc_inputs(n_items: int, rng: np.random.Generator):
    n_edges = n_items * COOC_EDGES_PER_ITEM
    dst = np.sort(rng.integers(0, n_items, n_edges))
    src = rng.integers(0, n_items, n_edges)
    wn = rng.random(n_edges, dtype=np.float32)
    f = rng.standard_normal((n_items, COOC_DIM), dtype=np.float32)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(dst)) + 1])
    return starts, dst[starts], src, wn, f


def native_cooc() -> dict:
    """cooc_apply_native against numpy's reduceat form at COOC_ITEMS (within
    COOC_RTOL/COOC_ATOL), then the native pass alone at COOC_TIMED_ITEMS."""
    rng = np.random.default_rng(SEED + 21)
    starts, segs, src, wn, f = cooc_inputs(COOC_ITEMS, rng)
    got = np.zeros_like(f)
    ok, native_s = host_seconds(lambda: host.cooc_apply_native(starts, segs, src, wn, f, got))
    check(ok, "cooc_apply_native did not run")
    ref = np.zeros_like(f)

    def numpy_form():
        ref[segs] = np.add.reduceat(f[src] * wn[:, None], starts, axis=0)

    _, numpy_s = host_seconds(numpy_form)
    err = np.abs(got - ref)
    check(bool((err <= COOC_ATOL + COOC_RTOL * np.abs(ref)).all()),
          f"cooc: the native pass is beyond rtol {COOC_RTOL}, atol {COOC_ATOL}: "
          f"{float(err.max())}")
    del ref, got
    starts, segs, src, wn, f = cooc_inputs(COOC_TIMED_ITEMS, rng)
    g = np.zeros_like(f)
    _, big_s = host_seconds(lambda: host.cooc_apply_native(starts, segs, src, wn, f, g))
    # the timed pass did the work: 1,000 segments summed by numpy
    ends = np.append(starts[1:], len(src))
    sample = rng.choice(len(segs), 1000, replace=False)
    want = np.stack([(f[src[starts[i] : ends[i]]] * wn[starts[i] : ends[i], None]).sum(0)
                     for i in sample])
    check(np.allclose(g[segs[sample]], want, rtol=COOC_RTOL, atol=COOC_ATOL),
          f"cooc at {COOC_TIMED_ITEMS}: sampled segments differ from numpy's sums")
    return {"threads": os.cpu_count(), "dim": COOC_DIM, "edges_per_item": COOC_EDGES_PER_ITEM,
            f"check_{COOC_ITEMS}": {"native_s": native_s, "numpy_reduceat_s": numpy_s,
                                    "max_abs_err": float(err.max()),
                                    "tolerance": [COOC_RTOL, COOC_ATOL]},
            f"timed_{COOC_TIMED_ITEMS}": {"native_s": big_s}}


def native_phase(dev, smi: str, samples, tree_1m: ArrayTree, tree_10m: ArrayTree) -> dict:
    """The port's host library: built here (no fallback: a missing library
    fails the run), then bench.py's index-learning cell, the tree codec,
    CSV ingest and the co-occurrence pass against their Python forms.
    Every time is host time on the card machine's CPU."""
    t_phase = time.perf_counter()
    check(host.get_lib() is not None, "native: the port's host library is not loaded")
    out = {"nvidia_smi": smi, "library": str(host.library_path().relative_to(ROOT)),
           "coordinate_descent": native_cd(dev)}
    raw = read_csv(str(ROOT / "data" / "example_data.csv"))
    ids, cats = unique_items_with_category(raw)
    sid, codes = category_sorted_codes(ids, cats)
    rng = np.random.default_rng(SEED + 20)
    syn = np.arange(1, CODEC_ITEMS + 1)
    syn_sid, syn_codes = category_sorted_codes(syn, syn % 97)
    syn_stat = {int(i): int(c) for i, c in zip(syn, rng.integers(0, 50, CODEC_ITEMS)) if c}
    out["tree_codec"] = {"example": codec_case("example", sid, codes, samples.stat),
                         "synthetic": codec_case("synthetic", syn_sid, syn_codes, syn_stat),
                         "catalog_1m": codec_timed("1m", tree_1m),
                         "catalog_10m": codec_timed("10m", tree_10m)}
    out["csv"] = native_csv()
    out["cooc"] = native_cooc()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------- reference recall
def recall_runs(dev, tree: ArrayTree, samples, model_type: str = "din", **conf) -> dict:
    """scripts/sparse_quality_check.py's protocol at RECALL_SEEDS: tdm.conf's
    trainer (``conf`` replacing its settings), RECALL_ITERS dense steps,
    ``evaluate`` on the whole eval split; each run and the mean recall@10."""
    eval_data = (samples.eval_seqs, samples.eval_labels, samples.eval_users)
    runs = []
    for seed in RECALL_SEEDS:
        tr = TDMTrainer(tree=tree, model_type=model_type, seed=seed, device=dev,
                        sparse_embed_update=False, **{**TDM_CONF, **conf})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(samples.train_seqs, samples.train_targets, RECALL_ITERS,
                 progress_interval=RECALL_ITERS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev = tr.evaluate(eval_data, samples.user_consumed)
        runs.append({"seed": seed, "train_s": t1 - t0, "eval_s": time.perf_counter() - t1,
                     **{k: getattr(ev, k) / ev.count
                        for k in ("recall", "precision", "ndcg", "loss")}})
        del tr
    return {"runs": runs, "mean_recall": float(np.mean([r["recall"] for r in runs]))}


def within_recall_band(runs: dict, jax_mean: float) -> dict:
    return {**runs, "jax_cpu_mean_recall": jax_mean, "gap": runs["mean_recall"] - jax_mean,
            "within_band": abs(runs["mean_recall"] - jax_mean) <= RECALL_BAND}


def reference_recall(dev, tree_path: str, samples) -> dict:
    """ROADMAP item 5's check: scripts/sparse_quality_check.py's protocol
    (configs/tdm.conf's trainer, RECALL_ITERS dense steps, E = 16, the
    category tree, ``evaluate`` on the whole eval split) for DIN and DeepFM
    at RECALL_SEEDS; each model's mean recall@10 within RECALL_BAND of the
    JAX package's mean (JAX_RECALL)."""
    tree = ArrayTree.from_file(tree_path)
    out = {m: within_recall_band(recall_runs(dev, tree, samples, m), JAX_RECALL[m])
           for m in ("din", "deepfm")}
    out.update(protocol=f"configs/tdm.conf's trainer, {RECALL_ITERS} dense iterations, E={E}, "
                        f"category tree, evaluate on {len(samples.eval_seqs)} eval windows",
               band=RECALL_BAND, seeds=list(RECALL_SEEDS))
    return out


def wide_recipe(dev, e: int, data) -> dict:
    """(c): scripts/quality_push_torch.py's recipe at width ``e``
    (WIDE_RECIPES[e], WIDE_ITERS iterations a stage) with every K1 call of
    its trainers (the evaluations' classic beams) and of the JTM sweep held
    against ``din_score_plain``; then the learned tree served through
    TDMServing's packed route from an f32 and a bf16 pair table
    (width_serving: the f32 route's every K3 level audited, its lists equal
    to the plain route's up to near ties, the bf16 table's equal to the f32
    one's; ``predict`` over the catalog against K1's plain version)."""
    name = WIDE_RECIPES[e]
    cfg = quality_push_torch.VARIANTS[name]
    check(cfg["embed"] == e, f"{name} is not at E={e}")
    lines = []
    t0 = time.perf_counter()
    with k1_audited() as k1_audit:
        tr = quality_push_torch.run_variant(name, cfg, data, str(OUT / "quality_push_torch"),
                                            device=dev, iters=WIDE_ITERS, report=lines.append)
    recipe_s = time.perf_counter() - t0
    check([ln["run"] for ln in lines] == [f"{name}-stage{i}-{s}" for i, s in
                                           enumerate(("category", "cluster", "jtm"), 1)],
          f"{name}: stages {lines}")
    check(all(0.0 <= ln[k] <= 1.0 for ln in lines for k in ("recall", "precision", "ndcg")),
          f"{name}: metrics {lines}")
    check(k1_audit["calls"] > 0, f"{name}: no K1 call was audited")
    check(tr.tree.num_items == len(data.item_ids), f"{name}: the learned tree lost items")
    serving = width_serving(dev, tr.model, tr.tree, data.samples.eval_seqs)
    return {"variant": name, "cut": {"iterations_a_stage": WIDE_ITERS, "variant's": cfg["iters"]},
            "stages": lines, "recipe_s": recipe_s, "k1_vs_plain": k1_audit, "serving": serving}


def wide_deep(dev, e: int, tree: ArrayTree, seqs: np.ndarray) -> dict:
    """(d): DIN at width ``e`` on the 1M catalog from seeded O(1)-scale
    weights (w_std), ``recommend_batch(4096)`` on the packed route (16 K3
    levels) from an f32 and a bf16 pair table (width_serving)."""
    t0 = time.perf_counter()
    num_index = (1 << (tree.max_level + 1)) - 1
    model = params_from_numpy(seed_params(num_index, np.random.default_rng(SEED + 60 + e), e),
                              device=dev)
    setup_s = time.perf_counter() - t0
    return {"items": DEEP_ITEMS, "embed_size": e, "setup_s": setup_s,
            "serving": width_serving(dev, model, tree, seqs)}


def wide(dev, tree_path: str, samples, deep: TDMServing, deep_seqs: np.ndarray) -> dict:
    """The wide path: (c) the recipe at E = 64, 96 and 128, (d) 1M serving
    at WIDE_DEEP and (e) the E = 64 recall check; the caller zeroes and
    reads the launch counts around it."""
    data = quality_push_torch.load_data()
    out = {f"recipe_e{e}": wide_recipe(dev, e, data) for e in WIDE}
    out.update({f"deep_e{e}": wide_deep(dev, e, deep.tree, deep_seqs) for e in WIDE_DEEP})
    tree = ArrayTree.from_file(tree_path)
    cfg = quality_push_torch.VARIANTS["e64x6k"]
    out["recall_e64"] = within_recall_band(
        recall_runs(dev, tree, samples, embed_size=cfg["embed"], learning_rate=cfg["lr"]),
        JAX_RECALL_E64)
    out["recall_e64"]["protocol"] = (
        f"stage 1 of e64x6k cut to {RECALL_ITERS} dense iterations: configs/tdm.conf's "
        f"trainer at E=64, lr {cfg['lr']}, category tree, evaluate on "
        f"{len(samples.eval_seqs)} eval windows")
    return out


def launch_us(dev, n: int = 2000) -> float:
    """Host microseconds a launch: ``n`` in-place adds on a small tensor,
    ended by a synchronize (after a warm-up)."""
    x = torch.zeros(16, device=dev)
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def traced_batch(dev, deep: TDMServing, seqs: np.ndarray, calls: int, ms_phase5: float) -> dict:
    """One 1M ``recommend_batch`` inside ``core.profiling.trace``, whose
    Chrome trace must name K3's kernel; ``calls`` batches and the host's
    launch rate timed just before the trace and just after it (the
    profiler's after-effect), beside phase 5's time of the same batch."""
    def batch_ms() -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            deep.recommend_batch(seqs)
        return (time.perf_counter() - t0) / calls * 1e3

    before = {"ms_per_batch": batch_ms(), "us_per_launch": launch_us(dev)}
    trace_dir = ROOT / "chiprun_out" / "trace_torch"
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with profiling.trace(str(trace_dir)):
        deep.recommend_batch(seqs)
    traced_s = time.perf_counter() - t0
    after = {"ms_per_batch": batch_ms(), "us_per_launch": launch_us(dev)}
    (trace_path,) = trace_dir.glob("trace_*.json")
    k3_events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
                 if e.get("cat") == "kernel" and "packed_level" in e.get("name", "")]
    check(len(k3_events) > 0, f"the trace {trace_path} names no K3 kernel")
    return {"path": str(trace_path.relative_to(ROOT)), "traced_call_s": traced_s,
            "mb": trace_path.stat().st_size / 1e6, "k3_kernel_events": len(k3_events),
            "k3_kernel_name": k3_events[0]["name"], "calls": calls,
            "phase5_ms_per_batch": ms_phase5, "before_trace": before, "after_trace": after}


def main() -> int:
    # ---- 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "environment", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    OUT.mkdir(parents=True, exist_ok=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = _cuda.library_path()
    _cuda.library()
    log = lib_path.with_suffix(".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    usage = instance_usage(log)
    # the port's host library (csrc/host_ops.cc, g++): no fallback here
    host_lib, host_build_s = host_seconds(host.get_lib)
    check(host_lib is not None, "the port's host library did not build")
    # template arguments as nvcc mangles them: <kAdd, T>
    add_usage = {dt: ptxas_usage(log, f"write_kernelILb1E{m}E")
                 for dt, m in (("f32", "f"), ("bf16", "13__nv_bfloat16"))}
    mma = mma_counts(lib_path)
    rerank_usage = {e: ptxas_usage(log, f"dr_rerank_kernelILi{e}E")
                    for e in dr_rerank.KERNEL_WIDTHS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib_path.relative_to(ROOT)), "ptxas": ptxas,
          "instances": {n: {**u, "register_cap": reg_cap(n)} for n, u in sorted(usage.items())},
          "add_ptxas": add_usage, "dr_rerank_ptxas": rerank_usage, "sass_mma": mma,
          "host_library": str(host.library_path().relative_to(ROOT)),
          "host_library_s": host_build_s})
    # every K1 and K3 instance within its register cap (K1 and the one-tile
    # K3 at E <= 16: 64; K1's direct kernel at E = 8: 128) and no spill;
    # every K3 instance on the tensor cores
    expected = {f"K1 E={e}" for e in KERNEL_WIDTHS} | {"K1 E=8 direct"} | {
        f"K3 E={e} {r} {t}" for e in KERNEL_WIDTHS for r in ("f32", "bf16")
        for t in ("one-tile", "tiles")}
    check(set(usage) == expected, f"the build's K1/K3 instances: {sorted(usage)}")
    over = {n: u for n, u in usage.items()
            if not 0 < u["registers"] <= reg_cap(n) or u["spill_bytes"]}
    check(not over, f"instances past their register cap or spilling: {over}")
    check(all(0 < u["registers"] <= 64 and u["spill_bytes"] == 0 for u in add_usage.values()),
          f"the row add uses more than 64 registers or spills: {add_usage}")
    check(all(u["registers"] > 0 and u["spill_bytes"] == 0 for u in rerank_usage.values()),
          f"the DR rerank kernel is missing a width or spills: {rerank_usage}")
    # K3 and the wide K1 on the tensor cores, K3 on wgmma
    no_mma = tensor_core_gate(mma)
    check(not no_mma, f"instances without their tensor-core instructions (HMMA, HGMMA): {no_mma}")

    # ---- 3. kernels against their plain versions
    tree_path, ckpt, seqs, facts4, samples, heavy = example_data()  # set-up of the main path
    weights = tuple(t.detach() for t in params_from_numpy(
        seed_params(7, np.random.default_rng(SEED + 4)), device=dev).scorer_weights())
    kern = kernels_vs_plain(dev, weights, facts4["catalog_items"])
    flush = torch.empty(64 << 20, device=dev)
    kern_w = {e: kernels_at_width(dev, e, facts4["catalog_items"], flush) for e in WIDTHS}
    del flush
    emit({"phase": "kernels", "tolerance": TOL, "flip_share": FLIP_SHARE, **kern,
          **{f"e{e}": k for e, k in kern_w.items()}})

    deep, deep_seqs, facts5 = deep_catalog(dev)  # set-up of the main path

    # ---- 4 + 5. the main path: launch counts zeroed just before, read just after
    zero_launches()
    t0 = time.perf_counter()
    serv = TDMServing.load(ckpt, tree_path, topk=TOPK, candidate_num=BEAM)
    packed_lists = serv.recommend_batch(seqs)  # auto route: packed (K3)
    k3_example = packed_level_kernel.launches
    # the heaviest user: beam (210 + 10) // 2 = 110 on the packed route
    heavy_rec = serv.recommend(heavy[-SEQ_LEN:], consumed=heavy)
    k3_heavy = packed_level_kernel.launches - k3_example
    classic = TDMServing.load(ckpt, tree_path, topk=TOPK, candidate_num=BEAM, packed=False)
    classic_lists = classic.recommend_batch(seqs)  # classic route (K1)
    k1_classic = din_kernel.launches
    pred_items = serv.tree.item_ids.astype(np.int64)
    pred = serv.predict(seqs[0], pred_items)  # K1 over the whole catalog
    facts4["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deep.recommend_batch(deep_seqs)  # the first call builds the pair table
    facts5["first_call_s"] = time.perf_counter() - t0
    calls = 5
    t0 = time.perf_counter()
    for _ in range(calls):
        deep_lists = deep.recommend_batch(deep_seqs)
    elapsed = time.perf_counter() - t0
    launches = read_launches()

    # ---- 4. checks of the example catalog's routes
    cfg = make_config(serv.tree, BEAM)
    levels = cfg.max_level - cfg.start_level
    check(k3_example == levels, f"packed route: {k3_example} K3 launches, not {levels}")
    heavy_beam = (len(heavy) + TOPK) // 2
    hcfg = make_config(serv.tree, heavy_beam)
    check(k3_heavy == hcfg.max_level - hcfg.start_level,
          f"the heavy user's recommend: {k3_heavy} K3 launches")
    check_lists([heavy_rec], serv.tree)
    check(not np.isin(heavy_rec, heavy).any(), "recommend returned a consumed item")
    check(k1_classic == levels, f"classic route: {k1_classic} K1 launches, not {levels}")
    check(launches["din_score"] == levels + 1, "predict did not launch K1 once")
    check_lists(packed_lists, serv.tree)
    check_lists(classic_lists, classic.tree)
    check(pred.shape == pred_items.shape and bool(np.isfinite(pred).all()), "predict output")
    codes = torch.as_tensor(serv.tree.ids_to_codes(seqs), dtype=torch.long, device=dev)
    codes_heavy = torch.as_tensor(serv.tree.ids_to_codes(heavy[None, -SEQ_LEN:]),
                                  dtype=torch.long, device=dev)
    with torch.inference_mode():
        # predict's logits: K1's (as predict computed them) against plain
        item_codes = torch.as_tensor(serv.tree.ids_to_codes(pred_items[None]),
                                     dtype=torch.long, device=dev)
        logits = serv.params(item_codes, codes[:1])[0]
        check(np.array_equal(torch.sigmoid(logits).cpu().numpy(), pred),
              "predict is not the sigmoid of K1's logits")
        logits_plain = plain_apply(serv.params, item_codes,
                                   serv.params.precompute_seq(codes[:1]))[0]
    facts4.update(
        items=serv.tree.num_items, max_level=serv.tree.max_level, batch=BATCH,
        launches={"packed_route_k3": k3_example, "classic_route_k1": k1_classic,
                  "predict_k1": launches["din_score"] - k1_classic},
        packed_vs_plain=audit_packed(
            serv.params, make_packed_tree(serv.tree, serv.params.embedding, BEAM),
            codes, packed_lists),
        classic_vs_plain=audit_classic(classic.params, classic.tree, codes, classic_lists),
        predict_logits_vs_plain=within("din_score", logits, logits_plain),
        heavy_user={"interactions": len(heavy), "beam": heavy_beam, "k3_launches": k3_heavy,
                    "vs_plain": audit_packed(
                        serv.params, make_packed_tree(serv.tree, serv.params.embedding,
                                                      heavy_beam),
                        codes_heavy, topk_lists(serv._beam_fn(heavy_beam), serv.params,
                                                codes_heavy))},
    )
    emit({"phase": "example_serving", **facts4})

    # ---- 5. checks of the deep catalog
    dcfg = make_config(deep.tree, BEAM)
    dlevels = dcfg.max_level - dcfg.start_level
    k3_deep = launches["packed_level"] - k3_example - k3_heavy
    check(k3_deep == dlevels * (calls + 1),
          f"deep catalog: {k3_deep} K3 launches, not {dlevels} x {calls + 1}")
    check_lists(deep_lists, deep.tree)
    dpacked = make_packed_tree(deep.tree, deep.params.embedding, BEAM)
    dcodes = torch.as_tensor(deep.tree.ids_to_codes(deep_seqs), dtype=torch.long, device=dev)
    facts5.update(
        levels=dlevels, batch=BATCH, calls=calls, k3_launches=k3_deep,
        pair_table_gb=dpacked.pair_table.numel() * 4 / 1e9,
        ms_per_batch=elapsed / calls * 1e3, qps=BATCH * calls / elapsed,
        vs_plain=audit_packed(deep.params, dpacked, dcodes, deep_lists),
    )
    emit({"phase": "deep_catalog", **facts5})

    # ---- training paths: launch counts zeroed just before, read just after
    zero_launches()
    facts_ex, mv_table_add = example_training(dev, tree_path, samples)
    facts_ex["launches"] = read_launches()
    check(facts_ex["launches"]["write_rows"] == 6 and facts_ex["launches"]["add_rows"] == 3,
          f"mv/pmv steps: {facts_ex['launches']}")
    emit({"phase": "example_training", **facts_ex})
    zero_launches()
    facts_deep, pmv_commit, deep_model = deep_training(dev, deep.tree, deep_seqs)
    facts_deep["launches"] = read_launches()
    emit({"phase": "deep_training", **facts_deep})
    for name in launches:
        launches[name] += facts_ex["launches"][name] + facts_deep["launches"][name]

    # ---- K2 and the row scatter-add against their plain versions, on the
    # training paths' own calls and at the spikes' shapes
    rk = row_kernels(dev, pmv_commit, mv_table_add)
    del pmv_commit, mv_table_add
    emit({"phase": "row_kernels", **rk})

    # ---- the TDM/JTM workflow through the CLI, and the deep sweep and
    # clustering: launch counts zeroed just before each, read just after
    zero_launches()
    facts_wf = workflow(dev, seqs)
    facts_wf["launches"] = read_launches()
    check(facts_wf["launches"]["din_score"] > 0 and facts_wf["launches"]["add_rows"] > 0,
          f"workflow: {facts_wf['launches']}")
    emit({"phase": "workflow", **facts_wf})
    zero_launches()
    facts_jd = jtm_deep(dev, deep.tree, deep_model)
    facts_jd["launches"] = read_launches()
    check(facts_jd["launches"]["din_score"] > 0 and facts_jd["launches"]["add_rows"] > 0,
          f"jtm_deep: {facts_jd['launches']}")
    emit({"phase": "jtm_deep", **facts_jd})
    del deep_model
    for name in launches:
        launches[name] += facts_wf["launches"][name] + facts_jd["launches"][name]

    # ---- OTM through the CLI on the example catalog, and at 1M items:
    # launch counts zeroed just before each, read just after
    zero_launches()
    facts_oe = otm_example(dev)
    facts_oe["launches"] = read_launches()
    check(facts_oe["launches"]["din_score"] > 0 and facts_oe["launches"]["packed_level"] > 0
          and facts_oe["launches"]["add_rows"] > 0, f"otm_example: {facts_oe['launches']}")
    emit({"phase": "otm_example", **facts_oe})
    zero_launches()
    facts_od = otm_deep(dev)
    facts_od["launches"] = read_launches()
    check(all(facts_od["launches"][k] > 0 for k in ("din_score", "packed_level", "write_rows")),
          f"otm_deep: {facts_od['launches']}")
    emit({"phase": "otm_deep", **facts_od})
    for name in launches:
        launches[name] += facts_oe["launches"][name] + facts_od["launches"][name]

    # ---- Deep Retrieval through the CLI on the example catalog, and
    # bench.py's 1M serving and 10M E-step cells: launch counts zeroed just
    # before each, read just after
    zero_launches()
    facts_dre = dr_example(dev)
    facts_dre["launches"] = read_launches()
    check(facts_dre["launches"]["write_rows"] == 3 * (DR_PMV_STEPS + DR_TIMED_BATCHES),
          f"dr_example: {facts_dre['launches']}, not 3 K2 launches a pmv E-step")
    emit({"phase": "dr_example", **facts_dre})
    zero_launches()
    facts_drd, estep = dr_deep(dev)
    facts_drd["launches"] = read_launches()
    check(facts_drd["launches"]["write_rows"] == 3 * (DR_WARMUP_STEPS + DR_TIMED_STEPS),
          f"dr_deep: {facts_drd['launches']}, not 3 K2 launches an E-step")
    check(facts_dre["launches"]["dr_rerank"] > 0,
          f"dr_example: the block route launched no rerank kernel: {facts_dre['launches']}")
    check(facts_drd["launches"]["dr_rerank"] == 1 + DR_SERVE_CALLS,
          f"dr_deep: {facts_drd['launches']}, not one rerank launch a block batch")
    facts_drd["estep_10m"]["k2_commits"] = dr_commits(estep)
    del estep
    emit({"phase": "dr_deep", **facts_drd})
    for name in launches:
        launches[name] += facts_dre["launches"][name] + facts_drd["launches"][name]
    dr_k2 = facts_drd["estep_10m"]["k2_commits"]
    flush = torch.empty(64 << 20, device=dev)
    facts_drr = dr_rerank_case(dev, flush)
    del flush
    emit({"phase": "dr_rerank", **facts_drr})

    # ---- the 10M-item TDM path: resident training, bf16 pair-table
    # serving, resume and bf16 tables; launch counts zeroed just before,
    # read just after
    zero_launches()
    facts_10m, tree_10m = tdm_10m(dev, deep, deep_seqs, tree_path, samples, weights)
    facts_10m["launches"] = read_launches()
    check(all(facts_10m["launches"][k] > 0
              for k in ("packed_level_bf16_rows", "add_rows_bf16", "write_rows")),
          f"tdm_10m: {facts_10m['launches']}")
    print(f"tdm_10m: torch.cuda.max_memory_allocated {facts_10m['peak_allocated_gb']:.3f} GB",
          flush=True)
    emit({"phase": "tdm_10m", **facts_10m})
    for name in launches:
        launches[name] += facts_10m["launches"][name]

    # ---- the port's host library (csrc/host_ops.cc) against the Python
    # forms: launch counts zeroed just before, read just after
    zero_launches()
    facts_native = native_phase(dev, smi, samples, deep.tree, tree_10m)
    facts_native["launches"] = read_launches()
    del tree_10m
    emit({"phase": "native", **facts_native})
    for name in launches:
        launches[name] += facts_native["launches"][name]

    # ---- DIN at E = 8 and 32, DeepFM on every path, and item 5's recall
    # check: launch counts zeroed just before each, read just after
    zero_launches()
    facts_w = {"e32_1m": deep_width_32(dev, deep.tree, deep_seqs),
               "e32_sweep": sweep_width_32(dev, tree_path, samples),
               "e8_example": example_width_8(dev, tree_path, samples, seqs)}
    facts_w["launches"] = read_launches()
    check(all(facts_w["launches"][f"{k}_e{e}"] > 0 for e in WIDTHS
              for k in ("din_score", "packed_level", "packed_level_bf16_rows")),
          f"widths: {facts_w['launches']}")
    emit({"phase": "widths", **facts_w})
    flush = torch.empty(64 << 20, device=dev)
    zero_launches()
    facts_fm = {"workflow": deepfm_workflow(dev, seqs), "otm": deepfm_otm(dev),
                "deep_1m": deepfm_deep(dev, deep.tree, deep_seqs, flush)}
    facts_fm["launches"] = read_launches()
    del flush
    fm_bf16 = facts_fm["deep_1m"]["bf16_mv"]["launches"]
    check(facts_fm["launches"]["add_rows"] > 0
          and facts_fm["launches"]["write_rows"]
          == facts_fm["deep_1m"]["k2_launches"] + fm_bf16["write_rows"]
          and facts_fm["launches"]["add_rows_bf16"] == fm_bf16["add_rows_bf16"] > 0,
          f"deepfm: {facts_fm['launches']}")
    check(not any(n for k, n in facts_fm["launches"].items()
                  if k.startswith(("din_score", "packed_level"))),
          f"deepfm: a DIN kernel launched: {facts_fm['launches']}")
    emit({"phase": "deepfm", **facts_fm})
    zero_launches()
    facts_rr = reference_recall(dev, tree_path, samples)
    facts_rr["launches"] = read_launches()
    emit({"phase": "reference_recall", **facts_rr})
    for model_type in ("din", "deepfm"):
        check(facts_rr[model_type]["within_band"],
              f"reference_recall: {model_type}'s mean recall@10 is not within {RECALL_BAND} "
              f"of the JAX package's: {facts_rr[model_type]}")
    for name in launches:
        launches[name] += (facts_w["launches"][name] + facts_fm["launches"][name]
                           + facts_rr["launches"][name])

    # ---- K1 and K3 at E = 64, 96 and 128: against their plain versions,
    # then the wide path (the recipe, 1M serving, the E = 64 recall check)
    # with launch counts zeroed just before, read just after
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, device=dev)
    kern_wide = {e: kernels_at_width(dev, e, facts4["catalog_items"], flush) for e in WIDE}
    del flush
    checks_s = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    facts_wide = wide(dev, tree_path, samples, deep, deep_seqs)
    facts_wide["launches"] = read_launches()
    emit({"phase": "wide", "kernels_vs_plain_s": checks_s, "path_s": time.perf_counter() - t0,
          "flip_share": {e: FLIP_SHARE[e] for e in WIDE},
          "kernels": {f"e{e}": k for e, k in kern_wide.items()}, **facts_wide})
    check(all(facts_wide["launches"][f"{k}_e{e}"] > 0 for e in WIDE
              for k in ("din_score", "packed_level", "packed_level_bf16_rows")),
          f"wide: {facts_wide['launches']}")
    check(facts_wide["recall_e64"]["within_band"],
          f"wide: the E = 64 mean recall@10 is not within {RECALL_BAND} of the JAX "
          f"package's: {facts_wide['recall_e64']}")
    for name in launches:
        launches[name] += facts_wide["launches"][name]

    # ---- the multi-device paths: (a) in this process over nccl, (b) on
    # two ranks sharing the card over gloo; each part's launch counts
    # zeroed just before it, read just after
    facts_mesh = mesh(dev, deep, deep_seqs, deep_lists, tree_path, smi)
    emit({"phase": "mesh", **facts_mesh})
    check(all(facts_mesh["launches"][k] > 0
              for k in ("din_score", "packed_level", "write_rows", "add_rows")),
          f"mesh: {facts_mesh['launches']}")
    for name in launches:
        launches[name] += facts_mesh["launches"][name]

    # ---- trace: last, as the profiler leaves every later host launch
    # slower; launch counts zeroed just before, read just after
    zero_launches()
    facts_tr = traced_batch(dev, deep, deep_seqs, calls, facts5["ms_per_batch"])
    facts_tr["launches"] = read_launches()
    check(facts_tr["launches"]["packed_level"] == dlevels * (2 * calls + 1),
          f"trace: {facts_tr['launches']}, not {dlevels} x {2 * calls + 1} K3 launches")
    emit({"phase": "trace", **facts_tr})
    for name in launches:
        launches[name] += facts_tr["launches"][name]

    # ---- 6. kernel summary
    src = {"din_score": "dismember_tpu_torch/csrc/din_kernels.cu",
           "packed_level": "dismember_tpu_torch/csrc/din_kernels.cu",
           "packed_level_bf16_rows": "dismember_tpu_torch/csrc/din_kernels.cu",
           "write_rows": "dismember_tpu_torch/csrc/row_writer.cu",
           "add_rows": "dismember_tpu_torch/csrc/row_writer.cu",
           "add_rows_bf16": "dismember_tpu_torch/csrc/row_writer.cu",
           "dr_rerank": "dismember_tpu_torch/csrc/dr_rerank.cu"}
    replaces = {"din_score": "dismember_tpu/ops/din_kernel.py:34",
                "packed_level": "dismember_tpu/ops/packed_level_kernel.py:102",
                "packed_level_bf16_rows": "dismember_tpu/ops/packed_level_kernel.py:102",
                "write_rows": "dismember_tpu/ops/row_writer.py:41",
                "add_rows": "scripts/spike_pallas_scatter128.py:70",
                "add_rows_bf16": "scripts/spike_pallas_scatter128.py:70",
                "dr_rerank": "no Pallas kernel: the XLA chain of "
                             "dismember_tpu/retrieval/dr_serve.py:413"}
    also = {"write_rows": ["scripts/spike_pallas_scatter.py:44",
                           "scripts/spike_pallas_scatter.py:58",
                           "scripts/spike_pallas_scatter128.py:44"]}
    # the bf16 DeepFM mv route at 1M items: K2's m|v commit and the bf16 add
    fm_1m_bf16 = facts_fm["deep_1m"]["bf16_mv"]
    fm_cases = {"write_rows": fm_1m_bf16["mv_commit"], "add_rows_bf16": fm_1m_bf16["table_add"]}
    # each kernel's timed case: K1 and K3 at the serving shapes (K3 also on
    # the 10M bf16 table's rows), K2 at the pmv step's commit, the add at
    # the mv step's table update (f32, and a bf16 table's)
    timed = {**{n: {**kern[n], "library_ms": None} for n in ("din_score", "packed_level")},
             "packed_level_bf16_rows": {**facts_10m["k3_bf16_rows"],
                                        "wide": kern["packed_level_bf16_rows"]["wide"],
                                        "library_ms": None},
             "write_rows": rk["pmv_commit"], "add_rows": rk["mv_table_add"],
             "add_rows_bf16": facts_10m["bf16_tables"]["mv_table_add"], "dr_rerank": facts_drr}
    errs = {"din_score": max(kern["din_score"]["max_abs_err"],
                             kern["din_score"]["wide"]["max_abs_err"],
                             kern["din_score"]["l24"]["max_abs_err"],
                             kern["din_score"]["sweep"]["max_abs_err"],
                             kern["din_score"]["sweep_u2"]["max_abs_err"],
                             facts_ex["k1_vs_plain"]["max_abs_err"],
                             facts_wf["sweep"]["k1_vs_plain"]["max_abs_err"],
                             facts_jd["sweep"]["audited_step"]["k1_vs_plain"]["max_abs_err"],
                             facts_oe["construction"]["k1_vs_plain"]["max_abs_err"],
                             facts_oe["frozen_k1_vs_plain"]["max_abs_err"]),
            "packed_level": max(kern["packed_level"]["max_abs_err"],
                                *(c["max_abs_err"] for c in kern["packed_level"]["wide"].values()),
                                facts4["heavy_user"]["vs_plain"]["max_abs_err"],
                                facts_oe["eval"]["k3_vs_plain"]["max_abs_err"],
                                facts_od["serving"]["k3_vs_plain"]["max_abs_err"],
                                facts_mesh["nccl_world_1"]["serving"]["k3_audit"]["max_abs_err"]),
            "packed_level_bf16_rows": max(
                facts_10m["k3_bf16_rows"]["max_abs_err"],
                *(c["max_abs_err"] for c in kern["packed_level_bf16_rows"]["wide"].values()),
                facts_10m["serving"]["vs_plain"]["max_abs_err"]),
            "write_rows": max(row_errors(rk, "write"),
                              *(c["max_abs_err"] for c in dr_k2.values()),
                              fm_1m_bf16["mv_commit"]["max_abs_err"]),
            "add_rows": row_errors(rk, "add"), "dr_rerank": facts_drr["max_abs_err"],
            "add_rows_bf16": max(facts_10m["bf16_tables"]["mv_table_add"]["max_abs_err"],
                                 facts_10m["bf16_tables_deepfm"]["mv_table_add"]["max_abs_err"],
                                 fm_1m_bf16["table_add"]["max_abs_err"])}
    # the instances at the other widths: K1 at the serving shape (also the
    # sweep's and L = 24), K3 at [4096, 20] on f32 and bf16
    # rows (also beam 110 and L = 24); their errors over
    # the kernel checks and every audit of the widths and wide phases (at E
    # = 32 also the sweep's K1 calls)
    audits = {8: [facts_w["e8_example"]], 32: [facts_w["e32_1m"]],
              **{e: [facts_wide[f"recipe_e{e}"]]
                 + ([facts_wide[f"deep_e{e}"]] if e in WIDE_DEEP else []) for e in WIDE}}
    sweep_audits = {32: [facts_w["e32_sweep"]["k1_vs_plain"]["max_abs_err"]]}
    kern_all = {**kern_w, **kern_wide}
    for e, fws in audits.items():
        kw = kern_all[e]
        k1 = kw["din_score"]
        timed[f"din_score_e{e}"] = {**k1["serving"], "sweep": k1["sweep"], "l24": k1["l24"],
                                    "library_ms": None}
        for k in ("packed_level", "packed_level_bf16_rows"):
            timed[f"{k}_e{e}"] = {**kw[k], "library_ms": None}
            errs[f"{k}_e{e}"] = max([kw[k]["max_abs_err"]]
                                    + [c["max_abs_err"] for c in kw[k].get("wide", {}).values()]
                                    + ([fw["serving"]["float32"]["vs_plain"]["max_abs_err"]
                                        for fw in fws] if k == "packed_level" else []))
        errs[f"din_score_e{e}"] = max(
            [c["max_abs_err"] for c in k1.values()]
            + [fw["serving"]["float32"]["predict_vs_plain"]["max_abs_err"] for fw in fws]
            + [fw["k1_vs_plain"]["max_abs_err"] for fw in fws if "k1_vs_plain" in fw]
            + sweep_audits.get(e, []))
        for k in ("din_score", "packed_level", "packed_level_bf16_rows"):
            src[f"{k}_e{e}"], replaces[f"{k}_e{e}"] = src[k], replaces[k]
    summary = []
    for name, k in timed.items():
        check(launches[name] > 0, f"{name} never launched on the main path")
        summary.append({
            "name": name, "route": "cuda", "source": src[name], "replaces": replaces[name],
            **({"also_replaces": also[name]} if name in also else {}),
            "launches": launches[name], "max_abs_err": errs[name], "ms": k["ms"],
            "ms_p10": k["ms_p10"], "ms_p90": k["ms_p90"],
            **({"cold_ms": k["cold_ms"]} if "cold_ms" in k else {}),
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "ok": True,
            # K1 also at the JTM sweep's batch shape
            **({"sweep_ms": k["sweep"]["ms"], "sweep_cold_ms": k["sweep"]["cold_ms"],
                "sweep_plain_ms": k["sweep"]["plain_ms"],
                "sweep_bound_ms": k["sweep"]["bound_ms"], "sweep_shape": k["sweep"]["shape"]}
               if name.startswith("din_score") else {}),
            # K2 also at the 10M DR E-step's three commits
            **({"dr_estep_10m_commits": {
                n: {key: c[key] for key in ("table", "rows", "rows_written", "ms", "plain_ms",
                                            "library_ms", "bound_ms", "bound_by")}
                for n, c in dr_k2.items()}} if name == "write_rows" else {}),
            # K2 and the bf16 add also at the 1M bf16 DeepFM mv step's shapes
            **({"deepfm_bf16_mv_1m": {
                key: fm_cases[name][key] for key in (
                    "table", "rows", "rows_written", "warm_ms", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")}} if name in fm_cases else {}),
            # K1 at the other widths also at L = 24
            **({"l24_ms": k["l24"]["ms"], "l24_cold_ms": k["l24"]["cold_ms"],
                "l24_plain_ms": k["l24"]["plain_ms"], "l24_bound_ms": k["l24"]["bound_ms"],
                "l24_shape": k["l24"]["shape"]} if "ms" in k.get("l24", {}) else {}),
            # K3 also at beam 110 (the example catalog's widest recommend)
            # and at L = 24 (two sequence tiles)
            **({f"{case}_{key}": k["wide"][case][key] for case in ("beam110_l10", "beam20_l24")
                for key in ("ms", "cold_ms", "plain_ms", "bound_ms", "shape")}
               if "beam110_l10" in k.get("wide", {}) else {}),
        })
    emit({"kernels": summary})

    # ---- 7. last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
