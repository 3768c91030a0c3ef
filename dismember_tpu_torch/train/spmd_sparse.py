"""Sharded lazy row-sparse Adam: catalog-scale training over the mesh.

Port of ``dismember_tpu/train/spmd_sparse.py``.  The embedding table AND its
lazy-Adam state are row-sharded on "model" and every row update stays
shard-local:

- forward row gather: each table shard gathers the rows it owns (masked
  local gather, other rows exact zeros) and one all-reduce over "model"
  assembles the full rows (:func:`gather_rows_sharded`);
- backward row updates: each rank's (codes, row-grad) lists are
  all-gathered over "data" *in single-device flat order*
  (:func:`allgather_rows`), then every table shard dedups and lazy-Adams
  exactly the rows it owns (``sparse_adam.apply_rows`` on the local shard:
  K2 ``write_rows_128`` for the packed m|v rows, the add on the table
  shard).  The traffic of a step is O(touched rows x E), never O(table);
- the packed m|v state shards as one packed table a rank, each with its own
  scratch row; no rank allocates the whole stack.

The tower is replicated: its gradients are summed over "data", and the
loss is normalised by the global batch weight sum, which reproduces the
single-device weighted-mean loss.  With the batch unsharded (a (1, N) mesh)
the step is bit for bit the single-device mv step.

Random streams: the sparse step draws each data shard's negatives from a
generator seeded from (seed, step, data index), :func:`shard_generator`, as
the JAX package folds the data index into its key; the draws depend on the
number of data shards.
"""

from __future__ import annotations

import numpy as np
import torch

from dismember_tpu_torch.constants import PADDING_IDX
from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, round_up
from dismember_tpu_torch.train import sparse_adam


def sparse_padded_rows(num_rows: int, mesh, embed_dim: int) -> int:
    """Row count padded so the table splits evenly over "model" AND each
    shard's row count is a multiple of the packed-m|v slot count (so
    logical rows never straddle shard boundaries mid-slot)."""
    n_model = meshlib.axis_size(mesh, MODEL_AXIS)
    s = max(sparse_adam._packed_slots(embed_dim), 1)
    return round_up(num_rows, n_model * s)


def sharded_state_zeros(v_rows: int, embed_dim: int, n_model: int,
                        device="cpu") -> dict:
    """This rank's lazy-Adam state for its 1/n_model of a [V, E] table:
    packed m|v ``{"mv": [phys, 128], "count"}`` with its own scratch row
    (rank k's slice of the JAX package's [n_model * phys, 128] stack), or
    split ``{"m", "v": [V / n_model, E], "count"}`` when the width does not
    pack."""
    if v_rows % n_model:
        raise ValueError(f"{v_rows} rows don't split over {n_model} shards")
    v_shard = v_rows // n_model
    s = sparse_adam._packed_slots(embed_dim)
    if s > 0 and v_shard % s == 0:
        return {"mv": torch.zeros(v_shard // s + 1, 128, device=device), "count": 0}
    return {"m": torch.zeros(v_shard, embed_dim, device=device),
            "v": torch.zeros(v_shard, embed_dim, device=device), "count": 0}


def whole_state(state: dict, v_rows: int, embed_dim: int, mesh) -> dict:
    """This rank's slice of a row-sharded lazy-Adam or p|m|v state (``mv``,
    ``pmv`` or ``m``/``v``, and ``count``) in the layout a single-device
    trainer holds for a ``v_rows``-row table: the slices gathered over
    "model" (a collective), a packed table's without their scratch rows,
    cut to the rows ``v_rows`` needs, and one zero scratch row appended (a
    single-device packed table's stays zero)."""
    out = {}
    for k, t in state.items():
        if k == "count":
            out[k] = t
        elif k in ("mv", "pmv"):
            s = (sparse_adam._packed_slots(embed_dim) if k == "mv"
                 else sparse_adam.pmv_slots(embed_dim))
            body = meshlib.full_rows(t[:-1], mesh)[: -(-v_rows // s)]
            out[k] = torch.cat([body, body.new_zeros(1, body.shape[1])])
        else:
            out[k] = meshlib.full_rows(t, mesh)[:v_rows]
    return out


def restore_state(state: dict, whole: dict, mesh) -> None:
    """The inverse of :func:`whole_state`, in place on this rank's slices:
    ``whole`` (tensors or arrays in the single-device layout) gives each
    slice its rows; padding rows and scratch rows keep their values."""
    for k, t in state.items():
        if k == "count":
            state[k] = int(np.asarray(whole[k]))
        elif k in ("mv", "pmv"):
            meshlib.set_local_rows(t[:-1], whole[k][:-1], mesh)
        else:
            meshlib.set_local_rows(t, whole[k], mesh)


def state_moments(state: dict, v_rows: int, embed_dim: int, n_model: int, mesh=None):
    """(m, v) as [V, E] numpy arrays, for parity checks against a
    single-device state.  ``state`` is the stacked state (every shard's
    rows in "model" order, as the JAX package holds it), or with ``mesh``
    this rank's slice, which is gathered first; scratch rows are dropped."""
    def host(k):
        t = state[k]
        if mesh is not None:
            t = meshlib.all_gather_rows(torch.as_tensor(t), mesh, MODEL_AXIS)
        return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)

    if "m" in state:
        return host("m"), host("v")
    v_shard = v_rows // n_model
    mv = host("mv").reshape(n_model, -1, 128)[:, :-1]
    mv = mv.reshape(n_model, v_shard, 2 * embed_dim).reshape(v_rows, 2 * embed_dim)
    return mv[:, :embed_dim], mv[:, embed_dim:]


def shard_generator(seed: int, step: int, data_index: int, device) -> torch.Generator:
    """The generator of data shard ``data_index`` at ``step``: one stream a
    (seed, step, data index)."""
    s = np.random.SeedSequence([seed, 5, step, data_index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


# ---------------------------------------------------------------------------
# collective building blocks (any row-sharded table workload)
# ---------------------------------------------------------------------------


def gather_rows_sharded(table_shard: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
                        mesh, upcast: bool = True) -> torch.Tensor:
    """Distributed row gather: rows [R, E], zeros where ``~valid``.  Each
    row has one owner on "model"; the all-reduce adds exact zeros from the
    others, so values equal an unsharded gather (a -0.0 comes back +0.0).
    ``upcast``: bf16 rows come back f32 (the trainers' gathers); False
    keeps the table's dtype (the pair table's rows).  With one "model"
    shard the rank owns every row: a plain masked gather, no all-reduce."""
    if meshlib.axis_size(mesh, MODEL_AXIS) == 1:
        rows = table_shard[torch.where(valid, codes, 0)]
        if upcast and rows.dtype in (torch.bfloat16, torch.float16):
            rows = rows.float()
        return rows * valid[..., None].to(rows.dtype)
    v_shard = table_shard.shape[0]
    loc = codes - meshlib.axis_index(mesh, MODEL_AXIS) * v_shard
    mine = (loc >= 0) & (loc < v_shard) & valid
    rows = table_shard[torch.where(mine, loc, 0)]
    if upcast and rows.dtype in (torch.bfloat16, torch.float16):
        rows = rows.float()
    rows = rows * mine[..., None].to(rows.dtype)
    return meshlib.psum(rows, mesh, MODEL_AXIS)


def allgather_rows(parts, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """[(codes [r_i], g [r_i, E]), ...] per flat segment -> (codes [R],
    g [R, E]) in single-device flat order: each segment is all-gathered
    over "data" on its own, then the segments concatenate, matching
    ``cat([seg0 of all rows, seg1 of all rows])`` on an unsharded batch."""
    codes = torch.cat([meshlib.all_gather_rows(c, mesh, DATA_AXIS) for c, _ in parts])
    g = torch.cat([meshlib.all_gather_rows(g, mesh, DATA_AXIS) for _, g in parts])
    return codes, g


def localize_codes(flat_all: torch.Tensor, v_shard: int, mesh) -> torch.Tensor:
    """Global row ids -> shard-local ids; rows owned elsewhere (and -1
    padding) become -1, which ``sparse_adam.dedup_rows`` drops."""
    loc = flat_all - meshlib.axis_index(mesh, MODEL_AXIS) * v_shard
    mine = (flat_all >= 0) & (loc >= 0) & (loc < v_shard)
    return torch.where(mine, loc, -1)


def psum_grads(grads: dict, mesh) -> dict:
    """Tower gradients summed over "data" in one all-reduce of their
    concatenation."""
    if not grads:
        return grads
    names = list(grads)
    buf = meshlib.psum(torch.cat([grads[n].reshape(-1) for n in names]), mesh, DATA_AXIS)
    return {n: g.view_as(grads[n])
            for n, g in zip(names, buf.split([grads[n].numel() for n in names]))}


def sharded_row_grads(trainer, seq_codes, codes, labels, weights):
    """The gradient half of a sharded row step on this rank's data rows:
    rows gathered from the trainer's table shard, the scorer's forward and
    the BCE normalised by the global weight sum, the tower gradients summed
    over "data" and the row gradients all-gathered over "data".  Returns
    (global loss, flat codes [R], row grads [R, E], n candidate rows,
    tower grads by name)."""
    mesh = trainer.mesh
    b, u = codes.shape
    flat = torch.cat([codes.reshape(-1), seq_codes.reshape(-1)])
    valid = flat != PADDING_IDX
    rows = gather_rows_sharded(trainer._shard, torch.where(valid, flat, 0), valid, mesh)
    denom = torch.clamp_min(meshlib.psum(weights.sum().reshape(1), mesh, DATA_AXIS)[0], 1.0)
    loss, g_rows, grads = trainer._row_loss_grads(rows, seq_codes, labels, weights, b, u, denom)
    loss = meshlib.psum(loss.reshape(1), mesh, DATA_AXIS)[0]
    grads = psum_grads(grads, mesh)
    g_rows = g_rows * valid[:, None].to(g_rows.dtype)
    nc = b * u
    flat_all, g_all = allgather_rows([(flat[:nc], g_rows[:nc]), (flat[nc:], g_rows[nc:])], mesh)
    n_cand = nc * meshlib.axis_size(mesh, DATA_AXIS)
    return loss, flat_all, g_all, n_cand, grads


# ---------------------------------------------------------------------------
# TDM / OTM sharded sparse train step
# ---------------------------------------------------------------------------


def make_sharded_sparse_train_step(trainer):
    """``step(seq_codes, codes, labels, weights) -> loss`` for a mesh
    trainer in the sparse mode: this rank's data rows of a sampled batch,
    the trainer's table shard (``trainer._shard``) and its local mv or split
    state (``trainer.emb_state``) updated in place by
    ``sparse_adam.apply_rows``; the tower's Adam replicated."""
    v_shard = trainer._shard.shape[0]

    def step(seq_codes, codes, labels, weights):
        loss, flat_all, g_all, _, grads = sharded_row_grads(
            trainer, seq_codes, codes, labels, weights)
        with torch.no_grad():
            trainer._adam_step(trainer._shard_params(), grads)
            local = localize_codes(flat_all, v_shard, trainer.mesh)
            sparse_adam.apply_rows(trainer._shard, trainer.emb_state, local, g_all,
                                   trainer.learning_rate)
        return loss.detach()

    return step
