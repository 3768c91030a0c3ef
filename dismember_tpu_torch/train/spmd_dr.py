"""Row-sharded Deep Retrieval: pmv tables, E-step and serving over the mesh.

Port of ``dismember_tpu/train/spmd_dr.py``.  DR's item-scaled tables (the
layer embedding [num_items + K*(D-1), E], the rerank embedding
[num_items, E] and the softmax projection [num_items, E+1] w|b) are the
largest arrays of the project; all three row-shard on "model" in their
packed p|m|v form (``train/sparse_adam.py``), with the update discipline of
``train/spmd_sparse.py``:

- forward row gathers: masked local gather plus an all-reduce over
  "model" (exact: one owner a row, the others add zeros);
- row updates: (codes, row-grad) all-gathered over "data" in
  single-device flat order, then each rank runs
  ``sparse_adam.pmv_apply_rows`` on the rows it owns: one K2 commit a
  table a step, three an E-step, on the rank's slice;
- the dense tower (heads, linear) replicated, its gradients summed over
  "data".

The stacked format: shard k's packed table is rows [k*phys, (k+1)*phys)
of the JAX package's [n_model*phys, 128] array; each slice is a
self-contained packed table for logical rows [k*v_shard, (k+1)*v_shard)
with its own scratch row, and it is all a rank holds.  With the batch
unsharded (a (1, N) mesh) the steps are bit for bit the single-device pmv
steps.  Each data shard draws its negatives from its own (seed, step, data
index) stream (``spmd_sparse.shard_generator``).
"""

from __future__ import annotations

import torch

from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.core.checkpoint import flatten
from dismember_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, round_up
from dismember_tpu_torch.models import dr_models
from dismember_tpu_torch.ops import dr_rerank
from dismember_tpu_torch.retrieval.dr_serve import (
    DevicePathMap,
    build_seq_pack,
    train_frequency_priority,
    window_parts,
)
from dismember_tpu_torch.retrieval.path_beam import path_beam_search
from dismember_tpu_torch.train import sparse_adam
from dismember_tpu_torch.train.spmd_sparse import (
    allgather_rows,
    gather_rows_sharded,
    localize_codes,
    psum_grads,
)

# ---------------------------------------------------------------------------
# per-shard pmv tables
# ---------------------------------------------------------------------------


def pmv_sharded_rows(v_rows: int, embed_dim: int, n_model: int) -> int:
    """Row count padded so each "model" shard's rows slot-pack cleanly."""
    s = sparse_adam.pmv_slots(embed_dim)
    if s == 0:
        raise ValueError(f"width {embed_dim} does not pack p|m|v")
    return round_up(v_rows, n_model * s)


def _padded(table: torch.Tensor, n_model: int) -> torch.Tensor:
    v, e = table.shape
    pad = pmv_sharded_rows(v, e, n_model) - v
    return torch.cat([table.float(), table.new_zeros(pad, e, dtype=torch.float32)])


def pmv_init_local(table: torch.Tensor, mesh) -> dict:
    """This rank's packed p|m|v table with zero moments: its rows of
    ``table`` padded by :func:`pmv_sharded_rows` (no rank builds the
    stack)."""
    n_model = meshlib.axis_size(mesh, MODEL_AXIS)
    return sparse_adam.pmv_init(meshlib.local_rows(_padded(table, n_model), mesh))


def pmv_gather_sharded(pmv_shard: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
                       v_shard: int, e: int, mesh) -> torch.Tensor:
    """Distributed pmv row gather: [R, E] f32 params, zeros where
    ``~valid`` (exact: one owner a row plus an all-reduce of zeros; with
    one "model" shard, a plain masked gather)."""
    if meshlib.axis_size(mesh, MODEL_AXIS) == 1:
        rows = sparse_adam.pmv_gather(pmv_shard, torch.where(valid, codes, 0), e)
        return rows * valid[:, None].to(rows.dtype)
    loc = codes - meshlib.axis_index(mesh, MODEL_AXIS) * v_shard
    mine = (loc >= 0) & (loc < v_shard) & valid
    rows = sparse_adam.pmv_gather(pmv_shard, torch.where(mine, loc, 0), e)
    rows = rows * mine[:, None].to(rows.dtype)
    return meshlib.psum(rows, mesh, MODEL_AXIS)


class ShardedPmv:
    """The trainer's view of one row-sharded pmv table: logical rows
    ``v_rows`` of width ``e``, this rank's slice in ``state``."""

    def __init__(self, table: torch.Tensor, mesh):
        self.mesh = mesh
        self.v_rows, self.e = table.shape
        n_model = meshlib.axis_size(mesh, MODEL_AXIS)
        self.v_shard = pmv_sharded_rows(self.v_rows, self.e, n_model) // n_model
        self.state = pmv_init_local(table, mesh)

    def gather(self, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return pmv_gather_sharded(self.state["pmv"], torch.where(valid, codes, 0), valid,
                                  self.v_shard, self.e, self.mesh)

    def apply(self, flat_all: torch.Tensor, g_all: torch.Tensor, lr: float) -> None:
        """Lazy Adam on the rows this rank owns (one K2 commit)."""
        local = localize_codes(flat_all, self.v_shard, self.mesh)
        sparse_adam.pmv_apply_rows(self.state, local, g_all, lr)

    def unpack(self) -> torch.Tensor:
        """The [V, E] params on every rank (an all-gather over "model")."""
        local = sparse_adam.pmv_unpack(self.state, self.v_shard, self.e)
        return meshlib.full_rows(local, self.mesh)[: self.v_rows]

    def refresh(self, table: torch.Tensor) -> None:
        n_model = meshlib.axis_size(self.mesh, MODEL_AXIS)
        sparse_adam.pmv_refresh(self.state, meshlib.local_rows(_padded(table, n_model),
                                                                self.mesh))


# ---------------------------------------------------------------------------
# sharded E-step (layer + rerank)
# ---------------------------------------------------------------------------


def make_sharded_dr_steps(trainer, mesh):
    """Sharded pmv layer and rerank steps for a DRTrainer.

    Returns (layer_step, rerank_step, layer_opt_state, rerank_opt_state):
    the opt states hold the heads' and linear's Adam states and
    the three :class:`ShardedPmv` tables; the steps take this rank's data
    rows, ``layer_step(seqs, paths) -> D losses`` and
    ``rerank_step(seqs, labels, negs) -> loss`` (global values), and
    update the states in place."""
    from dismember_tpu_torch.train.dr import _adam_apply, _adam_init, _heads_of, _leaves

    n_data = meshlib.axis_size(mesh, DATA_AXIS)
    e = trainer.embed_size
    lp, rp = trainer.layer_params, trainer.rerank_params
    layer_emb = ShardedPmv(lp["embedding"], mesh)
    rerank_emb = ShardedPmv(rp["embedding"], mesh)
    rerank_wb = ShardedPmv(trainer._wb_mirror(), mesh)
    layer_opt_state = (_adam_init({"heads": lp["heads"]}), layer_emb)
    rerank_opt_state = (_adam_init({"linear": rp["linear"]}), rerank_emb, rerank_wb)

    def layer_step(seqs, paths):
        heads_opt, emb = trainer.layer_opt_state
        flat = trainer._layer_codes(seqs, paths)
        valid = flat >= 0
        rows = emb.gather(flat, valid).requires_grad_()
        heads = _leaves({"heads": trainer.layer_params["heads"]})
        with torch.enable_grad():
            losses = trainer._layer_losses_from_rows(
                rows, _heads_of(heads, trainer.num_layers), paths)
            g_rows, *g_heads = torch.autograd.grad(losses.sum() / n_data,
                                                   [rows, *heads.values()])
        losses = meshlib.psum(losses.detach(), mesh, DATA_AXIS) / n_data
        grads = psum_grads(dict(zip(heads, g_heads)), mesh)
        g_rows = g_rows * valid[:, None]
        ns = seqs.numel()
        flat_all, g_all = allgather_rows([(flat[:ns], g_rows[:ns]), (flat[ns:], g_rows[ns:])],
                                         mesh)
        with torch.no_grad():
            _adam_apply(heads_opt, flatten({"heads": trainer.layer_params["heads"]}), grads,
                        trainer.learning_rate)
            emb.apply(flat_all, g_all, trainer.learning_rate)
        return losses

    def rerank_step(seqs, labels, negs):
        rest_opt, emb, wb_t = trainer.rerank_opt_state
        b = seqs.shape[0]
        cand = torch.cat([labels.long()[:, None], negs.long()], 1)  # [B, 1+S]
        c = cand.shape[1]
        seq_flat = seqs.reshape(-1).long()
        seq_valid = seq_flat >= 0
        cflat = cand.reshape(-1)
        erows = emb.gather(seq_flat, seq_valid).requires_grad_()
        wb = wb_t.gather(cflat, torch.ones_like(cflat, dtype=torch.bool))
        wb = wb.reshape(b, c, e + 1).requires_grad_()
        linear = _leaves({"linear": trainer.rerank_params["linear"]})
        with torch.enable_grad():
            vec = dr_models.user_vector_from_emb(
                {"weight": linear["linear/weight"], "bias": linear["linear/bias"]},
                erows.view(b, -1, e))
            logits = dr_models.sampled_logits(vec, wb[..., :e], wb[..., e])
            loss = -torch.log_softmax(logits, dim=-1)[:, 0].mean() / n_data
            g_e, g_wb, *g_lin = torch.autograd.grad(loss, [erows, wb, *linear.values()])
        loss = meshlib.psum(loss.detach().reshape(1), mesh, DATA_AXIS)[0]
        grads = psum_grads(dict(zip(linear, g_lin)), mesh)
        g_e = g_e * seq_valid[:, None]
        seq_all, ge_all = allgather_rows([(seq_flat, g_e)], mesh)
        cand_all, gwb_all = allgather_rows([(cflat, g_wb.reshape(-1, e + 1))], mesh)
        with torch.no_grad():
            _adam_apply(rest_opt, flatten({"linear": trainer.rerank_params["linear"]}), grads,
                        trainer.learning_rate)
            emb.apply(seq_all, ge_all, trainer.learning_rate)
            wb_t.apply(cand_all, gwb_all, trainer.learning_rate)
        return loss

    return layer_step, rerank_step, layer_opt_state, rerank_opt_state


# ---------------------------------------------------------------------------
# sharded serving: path beam + path-major block rerank over the mesh
# ---------------------------------------------------------------------------


def make_sharded_dr_serving_fn(trainer, mesh, beam: int | None = None,
                               topk: int | None = None, max_items_per_path: int = 128):
    """The block route of ``retrieval/dr_serve.py`` over the mesh: the bf16
    [V, 2E] sequence pack (layer | rerank item embeddings) and the
    path-major block table row-shard on "model", fetched with the masked
    gather plus the all-reduce (bf16-exact: one owner a row, zeros
    elsewhere); the path beam runs on replicated heads and node rows.
    Values come from the trainer's whole tables: build it inside
    ``trainer.whole_table()``.  Returns ``fn(
    layer_params, rerank_params, seqs, consumed=None) -> (ids, scores)`` on
    this rank's "data" rows, the unsharded block route's results, or None
    when the dense path table or the block geometry does not fit."""
    dev = meshlib.mesh_device(mesh)
    dmap = DevicePathMap.build(trainer.path_index, max_items_per_path,
                               item_priority=train_frequency_priority(trainer), device=dev)
    if dmap is None:
        return None
    beam = beam or trainer.beam
    m = dmap.path_items.shape[1]
    k = min(topk or trainer.topk, beam * m)
    num_items, num_nodes, num_layers = trainer.data.num_items, trainer.num_nodes, \
        trainer.num_layers
    e = trainer.embed_size
    j_paths = max(1, int(trainer.num_paths))
    geom = dr_rerank.block_geometry(e, m)
    if geom is None:
        return None
    planes_n, m_pad = geom
    n_model = meshlib.axis_size(mesh, MODEL_AXIS)

    def shard(table):
        pad = (-table.shape[0]) % n_model
        table = torch.cat([table, table.new_zeros(pad, *table.shape[1:])])
        return meshlib.local_rows(table, mesh).clone()

    seq_shard = shard(build_seq_pack(trainer.layer_params["embedding"],
                                     trainer.rerank_params["embedding"]))
    block_tab = dr_rerank.build_block_table(trainer.rerank_params["softmax_w"],
                                            trainer.rerank_params["softmax_b"],
                                            dmap.path_items.long(), planes_n, m_pad)
    # zero rows pad the block table: their valid planes are 0
    block_shard = shard(block_tab.reshape(block_tab.shape[0], m_pad * planes_n))
    del block_tab

    def blocks_of(rows):
        blocks = gather_rows_sharded(block_shard, rows.reshape(-1).clamp_min(0),
                                     (rows >= 0).reshape(-1), mesh, upcast=False)
        return blocks.view(*rows.shape, m_pad, planes_n)

    @torch.no_grad()
    def fn(layer_params, rerank_params, seqs, consumed=None):
        b, l_seq = seqs.shape
        svalid = (seqs != -1).reshape(-1)
        srows = gather_rows_sharded(seq_shard, torch.where(svalid, seqs.reshape(-1), 0),
                                    svalid, mesh).view(b, l_seq, 2 * e)
        seq_parts, user_vec = window_parts(srows, layer_params, rerank_params, e)
        beam_params = {"embedding": layer_params["embedding"][num_items:],
                       "heads": layer_params["heads"]}
        paths, _ = path_beam_search(beam_params, seqs, beam, 0, num_nodes, num_layers,
                                    seq_parts=seq_parts)
        return dr_rerank.block_rerank_topk_plain(paths, dmap.path_table, None, user_vec,
                                                 consumed, num_nodes, e, k, j_paths,
                                                 blocks_of=blocks_of)

    fn.route = "block"
    fn._dmap = dmap
    return fn
