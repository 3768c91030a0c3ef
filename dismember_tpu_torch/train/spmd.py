"""SPMD train step and serving over the ("data", "model") mesh.

Port of ``dismember_tpu/train/spmd.py``.  The JAX package lets GSPMD lay
its collectives out; the port writes them out with the building blocks of
``train/spmd_sparse.py``:

- the dense step (:func:`make_sharded_train_step`): batches split on
  "data", the embedding table and its dense Adam moments row-sharded on
  "model", the tower and its moments replicated; tower gradients summed
  over "data" and normalised by the global batch weight sum, row gradients
  all-gathered over "data" in single-device order and densified on the
  shard that owns them;
- JTM's scoring pass (:func:`make_sharded_forward`) and the classic beam
  (:func:`make_sharded_beam_fn`): row lookups from the sharded table,
  then K1 on the rank's query rows;
- the deep-catalog beam (:func:`make_sharded_packed_beam_fn`): the pair
  table row-sharded on "model"; each level's pair rows come from the
  masked gather plus the all-reduce, then K3 runs on the rank's query rows.

A serving closure takes and returns this rank's "data" rows of a batch.
The table's row count must split over "model": :func:`padded_num_index`.
"""

from __future__ import annotations

import torch

from dismember_tpu_torch.constants import PADDING_IDX
from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.core.mesh import MODEL_AXIS
from dismember_tpu_torch.ops.packed_level_kernel import packed_level
from dismember_tpu_torch.retrieval.packed_beam import (
    PackedTree,
    beam_search_packed,
    build_pair_table,
)
from dismember_tpu_torch.retrieval.tree_beam import is_deep_catalog, make_beam_fn, make_config
from dismember_tpu_torch.train import spmd_sparse


def padded_num_index(num_index: int, mesh) -> int:
    return meshlib.round_up(num_index, meshlib.axis_size(mesh, MODEL_AXIS))


def pad_embedding_rows(table: torch.Tensor, rows: int) -> torch.Tensor:
    """``table`` with zero rows appended up to ``rows`` (padding rows are
    never addressed: codes < num_index)."""
    if rows == table.shape[0]:
        return table
    pad = torch.zeros(rows - table.shape[0], *table.shape[1:], dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad])


def _shard_of(table: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of ``table`` zero-padded to a "model" multiple."""
    table = pad_embedding_rows(table, padded_num_index(table.shape[0], mesh))
    return meshlib.local_rows(table, mesh).clone()


def make_sharded_train_step(trainer):
    """``step(seq_codes, codes, labels, weights) -> loss`` for a dense mesh
    trainer: this rank's data rows of a sampled batch, its table shard
    (``trainer._shard``) and the shard's dense Adam moments updated in
    place, the tower's Adam replicated.  On a (1, N) mesh the step is bit
    for bit the single-device dense step."""
    v_shard = trainer._shard.shape[0]

    def step(seq_codes, codes, labels, weights):
        loss, flat_all, g_all, n_cand, grads = spmd_sparse.sharded_row_grads(
            trainer, seq_codes, codes, labels, weights)
        with torch.no_grad():
            local = spmd_sparse.localize_codes(flat_all, v_shard, trainer.mesh)
            grads["embedding"] = trainer._dense_table_grad(local, g_all, n_cand,
                                                           table=trainer._shard)
            trainer._adam_step(trainer._shard_params(), grads)
        return loss

    return step


def make_sharded_otm_train_batch(trainer):
    """``batch(seqs, targets) -> level losses`` for a mesh OTM trainer on
    the global batch (the rows must split over "data"): this rank's rows
    take the trainer's own frozen targets and trajectory, with the row
    gathers distributed, then its per-level sharded steps (dense, or the
    sharded mv state of :mod:`train.spmd_sparse`)."""
    return lambda seqs, targets: trainer._train_batch(
        meshlib.data_rows(seqs, trainer.mesh), meshlib.data_rows(targets, trainer.mesh))


def _sharded_lookup(shard: torch.Tensor, mesh):
    """codes [...] (-1 padding) -> rows [..., E] f32 from the sharded
    table: ``embed_lookup``'s values."""

    def lookup(codes: torch.Tensor) -> torch.Tensor:
        valid = (codes != PADDING_IDX).reshape(-1)
        flat = torch.where(valid, codes.reshape(-1), 0)
        rows = spmd_sparse.gather_rows_sharded(shard, flat, valid, mesh)
        return rows.view(*codes.shape, shard.shape[1])

    return lookup


def make_sharded_forward(model, mesh):
    """Batched scoring over the mesh, JTM's aggregateWeights pass: the
    node-embedding table row-sharded on "model", the scorer's forward (K1
    on CUDA for DIN) on this rank's rows.  Returns (fn(codes [R, C],
    seqs [R, L]) -> logits [R, C], the table shard)."""
    shard = _shard_of(model.embedding.detach(), mesh)
    lookup = _sharded_lookup(shard, mesh)

    @torch.inference_mode()
    def fn(codes: torch.Tensor, seqs: torch.Tensor) -> torch.Tensor:
        ctx = model.ctx_from_seq_emb(lookup(seqs), (seqs == PADDING_IDX).to(torch.float32))
        return model.apply_from_emb(lookup(codes), ctx)

    return fn, shard


def make_sharded_beam_fn(model, tree, beam: int, mesh):
    """The classic beam over the mesh: the node table row-sharded on
    "model", the replicated [V, 2] node metadata, K1 per level on this
    rank's query rows.  Small catalogs; deep ones serve through
    :func:`make_sharded_packed_beam_fn`.  Returns ``fn(seq_codes) -> (ids,
    scores)``."""
    lookup = _sharded_lookup(_shard_of(model.embedding.detach(), mesh), mesh)
    pre = lambda m, seqs: m.ctx_from_seq_emb(  # noqa: E731
        lookup(seqs), (seqs == PADDING_IDX).to(torch.float32))
    app = lambda m, items, ctx: m.apply_from_emb(lookup(items), ctx)  # noqa: E731
    run = make_beam_fn(None, tree, beam, precompute=pre, apply=app,
                       device=meshlib.mesh_device(mesh))
    return torch.inference_mode()(lambda seq_codes: run(model, seq_codes))


def make_sharded_packed_beam_fn(packed: PackedTree, mesh, precompute,
                                level_fn=packed_level):
    """Deep-catalog serving over the mesh: the packed pair table
    row-sharded on "model" (zero rows pad it; their exists lanes are 0), the
    query batch split on "data".  Each level gathers the frontier's pair
    rows with the masked gather plus the all-reduce over "model" (exact:
    one owner a row), then ``level_fn`` (K3) scores them on this rank's
    rows.  Returns ``fn(params, seq_codes) -> (ids, scores)``, the results
    of ``retrieval.packed_beam.make_packed_beam_fn``."""
    n_pairs = packed.pair_table.shape[0]
    shard = _shard_of(packed.pair_table, mesh)
    ones = torch.ones((), dtype=torch.bool, device=shard.device)

    def gather(codes):
        rows = spmd_sparse.gather_rows_sharded(shard, codes.reshape(-1),
                                               ones.expand(codes.numel()), mesh, upcast=False)
        return rows.view(*codes.shape, shard.shape[1])

    local = PackedTree(pair_table=shard, embed_size=packed.embed_size, cfg=packed.cfg)

    def run(params, seq_codes):
        return beam_search_packed(params, seq_codes, local, precompute, level_fn,
                                  gather_rows=gather, n_pairs=n_pairs)

    return run


def make_sharded_tree_serving_fn(model, tree, beam: int, mesh):
    """Mesh serving of a TDM/OTM-style tree beam with ``TDMServing``'s
    deep-catalog rule (``retrieval.tree_beam.is_deep_catalog``): deep
    catalogs through :func:`make_sharded_packed_beam_fn` over the f32 pair
    table, small ones through :func:`make_sharded_beam_fn`.  Returns
    (fn(seq_codes) -> (ids, scores), route), route "packed" or
    "classic"."""
    if is_deep_catalog(tree, beam):
        table = build_pair_table(model.embedding.detach(), tree.node_exists, tree.node_id,
                                 tree.total_codes)
        packed = PackedTree(pair_table=table, embed_size=model.embed_size,
                            cfg=make_config(tree, beam))
        fn = make_sharded_packed_beam_fn(packed, mesh, type(model).precompute_seq)
        del packed, table
        return (lambda seq_codes: fn(model, seq_codes)), "packed"
    return make_sharded_beam_fn(model, tree, beam, mesh), "classic"

