"""Packed pair-row beam search: the deep-catalog serving loop.

Port of ``dismember_tpu/retrieval/packed_beam.py``, built like its
``make_packed_beam_fn_pallas``: per level one row gather out of the pair
table (outside the kernel), then K3 (``ops/packed_level_kernel``) scores both
children of every surviving parent.  Same frontiers and returned items as
the classic loop, up to K3's bf16 operand rounding and tie order.  A DeepFM
scorer, which has no kernel, scores its levels with its own
``apply_from_emb`` on the same rows in plain ops (``score_pair_rows``), with
K3's block order and masks: the JAX facade's packed route without
contraction levels.

``pair_table[c]`` packs everything the beam needs about both children of
internal code c into one row:

    [ emb(2c+1) | emb(2c+2) | exists(2c+1), exists(2c+2),
      id digits(2c+1) | id digits(2c+2) | 0-pad to 128k lanes ]

Ids are stored as exact float digits, never bit-cast: in an f32 table 2
base-4096 digits a child (id = hi*4096 + lo), in a bf16 table 4 base-256
digits (every digit an exact bf16 integer; the id codec of
``ops/packed_level_kernel.py``).  A bf16 table (``dtype=torch.bfloat16``)
halves the memory, 8.6 GB -> 4.3 GB at 10M items; its embedding lanes are
rounded to bf16, which the DIN scorer does to every operand anyway
(``train.tdm.MATMUL_FIRST_SCORERS``), so its scores are those of the f32
table.  Tables above ``_ONE_SHOT_BUILD_BYTES``
are filled in row chunks, bit for bit the one-shot build, with the host's
digit staging bounded by a chunk.  The JAX package's hybrid contraction
levels and stride-2 subtree rows are TPU layout workarounds that give the
same results; they are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.ops.packed_level_kernel import (
    ID_DIGITS,
    decode_id_digits,
    encode_id_digits,
    packed_level,
    pair_row_width,
    score_pair_rows,
)
from dismember_tpu_torch.retrieval.tree_beam import (
    NEG_INF,
    TreeBeamConfig,
    make_config,
    select_top,
    start_frontier,
)

# builds above this many bytes go in row chunks of about this size
_ONE_SHOT_BUILD_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class PackedTree:
    """Device-side packed pair table + the beam config it serves."""

    pair_table: torch.Tensor  # [n_pairs, row_width] float32 or bfloat16
    embed_size: int
    cfg: TreeBeamConfig


@torch.inference_mode()
def build_pair_table(
    embedding: torch.Tensor,  # [total_codes(+), E] node-code embedding table
    node_exists: np.ndarray,  # [total_codes] bool
    node_id: np.ndarray,  # [total_codes] int32
    total_codes: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The pair table in ``dtype`` on ``embedding``'s device: n_pairs =
    (total_codes - 1) // 2 rows, one per internal heap slot, existing or
    not (dead rows are masked by their exists lanes at query time).  Any
    size builds; above ``_ONE_SHOT_BUILD_BYTES`` the rows are filled in
    equal chunks (the same bits)."""
    n_pairs = (total_codes - 1) // 2
    e = embedding.shape[1]
    k = ID_DIGITS[dtype]
    row_width = pair_row_width(e, dtype)
    table = torch.zeros((n_pairs, row_width), dtype=dtype, device=embedding.device)
    out_bytes = n_pairs * row_width * table.element_size()
    n_chunks = max(1, -(-out_bytes // _ONE_SHOT_BUILD_BYTES))
    cs = max(1, -(-n_pairs // n_chunks))
    for start in range(0, n_pairs, cs):
        stop = min(start + cs, n_pairs)
        lo, hi = 1 + 2 * start, 1 + 2 * stop  # the chunk's children
        table[start:stop, : 2 * e] = embedding[lo:hi].reshape(stop - start, 2 * e).to(dtype)
        exists = np.asarray(node_exists[lo:hi], np.float32).reshape(stop - start, 2)
        digits = encode_id_digits(np.asarray(node_id[lo:hi], np.int64), dtype)
        lanes = np.concatenate([exists, digits[0::2], digits[1::2]], axis=1)
        table[start:stop, 2 * e : 2 * e + 2 + 2 * k] = torch.from_numpy(lanes).to(
            table.device).to(dtype)
    return table


def make_packed_tree(tree: ArrayTree, embedding: torch.Tensor, beam: int,
                     dtype: torch.dtype = torch.float32) -> PackedTree:
    """The pair table of ``tree`` in ``dtype`` and the beam config it serves."""
    cfg = make_config(tree, beam)
    if cfg.max_level - cfg.start_level < 1:
        raise ValueError(
            "packed beam needs at least one level below the start level; "
            "use the classic loop for trees this small"
        )
    table = build_pair_table(embedding, tree.node_exists, tree.node_id, tree.total_codes,
                             dtype=dtype)
    return PackedTree(pair_table=table, embed_size=int(embedding.shape[1]), cfg=cfg)


@torch.inference_mode()
def beam_search_packed(
    params,  # the scorer: DIN or DeepFM
    seq_codes: torch.Tensor,  # [B, L] long
    packed: PackedTree,
    precompute: Callable,
    level_fn: Callable = packed_level,
    gather_rows: Callable | None = None,
    n_pairs: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (leaf item ids [B, 2*beam], scores [B, 2*beam]), block-ordered
    children; non-existent leaves carry id -1 and score NEG_INF.  A DIN's
    levels go to ``level_fn``, K3 (:func:`packed_level`) or its plain
    version; any other scorer's to its ``apply_from_emb``.  ``gather_rows``
    (codes [B, beam] -> pair rows) and ``n_pairs`` replace the row gather
    out of ``packed.pair_table`` (a mesh's row-sharded table)."""
    with profiling.span("packed_beam.search"):  # issued, not waited for
        cfg = packed.cfg
        table = packed.pair_table
        b = seq_codes.shape[0]
        if gather_rows is None:
            gather_rows, n_pairs = (lambda c: table[c]), table.shape[0]
        ctx = precompute(params, seq_codes)
        if params.model_type == "din":
            weights = params.scorer_weights()
            level = lambda rows, alive: level_fn(  # noqa: E731
                rows, alive, *ctx, *weights, packed.embed_size)
        else:
            level = lambda rows, alive: score_pair_rows(  # noqa: E731
                lambda item_e: params.apply_from_emb(item_e, ctx), rows, alive, packed.embed_size)

        frontier, scores = start_frontier(cfg, b, seq_codes.device)
        dead = encode_id_digits(np.asarray([-1]), table.dtype)[0]
        ids_hilo = torch.tensor(dead, device=seq_codes.device).to(table.dtype).expand(
            b, 2 * cfg.beam, ID_DIGITS[table.dtype]
        )  # (-1, base-1, ...): a dead slot decodes to -1
        for _ in range(cfg.max_level - cfg.start_level):
            top_codes, top_alive = select_top(frontier, scores, cfg.beam)
            rows = gather_rows(top_codes.clamp(0, n_pairs - 1))  # [B, beam, ROW]
            scores, ids_hilo = level(rows, top_alive)
            # K3's outputs are block-ordered (left children | right children)
            frontier = torch.cat([2 * top_codes + 1, 2 * top_codes + 2], dim=1)

        ids = decode_id_digits(ids_hilo, table.dtype)
        leaf_ok = scores > NEG_INF / 2
        return torch.where(leaf_ok, ids, -1), scores


def make_packed_beam_fn(
    packed: PackedTree,
    precompute: Callable,
    level_fn: Callable = packed_level,
) -> Callable:
    """``(params, seq_codes) -> (item_ids, scores)`` closure over the pair
    table."""

    def run(params, seq_codes):
        return beam_search_packed(params, seq_codes, packed, precompute, level_fn)

    return run
