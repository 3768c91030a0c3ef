"""Packed pair-row beam search: the deep-catalog serving loop.

Port of ``dismember_tpu/retrieval/packed_beam.py``, built like its
``make_packed_beam_fn_pallas``: per level one row gather out of the pair
table (outside the kernel), then K3 (``ops/packed_level_kernel``) scores both
children of every surviving parent.  Same frontiers and returned items as
the classic loop, up to K3's bf16 operand rounding and tie order.

``pair_table[c]`` packs everything the beam needs about both children of
internal code c into one float32 row:

    [ emb(2c+1) | emb(2c+2) | exists(2c+1), exists(2c+2),
      idhi(2c+1), idlo(2c+1), idhi(2c+2), idlo(2c+2) | 0-pad to 128k lanes ]

Ids are stored as exact float digits (id = hi*4096 + lo), never bit-cast.
The JAX package's hybrid contraction levels and stride-2 subtree rows are
TPU layout workarounds that give the same results; they are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.ops.packed_level_kernel import packed_level
from dismember_tpu_torch.retrieval.tree_beam import (
    NEG_INF,
    TreeBeamConfig,
    make_config,
    select_top,
    start_frontier,
)

# id lanes of the f32 table: 2 base-4096 digits per id, each an exact f32
# integer (the top digit <= 2^19 for int32 ids).  The bf16 layout (4
# base-256 digits) is not ported yet.
ID_DIGITS, ID_BASE = 2, 4096
# above this the JAX package serves a bf16 table (serving.py's auto rule)
MAX_F32_TABLE_BYTES = 4 << 30


def _encode_id_digits(ids: np.ndarray, k: int, base: int) -> np.ndarray:
    """[N] int -> [N, k] float32 radix digits; the TOP digit keeps the full
    remaining quotient (and the sign: -1 -> (-1, base-1, ...) which decodes
    back to -1 under the floor-division radix identity)."""
    rem = ids.astype(np.int64)
    digits = []
    for _ in range(k - 1):
        q = np.floor_divide(rem, base)
        digits.append(rem - base * q)
        rem = q
    digits.append(rem)
    return np.stack(digits[::-1], axis=-1).astype(np.float32)


def _decode_id_digits(digits: torch.Tensor, base: int) -> torch.Tensor:
    """[..., k] float digit lanes -> [...] exact int64 ids."""
    acc = digits[..., 0].long()
    for i in range(1, digits.shape[-1]):
        acc = acc * base + digits[..., i].long()
    return acc


@dataclasses.dataclass(frozen=True)
class PackedTree:
    """Device-side packed pair table + the beam config it serves."""

    pair_table: torch.Tensor  # [n_pairs, row_width] float32
    embed_size: int
    cfg: TreeBeamConfig


@torch.inference_mode()
def build_pair_table(
    embedding: torch.Tensor,  # [total_codes(+), E] node-code embedding table
    node_exists: np.ndarray,  # [total_codes] bool
    node_id: np.ndarray,  # [total_codes] int32
    total_codes: int,
) -> torch.Tensor:
    """f32 pair table on ``embedding``'s device: n_pairs = (total_codes - 1)
    // 2 rows, one per internal heap slot, existing or not (dead rows are
    masked by their exists lanes at query time).  Tables over
    ``MAX_F32_TABLE_BYTES`` take the JAX package's bf16 layout, which is not
    ported yet, and raise."""
    n_pairs = (total_codes - 1) // 2
    e = embedding.shape[1]
    used = 2 * e + 2 + 2 * ID_DIGITS
    row_width = ((used + 127) // 128) * 128
    if n_pairs * row_width * 4 > MAX_F32_TABLE_BYTES:
        raise NotImplementedError(
            f"a pair table of {n_pairs} rows exceeds {MAX_F32_TABLE_BYTES} bytes "
            "in f32; the bf16 pair table is not ported yet (ROADMAP queue 1, "
            "next item c)"
        )
    dev = embedding.device

    child_exists = np.asarray(
        node_exists[1 : 2 * n_pairs + 1], np.float32
    ).reshape(n_pairs, 2)
    digits = _encode_id_digits(
        np.asarray(node_id[1 : 2 * n_pairs + 1], np.int64), ID_DIGITS, ID_BASE
    )  # [2*n_pairs, k]
    id_lanes = np.concatenate([digits[0::2], digits[1::2]], axis=1)

    table = torch.zeros((n_pairs, row_width), dtype=torch.float32, device=dev)
    table[:, : 2 * e] = embedding[1 : 2 * n_pairs + 1].reshape(n_pairs, 2 * e)
    table[:, 2 * e : 2 * e + 2] = torch.from_numpy(child_exists).to(dev)
    table[:, 2 * e + 2 : used] = torch.from_numpy(id_lanes).to(dev)
    return table


def make_packed_tree(tree: ArrayTree, embedding: torch.Tensor, beam: int) -> PackedTree:
    """The f32 pair table of ``tree`` and the beam config it serves."""
    cfg = make_config(tree, beam)
    if cfg.max_level - cfg.start_level < 1:
        raise ValueError(
            "packed beam needs at least one level below the start level; "
            "use the classic loop for trees this small"
        )
    table = build_pair_table(embedding, tree.node_exists, tree.node_id, tree.total_codes)
    return PackedTree(pair_table=table, embed_size=int(embedding.shape[1]), cfg=cfg)


@torch.inference_mode()
def beam_search_packed(
    params,  # DIN
    seq_codes: torch.Tensor,  # [B, L] long
    packed: PackedTree,
    precompute: Callable,
    level_fn: Callable = packed_level,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (leaf item ids [B, 2*beam], scores [B, 2*beam]), block-ordered
    children; non-existent leaves carry id -1 and score NEG_INF.
    ``level_fn`` is K3 (:func:`packed_level`) or its plain version."""
    cfg = packed.cfg
    table = packed.pair_table
    b = seq_codes.shape[0]
    n_pairs = table.shape[0]
    seq_e, pad = precompute(params, seq_codes)
    weights = params.scorer_weights()

    frontier, scores = start_frontier(cfg, b, seq_codes.device)
    dead = _encode_id_digits(np.asarray([-1]), ID_DIGITS, ID_BASE)[0]
    ids_hilo = torch.tensor(dead, device=seq_codes.device).expand(
        b, 2 * cfg.beam, ID_DIGITS
    )  # (-1, 4095): a dead slot decodes to -1
    for _ in range(cfg.max_level - cfg.start_level):
        top_codes, top_alive = select_top(frontier, scores, cfg.beam)
        rows = table[top_codes.clamp(0, n_pairs - 1)]  # [B, beam, ROW]
        scores, ids_hilo = level_fn(
            rows, top_alive, seq_e, pad, *weights, packed.embed_size
        )
        # K3's outputs are block-ordered (left children | right children)
        frontier = torch.cat([2 * top_codes + 1, 2 * top_codes + 2], dim=1)

    ids = _decode_id_digits(ids_hilo, ID_BASE)
    leaf_ok = scores > NEG_INF / 2
    return torch.where(leaf_ok, ids, -1), scores


def make_packed_beam_fn(
    packed: PackedTree,
    precompute: Callable,
    level_fn: Callable = packed_level,
) -> Callable:
    """``(params, seq_codes) -> (item_ids, scores)`` closure over the pair
    table (DIN scorer)."""

    def run(params, seq_codes):
        return beam_search_packed(params, seq_codes, packed, precompute, level_fn)

    return run
