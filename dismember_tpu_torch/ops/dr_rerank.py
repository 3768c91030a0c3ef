"""Deep Retrieval's block rerank: path lookup, row read, score, consumed
filter, dedup and top-k in one launch, and the block rows it reads.

Replaces no Pallas kernel: the JAX package's block serving route runs this
part as an XLA chain (``dismember_tpu/retrieval/dr_serve.py:413``
``_score_blocks_topk``, and the path keys, the path-table lookup and the
block gather before it), and the port ran it as ~100 plain PyTorch
operations over the gathered [B, beam, m_pad, planes] bf16 block (252 MB a
batch of 8,192 at beam 20, E = 16).  :func:`block_rerank_topk` launches
``dr_block_rerank_topk`` (``csrc/dr_rerank.cu``) for CUDA tensors and runs
:func:`block_rerank_topk_plain`, that chain, for CPU tensors.

The block table (:func:`build_block_table`) is path-major bf16 [n_paths,
m_pad, planes]: slot s of row p holds item ``path_items[p, s]``'s E
weights, its bias, its id in ``SLOT_DIGITS`` base-256 digits (the bf16
lanes of ``packed_level_kernel``'s id codec; ids < 2^31) and a valid flag
(``SLOT_PLANES`` planes past the weights), zeros past the path's items and
in the pad planes, in the narrowest geometry :func:`block_geometry` gives.

Inputs: the beam's ``paths`` [B, beam, D] int64, the dense ``path_table``
[K^D] int32 (row or -1), the block table, the f32 ``user_vec`` [B, E] and
the optional ``consumed`` ids [B, C] int64 (-1 pads).  Outputs: ``ids`` [B,
k] int64 and ``scores`` [B, k] f32, -1 and -3.4e38 where a row has fewer
than k items.  The kernel's scores are the plain chain's bit for bit (the
same f32 products of bf16 operands, summed over the planes in order, then
the bias); it keeps the top k distinct items by (score descending, id
ascending), which is the plain chain's top (k J) followed by the dedup,
because an item's copies carry identical scores.  So the lists agree
except in the order of equal scores, and in which of them is kept at the
k-th place; ``J`` only sizes the plain chain's pool.

On the H100 the kernel is bound by bytes: a gather of random 1.5 KB rows
(E = 16) with ~33 operations a slot.  A warp serves a query row, so a batch
keeps thousands of rows in flight; a path's slots are read by adjacent
lanes in 16-byte loads straight into registers, in groups of up to 16 slots
and the next group only where the last slot read was valid (items are
packed at the front of a row); selection runs in shared memory
(``csrc/dr_rerank.cu`` says how).  The kernel takes E = 8, 16, 32, 64 and
96 (``KERNEL_WIDTHS``; :func:`block_geometry` has no slot past E = 122),
any geometry :func:`block_geometry` returns, beam up to ``MAX_BEAM`` and k
up to ``MAX_K``; the wrapper raises past them, and ``dr_serve`` serves such
a route packed on the card (:func:`takes`).
"""

from __future__ import annotations

import math

import torch

from dismember_tpu_torch.ops import _cuda
from dismember_tpu_torch.ops.packed_level_kernel import (
    ID_DIGITS,
    NEG_INF,
    decode_id_digits,
    encode_id_digits,
)

KERNEL_WIDTHS = (8, 16, 32, 64, 96)
MAX_BEAM = 256  # csrc/dr_rerank.cu kMaxBeam
MAX_K = 256  # kMaxK
SLOT_DIGITS = ID_DIGITS[torch.bfloat16]  # a slot's id digits
SLOT_PLANES = 1 + SLOT_DIGITS + 1  # bias, id digits and the valid flag past the E weights
# elements of one [rows, C, consumed] comparison of the consumed filter
_CONSUMED_CHUNK = 1 << 26

# launches on CUDA tensors; core/profiling.py reports it as
# "dr_rerank.launches"
launches = 0


def block_geometry(e: int, m: int) -> tuple[int, int] | None:
    """(planes, m_pad) of the narrowest block row holding ``m`` item slots
    of ``e + SLOT_PLANES`` used planes whose width planes * m_pad is a
    multiple of 128 (the JAX package's choice, kept so both packages pad a
    path alike); None past 128 used planes."""
    used = e + SLOT_PLANES
    if used > 128:
        return None
    best = None
    for p in range(used, 129):
        q = 128 // math.gcd(p, 128)  # m_pad granularity for width % 128 == 0
        m_pad = -(-m // q) * q
        width = p * m_pad
        if best is None or width < best[0]:
            best = (width, p, m_pad)
    return (best[1], best[2]) if best else None


def build_block_table(softmax_w: torch.Tensor, softmax_b: torch.Tensor,
                      path_items: torch.Tensor, planes_n: int, m_pad: int) -> torch.Tensor:
    """Path-major bf16 table [n_paths, m_pad, planes_n]: slot s of row p
    holds item ``path_items[p, s]``'s weights, bias, id digits and a valid
    flag (zeros past the path's items and in the pad planes)."""
    n_paths, m = path_items.shape
    e = softmax_w.shape[1]
    items = torch.full((n_paths, m_pad), -1, dtype=torch.long, device=softmax_w.device)
    items[:, :m] = path_items
    flat = items.reshape(-1)
    safe = flat.clamp_min(0)
    digits = torch.as_tensor(encode_id_digits(flat.cpu().numpy(), torch.bfloat16),
                             device=flat.device)
    lanes = torch.zeros(flat.shape[0], planes_n, dtype=torch.bfloat16, device=flat.device)
    lanes[:, :e] = softmax_w[safe].to(torch.bfloat16)
    lanes[:, e] = softmax_b[safe].to(torch.bfloat16)
    lanes[:, e + 1 : e + 1 + SLOT_DIGITS] = digits.to(torch.bfloat16)
    lanes[:, e + 1 + SLOT_DIGITS] = (flat >= 0).to(torch.bfloat16)
    return lanes.view(n_paths, m_pad, planes_n)


def path_keys_and_dedup(paths: torch.Tensor, num_nodes: int):
    """[B, beam, D] paths -> (base-K keys [B, beam], first-occurrence mask).

    A padded beam (num_nodes < beam) repeats a path; only the first copy may
    count, or an item could exceed the J-occurrence bound the block dedup
    relies on."""
    beam = paths.shape[1]
    keys = torch.zeros(paths.shape[:2], dtype=torch.long, device=paths.device)
    for d in range(paths.shape[2]):
        keys = keys * num_nodes + paths[:, :, d]
    lower = torch.ones(beam, beam, dtype=torch.bool, device=paths.device).tril(-1)
    dup_path = ((keys[:, :, None] == keys[:, None, :]) & lower).any(-1)
    return keys, ~dup_path


def consumed_hit(cand: torch.Tensor, consumed: torch.Tensor) -> torch.Tensor:
    """[B, C] bool: the candidate is among the row's consumed ids [B, Cc]
    (-1 pads; a -1 candidate is invalid anyway).  Rows in chunks, so the
    [rows, C, Cc] comparison stays bounded."""
    b, c = cand.shape
    rows = max(1, _CONSUMED_CHUNK // max(1, c * consumed.shape[1]))
    hit = torch.zeros_like(cand, dtype=torch.bool)
    for s in range(0, b, rows):
        hit[s : s + rows] = (cand[s : s + rows, :, None] == consumed[s : s + rows, None, :]).any(-1)
    return hit


def top_items(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of [B, C] scores with their ids; -1 where the score is the
    invalid sentinel."""
    top_s, top_i = torch.topk(scores, k, dim=1)
    top_ids = torch.gather(ids, 1, top_i)
    return torch.where(top_s > NEG_INF / 2, top_ids, -1), top_s


def block_rerank_topk_plain(paths: torch.Tensor, path_table: torch.Tensor,
                            block_tab: torch.Tensor | None, user_vec: torch.Tensor, consumed,
                            num_nodes: int, e: int, k: int, j_paths: int, blocks_of=None):
    """The plain version: the path keys and first copies, the path-table
    lookup, the row read, then score, consumed filter, dedup and top-k.
    ``blocks_of`` (rows [B, beam], -1 where the path is empty -> their
    block rows [B, beam, m_pad, planes] bf16) replaces the read out of
    ``block_tab`` (a mesh's row-sharded table)."""
    keys, first = path_keys_and_dedup(paths, num_nodes)
    rows = path_table[keys].long()  # [B, beam]
    if blocks_of is None:
        blocks_of = lambda r: block_tab[r.clamp_min(0)]  # noqa: E731
    blocks = blocks_of(rows)  # [B, beam, m_pad, planes]
    b, beam, m_pad, _ = blocks.shape
    ub = user_vec.to(torch.bfloat16).float()  # the bf16-rounded user operand
    scores = blocks[..., 0].float() * ub[:, None, None, 0]
    for l in range(1, e):
        scores += blocks[..., l].float() * ub[:, None, None, l]  # [B, beam, m_pad]
    bias = blocks[..., e].float()
    ids = decode_id_digits(blocks[..., e + 1 : e + 1 + SLOT_DIGITS], torch.bfloat16)
    valid = (blocks[..., e + 1 + SLOT_DIGITS] > 0) & ((rows >= 0) & first)[:, :, None]
    c = beam * m_pad
    cand = torch.where(valid, ids, -1).reshape(b, c)
    ok = valid.reshape(b, c)
    if consumed is not None:
        ok &= ~consumed_hit(cand, consumed.long())
    scores = torch.where(ok, (scores + bias).reshape(b, c), NEG_INF)
    # an item sits on at most J retrieved paths, so top-(k*J) holds >= k
    # distinct items; every later copy of an id is masked, then top-k again
    kj = min(c, max(k, k * j_paths))
    top_ids, top_s = top_items(scores, cand, kj)
    lower = torch.ones(kj, kj, dtype=torch.bool, device=cand.device).tril(-1)
    eq = (top_ids[:, :, None] == top_ids[:, None, :]) & (top_ids[:, None, :] >= 0)
    is_dup = (eq & lower).any(-1)
    return top_items(torch.where(is_dup, NEG_INF, top_s), top_ids, k)


def takes(device: torch.device, e: int, beam: int, k: int) -> bool:
    """Whether :func:`block_rerank_topk` takes a block route of width ``e``,
    ``beam`` paths and top ``k`` on ``device``: the plain chain takes any on
    the CPU, the kernel its built widths and limits (and every geometry
    :func:`block_geometry` gives at them)."""
    if device.type == "cpu":
        return True
    return e in KERNEL_WIDTHS and 1 <= beam <= MAX_BEAM and 1 <= k <= MAX_K


def _check(paths, path_table, block_tab, user_vec, consumed, num_nodes: int, e: int,
           k: int) -> None:
    """Raise on what the kernel does not take."""
    name = "block_rerank_topk"
    dev = paths.device
    _cuda.check_inputs(name, dev, torch.int64, paths=paths,
                       **({} if consumed is None else {"consumed": consumed}))
    _cuda.check_inputs(name, dev, torch.int32, path_table=path_table)
    _cuda.check_inputs(name, dev, torch.bfloat16, block_tab=block_tab)
    _cuda.check_inputs(name, dev, torch.float32, user_vec=user_vec)
    if paths.ndim != 3 or block_tab.ndim != 3:
        raise ValueError(f"{name}: paths must be [B, beam, D] and block_tab [n_paths, m_pad, "
                         f"planes], got {tuple(paths.shape)} and {tuple(block_tab.shape)}")
    b, beam, depth = paths.shape
    _, m_pad, planes = block_tab.shape
    _cuda.check_shape(name, "path_table", path_table, (num_nodes**depth,))
    _cuda.check_shape(name, "user_vec", user_vec, (b, e))
    if consumed is not None and (consumed.ndim != 2 or consumed.shape[0] != b):
        raise ValueError(f"{name}: consumed must be [{b}, C], got {tuple(consumed.shape)}")
    if e not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: E={e} is not a built width {KERNEL_WIDTHS}")
    if planes % 2 or planes < e + SLOT_PLANES:
        raise ValueError(f"{name}: {planes} planes a slot do not hold E={e} "
                         f"(an even number of at least E + {SLOT_PLANES})")
    if not 1 <= beam <= MAX_BEAM:
        raise ValueError(f"{name}: beam {beam} is past the kernel's limit MAX_BEAM={MAX_BEAM}")
    if not 1 <= k <= min(MAX_K, beam * m_pad):
        raise ValueError(f"{name}: k={k} must lie in [1, min(MAX_K={MAX_K}, beam * m_pad="
                         f"{beam * m_pad})]")


def block_rerank_topk(paths: torch.Tensor, path_table: torch.Tensor, block_tab: torch.Tensor,
                      user_vec: torch.Tensor, consumed, num_nodes: int, e: int, k: int,
                      j_paths: int):
    """(ids [B, k] int64, scores [B, k] f32) of the block rerank: the CUDA
    kernel for CUDA tensors, :func:`block_rerank_topk_plain` for CPU
    tensors."""
    global launches
    dev = paths.device
    if dev.type == "cpu":
        return block_rerank_topk_plain(paths, path_table, block_tab, user_vec, consumed,
                                       num_nodes, e, k, j_paths)
    if dev.type != "cuda":
        raise ValueError(f"block_rerank_topk: unsupported device {dev}")
    _check(paths, path_table, block_tab, user_vec, consumed, num_nodes, e, k)
    b, beam, depth = paths.shape
    n_paths, m_pad, planes = block_tab.shape
    ids = torch.empty((b, k), dtype=torch.int64, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return ids, scores
    cc = 0 if consumed is None else consumed.shape[1]
    code = _cuda.library().dr_block_rerank_topk(
        paths.data_ptr(), path_table.data_ptr(), path_table.numel(), block_tab.data_ptr(),
        n_paths, user_vec.data_ptr(), consumed.data_ptr() if cc else None, ids.data_ptr(),
        scores.data_ptr(), b, beam, depth, num_nodes, e, planes, m_pad, cc, k,
        _cuda.stream_handle(dev))
    _cuda.check_launch("block_rerank_topk", code)
    launches += 1
    return ids, scores
