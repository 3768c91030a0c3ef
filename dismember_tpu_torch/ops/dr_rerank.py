"""Deep Retrieval's block rerank: path lookup, row read, score, consumed
filter, dedup and top-k in one launch.

Replaces no Pallas kernel: the JAX package's block serving route runs this
part as an XLA chain (``dismember_tpu/retrieval/dr_serve.py:413``
``_score_blocks_topk``, and the path keys, the path-table lookup and the
block gather before it), and the port ran it as ~100 plain PyTorch
operations over the gathered [B, beam, m_pad, planes] bf16 block (252 MB a
batch of 8,192 at beam 20, E = 16).  :func:`block_rerank_topk` launches
``dr_block_rerank_topk`` (``csrc/dr_rerank.cu``) for CUDA tensors and runs
:func:`block_rerank_topk_plain`, that chain as ``retrieval/dr_serve.py``
composes it, for CPU tensors.

Inputs: the beam's ``paths`` [B, beam, D] int64, the dense ``path_table``
[K^D] int32 (row or -1), the block table [n_paths, m_pad, planes] bf16
(``dr_serve._build_block_table``), the f32 ``user_vec`` [B, E] and the
optional ``consumed`` ids [B, C] int64 (-1 pads).  Outputs: ``ids`` [B, k]
int64 and ``scores`` [B, k] f32, -1 and -3.4e38 where a row has fewer than k
items.  The kernel's scores are the plain chain's bit for bit (the same f32
products of bf16 operands, summed over the planes in order, then the bias);
it keeps the top k distinct items by (score descending, id ascending), which
is the plain chain's top (k J) followed by the dedup, because an item's
copies carry identical scores.  So the lists agree except in the order of
equal scores, and in which of them is kept at the k-th place; ``J`` only
sizes the plain chain's pool.

On the H100 the kernel is bound by bytes: a gather of random 1.5 KB rows
(E = 16) with ~33 operations a slot.  A warp serves a query row, so a batch
keeps thousands of rows in flight; a path's slots are read by adjacent
lanes in 16-byte loads straight into registers, in groups of up to 16 slots
and the next group only where the last slot read was valid (items are
packed at the front of a row); selection runs in shared memory
(``csrc/dr_rerank.cu`` says how).  The kernel takes E = 8, 16, 32, 64 and
96 (``KERNEL_WIDTHS``; ``_block_geometry`` has no slot past E = 122), any
geometry ``_block_geometry`` returns, beam up to ``MAX_BEAM`` and k up to
``MAX_K``; the wrapper raises past them, and ``dr_serve`` serves such a
route packed on the card (:func:`takes`).
"""

from __future__ import annotations

import torch

from dismember_tpu_torch.ops import _cuda

KERNEL_WIDTHS = (8, 16, 32, 64, 96)
MAX_BEAM = 256  # csrc/dr_rerank.cu kMaxBeam
MAX_K = 256  # kMaxK
_SLOT_PLANES = 6  # bias, 4 id digits and the valid flag past the E weights

# launches on CUDA tensors; core/profiling.py reports it as
# "dr_rerank.launches"
launches = 0


def block_rerank_topk_plain(paths: torch.Tensor, path_table: torch.Tensor,
                            block_tab: torch.Tensor, user_vec: torch.Tensor, consumed,
                            num_nodes: int, e: int, k: int, j_paths: int):
    """The plain version: ``retrieval/dr_serve.py``'s path keys and first
    copies, the path-table lookup, the block gather and
    ``_score_blocks_topk``."""
    from dismember_tpu_torch.retrieval import dr_serve

    keys, first = dr_serve.path_keys_and_dedup(paths, num_nodes)
    rows = path_table[keys].long()  # [B, beam]
    blocks = block_tab[rows.clamp_min(0)]  # [B, beam, m_pad, planes]
    return dr_serve._score_blocks_topk(blocks, (rows >= 0) & first, user_vec, consumed, e, k,
                                       j_paths)


def takes(device: torch.device, e: int, beam: int, k: int) -> bool:
    """Whether :func:`block_rerank_topk` takes a block route of width ``e``,
    ``beam`` paths and top ``k`` on ``device``: the plain chain takes any on
    the CPU, the kernel its built widths and limits (and every geometry
    ``_block_geometry`` gives at them)."""
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
    if planes % 2 or planes < e + _SLOT_PLANES:
        raise ValueError(f"{name}: {planes} planes a slot do not hold E={e} "
                         f"(an even number of at least E + {_SLOT_PLANES})")
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
