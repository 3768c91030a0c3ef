"""Tree construction from learned embeddings: batched recursive clustering.

Port of ``dismember_tpu/index/cluster.py``.  Semantics parity with
tdm/.../cluster/RecursiveCluster.scala:16-211 and
tdm/src/main/java/com/mass/clustering/SpectralClustering.java:14-71:
- recursive 2-way split of the item set; children codes 2c+1 / 2c+2;
- a split runs k-means(k=2) (or spectral embedding + k-means) on the subset,
  takes centroid 0, sorts items by squared distance to it, and cuts at the
  midpoint (``balanceTree``: argPartition at n/2) so the tree stays balanced;
- 2-item sets assign directly (left/right in index order); singletons keep the
  parent's child code; leaf codes are later sunk to the bottom level by the
  tree builder;
- spectral: affinity exp(-||x-y||^2 / (2 sigma^2)), normalized Laplacian
  D^-1/2 W D^-1/2, top-k eigenvectors, row-unitized, k-means in the projected
  space (distances to centroid 0 measured there).

Splitting is level-synchronous: every cluster of a tree depth is split by one
batched 2-means on ``device`` (CUDA by default), while the host keeps the
bookkeeping in numpy, as the JAX package does.  Every ranking breaks ties
as the JAX package's does: ``torch.argsort(stable=True)`` for ``jnp.argsort``
and the same host ``np.lexsort``.  The k-means path takes segment sums as
f32 cumulative-sum differences, as the JAX package does, and sums them in
the order XLA's CPU backend does (:func:`_blocked_cumsum`); other sums (the
squared distances over E, the centroid divisions) may round differently on
the card than on the CPU, so near-equal distances may rank differently
there.
"""

from __future__ import annotations

import numpy as np
import torch

from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.core.io import open_file
from dismember_tpu_torch.data.native import cooc_apply_native
from dismember_tpu_torch.index.tree_io import write_tree


def _two_means_batch(x: torch.Tensor, mask: torch.Tensor, iters: int) -> torch.Tensor:
    """Batched k-means with k=2.

    x [S, m, E] (padded), mask [S, m] validity.  Returns centroid0 [S, E].
    Init: centroid0 = first valid point, centroid1 = farthest valid point
    from it (deterministic k-means++-style seeding).
    """
    rows = torch.arange(x.shape[0], device=x.device)
    c0 = x[rows, torch.argmax(mask.to(torch.int32), dim=1)]  # first valid point
    d0 = ((x - c0[:, None, :]) ** 2).sum(-1)
    c1 = x[rows, torch.argmax(torch.where(mask, d0, -1e30), dim=1)]
    for _ in range(iters):
        d0 = ((x - c0[:, None, :]) ** 2).sum(-1)
        d1 = ((x - c1[:, None, :]) ** 2).sum(-1)
        w0 = ((d0 <= d1) & mask).to(x.dtype)
        w1 = (~(d0 <= d1) & mask).to(x.dtype)
        n0 = w0.sum(1, keepdim=True)
        n1 = w1.sum(1, keepdim=True)
        new_c0 = torch.einsum("sm,sme->se", w0, x) / n0.clamp(min=1.0)
        new_c1 = torch.einsum("sm,sme->se", w1, x) / n1.clamp(min=1.0)
        # keep the old centroid when a cluster empties
        c0 = torch.where(n0 > 0, new_c0, c0)
        c1 = torch.where(n1 > 0, new_c1, c1)
    return c0


def _distance_rank_batch(x: torch.Tensor, mask: torch.Tensor, iters: int) -> torch.Tensor:
    """Run 2-means and return, per cluster, item positions sorted by squared
    distance to centroid 0 (valid items first).  [S, m] int64."""
    c0 = _two_means_batch(x, mask, iters)
    d = ((x - c0[:, None, :]) ** 2).sum(-1)
    d = torch.where(mask, d, 1e30)
    return torch.argsort(d, dim=1, stable=True)


def _spectral_project_batch(x: torch.Tensor, sigma: float = 1.0, k: int = 2) -> torch.Tensor:
    """Batched spectral embedding: x [S, m, E] (equal-size clusters).

    Mirrors SpectralClustering.fit/fitMatrix per cluster: Gaussian affinity
    (zero diagonal), symmetric normalization, top-k eigenvectors of the
    normalized affinity (largest algebraic), rows unitized.  An eigenvector's
    sign may differ between LAPACK and cuSOLVER; distances, and so the split,
    do not depend on it.
    """
    sq = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    w = torch.exp(-0.5 / (sigma * sigma) * sq)
    eye = torch.eye(x.shape[1], dtype=torch.bool, device=x.device)[None]
    w = torch.where(eye, 0.0, w)  # the reference leaves W[i,i] = 0
    d = w.sum(2)
    dinv = 1.0 / torch.sqrt(d.clamp(min=1e-12))
    m = w * dinv[:, :, None] * dinv[:, None, :]
    _, vecs = torch.linalg.eigh(m)  # ascending
    proj = vecs[:, :, -k:]  # [S, m, k]
    norms = torch.linalg.norm(proj, dim=2, keepdim=True)
    return proj / norms.clamp(min=1e-12)


def _spectral_features(feats: list[np.ndarray], device: torch.device, sigma: float = 1.0,
                       k: int = 2) -> list[np.ndarray]:
    """Project every cluster, batching by exact size (at a given tree depth
    cluster sizes differ by at most 1, so this is <= 2 eigh calls)."""
    by_size: dict[int, list[int]] = {}
    for i, f in enumerate(feats):
        by_size.setdefault(len(f), []).append(i)
    out: list[np.ndarray | None] = [None] * len(feats)
    for idxs in by_size.values():
        x = torch.as_tensor(np.stack([feats[i] for i in idxs]), device=device)
        proj = _spectral_project_batch(x, sigma, k).cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = proj[j]
    return out  # type: ignore[return-value]


def _blocked_cumsum(values: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive cumulative sum along dim 0 in the order XLA's CPU backend
    sums ``jnp.cumsum``: f32 adds in sequence within blocks of ``base``
    rows, plus the block totals' prefix, scanned the same way.  The adds are
    written out (``torch.cumsum`` accumulates in float64 on the CPU), so the
    CPU gives the JAX package's f32 sums bit for bit, and the card the same
    adds in the same order."""
    n, rest = values.shape[0], values.shape[1:]
    nb = -(-n // base)
    within = values.new_zeros((nb, base, *rest))
    within.view(nb * base, *rest)[:n] = values
    for j in range(1, base):
        within[:, j] += within[:, j - 1]
    if nb == 1:
        return within[0, :n]
    prefix = _blocked_cumsum(within[:, -1], base)
    prefix = torch.cat([prefix.new_zeros((1, *rest)), prefix[:-1]])
    return (within + prefix[:, None]).view(nb * base, *rest)[:n]


def _sorted_two_means_rank(
    x: torch.Tensor,  # [N, E] points, contiguous by segment
    start: torch.Tensor,  # [N] int64: index of the point's segment start
    end: torch.Tensor,  # [N] int64: index one past the segment end
    iters: int,
) -> torch.Tensor:
    """Scatter-free segment 2-means for segment-sorted points.

    Segment reductions are exclusive-cumsum differences (cs[end]-cs[start])
    plus row gathers.  All shapes fixed at [N, E]/[N].  Returns per-point
    squared distance to centroid 0 (the split-ranking key).
    """
    n = x.shape[0]

    def seg_sum(values: torch.Tensor) -> torch.Tensor:  # [N, k] -> [N, k]
        cs = torch.cat([values.new_zeros(1, values.shape[1]), _blocked_cumsum(values)])
        return cs[end] - cs[start]

    # init: c0/c1 = first/last point of the segment.  Points enter each level
    # ordered by distance rank of the parent split, so the ends of a segment
    # are naturally spread apart.
    c0 = x[start]
    c1 = x[(end - 1).clamp(0, n - 1)]
    for _ in range(iters):
        d0 = ((x - c0) ** 2).sum(1)
        d1 = ((x - c1) ** 2).sum(1)
        a1 = (d1 < d0).to(x.dtype)[:, None]  # [N, 1]
        a0 = 1.0 - a1
        sum0, sum1 = seg_sum(x * a0), seg_sum(x * a1)
        n0, n1 = seg_sum(a0), seg_sum(a1)
        c0 = torch.where(n0 > 0, sum0 / n0.clamp(min=1.0), c0)
        c1 = torch.where(n1 > 0, sum1 / n1.clamp(min=1.0), c1)
    return ((x - c0) ** 2).sum(1)


def _tree_cluster_kmeans_flat(
    ids: np.ndarray, embeddings: np.ndarray, cluster_iter: int, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """Level-synchronous balanced construction with the flat segment kernel."""
    n = len(ids)
    x = torch.as_tensor(embeddings, dtype=torch.float32, device=device)
    codes = np.zeros(n, dtype=np.int64)
    seg_code = np.zeros(n, dtype=np.int64)  # heap code of each point's cluster
    active = np.ones(n, dtype=bool)

    while active.any():
        act_idx = np.flatnonzero(active)
        sub_codes = seg_code[act_idx]
        # compact cluster ids 0..S-1 for the active set
        uniq, seg_act = np.unique(sub_codes, return_inverse=True)
        sizes = np.bincount(seg_act)

        # size-1 clusters keep their code; size-2 assign left/right directly
        small = sizes <= 2
        if small.any():
            order_s = np.argsort(seg_act, kind="stable")
            seg_sorted_s = seg_act[order_s]
            pts_sorted = act_idx[order_s]
            starts_s = np.searchsorted(seg_sorted_s, np.arange(len(uniq)))
            rank_s = np.arange(len(pts_sorted)) - starts_s[seg_sorted_s]
            size_of = sizes[seg_sorted_s]
            code_of = uniq[seg_sorted_s]
            one = size_of == 1
            two = size_of == 2
            codes[pts_sorted[one]] = code_of[one]
            codes[pts_sorted[two]] = 2 * code_of[two] + 1 + rank_s[two]
            active[pts_sorted[one | two]] = False

        big = sizes > 2
        if not big.any():
            break
        # permutation layout, fixed at [n] for every level: active big
        # clusters first (contiguous by segment), then every other point as a
        # singleton segment
        n_big = int(big.sum())
        remap = np.full(len(uniq), -1, dtype=np.int64)
        remap[np.flatnonzero(big)] = np.arange(n_big)
        seg_of_point = np.full(n, -1, dtype=np.int64)
        seg_of_point[act_idx] = remap[seg_act]

        pts = np.flatnonzero(seg_of_point >= 0)
        seg2 = seg_of_point[pts]
        order0 = np.argsort(seg2, kind="stable")
        pts_sorted = pts[order0]
        seg_sorted0 = seg2[order0]
        sizes2 = np.bincount(seg2, minlength=n_big)
        seg_starts = np.concatenate([[0], np.cumsum(sizes2)])
        m = len(pts)
        parked = np.flatnonzero(seg_of_point < 0)
        perm = np.concatenate([pts_sorted, parked])
        start_arr = np.empty(n, dtype=np.int64)
        end_arr = np.empty(n, dtype=np.int64)
        start_arr[:m] = seg_starts[seg_sorted0]
        end_arr[:m] = seg_starts[seg_sorted0 + 1]
        start_arr[m:] = np.arange(m, n)
        end_arr[m:] = np.arange(m + 1, n + 1)

        as_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        d0 = _sorted_two_means_rank(
            x[as_dev(perm)], as_dev(start_arr), as_dev(end_arr), cluster_iter
        ).cpu().numpy()[:m]

        # balanced midpoint split per segment, ranking by distance to c0
        big_codes = uniq[big]
        order1 = np.lexsort((d0, seg_sorted0))
        pts_final = pts_sorted[order1]
        seg_final = seg_sorted0[order1]
        rank = np.arange(m) - seg_starts[seg_final]
        left = rank < (sizes2[seg_final] // 2)
        child = np.where(
            left, 2 * big_codes[seg_final] + 1, 2 * big_codes[seg_final] + 2
        )
        seg_code[pts_final] = child

    return np.asarray(ids), codes


def tree_cluster(
    ids: np.ndarray,
    embeddings: np.ndarray,
    cluster_iter: int = 10,
    cluster_type: str = "kmeans",
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Assign tree codes to items by recursive balanced clustering on
    ``device``.  Returns (ids, codes) ready for :func:`write_tree`."""
    if cluster_type not in ("kmeans", "spectral"):
        raise ValueError("cluster_type must be one of ('kmeans', 'spectral')")
    dev = resolve_device(device)
    embeddings = np.asarray(embeddings, dtype=np.float32)
    if cluster_type == "kmeans":
        # flat segment formulation: one pass of device work per tree depth
        return _tree_cluster_kmeans_flat(ids, embeddings, cluster_iter, dev)
    return _tree_cluster_impl(ids, embeddings, cluster_iter, dev)


def _tree_cluster_impl(ids, embeddings, cluster_iter, device):
    """The padded per-cluster formulation, with spectral features."""
    n = len(ids)
    codes = np.zeros(n, dtype=np.int64)
    # clusters at the current level: (code, item positions)
    clusters: list[tuple[int, np.ndarray]] = [(0, np.arange(n))]

    while clusters:
        next_clusters: list[tuple[int, np.ndarray]] = []
        to_split: list[tuple[int, np.ndarray]] = []
        for code, idx in clusters:
            if len(idx) == 1:
                codes[idx[0]] = code
            elif len(idx) == 2:
                codes[idx[0]] = 2 * code + 1
                codes[idx[1]] = 2 * code + 2
            else:
                to_split.append((code, idx))
        if not to_split:
            break

        feats = _spectral_features([embeddings[idx] for _, idx in to_split], device)
        m = max(len(idx) for _, idx in to_split)
        e = feats[0].shape[1]
        x = np.zeros((len(to_split), m, e), dtype=np.float32)
        mask = np.zeros((len(to_split), m), dtype=bool)
        for i, f in enumerate(feats):
            x[i, : len(f)] = f
            mask[i, : len(f)] = True
        order = _distance_rank_batch(
            torch.as_tensor(x, device=device), torch.as_tensor(mask, device=device),
            cluster_iter,
        ).cpu().numpy()
        for i, (code, idx) in enumerate(to_split):
            ranked = idx[order[i, : len(idx)]]
            mid = len(idx) // 2
            next_clusters.append((2 * code + 1, ranked[:mid]))
            next_clusters.append((2 * code + 2, ranked[mid:]))
        clusters = next_clusters

    return np.asarray(ids), codes


def cooccurrence_embeddings(
    train_seqs: np.ndarray,
    train_targets: np.ndarray,
    num_items: int,
    dim: int = 32,
    n_iters: int = 8,
    seed: int = 0,
) -> np.ndarray:
    """Item features from session co-occurrence instead of learned leaf
    embeddings (host numpy).

    Power-iterated random projection of the (target, seq-item) co-occurrence
    operator: f <- orthogonalize(C @ f) from a Gaussian start.  Deduped
    count-weighted edges, symmetric normalization D^-1/2 W D^-1/2, and column
    orthogonalization each iteration (subspace iteration); k-means over f
    then groups items that co-occur.

    ``train_seqs`` [R, L] / ``train_targets`` [R] hold item POSITIONS in
    [0, num_items) (-1 = padding).  Returns [num_items, dim] float32,
    row-normalized; items never seen keep their random init.  Each
    iteration's operator pass runs in the native host library
    (``data/native.py`` ``cooc_apply_native``) when it loads, else in the
    numpy ``reduceat`` form.  The two differ by ~1 ulp (the native pass sums
    a segment's edges in order, ``reduceat`` pairwise); the native pass is
    the JAX package's, so with both libraries loaded the two packages agree
    bit for bit.
    """
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((num_items, dim), dtype=np.float32)

    seqs = np.asarray(train_seqs, np.int64)
    tgt = np.asarray(train_targets, np.int64)
    valid = (seqs >= 0) & (tgt[:, None] >= 0)
    a = np.broadcast_to(tgt[:, None], seqs.shape)[valid]
    b = seqs[valid]
    # symmetric operator (both directions), deduped to weighted edges
    key = np.concatenate([b, a]) * num_items + np.concatenate([a, b])
    uk, counts = np.unique(key, return_counts=True)
    dst = (uk // num_items).astype(np.int64)
    src = (uk % num_items).astype(np.int64)
    w = counts.astype(np.float32)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(dst)) + 1])
    segs = dst[starts]
    deg = np.zeros(num_items, np.float32)
    np.add.at(deg, dst, w)
    wn_flat = (w / (np.sqrt(deg[src]) * np.sqrt(deg[dst]) + 1e-12)).astype(np.float32)
    wn = wn_flat[:, None]
    touched = np.zeros(num_items, bool)
    touched[segs] = True

    for _ in range(n_iters):
        g = np.zeros_like(f)
        if not cooc_apply_native(starts, segs, src, wn_flat, f, g):
            g[segs] = np.add.reduceat(f[src] * wn, starts, axis=0)
        # column orthonormalization via the Gram matrix (symmetric /
        # Loewdin orthogonalization): basis-invariant like QR's Q, and
        # k-means + the final row normalization are rotation-invariant;
        # near-null directions are clamped
        g64 = g.astype(np.float64)
        lam, vec = np.linalg.eigh(g64.T @ g64)
        lam_max = max(float(lam[-1]), 1e-30)
        inv = 1.0 / np.sqrt(np.maximum(lam, 1e-12 * lam_max))
        g = (g64 @ ((vec * inv) @ vec.T) * np.sqrt(num_items)).astype(np.float32)
        f = np.where(touched[:, None], g, f)
    return f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-12)


def read_embeddings_csv(path: str, delimiter: str = ",") -> tuple[np.ndarray, np.ndarray]:
    """Read the ``id, e1, ..., ed`` embeddings CSV written by the trainer
    (RecursiveCluster.readFile parity)."""
    ids: list[int] = []
    vecs: list[list[float]] = []
    with open_file(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(delimiter)
            if len(parts) < 2:
                continue
            ids.append(int(parts[0].strip()))
            vecs.append([float(p) for p in parts[1:]])
    return np.asarray(ids, dtype=np.int64), np.asarray(vecs, dtype=np.float32)


def cluster_tree_from_embeddings(
    embed_path: str,
    output_tree_path: str,
    cluster_iter: int = 10,
    cluster_type: str = "kmeans",
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """The ``tdm-cluster-tree`` stage: embeddings CSV -> re-clustered pb tree
    (examples/.../tdm/TDMClusterTree.scala flow)."""
    dev = resolve_device(device)
    ids, embeds = read_embeddings_csv(embed_path)
    ids, codes = tree_cluster(ids, embeds, cluster_iter, cluster_type, device=dev)
    write_tree(output_tree_path, ids, codes)
    return ids, codes
