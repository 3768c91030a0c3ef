"""Deep Retrieval M-step: coordinate-descent path re-assignment.

Copy of ``dismember_tpu/train/dr_coordinate.py`` (host numpy, the beam
search on the trainer's device; the greedy select in the port's native host
library, ``data/native.py``, when it loads).

Parity with deep-retrieval/.../optim/CoordinateDescent.scala:12-219:
- per training sample, beam-search the top ``num_candidate_path`` paths with
  probabilities; aggregate per item either in ``batch`` mode (sum of path
  probabilities over all of the item's samples, keep top candidates) or
  ``streaming`` mode (per-batch merge with decay factor; unseen paths enter
  at ``decay * min_score + new``);
- per item (num_iteration rounds), greedily pick J paths maximizing
  ``N_v * (log1p(score + partial) - log1p(partial)) - penalty`` where the
  penalty is ``penalty_factor * ((s+1)^q - s^q)/q`` on the path's current
  size (``penaltyFunc``); previously selected paths are excluded; on rounds
  t > 1 the item's previous paths release their size first;
- items that never occur as a target get J random paths.

TPU-first + catalog scale: the expensive part — beam search over the whole
training set — is the batched ``path_beam_search`` jit.  Batch-mode
aggregation is vectorized host numpy (composite base-K int64 path keys,
lexsort + segment sums, per-item top-C by rank) instead of per-sample dict
loops; the greedy selection stays an item-sequential loop over small numpy
vectors because the path-size penalty couples items in order (the reference
iterates items sequentially too, CoordinateDescent.scala:50-83).

Streaming mode's decay merge is sequential over an ITEM'S occurrences but
independent across items, so it vectorizes as a rank-synchronous fold
(_collect_streaming_arrays): occurrences are ranked within their item by
original position (one lexsort), and fold step t merges the rank-t sample
of every still-active item at once — [A, C]-array set-union/decay/top-C ops
instead of per-path dict work.  Exactly the reference recurrence
(streamingPathScore, CoordinateDescent.scala:162-212); the dict loop is
kept as ``mode="streaming_dict"`` for parity tests.
"""

from __future__ import annotations

import logging

import numpy as np

from dismember_tpu_torch.data.native import dr_greedy_select_native
from dismember_tpu_torch.index.paths import PathIndex

logger = logging.getLogger("dismember_tpu_torch.dr_cd")


def _penalty(path_size: int, poly_order: int) -> float:
    f = lambda s: float(s) ** poly_order / poly_order  # noqa: E731
    return f(path_size + 1) - f(path_size)


def _path_keys(paths: np.ndarray, num_nodes: int) -> np.ndarray:
    """[..., D] digit paths -> composite base-K int64 keys."""
    keys = np.zeros(paths.shape[:-1], np.int64)
    for d in range(paths.shape[-1]):
        keys = keys * num_nodes + paths[..., d]
    return keys


def _keys_to_paths(keys: np.ndarray, num_nodes: int, num_layers: int) -> np.ndarray:
    """Composite keys -> [..., D] digit paths (inverse of _path_keys)."""
    out = np.zeros(keys.shape + (num_layers,), np.int32)
    rem = keys.copy()
    for d in range(num_layers - 1, -1, -1):
        out[..., d] = rem % num_nodes
        rem //= num_nodes
    return out


def _host(a, dtype) -> np.ndarray:
    """A device tensor or an array as a host array of ``dtype``."""
    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    return np.asarray(a, dtype)


def _pipelined_beam(trainer, train_seqs, cand: int, batch_size: int,
                    window: int = 4):
    """Yield ``(s, e, paths [b,C] int64, probs [b,C] f64)`` per batch with a
    FIFO window of in-flight device beam searches: the device (and the
    ~30ms-RTT relay) runs batch i+1..i+W while the host converts batch i.
    FIFO drain preserves the serial loop's batch order exactly."""
    from collections import deque

    n = len(train_seqs)
    old_beam = trainer.beam
    trainer.beam = cand
    # trainer-likes (test stubs) may only provide the blocking call; the
    # window then degrades to the serial loop
    search = getattr(
        trainer, "beam_search_paths_async", trainer.beam_search_paths
    )
    try:
        inflight: deque = deque()
        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            inflight.append((s, e, search(train_seqs[s:e])))
            if len(inflight) >= window:
                s0, e0, (p0, pr0) = inflight.popleft()
                yield s0, e0, _host(p0, np.int64), _host(pr0, np.float64)
        while inflight:
            s0, e0, (p0, pr0) = inflight.popleft()
            yield s0, e0, _host(p0, np.int64), _host(pr0, np.float64)
    finally:
        trainer.beam = old_beam


def collect_path_scores(
    trainer,
    train_seqs: np.ndarray,
    train_targets: np.ndarray,
    num_candidate_path: int,
    batch_size: int,
    mode: str = "batch",
    decay_factor: float = 0.999,
) -> dict[int, list[tuple[tuple, float]]]:
    """item -> top candidate (path, score) list via beam search over the
    training data (batchPathScore / streamingPathScore).  Streaming mode
    only — batch mode goes through :func:`_collect_batch_arrays`."""
    scores: dict[int, dict[tuple, float]] = {}
    n = len(train_seqs)
    old_beam = trainer.beam
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        trainer.beam = num_candidate_path
        paths, probs = trainer.beam_search_paths(train_seqs[s:e])
        trainer.beam = old_beam
        for i in range(e - s):
            item = int(train_targets[s + i])
            cand = {
                tuple(int(x) for x in paths[i, j]): float(probs[i, j])
                for j in range(paths.shape[1])
            }
            if mode == "batch":
                agg = scores.setdefault(item, {})
                for p, v in cand.items():
                    agg[p] = agg.get(p, 0.0) + v
            else:  # streaming
                if item not in scores:
                    scores[item] = dict(cand)
                else:
                    orig = scores[item]
                    min_score = min(orig.values())
                    merged: dict[tuple, float] = {}
                    for p in set(orig) | set(cand):
                        if p in orig and p in cand:
                            merged[p] = decay_factor * orig[p] + cand[p]
                        elif p in cand:
                            merged[p] = decay_factor * min_score + cand[p]
                        else:
                            merged[p] = decay_factor * orig[p]
                    top = sorted(merged.items(), key=lambda kv: -kv[1])[
                        :num_candidate_path
                    ]
                    scores[item] = dict(top)
    out: dict[int, list[tuple[tuple, float]]] = {}
    for item, agg in scores.items():
        top = sorted(agg.items(), key=lambda kv: -kv[1])[:num_candidate_path]
        out[item] = top
    return out


def _collect_batch_arrays(
    trainer,
    train_seqs: np.ndarray,
    train_targets: np.ndarray,
    num_candidate_path: int,
    batch_size: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized batch-mode aggregation (batchPathScore).

    Returns (items_u [I] item ids sorted asc, cand_keys [I, C] composite
    path keys, cand_scores [I, C]) — candidates per item sorted by summed
    score desc, padded with key -1 / score -inf.
    """
    k, d = trainer.num_nodes, trainer.num_layers
    assert float(k) ** d < 2**62, "path key overflows int64"
    c = num_candidate_path
    n = len(train_seqs)
    items_acc, keys_acc, sc_acc = [], [], []
    for s, e, paths, probs in _pipelined_beam(
        trainer, train_seqs, c, batch_size
    ):
        keys = _path_keys(paths, k)  # [b, C]
        items_acc.append(
            np.repeat(np.asarray(train_targets[s:e], np.int64), keys.shape[1])
        )
        keys_acc.append(keys.ravel())
        sc_acc.append(probs.ravel())
    items = np.concatenate(items_acc)
    keys = np.concatenate(keys_acc)
    sc = np.concatenate(sc_acc)

    # group-sum scores by (item, path key)
    order = np.lexsort((keys, items))
    items, keys, sc = items[order], keys[order], sc[order]
    new = np.concatenate(
        [[True], (items[1:] != items[:-1]) | (keys[1:] != keys[:-1])]
    )
    seg = np.cumsum(new) - 1
    sums = np.bincount(seg, weights=sc)
    g_items, g_keys = items[new], keys[new]

    # per item: top-C by summed score desc (stable — ties keep key order)
    order2 = np.lexsort((-sums, g_items))
    gi, gk, gs = g_items[order2], g_keys[order2], sums[order2]
    first = np.concatenate([[True], gi[1:] != gi[:-1]])
    group = np.cumsum(first) - 1
    pos = np.arange(len(gi))
    rank = pos - pos[first][group]
    keep = rank < c
    items_u = gi[first]
    cand_keys = np.full((len(items_u), c), -1, np.int64)
    cand_scores = np.full((len(items_u), c), -np.inf)
    cand_keys[group[keep], rank[keep]] = gk[keep]
    cand_scores[group[keep], rank[keep]] = gs[keep]
    return items_u, cand_keys, cand_scores


def _collect_streaming_arrays(
    trainer,
    train_seqs: np.ndarray,
    train_targets: np.ndarray,
    num_candidate_path: int,
    batch_size: int,
    decay_factor: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized streaming-mode aggregation (streamingPathScore).

    Per item the reference folds its occurrences in order: matched paths
    score ``decay*old + new``, paths new to the state enter at
    ``decay*min(old) + new``, unmatched old paths decay, then top-C.  The
    fold is independent across items, so occurrences are ranked within
    their item (one lexsort) and fold step t merges the rank-t sample of
    EVERY active item in one [A, C]-array op; the active set shrinks with
    the item-frequency tail, so total work is O(total_rows * C log C).

    Returns the same (items_u, cand_keys, cand_scores) format as
    :func:`_collect_batch_arrays`; candidate order is score-desc (set-vs-
    array order may differ only on exact score ties).
    """
    k = trainer.num_nodes
    assert float(k) ** trainer.num_layers < 2**62, "path key overflows int64"
    c = num_candidate_path
    n = len(train_seqs)
    keys_all = np.empty((n, c), np.int64)
    probs_all = np.empty((n, c), np.float64)
    for s, e, paths, probs in _pipelined_beam(
        trainer, train_seqs, c, batch_size
    ):
        keys_all[s:e] = _path_keys(paths, k)
        probs_all[s:e] = probs

    # in-sample dedup: a padded beam (beam > #paths) repeats a path with an
    # identical prob; the dict built one entry per key — mask repeats so the
    # matched-score sums below never double-count
    srt = np.sort(keys_all, axis=1)
    dup_exists = bool((srt[:, 1:] == srt[:, :-1]).any())
    if dup_exists:
        eq = keys_all[:, :, None] == keys_all[:, None, :]
        tri = np.tril(np.ones((c, c), bool), -1)
        dup = (eq & tri).any(-1)
        keys_all = np.where(dup, -2, keys_all)  # -2 never matches state (-1 pad)
        probs_all = np.where(dup, -np.inf, probs_all)

    items = np.asarray(train_targets, np.int64)
    order = np.lexsort((np.arange(n), items))  # stable: by item, then pos
    sorted_items = items[order]
    first = np.concatenate([[True], sorted_items[1:] != sorted_items[:-1]])
    grp = np.cumsum(first) - 1
    pos = np.arange(n)
    rank = pos - pos[first][grp]
    items_u = sorted_items[first]
    n_items_u = len(items_u)

    state_keys = np.full((n_items_u, c), -1, np.int64)
    state_scores = np.full((n_items_u, c), -np.inf)
    sel0 = rank == 0
    state_keys[grp[sel0]] = keys_all[order[sel0]]
    state_scores[grp[sel0]] = probs_all[order[sel0]]

    max_occ = int(rank.max()) + 1 if n else 0
    for t in range(1, max_occ):
        sel = rank == t
        rows = order[sel]
        gi = grp[sel]
        sk, ss = state_keys[gi], state_scores[gi]  # [A, C]
        nk, ns = keys_all[rows], probs_all[rows]  # [A, C]
        valid_s = sk >= 0
        ss_f = np.where(valid_s, ss, 0.0)
        min_s = np.where(valid_s, ss, np.inf).min(axis=1)  # [A]
        eq = nk[:, :, None] == sk[:, None, :]  # [A, Cnew, Cstate]
        has = eq.any(-1)
        matched = (eq * ss_f[:, None, :]).sum(-1)
        base = np.where(has, matched, min_s[:, None])
        valid_n = nk >= 0
        new_side = np.where(
            valid_n, decay_factor * base + ns, -np.inf
        )
        old_in_new = eq.any(1)  # [A, Cstate]
        old_side = np.where(
            valid_s & ~old_in_new, decay_factor * ss, -np.inf
        )
        all_keys = np.concatenate([nk, sk], axis=1)  # [A, 2C]
        all_scores = np.concatenate([new_side, old_side], axis=1)
        idx = np.argsort(-all_scores, axis=1, kind="stable")[:, :c]
        state_keys[gi] = np.take_along_axis(all_keys, idx, axis=1)
        state_scores[gi] = np.take_along_axis(all_scores, idx, axis=1)

    state_keys[state_scores == -np.inf] = -1
    return items_u, state_keys, state_scores


def _scores_to_arrays(
    scores: dict[int, list[tuple[tuple, float]]], num_candidate_path: int,
    num_nodes: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dict output of collect_path_scores -> the array format above."""
    c = num_candidate_path
    items_u = np.asarray(sorted(scores), np.int64)
    cand_keys = np.full((len(items_u), c), -1, np.int64)
    cand_scores = np.full((len(items_u), c), -np.inf)
    for i, item in enumerate(items_u):
        for j, (p, v) in enumerate(scores[int(item)][:c]):
            cand_keys[i, j] = _path_keys(np.asarray(p, np.int64), num_nodes)
            cand_scores[i, j] = v
    return items_u, cand_keys, cand_scores


def coordinate_descent(
    trainer,
    train_seqs: np.ndarray,
    train_targets: np.ndarray,
    num_iteration: int = 1,
    num_candidate_path: int = 20,
    batch_size: int = 8192,
    mode: str = "batch",
    decay_factor: float = 0.999,
    penalty_factor: float = 3e-6,
    penalty_poly_order: int = 4,
    seed: int = 0,
    greedy: str = "auto",
) -> PathIndex:
    """Run the M-step; returns a new PathIndex.

    ``greedy``: "native" runs the item-sequential J-path selection in C++
    (``csrc/host_ops.cc`` ``dm_dr_greedy_select``, an exact port: same libm
    calls, numpy argmax/NaN semantics and processing order, bit-identical
    selections on the same host) and raises when the library is unavailable
    or a row has more than 64 candidates; "python" keeps the numpy loop (the
    parity twin); "auto" uses native when it can, else the loop.  The loop
    is O(num_items * J) interpreter iterations."""
    import time as _time

    if greedy not in ("auto", "native", "python"):
        raise ValueError(f"unknown greedy mode {greedy!r}")
    num_items = trainer.data.num_items
    num_layers = trainer.num_layers
    num_nodes = trainer.num_nodes
    j_paths = trainer.num_paths
    q = float(penalty_poly_order)
    rng = np.random.default_rng(seed)
    _t0 = _time.perf_counter()

    occ = np.bincount(
        np.asarray(train_targets, np.int64), minlength=num_items
    )

    if mode == "batch":
        items_u, cand_keys, cand_scores = _collect_batch_arrays(
            trainer, train_seqs, train_targets, num_candidate_path, batch_size
        )
    elif mode == "streaming":
        items_u, cand_keys, cand_scores = _collect_streaming_arrays(
            trainer, train_seqs, train_targets, num_candidate_path,
            batch_size, decay_factor,
        )
    else:  # "streaming_dict": reference-shaped per-sample loop (parity twin)
        items_u, cand_keys, cand_scores = _scores_to_arrays(
            collect_path_scores(
                trainer, train_seqs, train_targets, num_candidate_path,
                batch_size, "streaming", decay_factor,
            ),
            num_candidate_path, num_nodes,
        )
    _t_collect = _time.perf_counter() - _t0
    row_of_item = np.full(num_items, -1, np.int64)
    row_of_item[items_u] = np.arange(len(items_u))

    # factorize candidate keys so path sizes live in one dense array
    uniq_keys, inv = np.unique(cand_keys, return_inverse=True)
    cand_idx = inv.reshape(cand_keys.shape)
    path_size = np.zeros(len(uniq_keys), np.int64)
    valid = cand_scores > -np.inf

    sel_idx = np.full((len(items_u), j_paths), -1, np.int64)
    random_paths: dict[int, np.ndarray] = {}

    use_native = False
    if greedy in ("auto", "native"):
        use_native = dr_greedy_select_native(
            np.ascontiguousarray(cand_idx, np.int64),
            np.ascontiguousarray(cand_scores, np.float64),
            np.ascontiguousarray(occ[items_u], np.int64), path_size, sel_idx,
            num_iteration, penalty_factor, q,
        )
        if greedy == "native" and not use_native:
            raise RuntimeError(
                "greedy='native': the native host library is unavailable or a row has "
                f"more than 64 candidates ({cand_idx.shape[1]})")
    if use_native:
        # rng draws for unscored items happen in the same (t, v) order as
        # the Python loop, so the random paths are bit-identical too
        for t in range(1, num_iteration + 1):
            for v in np.flatnonzero((occ == 0) | (row_of_item < 0)):
                random_paths[int(v)] = rng.integers(
                    0, num_nodes, size=(j_paths, num_layers)
                ).astype(np.int32)
    for t in [] if use_native else range(1, num_iteration + 1):
        for v in range(num_items):
            r = row_of_item[v]
            if occ[v] == 0 or r < 0:
                random_paths[v] = rng.integers(
                    0, num_nodes, size=(j_paths, num_layers)
                ).astype(np.int32)
                continue
            nv = occ[v]
            ci, sc, ok = cand_idx[r], cand_scores[r], valid[r]
            partial = 0.0
            chosen: list[int] = []
            for j in range(j_paths):
                if t > 1:
                    path_size[sel_idx[r, j]] -= 1
                use = ok & ~np.isin(ci, chosen)
                if not use.any():
                    use = ok
                sizes = path_size[ci].astype(np.float64)
                pen = penalty_factor * ((sizes + 1.0) ** q - sizes**q) / q
                gains = np.where(
                    use,
                    nv * (np.log1p(sc + partial) - np.log1p(partial)) - pen,
                    -np.inf,
                )
                b = int(np.argmax(gains))
                if not np.isfinite(gains[b]):
                    # all gains NaN/-inf — keep the best-scored usable cand
                    b = int(np.argmax(np.where(use, sc, -np.inf)))
                path_size[ci[b]] += 1
                chosen.append(int(ci[b]))
                # accumulate the selected path's *score* (the paper's running
                # sum; the reference accumulates the penalized gain instead —
                # dr CoordinateDescent.scala:62-75 — which can drive the
                # log1p argument below -1 and NaN the remaining selections)
                partial += float(sc[b])
            sel_idx[r] = chosen

    logger.info(
        f"CD phase walls: collect(beam+aggregate) {_t_collect:.3f}s, "
        f"greedy[{'native' if use_native else 'python'}] "
        f"{_time.perf_counter() - _t0 - _t_collect:.3f}s"
    )
    item_paths = np.zeros((num_items, j_paths, num_layers), dtype=np.int32)
    scored_mask = row_of_item >= 0
    scored_items = np.flatnonzero(scored_mask & (occ > 0))
    if len(scored_items):
        keys_sel = uniq_keys[sel_idx[row_of_item[scored_items]]]
        item_paths[scored_items] = _keys_to_paths(
            keys_sel, num_nodes, num_layers
        )
    for v, paths in random_paths.items():
        item_paths[v] = paths
    return PathIndex(item_paths=item_paths, num_nodes=num_nodes)
