"""The port's JTM tree learning (``dismember_tpu_torch/train/jtm.py``) against
the JAX package's, on the CPU: the same seeded numpy DIN params and training
rows go through both.  Weights agree at rtol/atol 1e-5 (f32 scores summed in
another order); host-mode projections are identical, device-mode ones may
differ on genuine near ties, bounded as the JAX package bounds its own
host/device pair (tests/test_jtm.py:246-248)."""

import numpy as np
import pytest
import torch

from dismember_tpu.data.ingest import read_csv as j_read_csv
from dismember_tpu.data.ingest import unique_items_with_category, user_interactions
from dismember_tpu.data.tdm_dataset import generate_split_samples
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.models import din as jdin
from dismember_tpu.train import jtm as J
from dismember_tpu_torch.core.io import read_bytes
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.ops import row_writer
from dismember_tpu_torch.train import jtm as T

E = 8
RTOL = ATOL = 1e-5


def near_tie_bound(n: int) -> int:
    return max(2, n // 50)


def seeded_params(num_index: int, seed: int = 0) -> dict:
    """DIN params from numpy at a scale where candidates' scores differ
    well above f32 rounding."""
    rng = np.random.default_rng(seed)
    f = lambda std, *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return {
        "embedding": f(0.5, num_index, E),
        "att_linear": {"weight": f(0.5, E, E)},
        "mlp1": {"weight": f(0.5, E, 2 * E), "bias": f(0.5, E)},
        "mlp2": {"weight": f(0.5, 1, E), "bias": f(0.5, 1)},
    }


@pytest.fixture(scope="module")
def setup(small_csv, tmp_path_factory):
    """tests/test_jtm.py's setup: the first 120 items of small_csv and their
    training rows, a category tree, E=8; params from numpy in both
    packages."""
    raw = j_read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    mask = np.isin(samples.train_targets, ids[:120])
    sorted_ids, codes = category_sorted_codes(ids[:120], cats[:120])
    path = str(tmp_path_factory.mktemp("jtm") / "tree.bin")
    write_tree(path, sorted_ids, codes, stat=samples.stat)
    jtree, tree = JArrayTree.from_file(path), ArrayTree.from_file(path)
    params = seeded_params(tree.total_codes)
    model = params_from_numpy(params, device="cpu")
    return (jtree, tree, params, model, samples.train_seqs[mask], samples.train_targets[mask])


def learners(setup, **kw):
    jtree, tree, params, model, seqs, targets = setup
    jl = J.TreeLearner(tree=jtree, params=params, forward=jdin.forward,
                       train_seqs=seqs, train_targets=targets, **kw)
    tl = T.TreeLearner(tree=tree, model=model, train_seqs=seqs, train_targets=targets,
                       device="cpu", **kw)
    return jl, tl


def diff_items(a: dict, b: dict) -> list:
    assert set(a) == set(b)
    return [k for k in a if a[k] != b[k]]


def check_projection(proj: dict, tree: ArrayTree) -> None:
    """Total, leaf-bounded, bijective (tests/test_jtm.py:37-52)."""
    assert set(proj) == set(int(x) for x in tree.item_ids)
    codes = np.asarray(list(proj.values()))
    lo = (1 << tree.max_level) - 1
    assert (codes >= lo).all() and (codes < 2 * lo + 1).all()
    assert len(np.unique(codes)) == len(codes)


def test_host_mode_matches_jax_host_mode(setup):
    jl, tl = learners(setup, gap=2, weights_mode="host")
    assert not tl._weights_device
    proj0 = np.zeros(len(tl.items), dtype=np.int64)
    np.testing.assert_allclose(tl.compute_weights(proj0, 0, 2), jl.compute_weights(proj0, 0, 2),
                               rtol=RTOL, atol=ATOL)
    proj = tl.optimize()
    assert proj == jl.optimize()
    check_projection(proj, setup[1])


@pytest.mark.parametrize("gap", [2, 3])
def test_device_mode_matches_jax_device_mode(setup, gap):
    jl, tl = learners(setup, gap=gap, weights_mode="device")
    assert tl._weights_device and jl._weights_device
    proj0 = np.zeros(len(tl.items), dtype=np.int64)
    np.testing.assert_allclose(tl.compute_weights(proj0, 0, gap),
                               jl.compute_weights(proj0, 0, gap), rtol=RTOL, atol=ATOL)
    pt, pj = tl.optimize(), jl.optimize()
    check_projection(pt, setup[1])
    assert len(diff_items(pt, pj)) <= near_tie_bound(len(pj))


@pytest.mark.parametrize("mode", ["host", "device"])
def test_hierarchical_ragged_batches_match_jax(setup, mode):
    """Gap 3, hierarchical from level 2, batches of 61 rows (ragged tails):
    the port's ancestor arithmetic (integer shifts on the device, heap
    shifts on the host) against the JAX package's."""
    kw = dict(gap=3, hierarchical=True, min_level=2, score_batch_rows=61, weights_mode=mode)
    jl, tl = learners(setup, **kw)
    for level in (1, 2, 3):
        np.testing.assert_array_equal(tl._seq_codes_at_level(level),
                                      jl._seq_codes_at_level(level))
    proj0 = np.zeros(len(tl.items), dtype=np.int64)
    np.testing.assert_allclose(tl.compute_weights(proj0, 0, 3), jl.compute_weights(proj0, 0, 3),
                               rtol=RTOL, atol=ATOL)
    pt, pj = tl.optimize(), jl.optimize()
    check_projection(pt, setup[1])
    if mode == "host":
        assert pt == pj
    else:
        assert len(diff_items(pt, pj)) <= near_tie_bound(len(pj))


def test_device_mode_is_bitwise_deterministic(setup):
    _, tl = learners(setup, gap=2, score_batch_rows=61)
    _, tl2 = learners(setup, gap=2, score_batch_rows=61)
    proj0 = np.zeros(len(tl.items), dtype=np.int64)
    w1, w2 = tl.compute_weights(proj0, 0, 2), tl2.compute_weights(proj0, 0, 2)
    assert np.array_equal(w1.view(np.int64), w2.view(np.int64))
    assert tl.optimize() == tl2.optimize()


def test_zero_evidence_items_keep_old_positions(setup):
    """Items without training rows stay at their old leaf (the JAX package's
    zero-evidence rule), and the port agrees with the JAX package."""
    jtree, tree, params, model, seqs, targets = setup
    small = (jtree, tree, params, model, seqs[:16], targets[:16])
    for mode in ("host", "device"):
        jl, tl = learners(small, gap=2, weights_mode=mode)
        assert not tl._has_rows().all()
        proj = tl.optimize()
        covered = set(int(t) for t in targets[:16]) | set(
            int(x) for x in seqs[:16].reshape(-1) if x > 0)
        moved = kept = 0
        for iid, code in zip(tree.item_ids, tree.item_codes):
            if int(iid) not in covered:
                kept += proj[int(iid)] == int(code)
                moved += proj[int(iid)] != int(code)
        assert kept > 0 and moved <= max(2, kept // 20), (mode, kept, moved)
        assert len(diff_items(proj, jl.optimize())) <= (0 if mode == "host" else 2)


def _bare(cls):
    return cls.__new__(cls)


def test_rebalance_capacity_matches_jax():
    """All items prefer candidate 0; capacity must push extras to others."""
    node_items = np.arange(6)
    candidates = np.array([7, 8, 9, 10])
    weights = np.tile(np.array([[4.0, 3.0, 2.0, 1.0]]), (6, 1))
    weights[:, 0] += np.arange(6) * 0.1
    old_codes = np.full(6, 9)
    out = T.TreeLearner.rebalance(_bare(T.TreeLearner), node_items, candidates, weights,
                                  old_codes, max_assign=2)
    sizes = {k: len(v) for k, v in out.items()}
    assert all(v <= 2 for v in sizes.values()) and sum(sizes.values()) == 6
    assert out == J.TreeLearner.rebalance(_bare(J.TreeLearner), node_items, candidates,
                                          weights, old_codes, max_assign=2)


def test_rebalance_prefers_old_assignment_and_no_evidence():
    node_items = np.arange(3)
    candidates = np.array([3, 4])
    weights = np.array([[1.0, 0.5], [1.0, 0.5], [1.0, 0.5]])
    old_codes = np.array([4, 3, 4])  # item 1's old node is 3
    out = T.TreeLearner.rebalance(_bare(T.TreeLearner), node_items, candidates, weights,
                                  old_codes, max_assign=1)
    assert 1 in out[3]
    # a no-evidence item claims its old node first
    flat = np.full((3, 2), -1e6)
    no_ev = np.array([True, False, True])
    args = (node_items, candidates, flat, old_codes)
    got = T.TreeLearner.rebalance(_bare(T.TreeLearner), *args, max_assign=2, no_evidence=no_ev)
    assert 0 in got[4] and 2 in got[4]
    assert got == J.TreeLearner.rebalance(_bare(J.TreeLearner), *args, max_assign=2,
                                          no_evidence=no_ev)


def test_fastpath_matches_full_greedy():
    """optimize()'s argmax fast path + overflow-only greedy equals the greedy
    rebalance over every occupied node (tests/test_jtm.py:142)."""
    rng = np.random.default_rng(5)
    n_items, max_level, gap = 97, 7, 2

    class StubLearner(T.GenericTreeLearner):
        def __post_init__(self):
            self._rng = np.random.default_rng(7)
            self._weights_device = False

        def compute_weights(self, proj, old_level, level):
            return self._rng.integers(0, 4, size=(n_items, 1 << (level - old_level))
                                      ).astype(np.float64)

    leaf_codes = (1 << max_level) - 1 + rng.permutation(n_items)

    def run():
        return StubLearner(model=None, max_level=max_level, items=np.arange(n_items),
                           item_old_codes=leaf_codes, rows_codes=np.zeros((n_items, 4), np.int64),
                           row_item_pos=np.arange(n_items, dtype=np.int64), gap=gap)

    fast = run().optimize()
    learner = run()
    proj = np.zeros(n_items, dtype=np.int64)
    for old_level in range(0, max_level, gap):
        level = min(max_level, old_level + gap)
        n_cand = 1 << (level - old_level)
        weights = learner.compute_weights(proj, old_level, level)
        old_codes = learner._old_ancestors_at_level(level)
        new_proj = proj.copy()
        for node in np.unique(proj):
            node_items = np.flatnonzero(proj == node)
            candidates = node * n_cand + (n_cand - 1) + np.arange(n_cand)
            balanced = learner.rebalance(node_items, candidates, weights[node_items], old_codes,
                                         1 << (max_level - level))
            for child, positions in balanced.items():
                new_proj[positions] = child
        proj = new_proj
    assert fast == {int(learner.items[i]): int(proj[i]) for i in range(n_items)}


@pytest.mark.parametrize("mode", ["host", "device"])
def test_otm_tree_learner_matches_jax(mode):
    """OTM's construction over synthetic mapped codes (rows NOT grouped by
    item: the device path sorts them)."""
    rng = np.random.default_rng(3)
    n_items, max_level = 40, 6
    codes = (1 << max_level) - 1 + rng.permutation(1 << max_level)[:n_items]
    item_to_code = {int(i): int(c) for i, c in zip(rng.permutation(1000)[:n_items] + 1, codes)}
    seqs = rng.choice(codes, size=(150, 5))
    seqs[rng.random(seqs.shape) < 0.2] = -1
    labels = rng.choice(codes, size=(150, 3))
    labels[:, 2] = -1
    params = seeded_params((1 << (max_level + 1)) - 1, seed=4)
    kw = dict(gap=2, weights_mode=mode, score_batch_rows=64)
    jl = J.otm_tree_learner(params, jdin.forward, item_to_code, seqs, labels, **kw)
    tl = T.otm_tree_learner(params_from_numpy(params, device="cpu"), item_to_code, seqs,
                            labels, device="cpu", **kw)
    proj0 = np.zeros(n_items, dtype=np.int64)
    np.testing.assert_allclose(tl.compute_weights(proj0, 0, 2), jl.compute_weights(proj0, 0, 2),
                               rtol=RTOL, atol=ATOL)
    pt, pj = tl.optimize(), jl.optimize()
    assert len(set(pt.values())) == n_items
    assert len(diff_items(pt, pj)) <= (0 if mode == "host" else near_tie_bound(n_items))


def test_write_projection_tree_is_byte_identical(setup, tmp_path):
    jl, tl = learners(setup, gap=2, weights_mode="host")
    proj = tl.optimize()
    J.write_projection_tree(setup[0], proj, str(tmp_path / "jax.bin"))
    T.write_projection_tree(setup[1], proj, str(tmp_path / "port.bin"))
    assert read_bytes(str(tmp_path / "port.bin")) == read_bytes(str(tmp_path / "jax.bin"))
    tree2 = ArrayTree.from_file(str(tmp_path / "port.bin"))
    assert tree2.num_items == setup[1].num_items
    for iid in list(proj)[:20]:
        assert tree2.ids_to_codes(np.array([iid]))[0] == proj[iid]


def test_floor_log2_at_every_power_of_two_boundary():
    xs = sorted({max(1, (1 << k) + d) for k in range(32) for d in (-1, 0, 1)})
    x = torch.tensor(xs, dtype=torch.int64)
    expect = torch.tensor([v.bit_length() - 1 for v in xs])
    assert torch.equal(T.floor_log2(x), expect)


@pytest.mark.parametrize("n_cand", [2, 4, 8])
def test_add_runs_matches_index_add(n_cand):
    """Runs summed first, then one add per item: equal to a plain index_add_
    of the raw logits, for a run that spans two batches and the 2-candidate
    case padded to the add's width of 4."""
    rng = np.random.default_rng(n_cand)
    n_items = 30
    idx = np.sort(rng.integers(0, n_items, 200))
    idx[-12:] = n_items  # padding rows collect in row N
    logits = torch.tensor(rng.normal(0, 3, (200, n_cand)), dtype=torch.float32)
    width = -(-n_cand // 4) * 4
    acc = torch.zeros(n_items + 1, width)
    cut = int(np.flatnonzero(idx == idx[90])[0]) + 1  # inside a run
    assert idx[cut - 1] == idx[cut]
    calls = []
    saved = row_writer.add_rows

    def spy(table, i, rows):
        kept = i[i >= 0]
        assert len(torch.unique(kept)) == len(kept), "a repeated index reached the add"
        calls.append(len(kept))
        return saved(table, i, rows)

    row_writer.add_rows = spy
    try:
        for s, e in ((0, cut), (cut, 200)):
            T.add_runs(acc, torch.as_tensor(idx[s:e]), logits[s:e])
    finally:
        row_writer.add_rows = saved
    assert len(calls) == 2
    ref = torch.zeros(n_items + 1, n_cand).index_add_(0, torch.as_tensor(idx), logits)
    np.testing.assert_allclose(acc[:, :n_cand].numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    assert not acc[:, n_cand:].any()


def test_learner_needs_cuda_unless_cpu_is_asked(setup, monkeypatch):
    jtree, tree, params, model, seqs, targets = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.TreeLearner(tree=tree, model=model, train_seqs=seqs, train_targets=targets)
    for mode in ("sharded", "auto"):
        with pytest.raises(ValueError, match="weights_mode"):
            T.TreeLearner(tree=tree, model=model, train_seqs=seqs, train_targets=targets,
                          weights_mode=mode, device="cpu")
    # host mode is the CPU parity twin: on CUDA the sweep goes through the add
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="CPU parity twin"):
        T.TreeLearner(tree=tree, model=model, train_seqs=seqs, train_targets=targets,
                      weights_mode="host", device=torch.device("cuda"))
