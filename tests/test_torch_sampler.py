"""The port's negative sampler against the JAX package's.  The two draw from
different random streams, so positives, layout and labels must be equal,
negatives must keep the sampler's invariants, and per-level frequencies must
lie within a total-variation bound of JAX's."""

import jax
import numpy as np
import pytest
import torch

from dismember_tpu.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu.data.tdm_dataset import generate_split_samples
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.train.sampler import TreeSampler as JTreeSampler
from dismember_tpu.train.sampler import exists_lookup as j_exists_lookup
from dismember_tpu.train.sampler import pack_exists_rows as j_pack_exists_rows
from dismember_tpu.train.sampler import parse_layer_neg_counts as j_parse
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.train.sampler import (
    TreeSampler,
    exists_lookup,
    pack_exists_rows,
    parse_layer_neg_counts,
)

NEG_COUNTS = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"
# Total-variation distance between the port's and JAX's per-level negative
# frequencies, N >= 20k draws on levels of <= 64 nodes: sampling noise alone
# gives ~0.03 (E|p - q| ~ 0.8 * sqrt(2p/N) per node); a sampler that skipped
# the positive's exclusion or drew with replacement moves it by > 0.1.
TV_BOUND = 0.06
# negatives on levels 1-6 only: the frequency tests read levels 5 and 6
SHALLOW = "0,1,2,3,4,5,6" + ",0" * 16


@pytest.fixture(scope="module")
def trees(small_csv, tmp_path_factory):
    raw = read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    path = str(tmp_path_factory.mktemp("tree") / "tree.bin")
    write_tree(path, sorted_ids, codes, stat=samples.stat)
    return JArrayTree.from_file(path), ArrayTree.from_file(path)


def _draw(jsampler, sampler, targets, seed):
    jc, jl, jw = (np.asarray(a) for a in jax.device_get(jax.jit(jsampler.sample)(
        jax.random.PRNGKey(seed), targets, jsampler.device_state())))
    gen = torch.Generator().manual_seed(seed)
    tc, tl, tw = (a.numpy() for a in sampler.sample(gen, torch.as_tensor(targets).long()))
    return (jc, jl, jw), (tc, tl, tw)


def test_parse_neg_counts_matches_jax():
    for s, lvl in (("0,5", 1), ("0,1", 3), ("0,1,2,3", 3), ("0,1.0,3,7,9", 4)):
        try:
            ref = j_parse(s, lvl)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                parse_layer_neg_counts(s, lvl)
        else:
            assert parse_layer_neg_counts(s, lvl) == ref


def test_exists_rows_match_jax(trees):
    jtree, tree = trees
    rows = pack_exists_rows(tree.node_exists, device="cpu")
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_pack_exists_rows(jtree.node_exists)))
    codes = np.random.default_rng(0).integers(0, tree.total_codes, 500)
    np.testing.assert_array_equal(
        exists_lookup(rows, torch.as_tensor(codes)).numpy(),
        np.asarray(j_exists_lookup(j_pack_exists_rows(jtree.node_exists),
                                   codes.astype(np.int32))))


@pytest.mark.parametrize("max_exact", [1 << 18, 4])
def test_layout_positives_and_negative_invariants(trees, max_exact):
    """Exact (Gumbel top-k) and rejection paths: unit, labels and positives
    equal JAX's; negatives exist, lie in their level, are not the positive
    and have no duplicates."""
    jtree, tree = trees
    js = JTreeSampler.build(jtree, NEG_COUNTS, max_exact_level=max_exact)
    ts = TreeSampler.build(tree, NEG_COUNTS, max_exact_level=max_exact, device="cpu")
    assert ts.unit == js.unit and ts.level_exact == js.level_exact
    np.testing.assert_array_equal(ts.unit_labels, js.unit_labels)
    targets = np.asarray(tree.item_codes[:64])
    (jc, jl, jw), (tc, tl, tw) = _draw(js, ts, targets, 3)
    assert tc.shape == jc.shape == (64, ts.unit)
    np.testing.assert_array_equal(tl, jl)
    off = 0
    for level in range(1, tree.max_level + 1):
        np.testing.assert_array_equal(tc[:, off], jc[:, off])  # positives
        neg = ts.neg_counts[level]
        lo, hi = (1 << level) - 1, (1 << (level + 1)) - 1
        negs, w = tc[:, off + 1 : off + 1 + neg], tw[:, off + 1 : off + 1 + neg]
        assert (negs[w == 0] == -1).all()
        for i in range(len(targets)):
            real = negs[i][w[i] > 0]
            assert len(np.unique(real)) == len(real)
            assert tc[i, off] not in real
            assert ((real >= lo) & (real < hi)).all() and tree.node_exists[real].all()
        # a slot fills whenever the level has room (JAX's fill rate)
        np.testing.assert_allclose(w.mean(), jw[:, off + 1 : off + 1 + neg].mean(), atol=0.02)
        off += 1 + neg
    assert off == ts.unit


def _level_tv(jc, tc, sampler, level):
    off = sum(1 + sampler.neg_counts[lv] for lv in range(1, level))
    neg = sampler.neg_counts[level]
    lo, n = (1 << level) - 1, 1 << level
    hj = np.bincount(jc[:, off + 1 : off + 1 + neg].ravel() - lo, minlength=n)
    ht = np.bincount(tc[:, off + 1 : off + 1 + neg].ravel() - lo, minlength=n)
    return 0.5 * np.abs(hj / hj.sum() - ht / ht.sum()).sum(), ht, hj.sum()


@pytest.mark.parametrize("with_prob,max_exact", [(False, 1 << 18), (True, 1 << 18), (False, 4)])
def test_level_frequencies_match_jax(trees, with_prob, max_exact):
    jtree, tree = trees
    js = JTreeSampler.build(jtree, SHALLOW, with_prob=with_prob, max_exact_level=max_exact)
    ts = TreeSampler.build(tree, SHALLOW, with_prob=with_prob, max_exact_level=max_exact,
                           device="cpu")
    targets = np.asarray(np.resize(tree.item_codes, 4096))
    (jc, _, _), (tc, _, _) = _draw(js, ts, targets, 11)
    for level in (5, 6):
        tv, _, n = _level_tv(jc, tc, ts, level)
        assert n >= 20_000 and tv < TV_BOUND, (level, tv)


def test_with_prob_prefers_heavy_nodes(trees):
    """Weighted sampling draws heavy nodes (by node probability) more often
    than light ones, and more often than uniform sampling does."""
    _, tree = trees
    level = 6
    lo, n = (1 << level) - 1, 1 << level
    prob = tree.node_prob[lo : lo + n]
    exist = tree.node_exists[lo : lo + n]
    order = np.argsort(prob[exist])
    codes = np.flatnonzero(exist)
    light, heavy = codes[order[: len(order) // 4]], codes[order[-(len(order) // 4):]]
    targets = torch.as_tensor(np.resize(tree.item_codes, 4096)).long()
    share = {}
    for wp in (False, True):
        ts = TreeSampler.build(tree, SHALLOW, with_prob=wp, device="cpu")
        tc = ts.sample(torch.Generator().manual_seed(5), targets)[0].numpy()
        _, h, _ = _level_tv(tc, tc, ts, level)
        share[wp] = (h[heavy].sum() / h.sum(), h[light].sum() / h.sum())
    assert share[True][0] > 2 * share[True][1]
    assert share[True][0] > share[False][0]
