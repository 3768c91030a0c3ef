"""The serving facade's consumed filter and final top-k
(``retrieval/tree_beam.filter_topk``): the native pass (``csrc/serve_ops.cc``)
against the numpy form (under ``DISMEMBER_NO_NATIVE``) and the JAX package's
``filter_topk``, list for list and bit for bit; the ``tree_beam.filter_native``
counter; the inputs that take the numpy form; and ``TDMServing`` on the packed
route serving the same lists with the library and without it."""

import numpy as np
import pytest
import torch

from dismember_tpu.retrieval.tree_beam import filter_topk as jax_filter_topk
from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.data import native
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu_torch.retrieval import tree_beam
from dismember_tpu_torch.serving import TDMServing
from dismember_tpu_torch.train.tdm import build_model, packed_fns, serving_fns

W, K = 40, 10  # the facade's beam of 20: 40 leaves a row, the top 10 served


@pytest.fixture(scope="module")
def serve_lib():
    """The port's serving library, built here by g++: no skip, a missing
    build fails."""
    lib = native.get_serve_lib()
    assert lib is not None, "the port's serving library did not build"
    return lib


@pytest.fixture(autouse=True)
def _recording():
    profiling.enable(False)
    profiling.reset()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.reset()


def _native_calls() -> int:
    return profiling.snapshot()["counters"].get("tree_beam.filter_native", 0)


def _assert_same_lists(*results):
    first = results[0]
    for other in results[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            assert a.dtype == b.dtype == np.int64
            assert np.array_equal(a, b), (a, b)


def _check(monkeypatch, ids, scores, topk, consumed):
    """filter_topk with the library (one native call), under
    ``DISMEMBER_NO_NATIVE`` (none) and the JAX package's: the same lists."""
    before = _native_calls()
    got = tree_beam.filter_topk(ids, scores, topk, consumed)
    assert _native_calls() == before + 1
    with monkeypatch.context() as m:
        m.setenv("DISMEMBER_NO_NATIVE", "1")
        numpy_form = tree_beam.filter_topk(ids, scores, topk, consumed)
    assert _native_calls() == before + 1
    _assert_same_lists(got, numpy_form, jax_filter_topk(ids, scores, topk, consumed))
    assert len(got) == len(ids)
    return got


def _batch(b, w=W, seed=0):
    """Item ids (with repeats within a row) and float32 scores."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4 * max(w, 1), size=(b, w)).astype(np.int64),
            rng.standard_normal((b, w)).astype(np.float32))


def _consumed(ids, seed, most=12):
    """Per row: some of its own ids and some absent ones, 0 to ``most``."""
    rng = np.random.default_rng(seed)
    out = []
    for row in ids:
        n = int(rng.integers(0, most + 1))
        own = rng.choice(row, size=min(n, len(row)), replace=False) if len(row) else row[:0]
        absent = rng.integers(10_000, 20_000, size=int(rng.integers(0, 3)))
        out.append(np.concatenate([own, absent]).astype(np.int64))
    return out


@pytest.mark.parametrize("b", [0, 1, 7, 256])
def test_random_batches(serve_lib, monkeypatch, b):
    ids, scores = _batch(b, seed=b)
    got = _check(monkeypatch, ids, scores, K, _consumed(ids, seed=b + 1))
    assert all(len(x) <= K for x in got)
    _check(monkeypatch, ids, scores, K, None)


@pytest.mark.parametrize("w,topk", [(5, 10), (8, 8), (9, 1), (13, 4), (40, 0), (40, 16),
                                    (40, 17), (64, 10), (100, 30)])
def test_widths_and_topk_past_the_width(serve_lib, monkeypatch, w, topk):
    """Widths off the 8-slot vectors, one vector, k past the 16 group minima
    the bound is drawn from, and ``topk`` > W."""
    ids, scores = _batch(33, w=w, seed=w + topk)
    got = _check(monkeypatch, ids, scores, topk, _consumed(ids, seed=w, most=w // 3))
    assert max(len(x) for x in got) <= min(topk, w)


def _special_scores(kind, shape, rng):
    if kind == "ties":
        return rng.integers(0, 3, size=shape).astype(np.float32)
    if kind == "signed_zeros":
        return rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), size=shape)
    if kind == "nan":
        s = rng.standard_normal(shape).astype(np.float32)
        s[rng.random(shape) < 0.3] = np.nan
        s[0] = np.nan  # a row of NaN alone
        return s
    if kind == "infinities":  # and the beam's -3.4e38 for a dead leaf
        return rng.choice(np.array([np.inf, -np.inf, -3.4e38, 3.4e38, 0.5], np.float32),
                          size=shape)
    return rng.choice(np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 1.0,
                                np.float32(1e-45), -np.float32(1e-45)], np.float32), size=shape)


@pytest.mark.parametrize("kind", ["ties", "signed_zeros", "nan", "infinities", "mixed"])
def test_ties_signed_zeros_and_nan(serve_lib, monkeypatch, kind):
    """Equal scores go by column, 0.0 and -0.0 are one score, and a NaN
    comes after every other slot, unkept ones included."""
    rng = np.random.default_rng(len(kind))
    ids, _ = _batch(64, seed=5)
    scores = _special_scores(kind, ids.shape, rng)
    _check(monkeypatch, ids, scores, K, _consumed(ids, seed=6))
    _check(monkeypatch, ids, scores, K, None)


def test_pads_and_rows_left_short(serve_lib, monkeypatch):
    """-1 pads anywhere, a row of pads alone, rows with fewer than k kept
    slots (pads, consumed ids, -inf and NaN scores competing for the last
    places)."""
    rng = np.random.default_rng(7)
    ids, scores = _batch(48, seed=8)
    ids[rng.random(ids.shape) < 0.4] = -1
    ids[0] = -1
    ids[1, 3:] = -1
    ids[2, : W - 4] = -1
    scores[3, ::2] = -np.inf
    scores[4, ::3] = np.nan
    ids[4, 1::3] = -1
    scores[5] = -np.inf  # kept -inf slots and unkept ones tied, in column order
    scores[5, -3:] = 1.0
    ids[5] = np.arange(W)
    ids[5, 1::4] = -1
    got = _check(monkeypatch, ids, scores, K, _consumed(ids, seed=9, most=20))
    assert len(got[0]) == 0 and len(got[1]) <= 3
    assert any(0 < len(x) < K for x in got)


@pytest.mark.parametrize("form", ["none", "empty_lists", "duplicates", "absent",
                                  "longer_than_w", "past_the_scan", "int32", "python_lists",
                                  "python_lists_with_empty"])
def test_consumed_forms(serve_lib, monkeypatch, form):
    ids, scores = _batch(40, seed=10)
    rng = np.random.default_rng(11)
    if form == "none":
        consumed = None
    elif form == "empty_lists":
        consumed = [np.array([], np.int64) for _ in ids]
    elif form == "duplicates":
        consumed = [np.repeat(row[:3], 3) for row in ids]
    elif form == "absent":
        consumed = [rng.integers(10_000, 20_000, size=5) for _ in ids]
    elif form == "longer_than_w":  # every own id and more: rows left empty
        consumed = [np.concatenate([row, rng.integers(10_000, 20_000, 20)]) for row in ids]
    elif form == "past_the_scan":  # 17 to 39 ids: the sorted, binary-searched lists
        consumed = [rng.choice(row, size=int(rng.integers(17, 40)), replace=False)
                    for row in ids]
    elif form == "int32":
        consumed = [c.astype(np.int32) for c in _consumed(ids, seed=12)]
    elif form == "python_lists":
        consumed = [c.tolist() for c in _consumed(ids, seed=13)]
    else:
        consumed = [c.tolist() if i % 2 else [] for i, c in enumerate(_consumed(ids, seed=14))]
    got = _check(monkeypatch, ids, scores, K, consumed)
    if form == "longer_than_w":
        assert not any(len(x) for x in got)


def test_native_calls_are_counted_once_a_call(serve_lib, monkeypatch):
    ids, scores = _batch(16, seed=15)
    for _ in range(3):
        tree_beam.filter_topk(ids, scores, K)
    assert _native_calls() == 3
    monkeypatch.setenv("DISMEMBER_NO_NATIVE", "1")
    tree_beam.filter_topk(ids, scores, K)
    assert _native_calls() == 3
    assert profiling.snapshot()["spans"]["tree_beam.filter_topk"]["calls"] == 4


@pytest.mark.parametrize("case", ["float64_scores", "int32_ids", "consumed_for_fewer_rows"])
def test_inputs_the_pass_does_not_take_go_to_the_numpy_form(serve_lib, case):
    ids, scores = _batch(12, seed=16)
    consumed = _consumed(ids, seed=17)
    if case == "float64_scores":
        scores = scores.astype(np.float64)
    elif case == "int32_ids":
        ids = ids.astype(np.int32)
    else:
        consumed = consumed[:5]
    got = tree_beam.filter_topk(ids, scores, K, consumed)
    assert _native_calls() == 0
    want = jax_filter_topk(ids, scores, K, consumed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_strided_inputs_take_the_native_pass(serve_lib, monkeypatch):
    ids, scores = _batch(20, w=2 * W, seed=18)
    _check(monkeypatch, ids[:, ::2], np.asfortranarray(scores[:, ::2]), K,
           _consumed(ids[:, ::2], seed=19))


def test_tdm_serving_packed_route_serves_the_same_lists(serve_lib, tmp_path, monkeypatch):
    """``TDMServing.recommend_batch`` on a 9-level tree (the packed route,
    K3's plain version on the CPU) with a consumed list a row, each holding
    the row's window and some of what it is served without one: the same
    lists with the library (one native pass a batch) and without."""
    n = 300
    ids = np.arange(1, n + 1)
    sorted_ids, codes = category_sorted_codes(ids, np.repeat(np.arange(30), 10))
    path = str(tmp_path / "tree.bin")
    write_tree(path, sorted_ids, codes)
    tree = ArrayTree.from_file(path)
    model = build_model("din", tree.max_level, 16, 8, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    pre, app = serving_fns("din")
    _, app_emb = packed_fns("din")
    serv = TDMServing(model, type(model).forward, tree, precompute=pre, apply=app,
                      apply_emb=app_emb, model_type="din", topk=5, candidate_num=4)
    assert serv._use_packed(4)
    rng = np.random.default_rng(20)
    seqs = rng.choice(tree.item_ids, size=(32, 8)).astype(np.int64)
    seqs[0, 3:] = 0
    unfiltered = serv.recommend_batch(seqs)
    consumed = [np.concatenate([row[row > 0], served[: i % 4]])
                for i, (row, served) in enumerate(zip(seqs, unfiltered))]
    profiling.reset()
    got = serv.recommend_batch(seqs, consumed=consumed)
    snap = profiling.snapshot()["counters"]
    assert snap["tree_beam.filter_native"] == snap["serving.batches"] == 1
    monkeypatch.setenv("DISMEMBER_NO_NATIVE", "1")
    _assert_same_lists(got, serv.recommend_batch(seqs, consumed=consumed))
    assert _native_calls() == 1
    assert any(not np.array_equal(g, u) for g, u in zip(got, unfiltered))
    for g, c in zip(got, consumed):
        assert not np.isin(g, c).any()
