"""The port's native host library (``dismember_tpu_torch/data/native.py``
over ``csrc/host_ops.cc``) against the JAX package's library and the port's
Python forms: CSV ingest, per-user grouping, the KV scan, the tree codec,
the co-occurrence pass and DR's greedy select, bit for bit; the fallbacks
(more than 64 candidates, ``DISMEMBER_NO_NATIVE``, a failed build).  The
serving library (``csrc/serve_ops.cc``) builds beside it under its own name
and falls back the same way; its pass is held to the numpy form in
``tests/test_torch_filter_topk.py``."""

import logging
import struct

import numpy as np
import pytest

from dismember_tpu.data import ingest as jingest
from dismember_tpu.data import native as jnative
from dismember_tpu.index import tree_io as jtree_io
from dismember_tpu.index.proto import KVItem
from dismember_tpu.train import dr_coordinate as jdc
from dismember_tpu_torch.data import ingest, native
from dismember_tpu_torch.index import tree_io
from dismember_tpu_torch.retrieval import tree_beam
from dismember_tpu_torch.train import dr_coordinate as dc

K, D, J = 20, 3, 2


@pytest.fixture(scope="module")
def lib():
    """The port's library, built here by g++: no skip, a missing build fails."""
    lib = native.get_lib()
    assert lib is not None, "the port's host library did not build"
    return lib


@pytest.fixture(scope="module")
def jlib():
    lib = jnative.get_lib()
    assert lib is not None, "the JAX package's host library did not build"
    return lib


@pytest.fixture
def no_native(monkeypatch):
    """The port's module with its library switched off (its cache reset and
    restored by monkeypatch)."""
    monkeypatch.setenv("DISMEMBER_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_library_builds_into_build_host(lib):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "host")
    assert path.name.startswith("libdismember_host_") and path.exists()
    assert native.SOURCE.parent.name == "csrc"
    assert "-ffp-contract=off" in native.CXX_FLAGS and "-march=native" in native.CXX_FLAGS


def test_serving_library_builds_into_build_host_under_its_own_name(lib):
    serve_lib = native.get_serve_lib()
    assert serve_lib is not None, "the port's serving library did not build"
    host = native.library_path()
    serve = native.library_path(native.SERVE_SOURCE, "serve")
    assert serve.parent == host.parent == native.BUILD_DIR
    assert serve.name.startswith("libdismember_serve_") and serve.exists()
    assert len(serve.stem.rsplit("_", 1)[1]) == 16 and serve.stem[-16:] != host.stem[-16:]
    assert native.SERVE_SOURCE.parent == native.SOURCE.parent
    assert serve_lib is native.get_serve_lib() and serve_lib is not lib


def _code_lines(path) -> list[str]:
    """A C++ source's lines from its first #include on, comments cut."""
    text = path.read_text()
    return [ln.split("//")[0].rstrip() for ln in text[text.index("#include"):].splitlines()]


def test_source_is_the_jax_packages_code():
    """The port's host_ops.cc is a copy of native/host_ops.cc: a change to
    the code of one must go to the other, or the libraries' outputs part
    (only the comments differ)."""
    jax_source = native.SOURCE.parents[2] / "native" / "host_ops.cc"
    assert _code_lines(native.SOURCE) == _code_lines(jax_source)


@pytest.mark.parametrize("which", ["small", "example"])
def test_csv_fields_equal_python_and_jax(lib, jlib, small_csv, example_csv, which):
    path = small_csv if which == "small" else example_csv
    got = ingest.read_csv(path)
    ref = ingest._read_csv_python(path)
    users, items, cats, labels, timestamps, names = jnative.parse_csv_native(path)
    for f, want in (("user", users), ("item", items), ("category", cats), ("label", labels),
                    ("timestamp", timestamps)):
        for a in (getattr(ref, f), want):
            np.testing.assert_array_equal(getattr(got, f), a)
            assert getattr(got, f).dtype == a.dtype, f
    assert got.category_names == ref.category_names == names


def test_user_interactions_equal_python_and_jax(lib, jlib, example_csv, monkeypatch):
    raw = ingest.read_csv(example_csv)
    got = ingest.user_interactions(raw)
    want = jnative.user_interactions_native(raw.user, raw.item, raw.timestamp)
    monkeypatch.setattr(ingest, "user_interactions_native", lambda *a: None)
    python = ingest.user_interactions(raw)
    assert list(got) == list(python) == list(want)
    for u in got:
        np.testing.assert_array_equal(got[u], python[u])
        np.testing.assert_array_equal(got[u], want[u])


def test_kv_scan_equals_jax(lib, jlib):
    recs = [KVItem(key=str(i).encode(), value=bytes(range(i % 7))).encode() for i in range(50)]
    data = b"".join(struct.pack(">i", len(r)) + r for r in recs)
    off, ln = native.scan_kv_records_native(data)
    joff, jln = jnative.scan_kv_records_native(data)
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_array_equal(ln, jln)
    assert [data[o : o + n] for o, n in zip(off, ln)] == recs


def _catalog(n, seed):
    """Item ids with uneven codes: a category sort, and some leaves lifted
    above the bottom level, so leaf sinking and ancestor sums both run."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(10 * n, size=n, replace=False) + 1
    sorted_ids, codes = tree_io.category_sorted_codes(ids, rng.integers(0, 7, size=n))
    stat = {int(i): int(c) for i, c in zip(sorted_ids, rng.integers(0, 40, size=n))
            if rng.random() < 0.8}
    return sorted_ids, codes, stat


@pytest.mark.parametrize("with_stat", [False, True])
def test_tree_bytes_equal_across_writers(lib, jlib, tmp_path, monkeypatch, with_stat):
    ids, codes, stat = _catalog(3000, 4)
    stat = stat if with_stat else None
    tree_io.write_tree(str(tmp_path / "native.bin"), ids, codes, stat=stat)
    jtree_io.write_tree(str(tmp_path / "jax.bin"), ids, codes, stat=stat)
    monkeypatch.setattr(tree_io, "write_tree_native", lambda *a: False)
    tree_io.write_tree(str(tmp_path / "python.bin"), ids, codes, stat=stat)
    got = (tmp_path / "native.bin").read_bytes()
    assert got == (tmp_path / "python.bin").read_bytes()
    assert got == (tmp_path / "jax.bin").read_bytes()


def test_tree_read_native_equals_python_and_jax(lib, jlib, tmp_path):
    ids, codes, stat = _catalog(2000, 5)
    path = str(tmp_path / "t.bin")
    tree_io.write_tree(path, ids, codes, stat=stat)
    got = tree_io.read_tree(path)
    want = jtree_io.read_tree(path)
    ref = tree_io._read_tree_python(path)
    built = tree_io.build_tree(ids, codes, stat)
    assert got.max_level == want.max_level == ref.max_level == built.max_level
    order = np.argsort(want.node_codes)  # the JAX package's keeps file order
    for f in ("item_ids", "leaf_codes", "node_codes", "node_ids", "node_probs",
              "node_is_leaf"):
        g, w = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(g, w[order] if f.startswith("node_") else w)
        np.testing.assert_array_equal(g, getattr(ref, f))
        np.testing.assert_array_equal(g, getattr(built, f))
        assert g.dtype == getattr(ref, f).dtype, f


def _cooc_inputs(n_items=3000, dim=16, n_edges=60_000, seed=3):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n_items, n_edges))
    src = rng.integers(0, n_items, n_edges).astype(np.int64)
    wn = rng.random(n_edges, dtype=np.float32)
    f = rng.standard_normal((n_items, dim), dtype=np.float32)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(dst)) + 1]).astype(np.int64)
    return starts, dst[starts].astype(np.int64), src, wn, f


@pytest.mark.parametrize("threads", [1, 4])
def test_cooc_pass_equals_jax_library_bit_for_bit(lib, jlib, threads):
    starts, segs, src, wn, f = _cooc_inputs()
    got, want = np.zeros_like(f), np.zeros_like(f)
    assert native.cooc_apply_native(starts, segs, src, wn, f, got, n_threads=threads)
    assert jnative.cooc_apply_native(starts, segs, src, wn, f, want, n_threads=threads)
    np.testing.assert_array_equal(got, want)
    # against the numpy form: sequential against pairwise sums, the JAX
    # package's test's tolerance
    ref = np.zeros_like(f)
    ref[segs] = np.add.reduceat(f[src] * wn[:, None], starts, axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


class _Beam:
    """A trainer stand-in whose beam search returns fixed paths and
    probabilities by sample (sequence column 0 holds the sample's index)."""

    def __init__(self, num_items, paths, probs):
        self.data = type("D", (), {"num_items": num_items})()
        self.num_nodes, self.num_layers, self.num_paths = K, D, J
        self.beam = paths.shape[1]
        self._paths, self._probs = paths, probs

    def beam_search_paths(self, seqs):
        rows = np.asarray(seqs)[:, 0]
        return self._paths[rows, : self.beam], self._probs[rows, : self.beam]


def _cd_inputs(c, n=600, n_items=90, seed=6):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, K, size=(12, D))  # few distinct paths: items contend
    paths = pool[rng.integers(0, len(pool), size=(n, c))].astype(np.int32)
    probs = rng.random((n, c)) * 0.5
    seqs = np.zeros((n, 10), np.int64)
    seqs[:, 0] = np.arange(n)
    targets = rng.integers(0, n_items - 10, size=n)  # 10 items never occur: random paths
    return (lambda: _Beam(n_items, paths, probs)), seqs, targets


@pytest.mark.parametrize("mode,iters", [("batch", 1), ("batch", 2), ("streaming", 1),
                                        ("streaming", 2)])
def test_native_greedy_equals_python_and_jax(lib, jlib, caplog, mode, iters):
    beam, seqs, targets = _cd_inputs(6)
    kw = dict(num_iteration=iters, num_candidate_path=6, batch_size=128, mode=mode, seed=3,
              penalty_factor=0.05)
    with caplog.at_level(logging.INFO, logger="dismember_tpu_torch.dr_cd"):
        auto = dc.coordinate_descent(beam(), seqs, targets, **kw)
    assert "greedy[native]" in caplog.text
    got = dc.coordinate_descent(beam(), seqs, targets, greedy="native", **kw)
    python = dc.coordinate_descent(beam(), seqs, targets, greedy="python", **kw)
    jax_native = jdc.coordinate_descent(beam(), seqs, targets, greedy="native", **kw)
    for other in (auto, python, jax_native):
        np.testing.assert_array_equal(got.item_paths, other.item_paths)
    assert len(np.unique(got.item_paths[-10:].reshape(10, -1), axis=0)) > 1  # drawn paths


def test_more_than_64_candidates_take_the_python_loop(lib, caplog):
    beam, seqs, targets = _cd_inputs(70, n=300, n_items=40)
    kw = dict(num_candidate_path=70, batch_size=128, mode="batch", seed=1)
    with caplog.at_level(logging.INFO, logger="dismember_tpu_torch.dr_cd"):
        auto = dc.coordinate_descent(beam(), seqs, targets, **kw)
    assert "greedy[python]" in caplog.text
    python = dc.coordinate_descent(beam(), seqs, targets, greedy="python", **kw)
    np.testing.assert_array_equal(auto.item_paths, python.item_paths)
    with pytest.raises(RuntimeError, match="more than 64 candidates"):
        dc.coordinate_descent(beam(), seqs, targets, greedy="native", **kw)


def test_no_native_env_takes_the_python_forms(no_native, small_csv, tmp_path):
    assert native.get_lib() is None
    assert native.get_serve_lib() is None
    assert not native.cooc_apply_native(*_cooc_inputs(n_items=10, n_edges=20),
                                        np.zeros((10, 16), np.float32))
    assert native.parse_csv_native(small_csv) is None
    raw = ingest.read_csv(small_csv)
    ref = jingest._read_csv_python(small_csv)
    np.testing.assert_array_equal(raw.item, ref.item)
    ids, codes, stat = _catalog(300, 6)
    tree_io.write_tree(str(tmp_path / "t.bin"), ids, codes, stat=stat)
    jtree_io.write_tree(str(tmp_path / "j.bin"), ids, codes, stat=stat)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    beam, seqs, targets = _cd_inputs(6)
    with pytest.raises(RuntimeError, match="native host library is unavailable"):
        dc.coordinate_descent(beam(), seqs, targets, greedy="native", num_candidate_path=6)


def test_failed_build_warns_once_and_falls_back(monkeypatch, caplog, small_csv):
    monkeypatch.delenv("DISMEMBER_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with caplog.at_level(logging.WARNING, logger="dismember_tpu_torch.native"):
        assert native.get_lib() is None
        assert native.get_lib() is None
        raw = ingest.read_csv(small_csv)
    assert caplog.text.count("native host library unavailable") == 1
    np.testing.assert_array_equal(raw.user, jingest._read_csv_python(small_csv).user)


def test_failed_serving_build_warns_once_and_falls_back(monkeypatch, caplog):
    monkeypatch.delenv("DISMEMBER_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_serve_lib", None)
    monkeypatch.setattr(native, "_serve_tried", False)
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50, size=(6, 40))
    scores = rng.standard_normal((6, 40)).astype(np.float32)
    consumed = [row[:3] for row in ids]
    with caplog.at_level(logging.WARNING, logger="dismember_tpu_torch.native"):
        assert native.get_serve_lib() is None
        assert native.get_serve_lib() is None
        got = tree_beam.filter_topk(ids, scores, 10, consumed)
    assert caplog.text.count("native serving library unavailable") == 1
    assert "native host library unavailable" not in caplog.text
    for a, b in zip(got, tree_beam._filter_topk_numpy(ids, scores, 10, consumed)):
        np.testing.assert_array_equal(a, b)


def test_pointer_arguments_are_checked(lib):
    starts, segs, src, wn, f = _cooc_inputs(n_items=10, n_edges=20)
    with pytest.raises(TypeError, match="wn must be C-contiguous float32"):
        native.cooc_apply_native(starts, segs, src, wn.astype(np.float64), f, np.zeros_like(f))
    with pytest.raises(TypeError, match="non-contiguous"):
        native.cooc_apply_native(starts, segs, src, wn, f, np.zeros((10, 32), np.float32)[:, ::2])
    with pytest.raises(ValueError, match="src indexes past"):
        native.cooc_apply_native(starts, segs, src + 10, wn, f, np.zeros_like(f))
    idx = np.zeros((4, 3), np.int64)
    with pytest.raises(TypeError, match="cand_scores"):
        native.dr_greedy_select_native(idx, np.zeros((4, 3), np.float32), np.ones(4, np.int64),
                                       np.zeros(1, np.int64), np.full((4, 2), -1, np.int64),
                                       1, 0.1, 4.0)


def test_serving_pointer_arguments_are_checked(lib):
    ids = np.zeros((3, 8), np.int64)
    scores = np.zeros((3, 8), np.float32)
    cons, lens = np.arange(4, dtype=np.int64), np.array([1, 1, 2], np.int64)
    with pytest.raises(TypeError, match="scores must be C-contiguous float32"):
        native.filter_topk_native(ids, scores.astype(np.float64), cons, lens, 2)
    with pytest.raises(TypeError, match="non-contiguous"):
        native.filter_topk_native(np.zeros((3, 16), np.int64)[:, ::2], scores, cons, lens, 2)
    with pytest.raises(ValueError, match="does not split cons"):
        native.filter_topk_native(ids, scores, cons, lens + 1, 2)
    with pytest.raises(ValueError, match="outside"):
        native.filter_topk_native(ids, scores, cons, lens, 9)
