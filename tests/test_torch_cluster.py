"""The port's tree clustering (``dismember_tpu_torch/index/cluster.py``)
against the JAX package's, on the CPU, from the same numpy inputs.

k-means: identical codes; the port sums segments in the order XLA's CPU
backend does, so every distance is bit-equal.  Spectral: LAPACK builds
differ in an eigenvector's last bits (torch's MKL against the LAPACK jaxlib
calls), and a 2-means whose centroid 0 is the midpoint of two points ranks
those two by an exact tie in exact arithmetic, decided by those bits; the
rank order then places the pair's items when a split leaves them in a node
of one or two items.  So the spectral comparison is identical item sets
under every node that holds three items or more, and a valid code set.
The JAX package's eigh runs on OpenBLAS, whose result moves with its
thread count: at 1,000 items and 8 threads 8 of the root's left child's
500 items cross its split and the children swap sides, which no reordering
of children undoes; the port's (MKL in torch) is the same at 1 and 8
threads.  So the reference runs on one OpenBLAS thread, where it is
steady."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from dismember_tpu.index import cluster as J
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu_torch.core.io import read_bytes
from dismember_tpu_torch.index import cluster as T

SIZES = [3, 5, 64, 1000]


def blobs(n: int, e: int = 8, seed: int = 0) -> np.ndarray:
    """Well-separated Gaussian blobs: 2 for the spectral affinity's sake
    (a sigma-1 graph stays connected, so its top eigenvalue is simple),
    centres 3 apart, spread 0.3."""
    rng = np.random.default_rng(seed)
    centers = np.zeros((2, e))
    centers[1, 0] = 3.0
    return (centers[np.arange(n) % 2] + rng.normal(0, 0.3, (n, e))).astype(np.float32)


def node_sets(ids: np.ndarray, codes: np.ndarray, min_items: int) -> dict:
    """Heap code -> frozenset of item ids under it, for nodes holding at
    least ``min_items`` items (codes taken as given, before leaf sinking)."""
    members: dict[int, set] = {}
    for i, c in zip(ids.tolist(), codes.tolist()):
        while True:
            members.setdefault(c, set()).add(i)
            if c == 0:
                break
            c = (c - 1) >> 1
    return {c: frozenset(s) for c, s in members.items() if len(s) >= min_items}


@pytest.mark.parametrize("n", SIZES)
def test_kmeans_codes_match_jax(n):
    x = blobs(n, seed=n)
    ids = np.arange(1, n + 1)
    got_ids, got = T.tree_cluster(ids, x, 10, "kmeans", device="cpu")
    ref_ids, ref = J.tree_cluster(ids, x, 10, "kmeans")
    np.testing.assert_array_equal(got_ids, ref_ids)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) == n


@pytest.mark.parametrize("n", SIZES)
def test_spectral_matches_jax(n):
    x = blobs(n, e=4, seed=n)
    ids = np.arange(1, n + 1)
    _, got = T.tree_cluster(ids, x, 10, "spectral", device="cpu")
    with threadpool_limits(1, user_api="blas"):
        _, ref = J.tree_cluster(ids, x, 10, "spectral")
    assert len(np.unique(got)) == n
    assert node_sets(ids, got, 3) == node_sets(ids, ref, 3)


def test_spectral_projection_matches_jax_up_to_sign():
    import jax.numpy as jnp

    x = blobs(24, e=4, seed=1).reshape(2, 12, 4)
    got = T._spectral_project_batch(torch.as_tensor(x)).numpy()
    ref = np.asarray(J._spectral_project_batch(jnp.asarray(x)))
    # a column's sign is LAPACK's choice; the rows' distances are not
    sign = np.sign((got * ref).sum(axis=1, keepdims=True))
    np.testing.assert_allclose(got * sign, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cluster_type", ["kmeans", "spectral"])
def test_tiny_sets(cluster_type):
    """tests/test_cluster.py:85-89's two-item set, and a singleton."""
    for ids, emb, codes in ((np.array([7, 8]), np.array([[0.0, 0.0], [1.0, 1.0]]), [1, 2]),
                            (np.array([5]), np.array([[0.5, 0.5]]), [0])):
        _, got = T.tree_cluster(ids, emb, cluster_type=cluster_type, device="cpu")
        _, ref = J.tree_cluster(ids, emb, cluster_type=cluster_type)
        np.testing.assert_array_equal(got, ref)
        assert got.tolist() == codes


def test_blocked_cumsum_is_xla_cpu_cumsum():
    """The segment sums' order: XLA's CPU cumsum, bit for bit, at lengths
    that take zero, one and two levels of block totals."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for n in (7, 16, 300, 5000):
        x = rng.normal(0, 5, (n, 3)).astype(np.float32)
        got = T._blocked_cumsum(torch.as_tensor(x)).numpy()
        ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
        assert np.array_equal(got.view(np.int32), ref.view(np.int32)), n


@pytest.mark.parametrize("cluster_type", ["kmeans", "spectral"])
def test_tree_file_from_embeddings_csv_is_byte_identical(tmp_path, cluster_type):
    rng = np.random.default_rng(2)
    n, e = 64, 4
    csv = tmp_path / "embed.csv"
    with open(csv, "w") as f:
        for i in range(1, n + 1):
            f.write(f"{i}, " + ", ".join(f"{v:.12g}" for v in rng.normal(size=e)) + "\n")
    ids, emb = T.read_embeddings_csv(str(csv))
    ref_ids, ref_emb = J.read_embeddings_csv(str(csv))
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(emb, ref_emb)
    T.cluster_tree_from_embeddings(str(csv), str(tmp_path / "port.bin"), 3, cluster_type,
                                   device="cpu")
    J.cluster_tree_from_embeddings(str(csv), str(tmp_path / "jax.bin"), 3, cluster_type)
    port = read_bytes(str(tmp_path / "port.bin"))
    if cluster_type == "kmeans":
        assert port == read_bytes(str(tmp_path / "jax.bin"))
    tree = JArrayTree.from_file(str(tmp_path / "port.bin"))
    assert sorted(tree.item_ids.tolist()) == list(range(1, n + 1))


@pytest.mark.parametrize("n_iters", [1, 6])
def test_cooccurrence_embeddings_match_jax_numpy_path(monkeypatch, n_iters):
    import dismember_tpu.data.native as native

    # the JAX package's numpy pass (its native library matches it bit for bit)
    monkeypatch.setattr(native, "cooc_apply_native", lambda *a, **k: False)
    rng = np.random.default_rng(0)
    n_items, per = 128, 16
    g = rng.integers(0, n_items // per, size=800)
    seqs = g[:, None] * per + rng.integers(0, per, size=(800, 6))
    seqs[rng.random(seqs.shape) < 0.1] = -1
    targets = g * per + rng.integers(0, per, size=800)
    got = T.cooccurrence_embeddings(seqs, targets, n_items, dim=16, n_iters=n_iters)
    ref = J.cooccurrence_embeddings(seqs, targets, n_items, dim=16, n_iters=n_iters)
    assert got.dtype == np.float32 and got.shape == (n_items, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_iters", [1, 6])
def test_cooccurrence_embeddings_equal_jax_with_both_native_libraries(n_iters):
    """Both packages' native operator passes loaded: the two packages'
    features are equal bit for bit (each pass sums a segment's edges in
    order; numpy's ``reduceat`` would differ from it by ~1 ulp)."""
    import dismember_tpu.data.native as jnative
    from dismember_tpu_torch.data import native

    assert native.get_lib() is not None and jnative.get_lib() is not None
    rng = np.random.default_rng(1)
    n_items, per = 600, 20
    g = rng.integers(0, n_items // per, size=4000)
    seqs = g[:, None] * per + rng.integers(0, per, size=(4000, 8))
    seqs[rng.random(seqs.shape) < 0.1] = -1
    targets = g * per + rng.integers(0, per, size=4000)
    got = T.cooccurrence_embeddings(seqs, targets, n_items, dim=16, n_iters=n_iters)
    ref = J.cooccurrence_embeddings(seqs, targets, n_items, dim=16, n_iters=n_iters)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_tree_cluster_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ids, x = np.arange(1, 6), blobs(5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.tree_cluster(ids, x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.cluster_tree_from_embeddings("unused.csv", str(tmp_path / "t.bin"))
    with pytest.raises(ValueError, match="cluster_type"):
        T.tree_cluster(ids, x, cluster_type="agglomerative", device="cpu")
