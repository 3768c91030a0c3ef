"""The port's two host tree helpers against the JAX package's:
``ArrayTree.ancestor_matrix`` (every level's ancestor of each leaf, rows of
-1 for invalid codes) and ``LoadedTree.code_nodes`` (the legacy code ->
``Node`` dict).  Both are numpy on the host; tolerance: none."""

import numpy as np
import pytest

from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import read_tree as j_read_tree
from dismember_tpu.index.tree_io import write_tree as j_write_tree
from dismember_tpu_torch.data import native
from dismember_tpu_torch.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu_torch.data.tdm_dataset import generate_split_samples
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.proto import Node
from dismember_tpu_torch.index.tree_io import category_sorted_codes, read_tree, write_tree


@pytest.fixture(scope="module")
def trees(small_csv, tmp_path_factory):
    """The example catalog's category tree (with the split's counts as node
    probabilities), written by the port, and a 5-item tree whose leaves sink
    to different depths, written by the JAX package."""
    raw = read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    d = tmp_path_factory.mktemp("trees")
    write_tree(str(d / "example.bin"), sorted_ids, codes, stat=samples.stat)
    j_write_tree(str(d / "ragged.bin"), np.array([11, 12, 13, 14, 15]),
                 np.array([3, 4, 5, 13, 14]), stat={11: 4, 13: 1, 15: 9})
    return d


def _codes(tree, rng) -> dict[str, np.ndarray]:
    valid = rng.choice(tree.item_codes, size=min(200, tree.num_items), replace=False)
    invalid = np.array([-1, -5, -(1 << 20)])
    mixed = np.concatenate([valid[:7], invalid, valid[7:12], [-1]])
    rng.shuffle(mixed)
    return {"valid": valid, "invalid": invalid, "mixed": mixed,
            "empty": np.zeros(0, np.int64)}


@pytest.mark.parametrize("name", ["example", "ragged"])
def test_ancestor_matrix_matches_jax(trees, name):
    path = str(trees / f"{name}.bin")
    tree, jtree = ArrayTree.from_file(path), JArrayTree.from_file(path)
    for kind, codes in _codes(tree, np.random.default_rng(3)).items():
        got = tree.ancestor_matrix(codes)
        ref = jtree.ancestor_matrix(codes)
        assert got.dtype == ref.dtype == np.int32, kind
        assert got.shape == (len(codes), tree.max_level + 1), kind
        np.testing.assert_array_equal(got, ref, err_msg=kind)
        # column max_level is the leaf, column 0 the root, column l the
        # ancestor at level l; invalid codes are rows of -1
        ok = codes >= 0
        assert (got[~ok] == -1).all(), kind
        np.testing.assert_array_equal(got[ok, -1], codes[ok])
        assert (got[ok, 0] == 0).all(), kind
        for level in range(tree.max_level + 1):
            np.testing.assert_array_equal(got[ok, level],
                                          tree.ancestor_at_level(codes[ok], level))


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("name", ["example", "ragged"])
def test_code_nodes_match_jax(trees, name, reader, monkeypatch):
    path = str(trees / f"{name}.bin")
    if reader == "python":
        monkeypatch.setenv("DISMEMBER_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
    got = read_tree(path).code_nodes
    ref = j_read_tree(path).code_nodes
    assert sorted(got) == sorted(ref) and all(isinstance(k, int) for k in got)
    for code, node in got.items():
        assert isinstance(node, Node)
        want = ref[code]
        assert (node.id, node.probality, node.is_leaf) == (want.id, want.probality,
                                                           want.is_leaf), code
    loaded = read_tree(path)
    assert sum(n.is_leaf for n in got.values()) == len(loaded.item_ids)
    assert {c: n.id for c, n in got.items() if n.is_leaf} == dict(
        zip(loaded.leaf_codes.tolist(), loaded.item_ids.tolist()))
