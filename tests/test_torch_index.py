"""Port host code against the JAX package: tree files, ArrayTree, CSV ingest
and windowing, checkpoints and the DIN parameter layout."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dismember_tpu.core import checkpoint as jckpt
from dismember_tpu.data.ingest import read_csv as j_read_csv
from dismember_tpu.data.ingest import unique_items_with_category as j_unique
from dismember_tpu.data.ingest import user_interactions as j_user_interactions
from dismember_tpu.data.tdm_dataset import generate_split_samples as j_split
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes as j_codes
from dismember_tpu.index.tree_io import write_tree as j_write_tree
from dismember_tpu.models import din as jdin
from dismember_tpu_torch.core import checkpoint as tckpt
from dismember_tpu_torch.data.ingest import (
    read_csv,
    unique_items_with_category,
    user_interactions,
)
from dismember_tpu_torch.data.tdm_dataset import generate_split_samples
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import (
    build_tree,
    category_sorted_codes,
    read_tree,
    write_tree,
)
from dismember_tpu_torch.models.din import DIN, params_from_numpy


def _catalog(n):
    ids = np.arange(1, n + 1)
    cats = np.repeat(np.arange((n + 9) // 10), 10)[:n]
    return ids, cats


@pytest.mark.parametrize("n,with_stat", [(16, False), (47, True), (300, True)])
def test_tree_bytes_equal_jax(tmp_path, n, with_stat):
    ids, cats = _catalog(n)
    sid, codes = category_sorted_codes(ids, cats)
    jsid, jcodes = j_codes(ids, cats)
    np.testing.assert_array_equal(sid, jsid)
    np.testing.assert_array_equal(codes, jcodes)
    stat = {int(i): int(i % 5) for i in ids[::2]} if with_stat else None
    write_tree(str(tmp_path / "port.bin"), sid, codes, stat=stat)
    j_write_tree(str(tmp_path / "jax.bin"), sid, codes, stat=stat)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


@pytest.mark.parametrize("n", [47, 300])
def test_build_tree_in_memory_equals_file(tmp_path, n):
    ids, cats = _catalog(n)
    sid, codes = category_sorted_codes(ids, cats)
    stat = {int(i): 3 for i in ids[::3]}
    path = str(tmp_path / "t.bin")
    write_tree(path, sid, codes, stat=stat)
    mem, disk = build_tree(sid, codes, stat), read_tree(path)
    for f in dataclasses.fields(mem):
        a, b = getattr(mem, f.name), getattr(disk, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    port = ArrayTree.from_loaded(mem)
    ref = JArrayTree.from_file(path)
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(port.node_meta, ref.node_meta)
    raw = np.array([[0, 1, 5, n, n + 7, 10**6]])
    np.testing.assert_array_equal(port.ids_to_codes(raw), ref.ids_to_codes(raw))


def test_ingest_and_windows_match_jax(small_csv):
    raw, jraw = read_csv(small_csv), j_read_csv(small_csv)
    for f in ("user", "item", "category", "label", "timestamp"):
        np.testing.assert_array_equal(getattr(raw, f), getattr(jraw, f), err_msg=f)
    assert raw.category_names == jraw.category_names
    inter, jinter = user_interactions(raw), j_user_interactions(jraw)
    assert inter.keys() == jinter.keys()
    for u in inter:
        np.testing.assert_array_equal(inter[u], jinter[u])
    for a, b in zip(unique_items_with_category(raw), j_unique(jraw)):
        np.testing.assert_array_equal(a, b)
    s, js = generate_split_samples(inter, 10, 2, 0.8), j_split(jinter, 10, 2, 0.8)
    for f in ("train_seqs", "train_targets", "train_users", "eval_seqs",
              "eval_labels", "eval_users"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f), err_msg=f)
    assert s.stat == js.stat


def _jax_params(seed, num_index=63, e=16):
    return jdin.init_params(jax.random.PRNGKey(seed), num_index, e)


def test_jax_checkpoint_loads_in_port(tmp_path):
    params = _jax_params(0)
    path = str(tmp_path / "jax_ckpt")
    meta = {"model": "din", "embed_size": 16, "seq_len": 10}
    jckpt.save_pytree(path, params, meta=meta)
    model = DIN(63, 16, device="cpu")
    model.load_numpy(tckpt.load_pytree(path, model.param_tree()))
    assert tckpt.load_meta(path) == meta
    got, ref = model.params_numpy(), jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_loads_in_jax(tmp_path):
    model = DIN(63, 16, device="cpu", generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "port_ckpt.npz")
    tckpt.save_pytree(path, model.param_tree(), meta={"model": "din"})
    loaded = jckpt.load_pytree(path, _jax_params(1))
    assert jckpt.load_meta(path) == {"model": "din"}
    got = jax.tree_util.tree_map(np.asarray, loaded)
    ref = model.params_numpy()
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy_round_trip():
    ref = jax.tree_util.tree_map(np.asarray, _jax_params(2, num_index=31, e=8))
    model = params_from_numpy(ref, device="cpu")
    assert tuple(model.mlp1.weight.shape) == (8, 16)
    assert model.att_linear.bias is None
    got = model.params_numpy()
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    bad = dict(ref, embedding=ref["embedding"][:, :4])
    with pytest.raises(ValueError, match="embedding"):
        model.load_numpy(bad)


def test_din_init_is_seeded_normal_with_zero_biases():
    make = lambda s: DIN(2047, 16, device="cpu",  # noqa: E731
                         generator=torch.Generator().manual_seed(s))
    a, b, c = make(7), make(7), make(8)
    torch.testing.assert_close(a.embedding, b.embedding, rtol=0, atol=0)
    assert not torch.equal(a.embedding, c.embedding)
    assert abs(a.embedding.std().item() - 0.05) < 2e-3
    assert abs(a.embedding.mean().item()) < 2e-3
    assert not a.mlp1.bias.any() and not a.mlp2.bias.any()
