"""The port's Deep Retrieval host code and models against the JAX package
on one set of numpy inputs: the path index and its ItemSet blob, the
dataset, checkpoints with lists of heads, the layer and rerank forwards,
the sampled and full softmax losses, and the port's own negatives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core import checkpoint as jckpt
from dismember_tpu.data.dr_dataset import build_dr_data as j_build_dr_data
from dismember_tpu.index.paths import PathIndex as JPathIndex
from dismember_tpu.models import dr_models as jdm
from dismember_tpu_torch.core import checkpoint as ckpt
from dismember_tpu_torch.data.dr_dataset import build_dr_data
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.models import dr_models as dm
from dismember_tpu_torch.models.din import DIN

N_ITEMS, K, D, J, E, L = 50, 7, 3, 2, 8, 6
RTOL, ATOL = 2e-4, 1e-5


def _layer_params(seed=0, std=0.5, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return {"embedding": f(n_items + K * (D - 1), E),
            "heads": [{"weight": f(K, (L + d) * E), "bias": f(K)} for d in range(D)]}


def _rerank_params(seed=1, std=0.5, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return {"embedding": f(n_items, E), "linear": {"weight": f(E, L * E), "bias": f(E)},
            "softmax_w": f(n_items, E), "softmax_b": f(n_items)}


def _seqs(b=12, seed=2):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N_ITEMS, size=(b, L))
    s[:, :2] = np.where(rng.random((b, 2)) < 0.4, -1, s[:, :2])
    s[0] = -1  # an all-padding row
    return s


def _t(tree):
    return dm.to_device_tree(tree, "cpu")


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_path_index_random_init_matches_bit_for_bit():
    got = PathIndex.random_init(N_ITEMS, D, K, J, seed=3)
    ref = JPathIndex.random_init(N_ITEMS, D, K, J, seed=3)
    np.testing.assert_array_equal(got.item_paths, ref.item_paths)
    assert got.item_paths.dtype == ref.item_paths.dtype
    assert got.path_to_items() == ref.path_to_items()
    np.testing.assert_array_equal(got.path_key_of(got.item_paths), ref.path_key_of(ref.item_paths))


def test_itemset_blob_round_trips_across_packages(tmp_path):
    idx = PathIndex.random_init(N_ITEMS, D, K, J, seed=4)
    item_to_id = {1000 + 3 * i: i for i in range(N_ITEMS)}
    mine, theirs = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    idx.write(mine, item_to_id)
    JPathIndex(item_paths=idx.item_paths, num_nodes=K).write(theirs, item_to_id)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for reader, path in ((JPathIndex.read, mine), (PathIndex.read, theirs)):
        back, ids = reader(path, K)
        np.testing.assert_array_equal(back.item_paths, idx.item_paths)
        assert ids == item_to_id and back.num_nodes == K


def test_build_dr_data_matches(small_csv):
    got = build_dr_data(small_csv, seq_len=10, min_seq_len=2, split_ratio=0.8)
    ref = j_build_dr_data(small_csv, seq_len=10, min_seq_len=2, split_ratio=0.8)
    assert got.item_to_id == ref.item_to_id and got.id_to_item == ref.id_to_item
    assert got.num_items == ref.num_items
    for f in ("train_seqs", "train_targets", "eval_seqs", "eval_labels", "eval_users"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.user_consumed.keys() == ref.user_consumed.keys()
    for u in ref.user_consumed:
        np.testing.assert_array_equal(got.user_consumed[u], ref.user_consumed[u])
    again = build_dr_data(small_csv, 10, 2, 0.8, item_to_id=ref.item_to_id)
    np.testing.assert_array_equal(again.train_seqs, ref.train_seqs)


def test_dr_checkpoints_load_in_either_package(tmp_path):
    layer, rerank = _layer_params(), _rerank_params()
    jax_written, port_written = str(tmp_path / "jax_model"), str(tmp_path / "port_model")
    jckpt.save_pytree(jax_written + ".layer", jax.tree.map(jnp.asarray, layer),
                      meta={"num_layer": D})
    jckpt.save_pytree(jax_written + ".rerank", jax.tree.map(jnp.asarray, rerank))
    lt, rt = dm.dr_params_from_numpy(layer, rerank, device="cpu")
    ckpt.save_pytree(port_written + ".layer", lt, meta={"num_layer": D})
    ckpt.save_pytree(port_written + ".rerank", rt)
    with np.load(port_written + ".layer.npz") as f:
        assert sorted(f.files) == ["embedding"] + [f"heads/{d}/{k}" for d in range(D)
                                                   for k in ("bias", "weight")]
    for base in (jax_written, port_written):
        for tree, suffix, like_t in ((layer, ".layer", lt), (rerank, ".rerank", rt)):
            got = ckpt.load_pytree(base + suffix, like_t)
            ref = jckpt.load_pytree(base + suffix, tree)
            assert isinstance(got.get("heads", []), list)
            for a, b, c in zip(ckpt.flatten(got).values(), jax.tree.leaves(ref),
                               jax.tree.leaves(tree)):
                np.testing.assert_array_equal(a, np.asarray(b))
                np.testing.assert_array_equal(a, c)
        assert ckpt.load_meta(base + ".layer") == {"num_layer": D}


def test_din_checkpoint_keys_are_unchanged():
    din = DIN(11, 16, device="cpu", generator=torch.Generator().manual_seed(0))
    assert list(ckpt.flatten(din.param_tree())) == [
        "att_linear/weight", "embedding", "mlp1/bias", "mlp1/weight", "mlp2/bias",
        "mlp2/weight"]


def test_layer_forwards_match():
    layer = _layer_params()
    seqs = _seqs()
    rng = np.random.default_rng(5)
    paths = rng.integers(0, K, size=(len(seqs), J, D)).astype(np.int32)
    lt = _t(layer)
    jl = jax.tree.map(jnp.asarray, layer)
    st, pt = torch.as_tensor(seqs), torch.as_tensor(paths)
    got = dm.layer_forward_training(lt, st, pt, N_ITEMS, K)
    ref = jdm.layer_forward_training(jl, jnp.asarray(seqs), jnp.asarray(paths), N_ITEMS, K)
    assert len(got) == D
    for g, r in zip(got, ref):
        _close(g, r)
    seq_e = dm.embed_lookup(lt["embedding"], st)
    prefix_e = lt["embedding"][dm.prefix_rows(pt, N_ITEMS, K, D - 1)]
    for g, r in zip(dm.layer_logits_from_emb(lt["heads"], seq_e, prefix_e, K),
                    jdm.layer_logits_from_emb(jl["heads"], jnp.asarray(seq_e.numpy()),
                                              jnp.asarray(prefix_e.numpy()), K)):
        _close(g, r)
    parts = dm.layer_seq_parts(lt, st)
    jparts = jdm.layer_seq_parts(jl, jnp.asarray(seqs))
    beam = rng.integers(0, K, size=(len(seqs), 4, D)).astype(np.int32)
    for d in range(D):
        _close(parts[d], jparts[d])
        _close(dm.layer_forward_beam(lt, parts[d], torch.as_tensor(beam[:, :, :d]), d,
                                     N_ITEMS, K),
               jdm.layer_forward_beam(jl, jparts[d], jnp.asarray(beam[:, :, :d]), d,
                                      N_ITEMS, K))


def test_rerank_vector_and_losses_match():
    rerank = _rerank_params()
    seqs = _seqs()
    rt, jr = _t(rerank), jax.tree.map(jnp.asarray, rerank)
    vec = dm.rerank_user_vector(rt, torch.as_tensor(seqs))
    jvec = jdm.rerank_user_vector(jr, jnp.asarray(seqs))
    _close(vec, jvec)
    labels = np.arange(len(seqs)) * 3 % N_ITEMS
    key = jax.random.PRNGKey(7)
    # the JAX draw, handed to the port: the same negatives in both
    negs = jdm.sample_negatives(key, jnp.asarray(labels), N_ITEMS, 5)
    got = dm.sampled_softmax_loss_given(rt, vec, torch.as_tensor(labels),
                                        torch.as_tensor(np.array(negs)))
    ref = jdm.sampled_softmax_loss(jr, jvec, jnp.asarray(labels), key, 5)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    # the port's own draw: sampled_softmax_loss is the given-negatives loss
    # on sample_negatives from the same generator state
    own = dm.sampled_softmax_loss(rt, vec, torch.as_tensor(labels),
                                  torch.Generator().manual_seed(3), 5)
    own_negs = dm.sample_negatives(torch.Generator().manual_seed(3), torch.as_tensor(labels),
                                   N_ITEMS, 5)
    assert torch.equal(own, dm.sampled_softmax_loss_given(rt, vec, torch.as_tensor(labels),
                                                          own_negs))
    _close(dm.full_softmax_loss(rt, vec, torch.as_tensor(labels)),
           jdm.full_softmax_loss(jr, jvec, jnp.asarray(labels)), rtol=1e-5)
    cands = np.stack([labels, (labels + 1) % N_ITEMS, np.full_like(labels, -1)], 1)
    _close(dm.rerank_scores(rt, vec, torch.as_tensor(cands)),
           jdm.rerank_scores(jr, jvec, jnp.asarray(cands)))


def test_full_softmax_loss_chunked_matches(monkeypatch):
    """The chunked log-sum-exp (catalogs past 2^18 items) equals the
    one-shot softmax, as tests/test_dr.py holds the JAX package's."""
    rng = np.random.default_rng(8)
    params = {"softmax_w": torch.as_tensor(rng.standard_normal((1000, 8)), dtype=torch.float32),
              "softmax_b": torch.as_tensor(rng.standard_normal(1000) * 0.1,
                                           dtype=torch.float32)}
    vecs = torch.as_tensor(rng.standard_normal((17, 8)), dtype=torch.float32)
    labels = torch.arange(17) * 7
    one = float(dm.full_softmax_loss(params, vecs, labels))
    monkeypatch.setattr(dm, "_FULL_SOFTMAX_MAX", 128)
    np.testing.assert_allclose(float(dm.full_softmax_loss(params, vecs, labels)), one,
                               rtol=1e-6)


@pytest.mark.parametrize("n_items", [40, (1 << 18) + 5], ids=["exact", "rejection"])
def test_port_negatives_are_distinct_in_range_and_never_the_label(n_items):
    labels = torch.as_tensor(np.arange(32) * 1000 % n_items)
    gen = torch.Generator().manual_seed(0)
    negs = dm.sample_negatives(gen, labels, n_items, 8).numpy()
    assert negs.shape == (32, 8)
    assert (negs >= 0).all() and (negs < n_items).all()
    for i, row in enumerate(negs.tolist()):
        assert len(set(row)) == len(row) and int(labels[i]) not in row
    again = dm.sample_negatives(torch.Generator().manual_seed(0), labels, n_items, 8)
    np.testing.assert_array_equal(again.numpy(), negs)
