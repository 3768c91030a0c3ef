"""The port's TDM trainer against the JAX package: one dense, mv and pmv
step from a carried JAX state on the JAX sampler's batch; evaluate's metrics
and export from identical params; and the port's own training contract
(loss falls, determinism, dense/mv/pmv agreement, the pmv mirror)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu.data.tdm_dataset import generate_split_samples
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.train.tdm import TDMTrainer as JTDMTrainer
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.train import sparse_adam
from dismember_tpu_torch.train.tdm import TDMTrainer

NEG_COUNTS = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"
# tests/test_tdm_train.py's dense-vs-sparse tolerances: loss rtol 1e-5;
# params rtol 2e-4, atol 2e-6 (summation order of the f32 backward)
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
KW = dict(model_type="din", embed_size=8, learning_rate=3e-3, total_batch_size=512,
          layer_neg_counts=NEG_COUNTS, seed=7, topk=5, beam_size=8)
MODES = {"dense": dict(sparse_embed_update=False),
         "mv": dict(sparse_embed_update=True, sparse_format="mv"),
         "pmv": dict(sparse_embed_update=True, sparse_format="pmv")}


@pytest.fixture(scope="module")
def pipeline(small_csv, tmp_path_factory):
    raw = read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    path = str(tmp_path_factory.mktemp("tree") / "tree.bin")
    write_tree(path, sorted_ids, codes, stat=samples.stat)
    return JArrayTree.from_file(path), ArrayTree.from_file(path), samples


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(tree, samples, n):
    return tree.ids_to_codes(samples.train_seqs[:n]), tree.ids_to_codes(samples.train_targets[:n])


def _assert_params(got: dict, ref: dict, rtol=P_RTOL, atol=P_ATOL):
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_params(got[k], ref[k], rtol, atol)
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]),
                                       rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("mode", ["dense", "mv", "pmv"])
def test_step_from_carried_jax_state_matches_jax(pipeline, mode):
    """Two JAX steps, carry params + optax/sparse state to the port, then
    one step on the JAX sampler's batch in both packages."""
    jtree, tree, samples = pipeline
    jtr = JTDMTrainer(tree=jtree, **KW, **MODES[mode])
    assert (jtr._sparse, jtr._pmv) == (mode != "dense", mode == "pmv")
    sc, tc = _batch(jtree, samples, jtr.num_targets_per_batch)
    for k in (1, 2):
        jtr.params, jtr.opt_state, _ = jtr._train_step(
            jtr.params, jtr.opt_state, jax.random.PRNGKey(k), jnp.asarray(tc), jnp.asarray(sc))
    jtr._sync_mirrors()
    tr = TDMTrainer(tree=tree, device="cpu", **KW, **MODES[mode])
    tr.load_numpy(_np(jtr.params), _np(jtr.opt_state))
    sstate = jtr.sampler.device_state()
    codes, labels, weights = jax.jit(jtr.sampler.sample)(
        jax.random.PRNGKey(3), jnp.asarray(tc), sstate)
    # the reference step on exactly this batch
    jtr.sampler.sample = lambda *_: (codes, labels, weights)
    carry = ({k: v for k, v in jtr.params.items() if k != "embedding"}
             if mode == "pmv" else jtr.params)
    jp, jo, jloss = jax.jit(jtr._step_impl)(carry, jtr.opt_state, jax.random.PRNGKey(3),
                                            jnp.asarray(tc), jnp.asarray(sc), sstate)
    loss = tr.step_from_samples(
        *(torch.tensor(np.asarray(a)) for a in (sc, codes, labels, weights)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    if mode == "pmv":
        np.testing.assert_allclose(tr.emb_state["pmv"].numpy(), np.asarray(jo[1]["pmv"]),
                                   rtol=P_RTOL, atol=P_ATOL)
        assert tr.emb_state["count"] == int(jo[1]["count"]) == 3
        tr._sync_mirrors()
        jp = dict(jp, embedding=sparse_adam.pmv_unpack(
            {"pmv": torch.tensor(np.asarray(jo[1]["pmv"]))}, *tr.model.embedding.shape))
    _assert_params(tr.params, jp)
    assert tr.adam["count"] == 3


def test_dense_mv_pmv_agree(pipeline):
    """tests/test_tdm_train.py::test_sparse_step_matches_dense in the port:
    one sampled batch, three steps; untouched rows do not exist here because
    the batch repeats, so lazy and dense Adam agree."""
    _, tree, samples = pipeline
    trs = {m: TDMTrainer(tree=tree, device="cpu", **KW, **kw) for m, kw in MODES.items()}
    sc, tc = _batch(tree, samples, trs["dense"].num_targets_per_batch)
    sc, tc = torch.as_tensor(sc, dtype=torch.long), torch.as_tensor(tc, dtype=torch.long)
    batch = trs["dense"].sample(tc)
    for step in range(3):
        losses = {m: float(t.step_from_samples(sc, *batch)) for m, t in trs.items()}
        for m in ("mv", "pmv"):
            np.testing.assert_allclose(losses[m], losses["dense"], rtol=LOSS_RTOL,
                                       err_msg=f"{m} at step {step}")
    trs["pmv"]._sync_mirrors()
    for m in ("mv", "pmv"):
        _assert_params(trs[m].params, trs["dense"].model.params_numpy())


def test_evaluate_and_export_match_jax(pipeline, tmp_path):
    """With identical params: evaluate's precision, recall and nDCG equal
    JAX's, and the export file is byte-equal."""
    jtree, tree, samples = pipeline
    jtr = JTDMTrainer(tree=jtree, **KW)
    jtr.train(samples.train_seqs, samples.train_targets, iterations=20, progress_interval=20)
    tr = TDMTrainer(tree=tree, device="cpu", **KW)
    tr.load_numpy(_np(jtr.params))
    eval_data = (samples.eval_seqs[:64], samples.eval_labels[:64], samples.eval_users[:64])
    jev = jtr.evaluate(eval_data, samples.user_consumed)
    ev = tr.evaluate(eval_data, samples.user_consumed)
    assert ev.count == jev.count == 64
    for k in ("precision", "recall", "ndcg"):
        np.testing.assert_allclose(getattr(ev, k), getattr(jev, k), rtol=1e-12, err_msg=k)
    assert np.isfinite(ev.loss) and abs(ev.loss / 64 - jev.loss / 64) < 0.05
    jtr.export_embeddings(str(tmp_path / "j.csv"))
    tr.export_embeddings(str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_train_recommend_and_determinism(pipeline):
    """Loss falls; recommend gives topk unique real items without consumed
    ones; the same seed gives bitwise-identical tables and lists
    (tests/test_tdm_train.py:151)."""
    _, tree, samples = pipeline

    def run():
        tr = TDMTrainer(tree=tree, device="cpu", **{**KW, "total_batch_size": 1024, "seed": 123})
        logs = tr.train(samples.train_seqs, samples.train_targets, iterations=30,
                        progress_interval=15)
        return tr, logs

    (a, logs), (b, _) = run(), run()
    assert len(logs) == 2 and np.isfinite(logs[0]["train_loss"])
    assert logs[-1]["train_loss"] < logs[0]["train_loss"]
    np.testing.assert_array_equal(a.model.embedding.detach().numpy(),
                                  b.model.embedding.detach().numpy())
    seq = samples.eval_seqs[0]
    rec = a.recommend(seq, topk=5)
    np.testing.assert_array_equal(rec, b.recommend(seq, topk=5))
    assert len(np.unique(rec)) == 5 and np.isin(rec, tree.item_ids).all()
    consumed = samples.user_consumed[int(samples.eval_users[0])]
    assert not np.isin(a.recommend(seq, topk=5, consumed=consumed), consumed).any()


def test_pmv_mirror_lifecycle(pipeline):
    """tests/test_tdm_train.py::test_pmv_mirror_lifecycle in the port: train()
    leaves the mirror synced; an external load is adopted into the packed
    state at the next train(), moments and count kept."""
    _, tree, samples = pipeline
    tr = TDMTrainer(tree=tree, device="cpu", **{**KW, "seed": 5}, **MODES["pmv"])
    assert tr._pmv
    logs = tr.train(samples.train_seqs, samples.train_targets, iterations=10,
                    progress_interval=5)
    assert all(np.isfinite(lg["train_loss"]) for lg in logs)
    assert not tr._mirrors_stale
    v, e = tr.model.embedding.shape
    np.testing.assert_array_equal(tr.model.embedding.detach().numpy(),
                                  sparse_adam.pmv_unpack(tr.emb_state, v, e).numpy())
    assert len(tr.recommend(samples.eval_seqs[0], topk=5)) == 5
    loaded = np.random.default_rng(9).normal(size=(v, e)).astype(np.float32) * 0.01
    count = tr.emb_state["count"]
    tr.load_numpy({**tr.model.params_numpy(), "embedding": loaded})
    tr.train(samples.train_seqs, samples.train_targets, iterations=1, progress_interval=1)
    assert tr.emb_state["count"] == count + 1
    same = np.isclose(tr.model.embedding.detach().numpy(), loaded).all(axis=1)
    assert same.sum() > v // 2


def test_auto_route_and_not_ported_options(pipeline):
    jtree, tree, _ = pipeline
    kw = dict(embed_size=8, layer_neg_counts=NEG_COUNTS)
    for sparse in (None, True):
        j = JTDMTrainer(tree=jtree, sparse_embed_update=sparse, **kw)
        t = TDMTrainer(tree=tree, device="cpu", sparse_embed_update=sparse, **kw)
        assert (t._sparse, t._pmv) == (j._sparse, j._pmv)
        assert t.sampler.unit == j.sampler.unit
        assert t.num_targets_per_batch == j.num_targets_per_batch
    # a mesh is ported (tests/test_torch_spmd.py): anything else is refused
    with pytest.raises(TypeError, match="DeviceMesh with mesh_dim_names"):
        TDMTrainer(tree=tree, device="cpu", mesh=object(), **kw)
    # bf16 tables, step checkpoints and the resident loop are ported
    t = TDMTrainer(tree=tree, device="cpu", embed_dtype=torch.bfloat16, **kw)
    assert t.model.embedding.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="pmv needs"):
        TDMTrainer(tree=tree, device="cpu", embed_size=48, layer_neg_counts=NEG_COUNTS,
                   sparse_embed_update=True, sparse_format="pmv")
