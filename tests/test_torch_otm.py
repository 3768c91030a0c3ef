"""The port's OTM trainer against the JAX package on one set of numpy
params: target and trajectory math, one batch in the dense, mv, pmv and
f64 modes, evaluation and serving, and the port's guards.

Inputs are tie-free: weights at O(1) scale give logits that differ by far
more than the two packages' rounding, so pseudo-target decisions and beam
choices agree; trajectories are compared as sets per row and level, since
``torch.topk`` and ``lax.top_k`` order their picks differently."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.data.otm_dataset import build_otm_data
from dismember_tpu.retrieval.packed_beam import PackedTree as JPackedTree
from dismember_tpu.retrieval.packed_beam import build_pair_table as j_build_pair_table
from dismember_tpu.retrieval.packed_beam import make_packed_beam_fn_pallas
from dismember_tpu.retrieval.tree_beam import TreeBeamConfig as JTreeBeamConfig
from dismember_tpu.train import otm as jotm
from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.data import otm_dataset as ds
from dismember_tpu_torch.serving import OTMServing
from dismember_tpu_torch.train import otm
from dismember_tpu_torch.train.otm import OTMTrainer

E, BEAM = 8, 4
# tests/test_tdm_train.py's dense-vs-sparse tolerances: loss rtol 1e-5;
# params rtol 2e-4, atol 2e-6 (summation order of the f32 backward)
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
SCORE_RTOL, SCORE_ATOL = 2e-4, 1e-5
LABEL_ATOL = 1e-6
F64_TOL = 1e-10
KW = dict(embed_size=E, beam_size=BEAM, topk=5, learning_rate=3e-3,
          total_train_batch_size=256, total_eval_batch_size=256, seed=0)
MODES = {"dense": dict(sparse_embed_update=False),
         "mv": dict(sparse_embed_update=True, sparse_format="mv"),
         "pmv": dict(sparse_embed_update=True, sparse_format="pmv"),
         "f64": dict(precision="f64")}


@pytest.fixture(scope="module")
def data(small_csv):
    """The JAX package's data, with the eval set cut to 24 windows."""
    d = build_otm_data(small_csv, seq_len=10, min_seq_len=2, split_ratio=0.8,
                       leaf_init_mode="category", label_num=3, seed=1)
    return dataclasses.replace(d, eval_seqs=d.eval_seqs[:24], eval_labels=d.eval_labels[:24],
                               eval_users=d.eval_users[:24])


def _params(num_index, seed, std=0.5):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return {"embedding": f(num_index, E), "att_linear": {"weight": f(E, E)},
            "mlp1": {"weight": f(E, 2 * E), "bias": f(E)},
            "mlp2": {"weight": f(1, E), "bias": f(1)}}


def _jax_trainer(d, params, **kw):
    jtr = jotm.OTMTrainer(d, **{**KW, **kw})
    with jtr._ctx():
        jtr.params = jax.tree.map(lambda a: jnp.asarray(a, jtr.dtype), params)
    jtr._adopt_mirrors()
    return jtr


def _trainer(d, params, **kw):
    tr = OTMTrainer(d, device="cpu", **{**KW, **kw})
    tr.load_numpy(params)
    tr._adopt_mirrors()
    return tr


def _batch(d, n=32):
    return d.train_seqs[:n], d.train_labels[:n]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def test_row_group_parents_level_labels_and_normal_targets_match_jax(data):
    rng = np.random.default_rng(0)
    parents = rng.integers(-1, 6, (16, 7))
    values = rng.random((16, 7)).astype(np.float32)
    j_ids, j_lab = jax.device_get(jotm._row_group_parents(jnp.asarray(parents, jnp.int32),
                                                          jnp.asarray(values)))
    ids, lab = otm._row_group_parents(_t(parents), torch.as_tensor(values))
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_allclose(lab.numpy(), j_lab, atol=LABEL_ATOL)
    nodes = rng.integers(-1, 12, (16, 8))
    t_ids = rng.integers(-1, 12, (16, 5))
    t_lab = rng.random((16, 5)).astype(np.float32)
    j_lab2, j_valid = jax.device_get(jotm.level_labels(
        jnp.asarray(nodes, jnp.int32), jnp.asarray(t_ids, jnp.int32), jnp.asarray(t_lab),
        jnp.float32))
    lab2, valid = otm.level_labels(_t(nodes), _t(t_ids), torch.as_tensor(t_lab), torch.float32)
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    np.testing.assert_allclose(lab2.numpy(), j_lab2, atol=LABEL_ATOL)
    jtr = jotm.OTMTrainer(data, target_mode="normal", **KW)
    tr = OTMTrainer(data, target_mode="normal", device="cpu", **KW)
    j_nt = jax.device_get(jtr._normal_targets(data.train_labels[:6]))
    nt = tr._normal_targets(_t(data.train_labels[:6]))
    np.testing.assert_array_equal(nt[0].numpy(), j_nt[0])
    np.testing.assert_array_equal(nt[1].numpy(), j_nt[1])


def test_pseudo_targets_and_trajectory_match_jax(data):
    p = _params(data.num_tree_nodes, 1)
    jtr, tr = _jax_trainer(data, p), _trainer(data, p)
    seqs, targets = _batch(data, 24)
    j_ids, j_lab = jax.device_get(jtr._pseudo(jtr.params, jnp.asarray(seqs, jnp.int32),
                                              jnp.asarray(targets, jnp.int32)))
    j_nodes, j_scores = jax.device_get(jtr._beam_traj(jtr.params, jnp.asarray(seqs, jnp.int32)))
    with torch.no_grad():
        scorer = tr._frozen_scorer(_t(seqs))
        ids, lab = tr._pseudo_targets_from(scorer, _t(targets))
        nodes, scores = tr._beam_trajectory_from(scorer, len(seqs))
    assert ids.shape == j_ids.shape == (tr.n_levels, len(seqs), 3)
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_allclose(lab.numpy(), j_lab, atol=LABEL_ATOL)
    assert nodes.shape == j_nodes.shape == (tr.n_levels, len(seqs), 2 * BEAM)
    for lvl in range(tr.n_levels):
        for r in range(len(seqs)):
            o, jo = np.argsort(nodes[lvl, r].numpy()), np.argsort(j_nodes[lvl, r])
            np.testing.assert_array_equal(nodes[lvl, r].numpy()[o], j_nodes[lvl, r][jo])
            np.testing.assert_allclose(scores[lvl, r].numpy()[o], j_scores[lvl, r][jo],
                                       rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_one_batch_matches_jax(data, mode):
    """One batch (n_levels Adam steps) from the same params and a fresh
    optimizer state in both packages: per-level losses and every param."""
    p = _params(data.num_tree_nodes, 2)
    jtr, tr = _jax_trainer(data, p, **MODES[mode]), _trainer(data, p, **MODES[mode])
    assert (tr._sparse, tr._pmv) == (jtr._sparse, jtr._pmv) == (mode in ("mv", "pmv"),
                                                                 mode == "pmv")
    seqs, targets = _batch(data)
    with jtr._ctx():
        jtr.params, jtr.opt_state, j_losses = jtr._train_batch(
            jtr.params, jtr.opt_state, jnp.asarray(seqs, jnp.int32),
            jnp.asarray(targets, jnp.int32))
    jtr._sync_mirrors()
    losses = tr._train_batch(_t(seqs), _t(targets))
    tr._sync_mirrors()
    if mode == "f64":
        assert losses.dtype == torch.float64 and tr.model.embedding.dtype == torch.float64
        rtol, atol, lrtol = F64_TOL, F64_TOL, F64_TOL
    else:
        rtol, atol, lrtol = P_RTOL, P_ATOL, LOSS_RTOL
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), rtol=lrtol)
    got, ref = tr.model.params_numpy(), jax.tree.map(np.asarray, jtr.params)
    for k in ("embedding", "att_linear", "mlp1", "mlp2"):
        for g, r in zip(jax.tree.leaves(got[k]), jax.tree.leaves(ref[k])):
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=k)
    if tr._sparse:
        assert tr.emb_state["count"] == int(jtr.opt_state[1]["count"]) == tr.n_levels


def test_evaluate_and_recommend_match_jax(data):
    """Evaluation and serving on one set of params.  The JAX side serves
    through the Pallas level body (interpret mode): the port's CPU level
    rounds matmul operands to bf16 like K3."""
    p = _params(data.num_tree_nodes, 3)
    jtr, tr = _jax_trainer(data, p), _trainer(data, p)
    total, s = data.num_tree_nodes, jtr.start_level
    start = np.arange((1 << s) - 1, (1 << (s + 1)) - 1)
    cfg = JTreeBeamConfig(beam=BEAM, max_level=jtr.leaf_level, start_level=s,
                          start_codes_padded=tuple(int(c) for c in np.concatenate(
                              [start, np.full(2 * BEAM - len(start), -1)])))
    table = j_build_pair_table(jtr.params["embedding"], np.ones(total, bool),
                               np.arange(total), total)
    jtr._packed_cache = (jtr.params, make_packed_beam_fn_pallas(
        JPackedTree(pair_table=table, embed_size=E, cfg=cfg), tile_b=8, interpret=True))
    jev, ev = jtr.evaluate(), tr.evaluate()
    for k in ("precision", "recall", "ndcg"):
        assert getattr(ev, k) == pytest.approx(getattr(jev, k), rel=1e-12), k
    assert ev.loss == pytest.approx(jev.loss, rel=1e-4)
    seqs = data.eval_seqs[:8]
    consumed = [data.user_consumed[int(u)] for u in data.eval_users[:8]]
    for got, ref in zip(tr.recommend_batch(seqs, consumed=consumed),
                        jtr.recommend_batch(seqs, consumed=consumed)):
        np.testing.assert_array_equal(got, ref)
    codes, scores = tr.recommend_batch(seqs, return_codes=True, with_scores=True)[0]
    assert 0 < len(codes) <= 5 and (np.diff(scores) <= 0).all()


@pytest.mark.parametrize("mode", ["dense", "pmv"])
def test_spans_count_the_batches_and_change_no_bit(data, mode):
    """With recording on, each batch opens otm.batch over one otm.frozen and
    n_levels row_step.step spans and counts one batch; losses and parameters
    are those of the run with recording off, bit for bit."""
    p = _params(data.num_tree_nodes, 6)
    batches = [(_t(s), _t(t)) for s, t in (_batch(data, 16), (data.train_seqs[16:32],
                                                              data.train_labels[16:32]))]
    a, b = _trainer(data, p, **MODES[mode]), _trainer(data, p, **MODES[mode])
    la = [a._train_batch(*x) for x in batches]
    profiling.reset()
    profiling.enable(True)
    try:
        lb = [b._train_batch(*x) for x in batches]
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    bits = lambda t: t.detach().view(torch.int32).numpy()  # noqa: E731
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(bits(x), bits(y))
    a._sync_mirrors()
    b._sync_mirrors()
    for (n, x), (_, y) in zip(a.model.named_parameters(), b.model.named_parameters()):
        np.testing.assert_array_equal(bits(x), bits(y), err_msg=n)
    n = len(batches)
    assert {k: v["calls"] for k, v in snap["spans"].items()} == {
        "otm.batch": n, "otm.frozen": n, "row_step.step": n * b.n_levels}
    assert snap["counters"]["otm.batches"] == n


def test_packed_search_rebuilds_when_the_embedding_changes(data):
    tr = _trainer(data, _params(data.num_tree_nodes, 4))
    fn = tr._packed_search()
    assert tr._packed_search() is fn
    tr._train_batch(*(_t(a) for a in _batch(data, 8)))
    assert tr._packed_search() is not fn


def test_serving_loads_a_checkpoint_on_the_cpu_only_when_asked(data, small_csv, tmp_path,
                                                              monkeypatch):
    from dismember_tpu_torch.core.checkpoint import save_pytree

    ckpt, mapping = str(tmp_path / "m"), str(tmp_path / "map.txt")
    save_pytree(ckpt, _params(data.num_tree_nodes, 5),
                meta={"model": "din", "embed_size": E, "seq_len": 10, "num_items": 1})
    ds.save_mapping(mapping, data.item_to_code)
    serv = OTMServing.load(ckpt, mapping, small_csv, label_num=3, beam_size=BEAM, topk=5,
                           device="cpu")
    items = serv.recommend(np.asarray([data.code_to_item[c] for c in data.eval_seqs[0]
                                       if c >= 0]))
    assert len(items) == 5 and set(items.tolist()) <= set(data.item_to_code)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OTMServing.load(ckpt, mapping, small_csv, label_num=3, beam_size=BEAM)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OTMTrainer(data, embed_size=E, beam_size=BEAM)


def test_guards(data):
    kw = dict(embed_size=E, beam_size=BEAM, device="cpu")
    assert OTMTrainer(data, model_type="deepfm", **kw).model.model_type == "deepfm"
    with pytest.raises(ValueError, match="unknown deep model"):
        OTMTrainer(data, model_type="dssm", **kw)
    # a mesh is ported (tests/test_torch_spmd_sparse.py): anything else is refused
    with pytest.raises(TypeError, match="DeviceMesh with mesh_dim_names"):
        OTMTrainer(data, mesh=object(), **kw)
    with pytest.raises(ValueError, match="f64"):
        OTMTrainer(data, precision="f64", sparse_embed_update=True, **kw)
    with pytest.raises(ValueError, match="packable"):
        OTMTrainer(data, embed_size=48, beam_size=BEAM, device="cpu",
                   sparse_embed_update=True, sparse_format="pmv")
    with pytest.raises(ValueError, match="unknown sparse_format"):
        OTMTrainer(data, sparse_format="xyz", **kw)
    with pytest.raises(ValueError, match="precision"):
        OTMTrainer(data, precision="f16", **kw)
    # the auto route as the JAX package takes it
    for sparse in (None, True):
        j = jotm.OTMTrainer(data, embed_size=E, beam_size=BEAM, sparse_embed_update=sparse)
        t = OTMTrainer(data, sparse_embed_update=sparse, **kw)
        assert (t._sparse, t._pmv, t.train_batch_size, t.n_levels) == (
            j._sparse, j._pmv, j.train_batch_size, j.n_levels)
