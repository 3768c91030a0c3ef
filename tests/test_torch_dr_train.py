"""The port's Deep Retrieval E-step and M-step against the JAX package: one
dense, split-sparse and pmv layer + rerank step on the same params, batch
and negatives (the negatives drawn by the JAX package's sampler and handed
to the port), the fused E-step, the pmv mirrors through ``train``, the
coordinate-descent aggregation and greedy selection on the same beam
output, and coordinate descent end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.data.dr_dataset import build_dr_data as j_build_dr_data
from dismember_tpu.index.paths import PathIndex as JPathIndex
from dismember_tpu.models import dr_models as jdm
from dismember_tpu.train import dr_coordinate as jdc
from dismember_tpu.train import sparse_adam as j_sparse_adam
from dismember_tpu.train.dr import DRTrainer as JDRTrainer
from dismember_tpu_torch.core.checkpoint import flatten
from dismember_tpu_torch.data.dr_dataset import build_dr_data
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.train import dr_coordinate as dc
from dismember_tpu_torch.train import sparse_adam
from dismember_tpu_torch.train.dr import DRTrainer

K, D, J, L, S = 20, 3, 2, 10, 4
# tests/test_tdm_train.py's dense-vs-sparse tolerances: loss rtol 1e-5;
# params rtol 2e-4, atol 2e-6 (summation order of the f32 backward)
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
STEPS = 3


@pytest.fixture(scope="module")
def datas(small_csv):
    return (build_dr_data(small_csv, seq_len=L, min_seq_len=2, split_ratio=0.8),
            j_build_dr_data(small_csv, seq_len=L, min_seq_len=2, split_ratio=0.8))


def _params(n_items, e, seed=0, std=0.1):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    layer = {"embedding": f(n_items + K * (D - 1), e),
             "heads": [{"weight": f(K, (L + d) * e), "bias": f(K)} for d in range(D)]}
    rerank = {"embedding": f(n_items, e), "linear": {"weight": f(e, L * e), "bias": f(e)},
              "softmax_w": f(n_items, e), "softmax_b": f(n_items)}
    return layer, rerank


def _pair(datas, e, **kw):
    data, jdata = datas
    idx = PathIndex.random_init(data.num_items, D, K, J, seed=2)
    args = dict(num_layers=D, num_nodes=K, num_paths_per_item=J, embed_size=e,
                learning_rate=3e-3, num_sampled=S, seq_len=L, seed=5, **kw)
    layer, rerank = _params(data.num_items, e)
    tr = DRTrainer(data, path_index=idx, device="cpu", **args)
    tr.load_params(layer, rerank)
    tr._adopt_mirrors()
    jtr = JDRTrainer(jdata, path_index=JPathIndex(item_paths=idx.item_paths, num_nodes=K), **args)
    jtr.layer_params = jax.tree.map(jnp.asarray, layer)
    jtr.rerank_params = jax.tree.map(jnp.asarray, rerank)
    jtr._adopt_mirrors()
    return tr, jtr


def _batch(tr, n=64, off=0):
    d = tr.data
    targets = d.train_targets[off : off + n]
    return d.train_seqs[off : off + n], tr.path_index.item_paths[targets], targets


def _assert_params_close(tr, jtr):
    for got, ref in ((tr.layer_params, jtr.layer_params), (tr.rerank_params, jtr.rerank_params)):
        g, r = flatten(got), flatten(jax.tree.map(np.asarray, ref))
        assert g.keys() == r.keys()
        for n in g:
            np.testing.assert_allclose(g[n].numpy(), r[n], rtol=P_RTOL, atol=P_ATOL, err_msg=n)


def _steps(tr, jtr, batches):
    """The same batches and negatives through both packages' separate
    layer and rerank steps; losses compared step by step."""
    for i, (seqs, paths, targets) in enumerate(batches):
        key = jax.random.PRNGKey(11 + i)
        negs = np.array(jdm.sample_negatives(key, jnp.asarray(targets, jnp.int32),
                                             tr.data.num_items, S))
        jseqs, jlabels = jnp.asarray(seqs, jnp.int32), jnp.asarray(targets, jnp.int32)
        jtr.layer_params, jtr.layer_opt_state, jl = jtr._layer_step(
            jtr.layer_params, jtr.layer_opt_state, jseqs, jnp.asarray(paths, jnp.int32))
        jtr.rerank_params, jtr.rerank_opt_state, jr = jtr._rerank_step(
            jtr.rerank_params, jtr.rerank_opt_state, key, jseqs, jlabels)
        ls = tr._layer_step(torch.as_tensor(seqs), torch.as_tensor(paths))
        rl = tr._rerank_step(torch.as_tensor(seqs), torch.as_tensor(targets),
                             torch.as_tensor(negs))
        np.testing.assert_allclose(ls.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(rl), float(jr), rtol=LOSS_RTOL)
    jtr._sync_mirrors()
    tr._sync_mirrors()


@pytest.mark.parametrize("e", [8, 16])
@pytest.mark.parametrize("route", ["dense", "pmv"])
def test_steps_match_jax(datas, route, e):
    tr, jtr = _pair(datas, e, sparse_embed_update=route == "pmv")
    assert tr._pmv == jtr._pmv == (route == "pmv") and tr._sparse == jtr._sparse
    _steps(tr, jtr, [_batch(tr, off=64 * i) for i in range(STEPS)])
    _assert_params_close(tr, jtr)
    if route == "pmv":  # E+1 packs 4 slots at E=8, 2 at E=16
        assert tr.rerank_opt_state[2]["pmv"].shape[0] == -(-tr.data.num_items
                                                           // sparse_adam.pmv_slots(e + 1)) + 1


@pytest.mark.parametrize("e", [8, 48], ids=["mv-moments", "split-moments"])
def test_split_sparse_steps_match_jax(datas, e, monkeypatch):
    """The split route: lazy Adam through ``sparse_adam.apply_rows``.  At
    E=48 no p|m|v slot fits; at E=8 the route is forced in both packages by
    refusing pmv, and the moments pack as m|v rows (K2 + the row add)."""
    if e == 8:
        for mod in (sparse_adam, j_sparse_adam):
            monkeypatch.setattr(mod, "pmv_slots", lambda embed_dim: 0)
    tr, jtr = _pair(datas, e, sparse_embed_update=True)
    assert tr._sparse and not tr._pmv and not jtr._pmv
    assert ("mv" in tr.layer_opt_state[1]) == (e == 8)
    _steps(tr, jtr, [_batch(tr, off=64 * i) for i in range(STEPS)])
    _assert_params_close(tr, jtr)


def test_pmv_matches_dense_on_repeated_batches(datas):
    """pmv against the port's own dense route: with the same batch every
    step, the rows lazy Adam skips have zero gradients, so the routes agree
    (the JAX package's tests/test_dr.py:192 argument)."""
    dense, _ = _pair(datas, 16, sparse_embed_update=False)
    pmv, _ = _pair(datas, 16, sparse_embed_update=True)
    seqs, paths, targets = (torch.as_tensor(a) for a in _batch(dense))
    negs = pmv.sample_negatives(targets)
    for _ in range(STEPS):
        ld, lp = dense._layer_step(seqs, paths), pmv._layer_step(seqs, paths)
        np.testing.assert_allclose(lp.numpy(), ld.numpy(), rtol=LOSS_RTOL)
        rd, rp = dense._rerank_step(seqs, targets, negs), pmv._rerank_step(seqs, targets, negs)
        np.testing.assert_allclose(float(rp), float(rd), rtol=LOSS_RTOL)
    pmv._sync_mirrors()
    for a, b in ((pmv.layer_params, dense.layer_params), (pmv.rerank_params, dense.rerank_params)):
        for n, t in flatten(a).items():
            np.testing.assert_allclose(t.numpy(), flatten(b)[n].numpy(), rtol=P_RTOL,
                                       atol=P_ATOL, err_msg=n)


def test_fused_estep_equals_separate_steps(datas):
    a, _ = _pair(datas, 8, sparse_embed_update=True)
    b, _ = _pair(datas, 8, sparse_embed_update=True)
    for i in range(STEPS):
        seqs, paths, targets = (torch.as_tensor(x) for x in _batch(a, off=64 * i))
        negs = a.sample_negatives(targets)
        la, ra = a._estep_fused(seqs, paths, targets, negs)
        lb, rb = b._layer_step(seqs, paths), b._rerank_step(seqs, targets, negs)
        assert torch.equal(la, lb) and torch.equal(ra, rb)
    for sa, sb in zip(a.layer_opt_state[1:] + a.rerank_opt_state[1:],
                      b.layer_opt_state[1:] + b.rerank_opt_state[1:]):
        assert torch.equal(sa["pmv"], sb["pmv"]) and sa["count"] == sb["count"] == STEPS


def test_pmv_mirrors_sync_through_train(datas, caplog):
    tr, _ = _pair(datas, 8, sparse_embed_update=True, train_batch_size=2048, beam_size=10)
    res = tr.train(num_epochs=1)
    assert len(res) == 1 and np.isfinite(res[0].rerank_loss)
    assert not tr._mirrors_stale
    n = tr.data.num_items
    np.testing.assert_array_equal(
        tr.layer_params["embedding"].numpy(),
        sparse_adam.pmv_unpack(tr.layer_opt_state[1], n + K * (D - 1), 8).numpy())
    # a checkpoint load replaces the mirrors; train() adopts them
    forced = torch.zeros_like(tr.rerank_params["softmax_w"])
    tr.rerank_params["softmax_w"] = forced
    tr._adopt_mirrors()
    wb = sparse_adam.pmv_unpack(tr.rerank_opt_state[2], n, 9)
    assert torch.equal(wb[:, :8], forced) and torch.equal(wb[:, 8], tr.rerank_params["softmax_b"])
    # an in-place copy into a mirror counts too, and wins over newer packed
    # state with a warning
    seqs, paths, targets = (torch.as_tensor(x) for x in _batch(tr))
    tr._layer_step(seqs, paths)
    assert tr._mirrors_stale
    tr.layer_params["embedding"].fill_(0.25)
    tr._adopt_mirrors()
    assert "externally replaced" in caplog.text
    got = sparse_adam.pmv_gather(tr.layer_opt_state[1]["pmv"], torch.arange(n), 8)
    assert bool((got == 0.25).all())
    # a load after raw steps survives the next sync (the CLI's order: steps,
    # then a checkpoint load, then serving)
    tr._rerank_step(seqs, targets, tr.sample_negatives(targets))
    layer = {k: v for k, v in tr.layer_params.items()}
    loaded = {"embedding": torch.full_like(tr.rerank_params["embedding"], -0.5),
              "linear": tr.rerank_params["linear"],
              "softmax_w": tr.rerank_params["softmax_w"] * 2,
              "softmax_b": tr.rerank_params["softmax_b"] + 1}
    tr.load_params(layer, loaded)
    tr.beam_search_paths(tr.data.eval_seqs[:4])  # syncs the mirrors
    assert not tr._mirrors_stale
    for k in ("embedding", "softmax_w", "softmax_b"):
        assert torch.equal(tr.rerank_params[k], loaded[k]), k


class _Beam:
    """A trainer stand-in whose beam search returns fixed paths and
    probabilities by sample (sequence column 0 holds the sample's index):
    both packages' M-steps then see the same beam output."""

    def __init__(self, num_items, paths, probs):
        self.data = type("D", (), {"num_items": num_items})()
        self.num_nodes, self.num_layers, self.num_paths = K, D, J
        self.beam = paths.shape[1]
        self._paths, self._probs = paths, probs

    def beam_search_paths(self, seqs):
        rows = np.asarray(seqs)[:, 0]
        return self._paths[rows, : self.beam], self._probs[rows, : self.beam]


@pytest.mark.parametrize("mode,iters", [("batch", 1), ("streaming", 2)])
def test_aggregation_and_greedy_match_jax_bit_for_bit(mode, iters):
    rng = np.random.default_rng(6)
    n, n_items, c = 600, 90, 6
    # few distinct paths, so items contend and the size penalty matters
    pool = rng.integers(0, K, size=(12, D))
    paths = pool[rng.integers(0, len(pool), size=(n, c))].astype(np.int32)
    probs = rng.random((n, c)) * 0.5
    seqs = np.zeros((n, L), np.int64)
    seqs[:, 0] = np.arange(n)
    targets = rng.integers(0, n_items - 10, size=n)  # 10 items never occur
    kw = dict(num_iteration=iters, num_candidate_path=c, batch_size=128, mode=mode, seed=3,
              penalty_factor=0.05)
    got = dc.coordinate_descent(_Beam(n_items, paths, probs), seqs, targets, greedy="python",
                                **kw)
    ref = jdc.coordinate_descent(_Beam(n_items, paths, probs), seqs, targets, greedy="python",
                                 **kw)
    np.testing.assert_array_equal(got.item_paths, ref.item_paths)
    agg = (dc._collect_batch_arrays if mode == "batch" else
           lambda *a: dc._collect_streaming_arrays(*a, 0.999))
    jagg = (jdc._collect_batch_arrays if mode == "batch" else
            lambda *a: jdc._collect_streaming_arrays(*a, 0.999))
    for a, b in zip(agg(_Beam(n_items, paths, probs), seqs, targets, c, 128),
                    jagg(_Beam(n_items, paths, probs), seqs, targets, c, 128)):
        np.testing.assert_array_equal(a, b)
    # the native select (the port's host library) picks the Python loop's paths
    native = dc.coordinate_descent(_Beam(n_items, paths, probs), seqs, targets,
                                   greedy="native", **kw)
    np.testing.assert_array_equal(native.item_paths, got.item_paths)


def test_coordinate_descent_keeps_a_valid_assignment(datas):
    tr, _ = _pair(datas, 8, beam_size=10)
    d = tr.data
    idx = dc.coordinate_descent(tr, d.train_seqs, d.train_targets, num_candidate_path=10,
                                batch_size=512, mode="streaming")
    ip = idx.item_paths
    assert ip.shape == (d.num_items, J, D) and ip.dtype == np.int32
    assert ((ip >= 0) & (ip < K)).all() and idx.num_nodes == K
    seen = np.flatnonzero(np.bincount(d.train_targets, minlength=d.num_items))
    keys = idx.path_key_of(ip[seen])
    assert (keys[:, 0] != keys[:, 1]).mean() > 0.9  # J distinct paths where candidates allow
    assert not np.array_equal(ip, tr.path_index.item_paths)
