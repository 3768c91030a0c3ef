"""The port's Deep Retrieval serving against the JAX package on one set of
numpy params and one path index: the path beam, the device path map with
its truncation, the block geometry, and the exact, packed and block routes
with the consumed filter and dedup; and the port's frozen-table choice.

Inputs are tie-free (weights at O(1) scale), so beams and top-k sets
agree; ``torch.topk`` and ``lax.top_k`` order equal values differently, so
paths are compared as sets per row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.data.dr_dataset import build_dr_data as j_build_dr_data
from dismember_tpu.index.paths import PathIndex as JPathIndex
from dismember_tpu.retrieval import dr_serve as jserve
from dismember_tpu.retrieval.path_beam import path_beam_search as j_path_beam_search
from dismember_tpu.serving import DRServing as JDRServing
from dismember_tpu.train.dr import DRTrainer as JDRTrainer
from dismember_tpu_torch.data.dr_dataset import build_dr_data
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.ops import dr_rerank
from dismember_tpu_torch.retrieval import dr_serve
from dismember_tpu_torch.retrieval.path_beam import path_beam_search
from dismember_tpu_torch.serving import DRServing
from dismember_tpu_torch.train.dr import DRTrainer

E, L, BEAM, TOPK = 8, 10, 10, 5
# (K, D): the conf's shape cut down, a hot map (16 paths of ~265 items,
# cut at 128: duplicates and truncation), and fewer paths than the beam
MAPS = {"random": (20, 3), "hot": (4, 2), "padded": (3, 2)}
SCORE_TOL = {"exact": 1e-5, "packed": 1e-3, "block": 1e-3}


@pytest.fixture(scope="module")
def datas(small_csv):
    ref = j_build_dr_data(small_csv, seq_len=L, min_seq_len=2, split_ratio=0.8)
    return build_dr_data(small_csv, seq_len=L, min_seq_len=2, split_ratio=0.8), ref


def _params(n_items, k, d, seed=0, std=0.5):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    layer = {"embedding": f(n_items + k * (d - 1), E),
             "heads": [{"weight": f(k, (L + i) * E), "bias": f(k)} for i in range(d)]}
    rerank = {"embedding": f(n_items, E), "linear": {"weight": f(E, L * E), "bias": f(E)},
              "softmax_w": f(n_items, E), "softmax_b": f(n_items)}
    return layer, rerank


def _pair(datas, name):
    """(port trainer, JAX trainer) on one path index and one set of params."""
    data, jdata = datas
    k, d = MAPS[name]
    idx = PathIndex.random_init(data.num_items, d, k, 2, seed=1)
    kw = dict(num_layers=d, num_nodes=k, num_paths_per_item=2, embed_size=E,
              beam_size=BEAM, topk=TOPK, seq_len=L)
    layer, rerank = _params(data.num_items, k, d)
    tr = DRTrainer(data, path_index=idx, device="cpu", **kw)
    tr.load_params(layer, rerank)
    jtr = JDRTrainer(jdata, path_index=JPathIndex(item_paths=idx.item_paths, num_nodes=k), **kw)
    jtr.layer_params = jax.tree.map(jnp.asarray, layer)
    jtr.rerank_params = jax.tree.map(jnp.asarray, rerank)
    return tr, jtr


def _consumed(data, b):
    users = data.eval_users[:b]
    width = max(len(data.user_consumed.get(int(u), ())) for u in users)
    cons = np.full((b, width), -1, np.int64)
    for i, u in enumerate(users):
        c = data.user_consumed.get(int(u), ())
        cons[i, : len(c)] = c
    return cons


@pytest.mark.parametrize("name", list(MAPS))
def test_path_beam_search_matches_by_path_sets(datas, name):
    tr, jtr = _pair(datas, name)
    k, d = MAPS[name]
    seqs = datas[0].eval_seqs[:24]
    paths, probs = path_beam_search(tr.layer_params, torch.as_tensor(seqs), BEAM,
                                    tr.data.num_items, k, d)
    jpaths, jprobs = j_path_beam_search(jtr.layer_params, jnp.asarray(seqs, jnp.int32), BEAM,
                                        tr.data.num_items, k, d)
    jpaths, jprobs = np.asarray(jpaths), np.asarray(jprobs)
    assert paths.shape == (len(seqs), BEAM, d)
    for i in range(len(seqs)):
        live = np.asarray(jprobs[i]) > 0  # a padded beam's zero-probability copies
        assert ({tuple(p) for p in paths[i].numpy()[probs[i].numpy() > 0]}
                == {tuple(p) for p in jpaths[i][live]})
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(MAPS))
def test_device_path_map_matches(datas, name):
    tr, jtr = _pair(datas, name)
    prio = dr_serve.train_frequency_priority(tr)
    np.testing.assert_array_equal(prio, jserve._train_frequency_priority(jtr))
    for cap, p in ((128, prio), (128, None), (3, prio)):
        got = dr_serve.DevicePathMap.build(tr.path_index, cap, item_priority=p, device="cpu")
        ref = jserve.DevicePathMap.build(jtr.path_index, cap, item_priority=p)
        np.testing.assert_array_equal(got.path_table.numpy(), np.asarray(ref.path_table))
        np.testing.assert_array_equal(got.path_items.numpy(), np.asarray(ref.path_items))
        assert got.truncated_paths == ref.truncated_paths
    if name == "hot":
        assert got.truncated_paths > 0
    assert dr_serve.DevicePathMap.build(tr.path_index, max_table=8, device="cpu") is None


def test_block_geometry_matches():
    for e in (8, 16, 32):
        for m in range(1, 131):
            assert dr_rerank.block_geometry(e, m) == jserve._block_geometry(e, m), (e, m)
    assert dr_rerank.block_geometry(126, 4) is None


@pytest.mark.parametrize("route", ["exact", "packed", "block"])
@pytest.mark.parametrize("name", list(MAPS))
def test_serving_routes_match_the_jax_route(datas, name, route):
    tr, jtr = _pair(datas, name)
    data = datas[0]
    b = 32
    seqs = data.eval_seqs[:b]
    cons = _consumed(data, b)
    fn = dr_serve.make_dr_serving_fn(tr, rerank_table=route)
    jfn = jserve.make_dr_serving_fn(jtr, rerank_table=route)
    assert fn.route == route
    for c in (None, cons):
        ids, scores = fn(tr.layer_params, tr.rerank_params, torch.as_tensor(seqs),
                         None if c is None else torch.as_tensor(c))
        jids, jscores = jfn(jtr.layer_params, jtr.rerank_params, jnp.asarray(seqs, jnp.int32),
                            None if c is None else jnp.asarray(c, jnp.int32))
        ids, scores = ids.numpy(), scores.numpy()
        jids, jscores = np.asarray(jids), np.asarray(jscores)
        assert ids.shape == jids.shape
        for i in range(b):
            assert set(ids[i]) == set(jids[i]), (i, ids[i], jids[i])
            live = ids[i][ids[i] >= 0]
            assert len(set(live)) == len(live)  # dedup: every item once
            if c is not None:
                assert not np.isin(live, c[i][c[i] >= 0]).any()
        ok = jscores > -1e38
        np.testing.assert_allclose(np.sort(scores, 1)[ok[:, ::-1]],
                                   np.sort(jscores, 1)[ok[:, ::-1]],
                                   rtol=SCORE_TOL[route], atol=SCORE_TOL[route])


def test_auto_route_and_host_route(datas):
    tr, _ = _pair(datas, "random")
    fn = dr_serve.make_dr_serving_fn(tr)
    assert fn.route == "exact"  # below 2^18 items
    seqs = datas[0].eval_seqs[:16]
    ids, _ = fn(tr.layer_params, tr.rerank_params, torch.as_tensor(seqs))
    for got, want in zip(ids.numpy(), tr.recommend_batch(seqs)):
        np.testing.assert_array_equal(got[got >= 0], want)


def test_closures_freeze_their_bf16_tables_and_read_the_rest_live(datas):
    """The port's choice (ROADMAP, "Frozen serving pack"), the JAX
    package's behaviour: a serving closure keeps the bf16 tables of the
    moment it was built (the block table and seq pack, the packed w|b
    rows) and reads everything else live, heads included; DRServing
    caches its closures."""
    tr, _ = _pair(datas, "hot")
    seqs = torch.as_tensor(datas[0].eval_seqs[:16])
    serve = {r: dr_serve.make_dr_serving_fn(tr, rerank_table=r)
             for r in ("exact", "packed", "block")}
    lp, rp = tr.layer_params, tr.rerank_params
    top = lambda r, lp_, rp_: serve[r](lp_, rp_, seqs)[0].numpy()  # noqa: E731
    before = {r: top(r, lp, rp) for r in serve}
    softmax = dict(rp, softmax_w=-rp["softmax_w"], softmax_b=-rp["softmax_b"])
    assert not np.array_equal(top("exact", lp, softmax), before["exact"])
    np.testing.assert_array_equal(top("packed", lp, softmax), before["packed"])
    np.testing.assert_array_equal(
        top("block", lp, dict(softmax, embedding=rp["embedding"] * 3.0)), before["block"])
    flipped = dict(lp, heads=[{"weight": -h["weight"], "bias": h["bias"]} for h in lp["heads"]])
    for r in serve:
        assert not np.array_equal(top(r, flipped, rp), before[r]), r
    serv = DRServing(tr)
    assert serv.device_serving_fn(topk=TOPK) is serv.device_serving_fn(topk=TOPK)


def test_dr_serving_facade_matches_jax(datas):
    tr, jtr = _pair(datas, "random")
    seqs = datas[0].eval_seqs[:8]
    serv, jserv = DRServing(tr), JDRServing(jtr)
    np.testing.assert_array_equal(serv.recommend_batch_device(seqs, topk=TOPK),
                                  jserv.recommend_batch_device(seqs, topk=TOPK))
    cons = datas[0].eval_seqs[3][-3:]
    np.testing.assert_array_equal(serv.recommend(seqs[3], topk=TOPK, consumed=cons),
                                  jserv.recommend(seqs[3], topk=TOPK, consumed=cons))
