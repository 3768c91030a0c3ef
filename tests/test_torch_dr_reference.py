"""The port's Deep Retrieval serving facade against the benchmark's plain
reference (``benchmark/reference/dr.py``, imported by path): the exact,
packed and block routes through ``DRServing.recommend_batch_device`` with
consumed lists, the host route against the exact route, the reference on
float8 operands failing the tolerances; and the facade itself: no host
path->items dict for the device route, the consumed list's two forms, the
host fallback's shape, and its spans and counters.

A small catalog (3,000 items, K 10, D 3, J 2, E 16, L 10, beam 20, top-10)
with seeded O(1)-scale weights, so beams and top-10 lists are far from
ties."""

import contextlib
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dismember_tpu_torch import serving
from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.data.dr_dataset import DRData
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.retrieval import dr_serve
from dismember_tpu_torch.serving import DRServing
from dismember_tpu_torch.train.dr import DRTrainer

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "benchmark_reference_dr", REPO / "benchmark" / "reference" / "dr.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

N, K, D, J, E, L, BEAM, TOPK, B = 3000, 10, 3, 2, 16, 10, 20, 10, 64
# the weights' standard deviations: layer logits of a few units over K,
# rerank logits ~5 (the benchmark configuration's choice)
STD = {"embedding": 1.0, "head": 0.2, "bias": 0.5, "linear": 0.1, "softmax_w": 1.0}
# the bf16 routes round the rerank weights, biases and user vector (block:
# the window's rows too) to bf16, a relative step of 2^-8 each: a logit
# moves by up to ~2^-7 of sum_e |w_e u_e| + |b|, ~0.1 at these scales; a
# path's layer logit by ~0.005, so a few paths near the beam's edge swap
BF16_TOL = {"order_gap": 0.1, "list_miss": 0.05, "path_miss": 0.05, "bad_items": 0}
# the exact route computes in f32 in another association order (the
# sequence part of a layer apart from the prefix part): ~1e-6 of a logit
EXACT_TOL = {"order_gap": 1e-4, "list_miss": 0.0, "path_miss": 0.0, "bad_items": 0}


def _weights(seed: int = 7) -> tuple[dict, dict]:
    rng = np.random.default_rng(seed)

    def f(std, *shape):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    layer = {"embedding": f(STD["embedding"], N + K * (D - 1), E),
             "heads": [{"weight": f(STD["head"], K, (L + d) * E), "bias": f(STD["bias"], K)}
                       for d in range(D)]}
    rerank = {"embedding": f(STD["embedding"], N, E),
              "linear": {"weight": f(STD["linear"], E, L * E), "bias": f(STD["bias"], E)},
              "softmax_w": f(STD["softmax_w"], N, E), "softmax_b": f(STD["bias"], N)}
    return layer, rerank


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return torch.as_tensor(tree)


def _item_paths(num_nodes: int = K) -> np.ndarray:
    """[N, J, D] node indices, uniform: the mapping both sides are given."""
    return np.random.default_rng(3).integers(0, num_nodes, (N, J, D)).astype(np.int32)


def _trainer(num_nodes: int = K) -> DRTrainer:
    data = DRData(item_to_id={}, id_to_item={}, num_items=N,
                  train_seqs=np.empty((0, L), np.int64), train_targets=np.empty(0, np.int64),
                  eval_seqs=np.empty((0, L), np.int64), eval_labels=np.empty((0, 1), np.int64),
                  eval_users=np.empty(0, np.int64), user_consumed={})
    tr = DRTrainer(data, num_layers=D, num_nodes=num_nodes, num_paths_per_item=J, embed_size=E,
                   seq_len=L, beam_size=BEAM, topk=TOPK,
                   path_index=PathIndex(_item_paths(num_nodes), num_nodes), device="cpu")
    layer, rerank = _weights()
    if num_nodes != K:
        layer["embedding"] = np.resize(layer["embedding"], (N + num_nodes * (D - 1), E))
        layer["heads"] = [{"weight": np.resize(h["weight"], (num_nodes, h["weight"].shape[1])),
                           "bias": np.resize(h["bias"], num_nodes)} for h in layer["heads"]]
    tr.load_params(layer, rerank)
    return tr


def _traffic(seed: int = 11) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] windows (a fifth left-padded with -1) and [B, L + 5] consumed
    ids: the window and five more items, -1 pads."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, N, (B, L))
    short = rng.random(B) < 0.2
    length = np.where(short, rng.integers(2, L, B), L)
    seqs = np.where(np.arange(L)[None, :] >= (L - length)[:, None], seqs, -1)
    cons = np.concatenate([seqs, rng.integers(0, N, (B, 5))], 1)
    return seqs, cons


@contextlib.contextmanager
def _route(route: str):
    """Facades built inside serve the closures' ``route``
    (``make_dr_serving_fn``'s ``rerank_table``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, "make_dr_serving_fn",
                   functools.partial(dr_serve.make_dr_serving_fn, rerank_table=route))
        yield


@pytest.fixture(scope="module")
def served():
    """The reference's parts, and per route the served lists with the beam
    the closure searched (recorded around ``dr_serve.path_beam_search``)."""
    tr = _trainer()
    seqs, cons = _traffic()
    layer, rerank = _tensors(_weights())
    pmap = ref.PathMap(torch.as_tensor(_item_paths()), K)
    st, ct = torch.as_tensor(seqs), torch.as_tensor(cons)
    answer = ref.serve(layer, rerank, pmap, st, ct, BEAM, TOPK, N)
    real, out = dr_serve.path_beam_search, {}
    for route in ("exact", "packed", "block"):
        seen = []

        def record(*a, **kw):
            paths, probs = real(*a, **kw)
            seen.append(paths)
            return paths, probs

        with _route(route), pytest.MonkeyPatch.context() as mp:
            mp.setattr(dr_serve, "path_beam_search", record)
            serv = DRServing(tr)
            ids = serv.recommend_batch_device(seqs, TOPK, cons)
        assert serv.device_serving_fn(TOPK).route == route
        out[route] = (ids, seen[-1])
    return {"trainer": tr, "seqs": seqs, "cons": cons, "layer": layer, "rerank": rerank,
            "pmap": pmap, "answer": answer, "routes": out}


def _judge(s, ids, paths, answer=None) -> dict:
    return ref.judge(s["rerank"], s["pmap"], torch.as_tensor(s["seqs"]),
                     torch.as_tensor(s["cons"]), torch.as_tensor(ids),
                     answer or s["answer"], N, served_paths=torch.as_tensor(paths))


@pytest.mark.parametrize("route, tol", [("exact", EXACT_TOL), ("packed", BF16_TOL),
                                        ("block", BF16_TOL)])
def test_each_route_is_held_to_the_reference(served, route, tol):
    ids, paths = served["routes"][route]
    assert ids.shape == (B, TOPK) and ids.dtype == np.int64
    numbers = _judge(served, ids, paths)
    assert all(numbers[k] <= v for k, v in tol.items()), numbers
    assert (ids >= 0).all()  # ~120 candidates a row: every list is full


def test_the_reference_on_fp8_operands_fails_a_tolerance(served):
    def fp8(x):
        return x.to(torch.float8_e4m3fn).float()

    s = served
    alt = ref.serve(s["layer"], s["rerank"], s["pmap"], torch.as_tensor(s["seqs"]),
                    torch.as_tensor(s["cons"]), BEAM, TOPK, N, rnd=fp8)
    numbers = _judge(s, alt["ids"].numpy(), alt["paths"].numpy())
    assert any(numbers[k] > v for k, v in BF16_TOL.items()), numbers


def test_the_host_route_equals_the_exact_device_route(served):
    serv = DRServing(served["trainer"])
    device, _ = served["routes"]["exact"]
    for i, (seq, c) in enumerate(zip(served["seqs"], served["cons"])):
        np.testing.assert_array_equal(serv.recommend(seq, TOPK, consumed=c[c >= 0]), device[i])


def test_the_device_route_builds_no_host_dict(served, monkeypatch):
    calls = []
    real = PathIndex.path_to_items
    monkeypatch.setattr(PathIndex, "path_to_items",
                        lambda self: calls.append(1) or real(self))
    serv = DRServing(served["trainer"])
    serv.recommend_batch_device(served["seqs"], TOPK, served["cons"])
    assert calls == []
    for seq in served["seqs"][:3]:
        serv.recommend(seq, TOPK)
    assert calls == [1]


def test_consumed_as_an_array_or_a_list_serves_alike_and_filters(served):
    seqs, cons = served["seqs"], served["cons"]
    with _route("block"):
        serv = DRServing(served["trainer"])
        as_array = serv.recommend_batch_device(seqs, TOPK, cons)
        as_list = serv.recommend_batch_device(seqs, TOPK, [c[c >= 0] for c in cons])
        unfiltered = serv.recommend_batch_device(seqs, TOPK)
    np.testing.assert_array_equal(as_array, as_list)
    assert not (as_array[:, :, None] == cons[:, None, :]).any()
    assert (unfiltered[:, :, None] == cons[:, None, :]).any()


def test_the_host_fallback_returns_the_same_shape():
    """K^D past the dense path table (300^3 > 2^24): the rows go through
    the host route, padded to [B, topk]."""
    tr = _trainer(num_nodes=300)
    serv = DRServing(tr)
    seqs, cons = _traffic()
    assert serv.device_serving_fn(TOPK) is None
    ids = serv.recommend_batch_device(seqs[:4], TOPK, cons[:4])
    assert ids.shape == (4, TOPK)
    for i in range(4):
        want = serv.recommend(seqs[i], TOPK, consumed=cons[i][cons[i] >= 0])
        np.testing.assert_array_equal(ids[i][: len(want)], want)
        assert (ids[i][len(want):] == -1).all()


def test_spans_are_off_by_default_and_named_when_on(served):
    profiling.reset()
    assert not profiling.enabled()
    seqs, cons = served["seqs"], served["cons"]
    DRServing(served["trainer"]).recommend_batch_device(seqs, TOPK, cons)
    assert profiling.snapshot()["spans"] == {}
    was = profiling.enable(True)
    try:
        serv = DRServing(served["trainer"])
        for _ in range(3):
            serv.recommend_batch_device(seqs, TOPK, cons)
        snap = profiling.snapshot()
    finally:
        profiling.enable(was)
        profiling.reset()
    assert {"dr_serving.recommend_batch", "dr_serving.upload", "path_beam.search",
            "dr_serve.rerank", "dr_serving.download"} <= set(snap["spans"])
    assert snap["spans"]["path_beam.search"]["calls"] == 3
    c = snap["counters"]
    assert c["dr_serving.batches"] == 3
    assert c["dr_serve.truncated_paths"] == 0 and c["dr_serving.short_lists"] == 0
