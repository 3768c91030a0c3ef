"""The port's dense mesh step, sharded beams, mesh trainer and mesh tree
sweeps (``train/spmd.py``) on four gloo ranks spawned once for the file,
against the JAX package's sharded step at the same mesh shape (on the
conftest's virtual devices) and against the port's single-device step.

Tolerances: the (1, 4) mesh leaves the batch unsharded, so it must equal
the single-device step bit for bit; a mixed (2, 2) mesh sums the data
shards' gradients in another order: loss rtol 1e-5, params rtol 2e-4 +
atol 2e-6 (tests/test_tdm_train.py's dense-vs-sparse tolerances).  Beams
equal in ids, scores within 1e-6; sweeps equal in projection, weights
within rtol 1e-6 / atol 1e-7 (tests/test_jtm_mesh.py's)."""

import copy
import os

import numpy as np
import pytest
import torch

from dismember_tpu_torch.core import mesh as meshlib, multihost
from dismember_tpu_torch.core.checkpoint import flatten
from dismember_tpu_torch.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu_torch.data.tdm_dataset import generate_split_samples
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu_torch.models.din import DIN
from dismember_tpu_torch.retrieval.packed_beam import make_packed_beam_fn, make_packed_tree
from dismember_tpu_torch.retrieval.tree_beam import make_beam_fn
from dismember_tpu_torch.train import multiproc, spmd
from dismember_tpu_torch.train.jtm import TreeLearner, otm_tree_learner
from dismember_tpu_torch.train.tdm import TDMTrainer

NEG6 = "0,1,2,3,4,5"
PIPE_NEG = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
STEPS, B = 3, 8
SHAPES = [(2, 2), (1, 4), (4, 1)]


def _write_tree(path, n_items, cats):
    ids = np.arange(1, n_items + 1)
    sorted_ids, codes = category_sorted_codes(ids, cats(ids))
    write_tree(path, sorted_ids, codes)
    return path


def _pipeline(csv: str, tmp: str):
    raw = read_csv(csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    path = os.path.join(tmp, "pipe.bin")
    if not os.path.exists(path):
        write_tree(path, sorted_ids, codes, stat=samples.stat)
    return ArrayTree.from_file(path), samples, ids, cats


def _unflatten(flat):
    return multiproc._unflatten({k.split(":", 1)[1]: v for k, v in flat.items()})


def _trainer(tree, mesh=None, **kw):
    unit = 1 + 2 + 3 + 4 + 5 + 1  # positives and NEG6 negatives from level 1
    kw = dict(dict(layer_neg_counts=NEG6, embed_size=16, learning_rate=1e-3,
                   total_batch_size=B * unit, sparse_embed_update=False, device="cpu"), **kw)
    return TDMTrainer(tree=tree, mesh=mesh, **kw)


def _sweep_learners(model, tree, samples, mesh, n_items=120):
    ids = np.asarray(tree.item_ids)
    keep = np.isin(samples.train_targets, ids[:n_items])
    seqs, targets = samples.train_seqs[keep], samples.train_targets[keep]
    jtm = TreeLearner(tree, model, seqs, targets, gap=2, score_batch_rows=61, device="cpu",
                      mesh=mesh, hierarchical=True, min_level=2)
    item_to_code = {int(i): int(c) for i, c in zip(ids, tree.item_codes)}
    otm = otm_tree_learner(model, item_to_code, tree.ids_to_codes(seqs[:200]),
                           tree.ids_to_codes(targets[:200][:, None]), gap=2, score_batch_rows=37,
                           device="cpu", mesh=mesh)
    return jtm, otm


def _single_device_dense(tiny, params, inp):
    tr = _trainer(tiny)
    params = dict(params, embedding=params["embedding"][:63])
    tr.load_numpy(params)
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    losses = [float(tr.step_from_samples(t(inp[f"seq_{i}"]), t(inp[f"codes_{i}"]),
                                         t(inp[f"labels_{i}"]), t(inp[f"weights_{i}"])))
              for i in range(STEPS)]
    return {"losses": losses, "params": tr.model.params_numpy()}


def _held(tr):
    """What a trainer keeps of its table between boundaries: the model's
    embedding rows, and the bytes of its table rows with their moments or
    m|v state, beside the whole table's bytes a copy."""
    ts = [tr.model.embedding, tr._shard, *(v for k, v in (tr.emb_state or {}).items()
                                            if k != "count")]
    ts += [st["embedding"] for st in (tr.adam["mu"], tr.adam["nu"]) if "embedding" in st]
    return {"model_rows": tr.model.embedding.shape[0],
            "bytes": sum(t.numel() * t.element_size() for t in ts if t is not None),
            "whole": tr._table_rows * tr.embed_size * 4,
            "n_model": meshlib.axis_size(tr.mesh, meshlib.MODEL_AXIS)}


def _ranks(dev, inp_path):
    """Every scenario of the file on one rank; returns its results."""
    inp = dict(np.load(inp_path))
    meshes = {s: meshlib.make_mesh(*s, device="cpu") for s in SHAPES}
    out = {"coords": {s: (meshlib.axis_index(m, "data"), meshlib.axis_index(m, "model"))
                      for s, m in meshes.items()},
           "rank": torch.distributed.get_rank()}
    tiny = ArrayTree.from_file(str(inp["tiny_tree"]))
    params = _unflatten({k: v for k, v in inp.items() if k.startswith("param:")})
    # the dense step on the JAX draws
    for shape in [(2, 2), (1, 4)]:
        tr = _trainer(tiny, meshes[shape])
        tr.load_numpy(params)
        rows = lambda a: multihost.device_batch(meshes[shape], np.asarray(a))  # noqa: E731
        losses = [float(tr.step_from_samples(rows(inp[f"seq_{i}"]), rows(inp[f"codes_{i}"]),
                                             rows(inp[f"labels_{i}"]), rows(inp[f"weights_{i}"])))
                  for i in range(STEPS)]
        out[f"dense{shape}"] = {"losses": losses, "held": _held(tr),
                                "params": copy.deepcopy(multihost.gather_to_host(tr.params))}
    if out["rank"] == 0:  # the single-device step, in a process like the ranks'
        out["dense_ref"] = _single_device_dense(tiny, params, inp)
    # sharded beams
    model = DIN(64, 16, device="cpu")
    model.load_numpy(params)
    deep = ArrayTree.from_file(str(inp["deep_tree"]))
    deep_model = DIN((1 << (deep.max_level + 1)) - 1, 16, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    packed = make_packed_tree(deep, deep_model.embedding.detach(), beam=8)
    for shape in [(2, 2), (4, 1)]:
        mesh = meshes[shape]
        gather = lambda ids, sc: multihost.gather_to_host(  # noqa: E731
            {"ids": ids, "scores": sc}, mesh, meshlib.DATA_AXIS)
        classic = spmd.make_sharded_beam_fn(model, tiny, 4, mesh)
        out[f"classic{shape}"] = gather(*classic(multihost.device_batch(mesh, inp["evals"])))
        pk = spmd.make_sharded_packed_beam_fn(packed, mesh, DIN.precompute_seq)
        out[f"packed{shape}"] = gather(*pk(deep_model,
                                           multihost.device_batch(mesh, inp["deep_evals"])))
        fn, route = spmd.make_sharded_tree_serving_fn(deep_model, deep, 8, mesh)
        out[f"route{shape}"] = (route, spmd.make_sharded_tree_serving_fn(model, tiny, 4, mesh)[1])
        out[f"served{shape}"] = gather(*fn(multihost.device_batch(mesh, inp["deep_evals"])))
    # the trainer end to end on the example data
    tree, samples, _, _ = _pipeline(str(inp["csv"]), str(inp["tmp"]))
    kw = dict(layer_neg_counts=PIPE_NEG, embed_size=8, learning_rate=3e-3, total_batch_size=512,
              seed=7, topk=5, beam_size=8, device="cpu")
    ev = (samples.eval_seqs[:64], samples.eval_labels[:64], samples.eval_users[:64])
    for shape, sparse in [((1, 4), False), ((2, 2), True), (None, False)]:
        if shape is None:  # the single-device trainer from the (1, 4) run's weights
            if out["rank"]:
                break
            tr = TDMTrainer(tree=tree, sparse_embed_update=False, **kw)
            init = dict(out["trainer(1, 4)"]["init"])
            init["embedding"] = init["embedding"][: tr.model.embedding.shape[0]]
            tr.model.load_numpy(init)
        else:
            tr = TDMTrainer(tree=tree, mesh=meshes[shape], sparse_embed_update=sparse, **kw)
            init = copy.deepcopy(multihost.gather_to_host(tr.params))
        logs = tr.train(samples.train_seqs, samples.train_targets, iterations=6,
                        progress_interval=3)
        res = tr.evaluate(ev, samples.user_consumed)
        out[f"trainer{shape}"] = {
            "init": init, "params": copy.deepcopy(multihost.gather_to_host(tr.params)),
            "losses": [g["train_loss"] for g in logs],
            "eval": (res.loss, res.precision, res.recall, res.ndcg),
            "rec": np.stack(tr.recommend_batch(samples.eval_seqs[:8])), "sparse": tr._sparse,
            "mv": sorted(tr.emb_state) if tr.emb_state else None,
            "shard_rows": None if tr._shard is None else tr._shard.shape[0],
            "held": None if tr.mesh is None else _held(tr)}
    # mesh tree sweeps
    sweep_model = DIN((1 << (tree.max_level + 1)) - 1, 8, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    for shape in [(2, 2), (4, 1)]:
        jtm, otm = _sweep_learners(sweep_model, tree, samples, meshes[shape])
        proj = np.zeros(len(jtm.items), dtype=np.int64)
        out[f"sweep{shape}"] = {"weights": jtm.compute_weights(proj, 0, 2),
                                "jtm": jtm.optimize(), "otm": otm.optimize()}
    return out


@pytest.fixture(scope="module")
def run(small_csv, tmp_path_factory):
    """The JAX side in process, then one spawn of four ranks for every
    scenario."""
    import jax
    import jax.numpy as jnp
    import optax

    from dismember_tpu.core import mesh as jmesh
    from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
    from dismember_tpu.models import din as jdin
    from dismember_tpu.train.sampler import TreeSampler as JTreeSampler
    from dismember_tpu.train.spmd import make_sharded_train_step

    tmp = tmp_path_factory.mktemp("torch_spmd")
    tiny = _write_tree(str(tmp / "tiny.bin"), 32, lambda ids: np.zeros(len(ids), np.int64))
    deep = _write_tree(str(tmp / "deep.bin"), 1 << 10, lambda ids: ids % 7)
    jtree = JArrayTree.from_file(tiny)
    params = jdin.init_params(jax.random.PRNGKey(0), 64, 16)
    sampler = JTreeSampler.build(jtree, NEG6, start_level=1)
    rng = np.random.default_rng(0)
    inp = {"tiny_tree": tiny, "deep_tree": deep, "csv": small_csv, "tmp": str(tmp)}
    inp.update({f"param:{k}": np.array(v) for k, v in flatten(params).items()})
    batches = []
    for i in range(STEPS):
        tc = jnp.asarray(rng.choice(jtree.item_codes, B).astype(np.int32))
        sc = jnp.asarray(jtree.ids_to_codes(rng.integers(1, 33, size=(B, 10))))
        key = jax.random.PRNGKey(10 + i)
        codes, labels, weights = jax.jit(sampler.sample)(key, tc)
        batches.append((key, tc, sc))
        inp.update({f"seq_{i}": np.asarray(sc, np.int64), f"codes_{i}": np.asarray(codes, np.int64),
                    f"labels_{i}": np.asarray(labels), f"weights_{i}": np.asarray(weights)})
    inp["evals"] = jtree.ids_to_codes(rng.integers(1, 33, size=(B, 10))).astype(np.int64)
    deep_tree = ArrayTree.from_file(deep)
    inp["deep_evals"] = deep_tree.ids_to_codes(
        rng.integers(1, (1 << 10) + 1, size=(B, 10))).astype(np.int64)
    # the JAX package's sharded dense step at (2, 2), on the same draws
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    optimizer = optax.adam(1e-3)
    step, jp, jo = make_sharded_train_step(jdin.forward, sampler, optimizer, mesh,
                                           jax.tree.map(jnp.array, params),
                                           optimizer.init(params))
    jlosses = []
    for key, tc, sc in batches:
        jp, jo, loss = step(jp, jo, key, tc, sc)
        jlosses.append(float(loss))
    np.savez(tmp / "inputs.npz", **inp)
    pipeline = _pipeline(small_csv, str(tmp))  # writes the tree the ranks read
    ranks = multiproc.spawn(_ranks, 4, (str(tmp / "inputs.npz"),), device="cpu", timeout=120)
    return {"inp": inp, "params": params, "jax": (jlosses, jax.tree.map(np.asarray, jp)),
            "ranks": ranks, "samples": pipeline}


def _assert_tree(got, want, exact=False):
    for k, v in flatten(want).items():
        g = flatten(got)[k]
        if exact:
            assert np.array_equal(g, v), k
        else:
            np.testing.assert_allclose(g, v, rtol=P_RTOL, atol=P_ATOL, err_msg=k)


def test_rank_coordinates_follow_the_jax_reshape(run):
    for r, res in enumerate(run["ranks"]):
        assert res["rank"] == r
        for (n_data, n_model), coords in res["coords"].items():
            assert coords == (r // n_model, r % n_model)
            assert meshlib.rank_layout(n_data, n_model)[coords].item() == r


def test_dense_step_matches_jax_sharded_step_at_2x2(run):
    jlosses, jparams = run["jax"]
    got = run["ranks"][0]["dense(2, 2)"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
    _assert_tree(got["params"], jparams)
    for r in run["ranks"][1:]:  # every rank ends with the same parameters
        _assert_tree(r["dense(2, 2)"]["params"], got["params"], exact=True)


def test_dense_step_at_1x4_is_the_single_device_step(run):
    ref = run["ranks"][0]["dense_ref"]
    for r in run["ranks"]:
        got = r["dense(1, 4)"]
        assert got["losses"] == ref["losses"]
        got["params"]["embedding"] = got["params"]["embedding"][:63]
        _assert_tree(got["params"], ref["params"], exact=True)


def test_sharded_beams_match_unsharded(run):
    inp = run["inp"]
    tiny, deep = ArrayTree.from_file(inp["tiny_tree"]), ArrayTree.from_file(inp["deep_tree"])
    model = DIN(64, 16, device="cpu")
    model.load_numpy(_unflatten({k: v for k, v in inp.items() if k.startswith("param:")}))
    pre, app = DIN.precompute_seq, DIN.apply_with_ctx
    ids, scores = make_beam_fn(None, tiny, 4, precompute=pre, apply=app, device="cpu")(
        model, torch.as_tensor(inp["evals"]))
    deep_model = DIN((1 << (deep.max_level + 1)) - 1, 16, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    pk = make_packed_beam_fn(make_packed_tree(deep, deep_model.embedding.detach(), beam=8),
                             DIN.precompute_seq)
    pids, pscores = pk(deep_model, torch.as_tensor(inp["deep_evals"]))
    for r in run["ranks"]:
        for shape in [(2, 2), (4, 1)]:
            assert r[f"route{shape}"] == ("packed", "classic")
            for key, (want_ids, want_sc) in [("classic", (ids, scores)),
                                             ("packed", (pids, pscores)),
                                             ("served", (pids, pscores))]:
                got = r[f"{key}{shape}"]
                np.testing.assert_array_equal(got["ids"], want_ids.numpy(), err_msg=key)
                np.testing.assert_allclose(got["scores"], want_sc.numpy(), rtol=0, atol=1e-6)


def test_trainer_with_mesh_end_to_end(run):
    """TDMTrainer(mesh=): at (1, 4) the dense route draws the single-device
    negatives, so train, evaluate and recommend equal the single-device
    trainer's from the same weights; at (2, 2) the sharded mv route trains
    and every rank agrees."""
    got, ref = run["ranks"][0]["trainer(1, 4)"], run["ranks"][0]["trainerNone"]
    assert got["losses"] == ref["losses"]
    assert got["eval"] == ref["eval"]
    np.testing.assert_array_equal(got["rec"], ref["rec"])
    v = ref["params"]["embedding"].shape[0]
    got["params"]["embedding"] = got["params"]["embedding"][:v]
    _assert_tree(got["params"], ref["params"], exact=True)
    assert got["shard_rows"] * 4 >= v and not got["sparse"]
    mv = [r["trainer(2, 2)"] for r in run["ranks"]]
    assert mv[0]["sparse"] and mv[0]["mv"] == ["count", "mv"]
    assert mv[0]["losses"][-1] < mv[0]["losses"][0] + 0.05 and np.isfinite(mv[0]["eval"]).all()
    for other in mv[1:]:
        assert other["losses"] == mv[0]["losses"] and other["eval"] == mv[0]["eval"]
        _assert_tree(other["params"], mv[0]["params"], exact=True)


@pytest.mark.parametrize("key", ["dense(2, 2)", "dense(1, 4)", "trainer(1, 4)",
                                 "trainer(2, 2)"])
def test_mesh_trainer_keeps_only_its_table_rows(run, key):
    """Between boundaries (after steps, and after train, evaluate and
    recommend) a mesh trainer's model holds no table rows, and what it
    keeps of the table is its V / n_model rows with their Adam moments or
    m|v state: 3 V E / n_model floats, plus the m|v slice's scratch row."""
    for r in run["ranks"]:
        held = r[key]["held"]
        assert held["model_rows"] == 0
        assert 3 * held["whole"] // held["n_model"] <= held["bytes"]
        assert held["bytes"] <= 3 * held["whole"] // held["n_model"] + 128 * 4


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_mesh_sweeps_match_single_device(run, shape):
    """score_batch_rows 61 and 37 force ragged batches (61 % 2, 37 % 4 are
    not 0): the pad rows are dropped before the accumulation."""
    tree, samples, _, _ = run["samples"]
    model = DIN((1 << (tree.max_level + 1)) - 1, 8, device="cpu",
                generator=torch.Generator().manual_seed(0))
    jtm, otm = _sweep_learners(model, tree, samples, None)
    w = jtm.compute_weights(np.zeros(len(jtm.items), dtype=np.int64), 0, 2)
    jproj, oproj = jtm.optimize(), otm.optimize()
    for r in run["ranks"]:
        got = r[f"sweep{shape}"]
        np.testing.assert_allclose(got["weights"], w, rtol=1e-6, atol=1e-7)
        assert got["jtm"] == jproj
        assert got["otm"] == oproj
