"""The port's row-sharded Deep Retrieval (``train/spmd_dr.py``) on four gloo
ranks spawned once for the file: the pmv E-step at a (1, 4) mesh against
the port's single-device pmv E-step (bit for bit), at (2, 2) against the
JAX package's ``make_sharded_dr_steps`` fed the same folded-key negatives
(loss rtol 1e-5, params rtol 2e-4 + atol 2e-6), ``DRTrainer(mesh=)`` end
to end, and the sharded block serving against the unsharded block route."""

import copy

import numpy as np
import pytest
import torch

from dismember_tpu_torch.core import mesh as meshlib, multihost
from dismember_tpu_torch.core.checkpoint import flatten
from dismember_tpu_torch.data.dr_dataset import DRData
from dismember_tpu_torch.retrieval.dr_serve import make_dr_serving_fn
from dismember_tpu_torch.train import multiproc, sparse_adam, spmd_dr
from dismember_tpu_torch.train.dr import DRTrainer

LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
STEPS, SEED = 2, 5
KW = dict(multiproc.DR_KW, device="cpu")


def _data() -> DRData:
    data, evals = multiproc.dr_inputs(SEED)
    rng = np.random.default_rng(SEED + 9)
    data.eval_seqs = evals
    data.eval_labels = rng.integers(0, data.num_items, size=(len(evals), 2)).astype(np.int64)
    data.eval_users = np.arange(len(evals), dtype=np.int64)
    data.user_consumed = {0: np.asarray([1, 2], np.int64)}
    return data


def _params(inp):
    flat = {k: v for k, v in inp.items() if k.startswith(("layer:", "rerank:"))}
    tree = multiproc._unflatten({k.replace(":", "/", 1): v for k, v in flat.items()})
    heads = tree["layer"]["heads"]
    tree["layer"]["heads"] = [heads[str(d)] for d in range(len(heads))]
    return tree["layer"], tree["rerank"]


def _estep(tr, data, inp, negs_key, rows):
    """STEPS E-steps on the whole train set; returns the losses and the
    synced params."""
    seqs = rows(data.train_seqs)
    paths = rows(tr.path_index.item_paths[data.train_targets])
    labels = rows(data.train_targets)
    losses = []
    for i in range(STEPS):
        ll = tr._layer_step(seqs, paths)
        rl = tr._rerank_step(seqs, labels, rows(inp[f"{negs_key}{i}"]))
        losses.append((ll.cpu().numpy(), float(rl)))
    with tr.whole_table():
        params = copy.deepcopy(multihost.gather_to_host({"layer": tr.layer_params,
                                                         "rerank": tr.rerank_params}))
    return {"losses": losses, "params": params}


def _held(tr):
    """What a mesh DR trainer keeps of its item-scaled tables between
    boundaries: the rows of its four params and the bytes of its three
    packed slices, with the bytes a (V / n_model)-row slice of each table
    needs."""
    n_model = meshlib.axis_size(tr.mesh, meshlib.MODEL_AXIS)
    tables = [tr.layer_opt_state[1], *tr.rerank_opt_state[1:]]
    need = sum((spmd_dr.pmv_sharded_rows(t.v_rows, t.e, n_model) // n_model
                // sparse_adam.pmv_slots(t.e) + 1) * 128 * 4 for t in tables)
    return {"param_rows": [tr.layer_params["embedding"].shape[0]]
            + [tr.rerank_params[k].shape[0] for k in ("embedding", "softmax_w", "softmax_b")],
            "bytes": sum(t.state["pmv"].numel() * 4 for t in tables), "need": need}


def _ranks(dev, inp_path):
    inp = dict(np.load(inp_path))
    meshes = {s: meshlib.make_mesh(*s, device="cpu") for s in [(1, 4), (2, 2)]}
    rank = torch.distributed.get_rank()
    data = _data()
    layer, rerank = _params(inp)
    out = {}
    for shape, negs in [((1, 4), "a_negs_"), ((2, 2), "b_negs_")]:
        mesh = meshes[shape]
        tr = DRTrainer(data, seed=SEED, mesh=mesh, **KW)
        tr.load_params(layer, rerank)
        out[f"estep{shape}"] = _estep(
            tr, data, inp, negs, lambda a: multihost.device_batch(mesh, np.asarray(a)))  # noqa: B023
        out[f"estep{shape}"]["pmv_rows"] = [t.state["pmv"].shape[0] for t in
                                            (tr.layer_opt_state[1], *tr.rerank_opt_state[1:])]
        out[f"held{shape}"] = _held(tr)
        with tr.whole_table():
            serve = spmd_dr.make_sharded_dr_serving_fn(tr, mesh, topk=5)
            ids, scores = serve(tr.layer_params, tr.rerank_params,
                                *multihost.device_batch(mesh, data.eval_seqs,
                                                        np.full((16, 1), -1, np.int64)))
            if rank == 0:  # the unsharded block route on the same weights
                ref = make_dr_serving_fn(tr, topk=5, rerank_table="block")
                rids, rscores = ref(tr.layer_params, tr.rerank_params,
                                    torch.as_tensor(data.eval_seqs), torch.full((16, 1), -1))
                out[f"serve_ref{shape}"] = {"ids": rids.numpy(), "scores": rscores.numpy()}
        out[f"serve{shape}"] = multihost.gather_to_host({"ids": ids, "scores": scores}, mesh,
                                                        meshlib.DATA_AXIS)
    if rank == 0:  # the single-device pmv E-step, in a process like the ranks'
        tr = DRTrainer(data, seed=SEED, sparse_embed_update=True, **KW)
        assert tr._pmv
        tr.load_params(layer, rerank)
        tr._adopt_mirrors()
        out["estep_ref"] = _estep(tr, data, inp, "a_negs_", torch.as_tensor)
    # DRTrainer(mesh=) end to end: train (sharded E-steps) and evaluate
    # (sharded block serving)
    tr = DRTrainer(data, seed=SEED, mesh=meshes[(2, 2)], train_batch_size=40,
                   eval_batch_size=14, **KW)
    results = tr.train(num_epochs=2)
    out["end"] = {"batch": tr.num_targets_per_batch, "eval_batch": tr.eval_targets_per_batch,
                  "results": [(r.layer_loss, r.rerank_loss, r.precision, r.recall, r.ndcg)
                              for r in results],
                  "log": tr.train_loss_log, "held": _held(tr)}
    try:
        DRTrainer(data, seed=SEED, mesh=meshes[(2, 2)], **dict(KW, embed_size=48))
    except ValueError as e:
        out["refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from dismember_tpu.core import mesh as jmesh
    from dismember_tpu.data.dr_dataset import DRData as JDRData
    from dismember_tpu.models import dr_models as jdr_models
    from dismember_tpu.train.dr import DRTrainer as JDRTrainer

    tmp = tmp_path_factory.mktemp("torch_spmd_dr")
    data = _data()
    jdata = JDRData(**{f: getattr(data, f) for f in data.__dataclass_fields__})
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    jkw = {k: v for k, v in KW.items() if k != "device"}
    sh = JDRTrainer(jdata, seed=SEED, mesh=mesh, **jkw)
    inp = {f"layer:{k}": np.array(v) for k, v in flatten(sh.layer_params).items()}
    inp.update({f"rerank:{k}": np.array(v) for k, v in flatten(sh.rerank_params).items()})
    seqs = jnp.asarray(data.train_seqs, jnp.int32)
    paths = jnp.asarray(sh.path_index.item_paths[data.train_targets], jnp.int32)
    labels = jnp.asarray(data.train_targets, jnp.int32)
    half = len(data.train_targets) // 2
    jlosses = []
    for i in range(STEPS):
        key = jax.random.PRNGKey(30 + i)
        # the negatives of each data shard: the key folded with its index
        draw = lambda d, lab: np.asarray(jdr_models.sample_negatives(  # noqa: E731
            jax.random.fold_in(key, d), lab, data.num_items, KW["num_sampled"]), np.int64)
        inp[f"a_negs_{i}"] = draw(0, labels)
        inp[f"b_negs_{i}"] = np.concatenate([draw(0, labels[:half]), draw(1, labels[half:])])
        sh.layer_params, sh.layer_opt_state, ll = sh._layer_step(
            sh.layer_params, sh.layer_opt_state, seqs, paths)
        sh.rerank_params, sh.rerank_opt_state, rl = sh._rerank_step(
            sh.rerank_params, sh.rerank_opt_state, key, seqs, labels)
        jlosses.append((np.asarray(ll), float(rl)))
    sh._sync_mirrors()
    jparams = jax.tree.map(np.asarray, {"layer": sh.layer_params, "rerank": sh.rerank_params})
    np.savez(tmp / "inputs.npz", **inp)
    ranks = multiproc.spawn(_ranks, 4, (str(tmp / "inputs.npz"),), device="cpu", timeout=120)
    return {"jax": (jlosses, jparams), "ranks": ranks}


def _assert_tree(got, want, exact=False):
    got = flatten(got)
    for k, v in flatten(want).items():
        if exact:
            assert np.array_equal(got[k], v), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=P_RTOL, atol=P_ATOL, err_msg=k)


def test_estep_at_1x4_is_the_single_device_pmv_estep(run):
    ref = run["ranks"][0]["estep_ref"]
    for r in run["ranks"]:
        got = r["estep(1, 4)"]
        for (gl, gr), (rl, rr) in zip(got["losses"], ref["losses"]):
            np.testing.assert_array_equal(gl, rl)
            assert gr == rr
        _assert_tree(got["params"], ref["params"], exact=True)


def test_estep_matches_jax_sharded_steps_at_2x2(run):
    jlosses, jparams = run["jax"]
    for r in run["ranks"]:
        got = r["estep(2, 2)"]
        for (gl, gr), (jl, jr) in zip(got["losses"], jlosses):
            np.testing.assert_allclose(gl, jl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(gr, jr, rtol=LOSS_RTOL)
        _assert_tree(got["params"], jparams)
        _assert_tree(got["params"], run["ranks"][0]["estep(2, 2)"]["params"], exact=True)
    # each rank holds its quarter or half of each packed table, never the stack
    rows = [r["estep(1, 4)"]["pmv_rows"] for r in run["ranks"]]
    assert all(x == rows[0] for x in rows)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_dr_serving_equals_unsharded(run, shape):
    ref = run["ranks"][0][f"serve_ref{shape}"]
    for r in run["ranks"]:
        got = r[f"serve{shape}"]
        np.testing.assert_array_equal(got["ids"], ref["ids"])
        np.testing.assert_array_equal(got["scores"], ref["scores"])


def test_dr_trainer_with_mesh_end_to_end(run):
    ends = [r["end"] for r in run["ranks"]]
    assert ends[0]["batch"] % 2 == 0 and ends[0]["eval_batch"] % 2 == 0
    res = ends[0]["results"]
    assert len(res) == 2 and all(np.isfinite(x).all() for x in res[-1][:2])
    assert 0.0 <= res[-1][3] <= 1.0
    for e in ends[1:]:  # every rank trains and evaluates alike
        assert e["results"] == ends[0]["results"] and e["log"] == ends[0]["log"]
    assert "p|m|v-packable" in run["ranks"][0]["refused"]


@pytest.mark.parametrize("when", ["after E-steps at (1, 4)", "after E-steps at (2, 2)",
                                  "after train and evaluate at (2, 2)"])
def test_mesh_dr_trainer_keeps_only_its_slices(run, when):
    """Between boundaries a mesh DR trainer's four item-scaled params are
    empty and its packed tables are slices of V / n_model rows (padded to
    whole slots, one scratch row each)."""
    key = {"after E-steps at (1, 4)": "held(1, 4)",
           "after E-steps at (2, 2)": "held(2, 2)"}.get(when)
    for r in run["ranks"]:
        held = r[key] if key else r["end"]["held"]
        assert held["param_rows"] == [0, 0, 0, 0]
        assert held["bytes"] == held["need"]


def test_load_params_copies_the_callers_arrays():
    """A CPU trainer's steps update its tensors in place; they must not
    write through to the arrays ``load_params`` was given (the mesh tests
    above load one set of weights into several trainers)."""
    data = _data()
    tr = DRTrainer(data, seed=SEED, sparse_embed_update=False, **KW)
    layer = multihost.gather_to_host(tr.layer_params)
    rerank = multihost.gather_to_host(tr.rerank_params)
    before = copy.deepcopy((layer, rerank))
    tr.load_params(layer, rerank)
    tr.train(num_epochs=1)
    _assert_tree({"l": layer, "r": rerank}, {"l": before[0], "r": before[1]}, exact=True)
