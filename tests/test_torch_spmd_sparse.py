"""The port's sharded sparse steps (``train/spmd_sparse.py``) on four gloo
ranks spawned once for the file: the TDM mv step and the OTM sparse batch
against the port's single-device mv route at a (1, 4) mesh (bit for bit)
and against the JAX package's sharded steps at (2, 2) on the same draws
(loss rtol 1e-5, params rtol 2e-4 + atol 2e-6: the data shards' gradients
sum in another order), and ``OTMTrainer(mesh=)`` end to end."""

import copy

import numpy as np
import pytest
import torch

from dismember_tpu_torch.core import mesh as meshlib, multihost
from dismember_tpu_torch.core.checkpoint import flatten
from dismember_tpu_torch.data.otm_dataset import OTMData
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu_torch.train import multiproc, spmd_sparse
from dismember_tpu_torch.train.otm import OTMTrainer
from dismember_tpu_torch.train.tdm import TDMTrainer

NEG6 = "0,1,2,3,4,5"
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
STEPS, B, E = 3, 8, 16
OTM_KW = dict(embed_size=16, beam_size=4, total_train_batch_size=512, seq_len=8, seed=11,
              device="cpu")


def _otm_data(n_items=24, leaf_level=5, L=8, n_rows=64, seed=2) -> OTMData:
    """tests/test_spmd_otm_sparse.py's data."""
    rng = np.random.default_rng(seed)
    leaf_lo = (1 << leaf_level) - 1
    item_to_code = {i + 1: leaf_lo + i for i in range(n_items)}
    all_nodes = np.zeros((1 << (leaf_level + 1)) - 1, bool)
    for c in item_to_code.values():
        while c >= 0:
            all_nodes[c] = True
            c = (c - 1) >> 1
    codes = np.asarray(list(item_to_code.values()))
    seqs = codes[rng.integers(0, n_items, size=(n_rows, L))]
    seqs[rng.random(size=seqs.shape) < 0.2] = -1
    labels = codes[rng.integers(0, n_items, size=(n_rows, 2))]
    return OTMData(item_to_code=item_to_code, code_to_item={v: k for k, v in item_to_code.items()},
                   leaf_level=leaf_level, num_items=n_items, all_nodes=all_nodes,
                   train_seqs=seqs.astype(np.int64), train_labels=labels.astype(np.int64),
                   train_users=np.zeros(n_rows, np.int64), eval_seqs=seqs[:4].astype(np.int64),
                   eval_labels=labels[:4].astype(np.int64), eval_users=np.zeros(4, np.int64),
                   user_consumed={}, label_num=2)


def _unflatten(inp, prefix):
    return multiproc._unflatten({k[len(prefix):]: v for k, v in inp.items()
                                 if k.startswith(prefix)})


def _tdm(tree, mesh=None):
    unit = 1 + 2 + 3 + 4 + 5 + 1  # positives and NEG6 negatives from level 1
    return TDMTrainer(tree=tree, layer_neg_counts=NEG6, embed_size=E, learning_rate=1e-3,
                      total_batch_size=B * unit, sparse_embed_update=True, sparse_format="mv",
                      mesh=mesh, device="cpu")


def _tdm_run(tr, inp, draws, rows):
    losses = [float(tr.step_from_samples(rows(inp[f"seq_{i}"]), rows(inp[f"{draws}codes_{i}"]),
                                         rows(inp[f"{draws}labels_{i}"]),
                                         rows(inp[f"{draws}weights_{i}"])))
              for i in range(STEPS)]
    return {"losses": losses, "params": copy.deepcopy(multihost.gather_to_host(tr.params)),
            "held": _held(tr)}


def _held(tr):
    """What a mesh trainer keeps of its table between boundaries: the
    model's embedding rows, and the bytes of its table rows with their
    moments or m|v state, beside the whole table's bytes a copy."""
    if tr.mesh is None:
        return None
    ts = [tr.model.embedding, tr._shard,
          *(v for k, v in (tr.emb_state or {}).items() if k != "count")]
    ts += [st["embedding"] for st in (tr.adam["mu"], tr.adam["nu"]) if "embedding" in st]
    return {"model_rows": tr.model.embedding.shape[0],
            "bytes": sum(t.numel() * t.element_size() for t in ts),
            "whole": tr._table_rows * tr.embed_size * 4,
            "n_model": meshlib.axis_size(tr.mesh, meshlib.MODEL_AXIS)}


def _otm_run(tr, data, batches=3):
    """Level losses of ``batches`` batches, the params after the first and
    after the last."""
    seqs, targets = (torch.as_tensor(a) for a in (data.train_seqs, data.train_labels))
    losses, first = [], None
    for _ in range(batches):
        losses.append(tr._batch_fn(seqs, targets).cpu().numpy())
        tr._sync_mirrors()
        first = first or copy.deepcopy(multihost.gather_to_host(tr.params))
    return {"losses": np.stack(losses),
            "params": copy.deepcopy(multihost.gather_to_host(tr.params)), "params1": first,
            "held": _held(tr)}


def _ranks(dev, inp_path):
    inp = dict(np.load(inp_path))
    meshes = {s: meshlib.make_mesh(*s, device="cpu") for s in [(1, 4), (2, 2)]}
    rank = torch.distributed.get_rank()
    out = {}
    tiny = ArrayTree.from_file(str(inp["tiny_tree"]))
    params = _unflatten(inp, "param:")
    for shape, draws in [((1, 4), "a_"), ((2, 2), "b_")]:
        tr = _tdm(tiny, meshes[shape])
        tr.load_numpy(params)
        out[f"tdm{shape}"] = _tdm_run(
            tr, inp, draws, lambda a: multihost.device_batch(meshes[shape], np.asarray(a)))  # noqa: B023
        out[f"tdm{shape}"]["moments"] = spmd_sparse.state_moments(
            tr.emb_state, 64, E, shape[1], mesh=meshes[shape])
    data = _otm_data()
    otm_params = _unflatten(inp, "otm:")
    for shape, mode in [((1, 4), "pseudo"), ((2, 2), "pseudo"), ((2, 2), "normal")]:
        tr = OTMTrainer(data, mesh=meshes[shape], sparse_embed_update=True, target_mode=mode,
                        **OTM_KW)
        tr.load_numpy(otm_params)
        out[f"otm{shape}{mode}"] = _otm_run(tr, data)
    dense = OTMTrainer(data, mesh=meshes[(2, 2)], sparse_embed_update=False,
                       **dict(OTM_KW, embed_size=8))
    dense.load_numpy(_unflatten(inp, "otm8:"))
    out["otm_dense"] = dict(_otm_run(dense, data, batches=1), sparse=dense._sparse)
    if rank == 0:  # the single-device routes, in a process like the ranks'
        tr = _tdm(tiny)
        tr.load_numpy(dict(params, embedding=params["embedding"][:63]))
        out["tdm_ref"] = _tdm_run(tr, inp, "a_", lambda a: torch.as_tensor(np.asarray(a)))
        for mode in ("pseudo", "normal"):
            ref = OTMTrainer(data, sparse_embed_update=True, sparse_format="mv",
                             target_mode=mode, **OTM_KW)
            rows = data.num_tree_nodes
            ref.load_numpy(dict(otm_params, embedding=otm_params["embedding"][:rows]))
            out[f"otm_ref{mode}"] = _otm_run(ref, data)
    out["refused"] = {}
    for name, kw in [("f64", dict(precision="f64")), ("pmv", dict(sparse_format="pmv"))]:
        try:
            OTMTrainer(data, mesh=meshes[(2, 2)], **kw, **OTM_KW)
        except ValueError as e:
            out["refused"][name] = str(e)
    # OTMTrainer(mesh=) end to end: one epoch, evaluate, recommend
    end = _otm_data(n_rows=70)
    tr = OTMTrainer(end, embed_size=16, beam_size=4, total_train_batch_size=64, seq_len=8,
                    sparse_embed_update=True, mesh=meshes[(2, 2)], seed=5, device="cpu")
    logs = tr.train(num_epochs=1)
    out["end"] = {"batch": tr.train_batch_size, "losses": logs[0]["level_losses"],
                  "recall": logs[0]["recall"],
                  "recs": [r.tolist() for r in tr.recommend_batch(end.eval_seqs[:2], topk=3)],
                  "params": copy.deepcopy(multihost.gather_to_host(tr.params)),
                  "held": _held(tr)}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax

    from dismember_tpu.core import mesh as jmesh
    from dismember_tpu.data.otm_dataset import OTMData as JOTMData
    from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
    from dismember_tpu.models import din as jdin
    from dismember_tpu.train import spmd_sparse as jspmd_sparse
    from dismember_tpu.train.otm import OTMTrainer as JOTMTrainer
    from dismember_tpu.train.sampler import TreeSampler as JTreeSampler

    tmp = tmp_path_factory.mktemp("torch_spmd_sparse")
    ids = np.arange(1, 33)
    sorted_ids, codes = category_sorted_codes(ids, np.zeros(32, np.int64))
    write_tree(str(tmp / "tiny.bin"), sorted_ids, codes)
    jtree = JArrayTree.from_file(str(tmp / "tiny.bin"))
    sampler = JTreeSampler.build(jtree, NEG6, start_level=1)
    params = jdin.init_params(jax.random.PRNGKey(3), 64, E)
    inp = {"tiny_tree": str(tmp / "tiny.bin")}
    inp.update({f"param:{k}": np.array(v) for k, v in flatten(params).items()})
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    optimizer = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    step, jp, jo = jspmd_sparse.make_sharded_sparse_train_step(
        "din", sampler, optimizer, mesh, jax.tree.map(jnp.array, params), 1e-3)
    sample = jax.jit(sampler.sample)
    rng = np.random.default_rng(0)
    jlosses = []
    for i in range(STEPS):
        tc = jnp.asarray(rng.choice(jtree.item_codes, B).astype(np.int32))
        sc = jnp.asarray(jtree.ids_to_codes(rng.integers(1, 33, size=(B, 10))))
        key = jax.random.PRNGKey(20 + i)
        inp[f"seq_{i}"] = np.asarray(sc, np.int64)
        # (1, N): data index 0 draws the whole batch; (2, 2): each half
        # draws with the key folded with its data index
        for name, parts in [("a_", [(0, slice(0, B))]),
                            ("b_", [(0, slice(0, B // 2)), (1, slice(B // 2, B))])]:
            drawn = [sample(jax.random.fold_in(key, d), tc[sl]) for d, sl in parts]
            for j, field in enumerate(("codes", "labels", "weights")):
                inp[f"{name}{field}_{i}"] = np.concatenate([np.asarray(x[j]) for x in drawn])
        jp, jo, loss = step(jp, jo, key, tc, sc)
        jlosses.append(float(loss))
    jm = jspmd_sparse.state_moments(jo[1], 64, E, 2)
    # OTM: the JAX package's sharded sparse batch at (2, 2), pseudo and normal
    data = _otm_data()
    jdata = JOTMData(**{f: getattr(data, f) for f in data.__dataclass_fields__})
    jotm = {}
    for mode in ("pseudo", "normal"):
        sh = JOTMTrainer(jdata, mesh=mesh, sparse_embed_update=True, target_mode=mode,
                         **{k: v for k, v in OTM_KW.items() if k != "device"})
        if mode == "pseudo":
            inp.update({f"otm:{k}": np.array(v) for k, v in flatten(sh.params).items()})
        losses = []
        for b in range(3):
            sh.params, sh.opt_state, lo = sh._train_batch(
                sh.params, sh.opt_state, jnp.asarray(data.train_seqs, jnp.int32),
                jnp.asarray(data.train_labels, jnp.int32))
            losses.append(np.asarray(lo))
            if b == 0:
                first = jax.tree.map(np.array, sh.params)
        jotm[mode] = (np.stack(losses), first)
    dense = JOTMTrainer(jdata, mesh=mesh, sparse_embed_update=False,
                        **{k: v for k, v in dict(OTM_KW, embed_size=8).items() if k != "device"})
    inp.update({f"otm8:{k}": np.array(v) for k, v in flatten(dense.params).items()})
    dense.params, dense.opt_state, lo = dense._train_batch(
        dense.params, dense.opt_state, jnp.asarray(data.train_seqs, jnp.int32),
        jnp.asarray(data.train_labels, jnp.int32))
    jotm["dense"] = (np.asarray(lo)[None], jax.tree.map(np.array, dense.params))
    np.savez(tmp / "inputs.npz", **inp)
    ranks = multiproc.spawn(_ranks, 4, (str(tmp / "inputs.npz"),), device="cpu", timeout=120)
    return {"jax_tdm": (jlosses, jax.tree.map(np.asarray, jp), jm), "jax_otm": jotm,
            "ranks": ranks}


def _assert_tree(got, want, exact=False, rows=None):
    for k, v in flatten(want).items():
        g = np.asarray(flatten(got)[k])
        v = np.asarray(v)
        if k == "embedding" and rows is not None:
            g, v = g[:rows], v[:rows]
        if exact:
            assert np.array_equal(g, v), k
        else:
            np.testing.assert_allclose(g, v, rtol=P_RTOL, atol=P_ATOL, err_msg=k)


def test_sparse_step_at_1x4_is_the_single_device_mv_step(run):
    ref = run["ranks"][0]["tdm_ref"]
    for r in run["ranks"]:
        got = r["tdm(1, 4)"]
        assert got["losses"] == ref["losses"]
        _assert_tree(got["params"], ref["params"], exact=True, rows=63)


def test_sparse_step_matches_jax_sharded_step_at_2x2(run):
    jlosses, jparams, (jm, jv) = run["jax_tdm"]
    for r in run["ranks"]:
        got = r["tdm(2, 2)"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
        _assert_tree(got["params"], jparams)
        m, v = got["moments"]
        np.testing.assert_allclose(m, jm, rtol=P_RTOL, atol=P_ATOL)
        np.testing.assert_allclose(v, jv, rtol=P_RTOL, atol=1e-9)
        _assert_tree(got["params"], run["ranks"][0]["tdm(2, 2)"]["params"], exact=True)


def test_sharded_otm_sparse_model_only(run):
    """(1, 4): the unsharded batch is the single-device mv batch, bit for
    bit: level losses, table and tower."""
    ref = run["ranks"][0]["otm_refpseudo"]
    rows = _otm_data().num_tree_nodes
    for r in run["ranks"]:
        got = r["otm(1, 4)pseudo"]
        np.testing.assert_array_equal(got["losses"], ref["losses"])
        _assert_tree(got["params"], ref["params"], exact=True, rows=rows)


@pytest.mark.parametrize("mode", ["pseudo", "normal"])
def test_sharded_otm_sparse_mixed_mesh(run, mode):
    """(2, 2): three batches' level losses against the JAX package's
    sharded sparse batch and the port's single-device batch, the params
    after the first batch against JAX's (later batches let Adam amplify
    the packages' rounding on near-zero gradients, as a single batch of
    tests/test_torch_otm.py bounds it) and after the third against the
    port's single-device batch."""
    jlosses, jparams1 = run["jax_otm"][mode]
    ref = run["ranks"][0][f"otm_ref{mode}"]
    rows = _otm_data().num_tree_nodes
    for r in run["ranks"]:
        got = r[f"otm(2, 2){mode}"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
        _assert_tree(got["params1"], jparams1)
        _assert_tree(got["params"], ref["params"], rows=rows)


def test_dense_mesh_otm_batch_matches_jax(run):
    jlosses, jparams = run["jax_otm"]["dense"]
    for r in run["ranks"]:
        got = r["otm_dense"]
        assert not got["sparse"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
        _assert_tree(got["params1"], jparams)


def test_otm_trainer_with_mesh_end_to_end(run):
    ends = [r["end"] for r in run["ranks"]]
    assert ends[0]["batch"] % 2 == 0
    assert all(np.isfinite(x) for x in ends[0]["losses"])
    assert all(len(x) == 3 for x in ends[0]["recs"])
    for e in ends[1:]:  # every rank trains, evaluates and serves alike
        assert e["losses"] == ends[0]["losses"] and e["recs"] == ends[0]["recs"]
        _assert_tree(e["params"], ends[0]["params"], exact=True)


@pytest.mark.parametrize("key", ["tdm(1, 4)", "tdm(2, 2)", "otm(1, 4)pseudo", "otm(2, 2)normal",
                                 "otm_dense", "end"])
def test_mesh_trainer_keeps_only_its_table_rows(run, key):
    """Between boundaries (after steps, batches, or train, evaluate and
    recommend) a mesh trainer's model holds no table rows, and what it
    keeps of the table is its V / n_model rows with their m|v state or
    Adam moments: 3 V E / n_model floats, plus the m|v slice's scratch
    row."""
    for r in run["ranks"]:
        held = r[key]["held"]
        assert held["model_rows"] == 0
        assert 3 * held["whole"] // held["n_model"] <= held["bytes"]
        assert held["bytes"] <= 3 * held["whole"] // held["n_model"] + 128 * 4


def test_a_mesh_refuses_f64_and_pmv(run):
    """The JAX package's rules (train/otm.py:165-166, 219-221)."""
    for r in run["ranks"]:
        assert "f32-only" in r["refused"]["f64"]
        assert "pmv is single-device" in r["refused"]["pmv"]
