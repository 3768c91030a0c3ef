"""The port's multi-process harness (``train/multiproc.py``) launched as two
separate processes (``python -m dismember_tpu_torch.train.multiproc``, a
``file://`` store) at meshes (1, 2) and (2, 1): losses, gathered params
and beam ids against the port's single-device run (bit for bit at (1, 2),
within the dense tolerances at (2, 1): loss rtol 1e-5, params rtol 2e-4 +
atol 2e-6) and against the JAX package's building blocks at the same mesh
shape on the same draws, as tests/test_multiproc.py holds the JAX harness.
The deep leg's packed beam ids equal the unsharded packed beam's."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dismember_tpu_torch.core.checkpoint import flatten
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu_torch.models.din import DIN
from dismember_tpu_torch.retrieval.packed_beam import make_packed_beam_fn, make_packed_tree
from dismember_tpu_torch.retrieval.tree_beam import make_beam_fn
from dismember_tpu_torch.train import multiproc
from dismember_tpu_torch.train.tdm import TDMTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
STEPS, B, SEED = 4, 16, 0
N_ITEMS = 32
THREADS = 2  # the workers' and the reference's: a CPU reduction's order follows it


def _launch(tmp, name, mode, n_model, inputs):
    """Two worker processes of one group; returns rank 0's results."""
    out = os.path.join(tmp, f"{name}.npz")
    args = [sys.executable, "-m", "dismember_tpu_torch.train.multiproc", "--num-processes", "2",
            "--init-method", f"file://{os.path.join(tmp, name + '.store')}", "--device", "cpu",
            "--mode", mode, "--n-model", str(n_model), "--steps", str(STEPS),
            "--global-batch", str(B), "--inputs", inputs, "--out", out]
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    procs = [subprocess.Popen(args + ["--process-id", str(i)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "multiproc worker 0/2" in logs[0]
    return dict(np.load(out))


def _tree(tmp) -> str:
    path = os.path.join(tmp, "tree.bin")
    ids = np.arange(1, N_ITEMS + 1)
    write_tree(path, *category_sorted_codes(ids, np.zeros(N_ITEMS, np.int64)))
    return path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """For each mesh: the JAX package's sharded step and beam on two
    virtual devices, their initial params and draws handed to the port's
    workers."""
    import jax
    import jax.numpy as jnp
    import optax

    from dismember_tpu.core import mesh as jmesh
    from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
    from dismember_tpu.models import din as jdin
    from dismember_tpu.train.sampler import TreeSampler as JTreeSampler
    from dismember_tpu.train.spmd import (
        make_sharded_beam_fn,
        make_sharded_train_step,
        padded_num_index,
    )

    tmp = str(tmp_path_factory.mktemp("torch_multiproc"))
    jtree = JArrayTree.from_file(_tree(tmp))
    tree = ArrayTree.from_file(os.path.join(tmp, "tree.bin"))
    batches, evals = multiproc.tdm_batches(tree, STEPS, B, N_ITEMS, SEED)
    sampler = JTreeSampler.build(jtree, multiproc.NEG_COUNTS, start_level=1)
    out = {}
    for n_model in (2, 1):
        mesh = jmesh.make_mesh(n_data=2 // n_model, n_model=n_model, devices=jax.devices()[:2])
        num_index = padded_num_index((1 << (jtree.max_level + 1)) - 1, mesh)
        params = jdin.init_params(jax.random.PRNGKey(SEED), num_index, 16)
        inp = {f"param:{k}": np.array(v) for k, v in flatten(params).items()}
        optimizer = optax.adam(1e-3)
        step, p, o = make_sharded_train_step(jdin.forward, sampler, optimizer, mesh,
                                             jax.tree.map(jnp.array, params),
                                             optimizer.init(params))
        losses = []
        for i, (tc, sc) in enumerate(batches):
            key = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), i)
            tcj, scj = jnp.asarray(tc, jnp.int32), jnp.asarray(sc, jnp.int32)
            drawn = jax.jit(sampler.sample)(key, tcj)
            for name, a in zip(("codes", "labels", "weights"), drawn):
                inp[f"{name}_{i}"] = np.array(a)
            p, o, loss = step(p, o, key, tcj, scj)
            losses.append(float(loss))
        host = jax.tree.map(np.array, p)
        beam_fn, bp = make_sharded_beam_fn(jdin.forward, jtree, 4, mesh, host,
                                           precompute=jdin.precompute_seq,
                                           apply=jdin.apply_with_ctx)
        ids, scores = beam_fn(bp, jnp.asarray(evals, jnp.int32))
        path = os.path.join(tmp, f"inputs{n_model}.npz")
        np.savez(path, **inp)
        out[n_model] = {"inp": inp, "jax": (losses, host, np.asarray(ids), np.asarray(scores)),
                        "tdm": _launch(tmp, f"tdm{n_model}", "tdm", n_model, path),
                        "deep": _launch(tmp, f"deep{n_model}", "deep", n_model, path)}
    out["tree"], out["batches"], out["evals"] = tree, batches, evals
    return out


def _single_device(run, n_model):
    """The port's single-device run of the same steps from the same params
    and draws, on the workers' thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return _single_device_steps(run, n_model)
    finally:
        torch.set_num_threads(threads)


def _single_device_steps(run, n_model):
    inp = run[n_model]["inp"]
    tree = run["tree"]
    unit = 1 + 2 + 3 + 4 + 5 + 1  # positives and NEG_COUNTS negatives from level 1
    tr = TDMTrainer(tree=tree, layer_neg_counts=multiproc.NEG_COUNTS, embed_size=16,
                    learning_rate=1e-3, total_batch_size=B * unit, sparse_embed_update=False,
                    device="cpu")
    params = multiproc._unflatten({k[6:]: v for k, v in inp.items() if k.startswith("param:")})
    params["embedding"] = params["embedding"][: tr.model.embedding.shape[0]]
    tr.load_numpy(params)
    t = torch.as_tensor
    losses = [float(tr.step_from_samples(t(sc), t(inp[f"codes_{i}"]).long(),
                                         t(inp[f"labels_{i}"]), t(inp[f"weights_{i}"])))
              for i, (_, sc) in enumerate(run["batches"])]
    pre, app = DIN.precompute_seq, DIN.apply_with_ctx
    ids, scores = make_beam_fn(None, tree, 4, precompute=pre, apply=app, device="cpu")(
        tr.model, t(run["evals"]))
    return losses, {k: v.detach().numpy() for k, v in flatten(tr.model.param_tree()).items()}, \
        ids.numpy(), scores.numpy()


@pytest.mark.parametrize("n_model", [2, 1])
def test_workers_match_the_single_device_run(run, n_model):
    got = run[n_model]["tdm"]
    losses, params, ids, scores = _single_device(run, n_model)
    v = params["embedding"].shape[0]
    if n_model == 2:  # (1, 2): the batch is unsharded, bit for bit
        assert got["losses"].tolist() == losses
        for k, want in params.items():
            g = got[f"params:{k}"]
            assert np.array_equal(g[:v] if k == "embedding" else g, want), k
        np.testing.assert_array_equal(got["beam_scores"], scores)
    else:
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        for k, want in params.items():
            g = got[f"params:{k}"]
            np.testing.assert_allclose(g[:v] if k == "embedding" else g, want, rtol=P_RTOL,
                                       atol=P_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["beam_ids"], ids)


@pytest.mark.parametrize("n_model", [2, 1])
def test_workers_match_the_jax_building_blocks(run, n_model):
    got = run[n_model]["tdm"]
    losses, params, ids, scores = run[n_model]["jax"]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    for k, want in flatten(params).items():
        np.testing.assert_allclose(got[f"params:{k}"], want, rtol=P_RTOL, atol=P_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["beam_ids"], ids)
    np.testing.assert_allclose(got["beam_scores"], scores, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_model", [2, 1])
def test_deep_leg_serves_the_unsharded_lists(run, n_model, tmp_path):
    """The packed beam with its pair table row-sharded over two processes
    equals the unsharded packed beam; the DR E-step and serving ran."""
    got = run[n_model]["deep"]
    n_items = 1 << 14
    ids = np.arange(1, n_items + 1)
    path = str(tmp_path / "deep.bin")
    write_tree(path, *category_sorted_codes(ids, multiproc.deep_tree_cats(ids)))
    tree = ArrayTree.from_file(path)
    model = DIN((1 << (tree.max_level + 1)) - 1, 16, device="cpu",
                generator=torch.Generator().manual_seed(SEED))
    fn = make_packed_beam_fn(make_packed_tree(tree, model.embedding.detach(), beam=8),
                             DIN.precompute_seq)
    seqs = tree.ids_to_codes(np.random.default_rng(SEED + 1).integers(
        1, n_items + 1, size=(B, 10))).astype(np.int64)
    want_ids, want_scores = fn(model, torch.as_tensor(seqs))
    np.testing.assert_array_equal(got["packed_ids"], want_ids.numpy())
    np.testing.assert_allclose(got["packed_scores"], want_scores.numpy(), rtol=0, atol=1e-6)
    assert np.isfinite(got["dr_layer_losses"]).all() and np.isfinite(got["dr_rerank_loss"])
    assert got["dr_ids"].shape == (B, 5) and (got["dr_ids"] >= 0).all()
