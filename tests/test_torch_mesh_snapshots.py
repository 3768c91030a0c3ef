"""Step snapshots of mesh trainers (``train/step_resume.py`` on a mesh), on
two gloo ranks spawned once for the file: TDM (sparse mv at (1, 2) and
(2, 1), dense at (1, 2)), OTM (sparse, (1, 2)) and DR (sharded pmv, (1, 2))
killed after a snapshot and resumed in fresh trainers end bit for bit where
an uninterrupted run ends; a (1, 2) snapshot equals, key for key and bit for
bit, the snapshot of the single-device trainer at the same step (drawing
the (1, 2) mesh's negatives), and loads in the JAX package's module."""

import copy
import shutil

import numpy as np
import pytest
import torch

from dismember_tpu_torch.core import mesh as meshlib, multihost
from dismember_tpu_torch.core.checkpoint import flatten
from dismember_tpu_torch.data.dr_dataset import build_dr_data
from dismember_tpu_torch.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu_torch.data.otm_dataset import build_otm_data
from dismember_tpu_torch.data.tdm_dataset import generate_split_samples
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu_torch.models import dr_models
from dismember_tpu_torch.train import multiproc, spmd_sparse
from dismember_tpu_torch.train.dr import DRTrainer
from dismember_tpu_torch.train.otm import OTMTrainer
from dismember_tpu_torch.train.tdm import TDMTrainer

NEG_COUNTS = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"
TDM_ITERS, TDM_KILL, EVERY = 16, 13, 6  # snapshots at 6 and 12; 13 lost to the kill


def _tdm(tree, mesh, sparse):
    kw = dict(sparse_embed_update=True, sparse_format="mv") if sparse else \
        dict(sparse_embed_update=False)
    return TDMTrainer(tree=tree, layer_neg_counts=NEG_COUNTS, embed_size=8, learning_rate=3e-3,
                      total_batch_size=2048, seed=11, mesh=mesh, device="cpu", **kw)


def _mesh_draws(tr):
    """A single-device TDM trainer drawing a (1, N) mesh's negatives: data
    shard 0's (seed, step, 0) stream draws the whole batch."""
    step = [0]

    def sample(target_codes):
        gen = spmd_sparse.shard_generator(tr.seed, step[0], 0, tr.device)
        step[0] += 1
        return tr.sampler.sample(gen, target_codes)

    tr.sample = sample
    return tr


def _otm(data, mesh):
    return OTMTrainer(data, embed_size=8, beam_size=4, total_train_batch_size=64, seed=0,
                      sparse_embed_update=True, sparse_format="mv", mesh=mesh, device="cpu")


def _dr(data, mesh):
    return DRTrainer(data, num_layers=3, num_nodes=20, num_paths_per_item=2, embed_size=8,
                     train_batch_size=128, num_sampled=4, seed=3, sparse_embed_update=True,
                     mesh=mesh, device="cpu")


def _dr_mesh_draws(tr):
    """A single-device DR trainer drawing a (1, N) mesh's negatives."""
    tr.sample_negatives = lambda labels: dr_models.sample_negatives(
        spmd_sparse.shard_generator(tr.seed, tr._mesh_steps, 0, tr.device), labels,
        tr.data.num_items, tr.num_sampled)
    return tr


def _params(tr):
    if isinstance(tr, DRTrainer):
        with tr.whole_table():
            return copy.deepcopy({"layer": flatten(tr.layer_params),
                                  "rerank": flatten(tr.rerank_params)})
    return copy.deepcopy(flatten(multihost.gather_to_host(tr.params)))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def _run(make, train_full, train_part, ckpt, keep):
    """Uninterrupted, killed-after-a-snapshot and resumed runs on fresh
    trainers: (the uninterrupted run's params, the resumed run's, the
    snapshot the killed run left, as rank 0 kept it)."""
    full = make()
    train_full(full)
    part = make()
    train_part(part, ckpt)
    if torch.distributed.get_rank() == 0:
        shutil.copy(ckpt + ".npz", keep)
    torch.distributed.barrier()
    res = make()
    train_full(res, ckpt)
    return _params(full), _params(res), _npz(keep)


def _ranks(dev, paths):
    # one intra-op thread a rank: the tensors are small, and the test
    # workers run beside each other (the single-device references run in
    # the same rank, so their reductions keep the mesh runs' order)
    torch.set_num_threads(1)
    tmp = paths["tmp"]
    rank = torch.distributed.get_rank()
    meshes = {s: meshlib.make_mesh(*s, device="cpu") for s in [(1, 2), (2, 1)]}
    tree = ArrayTree.from_file(paths["tree"])
    samples = generate_split_samples(user_interactions(read_csv(paths["csv"])), 10, 2, 0.8)
    seqs, targets = samples.train_seqs[:40], samples.train_targets[:40]

    def tdm_full(tr, ckpt=None):
        tr.train(seqs, targets, iterations=TDM_ITERS, progress_interval=100,
                 checkpoint_path=ckpt, checkpoint_every=EVERY if ckpt else 0)

    def tdm_part(tr, ckpt):
        tr.train(seqs, targets, iterations=TDM_KILL, progress_interval=100,
                 checkpoint_path=ckpt, checkpoint_every=EVERY)

    otm_data = build_otm_data(paths["csv"], seq_len=10, min_seq_len=2, split_ratio=0.8,
                              leaf_init_mode="category", label_num=3, seed=1)
    otm_data.train_seqs, otm_data.train_labels = otm_data.train_seqs[:96], \
        otm_data.train_labels[:96]
    otm_data.train_users = otm_data.train_users[:96]
    dr_data = build_dr_data(paths["csv"], seq_len=10, min_seq_len=2, split_ratio=0.8)
    dr_data.train_seqs, dr_data.train_targets = dr_data.train_seqs[:256], \
        dr_data.train_targets[:256]
    dr_data.eval_seqs, dr_data.eval_labels = dr_data.eval_seqs[:16], dr_data.eval_labels[:16]
    dr_data.eval_users = dr_data.eval_users[:16]

    def epochs(n):
        def train(tr, ckpt=None):
            tr.train(num_epochs=n, checkpoint_path=ckpt, checkpoint_every=1 if ckpt else 0)
        return train

    cases = {
        "tdm_mv(1, 2)": (lambda: _tdm(tree, meshes[(1, 2)], True), tdm_full, tdm_part),
        "tdm_mv(2, 1)": (lambda: _tdm(tree, meshes[(2, 1)], True), tdm_full, tdm_part),
        "tdm_dense(1, 2)": (lambda: _tdm(tree, meshes[(1, 2)], False), tdm_full, tdm_part),
        "otm(1, 2)": (lambda: _otm(otm_data, meshes[(1, 2)]), epochs(2), epochs(1)),
        "dr(1, 2)": (lambda: _dr(dr_data, meshes[(1, 2)]), epochs(2), epochs(1)),
    }
    out = {}
    for name, (make, full, part) in cases.items():
        out[name] = _run(make, full, part, f"{tmp}/{name}_r", f"{tmp}/{name}_kept.npz")
    # a mesh TDM trainer draws its init at the padded row count (as the JAX
    # package's): the single-device trainer starts from its weights
    inits = {sparse: copy.deepcopy(multihost.gather_to_host(
        _tdm(tree, meshes[(1, 2)], sparse).params)) for sparse in (True, False)}

    def tdm_single(sparse):
        tr = _tdm(tree, None, sparse)
        v = tr.model.embedding.shape[0]
        tr.model.load_numpy(dict(inits[sparse], embedding=inits[sparse]["embedding"][:v]))
        return tr

    if rank == 0:  # the single-device snapshots at the same steps
        singles = {
            "tdm_mv(1, 2)": (lambda: _mesh_draws(tdm_single(True)), tdm_part),
            "tdm_dense(1, 2)": (lambda: tdm_single(False), tdm_part),
            "otm(1, 2)": (lambda: _otm(otm_data, None), epochs(1)),
            "dr(1, 2)": (lambda: _dr_mesh_draws(_dr(dr_data, None)), epochs(1)),
        }
        for name, (make, part) in singles.items():
            ckpt = f"{tmp}/{name}_single"
            part(make(), ckpt)
            out[f"single {name}"] = _npz(ckpt + ".npz")
    return out


@pytest.fixture(scope="module")
def run(small_csv, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mesh_snapshots")
    raw = read_csv(small_csv)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    write_tree(str(tmp / "tree.bin"), sorted_ids, codes, stat=samples.stat)
    paths = {"tmp": str(tmp), "tree": str(tmp / "tree.bin"), "csv": small_csv}
    return multiproc.spawn(_ranks, 2, (paths,), device="cpu", timeout=240)


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal(a[k], b[k])
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(np.atleast_1d(x).view(np.uint8),
                                      np.atleast_1d(y).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("case", ["tdm_mv(1, 2)", "tdm_mv(2, 1)", "tdm_dense(1, 2)",
                                  "otm(1, 2)", "dr(1, 2)"])
def test_resumed_mesh_run_equals_uninterrupted(run, case):
    for r in run:
        full, resumed, _ = r[case]
        _assert_equal(resumed, full)


@pytest.mark.parametrize("case", ["tdm_mv(1, 2)", "tdm_dense(1, 2)", "otm(1, 2)",
                                  "dr(1, 2)"])
def test_1x2_snapshot_equals_single_device_snapshot(run, case):
    kept = run[0][case][2]
    _assert_equal(kept, run[0][f"single {case}"])
    _assert_equal(run[1][case][2], kept)  # one file, read by both ranks


def test_mesh_snapshot_loads_in_the_jax_package(run, tmp_path):
    # imported here: the spawned ranks import this module and need no JAX
    from dismember_tpu.train import step_resume as jstep_resume

    kept = run[0]["tdm_mv(1, 2)"][2]
    np.savez(tmp_path / "snap.npz", **kept)
    like = {k: 0 for k in kept if k != "__step_resume_meta__"}
    got, meta = jstep_resume.load_step_state(str(tmp_path / "snap"), like)
    assert meta["iteration"] == 2 * EVERY
    for k in like:
        np.testing.assert_array_equal(got[k], kept[k])
