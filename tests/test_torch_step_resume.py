"""Step-level checkpoint and resume in the port (train/step_resume.py),
mirroring tests/test_step_resume.py: the snapshot format against the JAX
package's module, and for each trainer a run killed after its last
snapshot and resumed in a fresh trainer, whose parameters must equal an
uninterrupted run's bit for bit (tolerance: none)."""

import jax
import numpy as np
import pytest
import torch

from dismember_tpu.train import step_resume as jstep_resume
from dismember_tpu_torch.data.dr_dataset import build_dr_data
from dismember_tpu_torch.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu_torch.data.otm_dataset import build_otm_data
from dismember_tpu_torch.data.tdm_dataset import generate_split_samples
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu_torch.train import step_resume
from dismember_tpu_torch.train.dr import DRTrainer
from dismember_tpu_torch.train.otm import OTMTrainer
from dismember_tpu_torch.train.tdm import TDMTrainer

NEG_COUNTS = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and parallel test
    workers with a thread per core each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    elif isinstance(a, int):
        assert a == b
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(bits(a), bits(b))


def test_save_load_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(5)
    gen_state = step_resume.generator_state(gen)
    want = torch.rand(4, generator=gen)
    tree = {"a": torch.arange(6, dtype=torch.float32),
            "b": {"c": torch.randn(3, 3).to(torch.bfloat16), "n": 7},
            "gen": gen_state}
    meta = {"iteration": 7, "rng": {"state": 2**80, "inc": 3}}
    p = str(tmp_path / "snap")
    step_resume.save_step_state(p, tree, meta)
    got, got_meta = step_resume.load_step_state(p, tree)
    assert got_meta == meta
    back = step_resume.to_torch(got, tree)
    assert back["b"]["n"] == 7
    assert_trees_equal(tree["a"], back["a"])
    assert back["b"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(back["b"]["c"]), bits(tree["b"]["c"]))
    step_resume.set_generator_state(gen, back["gen"])
    np.testing.assert_array_equal(torch.rand(4, generator=gen).numpy(), want.numpy())
    assert step_resume.load_step_state(str(tmp_path / "absent"), tree) is None
    assert not (tmp_path / "snap.npz.tmp").exists()


def test_snapshots_read_in_either_package(tmp_path):
    """The port's snapshot loads through the JAX package's module and the
    other way round: same leaves (bf16 as its bits), same meta."""
    arr = {"x": np.arange(5, dtype=np.float32), "y": {"z": np.arange(3, dtype=np.int32)}}
    meta = {"iteration": 3, "pos": 11}
    step_resume.save_step_state(str(tmp_path / "port"), arr, meta)
    got, got_meta = jstep_resume.load_step_state(str(tmp_path / "port"), arr)
    assert got_meta == meta
    np.testing.assert_array_equal(got["y"]["z"], arr["y"]["z"])
    jstep_resume.save_step_state(str(tmp_path / "jax"), arr, meta)
    got, got_meta = step_resume.load_step_state(str(tmp_path / "jax"), arr)
    assert got_meta == meta
    np.testing.assert_array_equal(got["x"], arr["x"])
    state = np.random.default_rng(3)
    state.random(5)
    js = step_resume.rng_state_to_json(state)
    fresh = np.random.default_rng(0)
    jstep_resume.rng_state_from_json(fresh, js)
    np.testing.assert_array_equal(fresh.random(4), state.random(4))


@pytest.fixture(scope="module")
def tdm_setup(small_csv, tmp_path_factory):
    raw = read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    path = str(tmp_path_factory.mktemp("tree") / "tree.bin")
    write_tree(path, sorted_ids, codes, stat=samples.stat)
    # a tiny train subset, so 40 iterations cross several epoch refills
    return ArrayTree.from_file(path), samples.train_seqs[:30], samples.train_targets[:30]


def _tdm(tree, **kw):
    kw.setdefault("model_type", "din")
    return TDMTrainer(tree=tree, embed_size=8, learning_rate=3e-3,
                      total_batch_size=2048, layer_neg_counts=NEG_COUNTS, seed=11,
                      device="cpu", **kw)


@pytest.mark.parametrize("sparse_kw", [
    {"sparse_embed_update": False},
    {"sparse_embed_update": True, "sparse_format": "pmv"},
    {"sparse_embed_update": True, "embed_dtype": torch.bfloat16},
    {"sparse_embed_update": True, "sparse_format": "mv", "model_type": "deepfm"},
    {"sparse_embed_update": False, "embed_dtype": torch.bfloat16, "model_type": "deepfm"},
    {"sparse_embed_update": True, "embed_dtype": torch.bfloat16, "model_type": "deepfm"},
], ids=["dense", "pmv", "bf16_mv", "deepfm_mv", "deepfm_bf16_dense", "deepfm_bf16_mv"])
def test_tdm_resume_bit_compatible(tdm_setup, tmp_path, sparse_kw):
    tree, seqs, targets = tdm_setup
    ckpt = str(tmp_path / "tdm_step")
    ref = _tdm(tree, **sparse_kw)
    ref.train(seqs, targets, iterations=40, progress_interval=100)
    part = _tdm(tree, **sparse_kw)
    part.train(seqs, targets, iterations=25, progress_interval=100,
               checkpoint_path=ckpt, checkpoint_every=10)
    assert (tmp_path / "tdm_step.npz").exists()
    del part  # snapshots at 10 and 20; iterations 21-25 are lost to the kill
    res = _tdm(tree, **sparse_kw)
    res.train(seqs, targets, iterations=40, progress_interval=100,
              checkpoint_path=ckpt, checkpoint_every=10)
    assert_trees_equal(ref.params, res.params)
    assert_trees_equal(ref.adam, res.adam)


def test_bf16_deepfm_snapshot_reads_in_either_package(tdm_setup, tmp_path):
    """A bf16 DeepFM trainer's snapshot (mv route) read through the JAX
    package's module gives the port's leaves bit for bit (the table as its
    bf16 bits); written back by the JAX module, it resumes a port trainer
    that ends where an uninterrupted run ends."""
    tree, seqs, targets = tdm_setup
    kw = {"sparse_embed_update": True, "embed_dtype": torch.bfloat16, "model_type": "deepfm"}
    part = _tdm(tree, **kw)
    part.train(seqs, targets, iterations=15, progress_interval=100,
               checkpoint_path=str(tmp_path / "port"), checkpoint_every=10)
    like = jax.tree.map(lambda _: 0, part._local_step_state())
    got, meta = step_resume.load_step_state(str(tmp_path / "port"), like)
    jgot, jmeta = jstep_resume.load_step_state(str(tmp_path / "port"), like)
    assert jmeta == meta and meta["iteration"] == 10
    assert jgot["params"]["embedding"].dtype.itemsize == 2
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))
    jstep_resume.save_step_state(str(tmp_path / "jax"), jgot, jmeta)
    ref = _tdm(tree, **kw)
    ref.train(seqs, targets, iterations=20, progress_interval=100)
    res = _tdm(tree, **kw)
    res.train(seqs, targets, iterations=20, progress_interval=100,
              checkpoint_path=str(tmp_path / "jax"), checkpoint_every=10)
    assert res.model.embedding.dtype == torch.bfloat16 and not res._pmv
    assert_trees_equal(ref.params, res.params)
    assert_trees_equal(ref.emb_state, res.emb_state)


def test_otm_resume_bit_compatible(small_csv, tmp_path):
    d = build_otm_data(small_csv, seq_len=10, min_seq_len=2, split_ratio=0.8,
                       leaf_init_mode="category", label_num=3, seed=1)
    d.train_seqs, d.train_labels = d.train_seqs[:96], d.train_labels[:96]
    d.train_users = d.train_users[:96]
    kw = dict(embed_size=8, beam_size=4, total_train_batch_size=64, seed=0, device="cpu")
    ckpt = str(tmp_path / "otm_step")
    ref = OTMTrainer(d, **kw)
    ref.train(num_epochs=2)
    part = OTMTrainer(d, **kw)
    part.train(num_epochs=1, checkpoint_path=ckpt, checkpoint_every=1)
    assert (tmp_path / "otm_step.npz").exists()
    del part
    res = OTMTrainer(d, **kw)
    res.train(num_epochs=2, checkpoint_path=ckpt, checkpoint_every=1)
    assert_trees_equal(ref.params, res.params)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "pmv"])
def test_dr_resume_bit_compatible(small_csv, tmp_path, sparse):
    d = build_dr_data(small_csv, seq_len=10, min_seq_len=2, split_ratio=0.8)
    d.train_seqs, d.train_targets = d.train_seqs[:256], d.train_targets[:256]
    d.eval_seqs, d.eval_labels = d.eval_seqs[:16], d.eval_labels[:16]
    d.eval_users = d.eval_users[:16]
    kw = dict(num_layers=3, num_nodes=20, num_paths_per_item=2, embed_size=8,
              train_batch_size=128, num_sampled=4, seed=3, sparse_embed_update=sparse,
              device="cpu")
    ckpt = str(tmp_path / "dr_step")
    ref = DRTrainer(d, **kw)
    assert ref._pmv == sparse
    ref.train(num_epochs=2)
    part = DRTrainer(d, **kw)
    part.train(num_epochs=1, checkpoint_path=ckpt, checkpoint_every=1)
    assert (tmp_path / "dr_step.npz").exists()
    del part
    res = DRTrainer(d, **kw)
    res.train(num_epochs=2, checkpoint_path=ckpt, checkpoint_every=1)
    assert_trees_equal(ref.layer_params, res.layer_params)
    assert_trees_equal(ref.rerank_params, res.rerank_params)
