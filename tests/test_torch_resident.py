"""The port's device-resident training loop (TDMTrainer.train_resident),
mirroring tests/test_resident.py: ResidentWindows and its window gather
against the JAX package's, and the loop's own contract, all bit for bit
(tolerance: none): the chunk size changes no bit, windows train as the
same rows given flat, the loss falls across epoch boundaries, and a
killed run resumed from its snapshot equals an uninterrupted one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.train.tdm import ResidentWindows as JResidentWindows
from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu_torch.train.tdm import ResidentWindows, TDMTrainer, window_rows

SEQ_LEN = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and parallel test
    workers with a thread per core each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(7)
    n_items, n_users, stream = 500, 120, 12
    ids = np.arange(1, n_items + 1)
    sorted_ids, codes = category_sorted_codes(ids, ids % 13)
    path = str(tmp_path_factory.mktemp("tree") / "t.bin")
    write_tree(path, sorted_ids, codes)
    items = rng.integers(1, n_items + 1, size=(n_users, stream))
    t_lo, t_hi = SEQ_LEN, stream
    n_win = t_hi - t_lo
    # the flat expansion in ResidentWindows' row order (r = u * n_win + w)
    idx = np.arange(SEQ_LEN)[None, :] + np.arange(n_win)[:, None]
    seqs = items[:, idx].reshape(n_users * n_win, SEQ_LEN)
    targets = items[:, t_lo:t_hi].reshape(-1)
    tree = ArrayTree.from_file(path)
    return tree, JArrayTree.from_file(path), items, seqs, targets, \
        ResidentWindows.from_items(tree, items, SEQ_LEN, t_lo, t_hi)


def _trainer(tree, **kw):
    kw.setdefault("sparse_embed_update", False)
    kw.setdefault("model_type", "din")
    return TDMTrainer(tree=tree, embed_size=8, learning_rate=3e-3,
                      total_batch_size=1024, seq_len=SEQ_LEN,
                      layer_neg_counts="0,1,2,3,4,5,6,7,8,9", seed=5, device="cpu", **kw)


def bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def assert_params_equal(a: TDMTrainer, b: TDMTrainer):
    for (n, x), (_, y) in zip(a.model.named_parameters(), b.model.named_parameters()):
        np.testing.assert_array_equal(bits(x), bits(y), err_msg=n)


def test_windows_from_items_match_jax(setup):
    tree, jtree, items, *_ , win = setup
    jwin = JResidentWindows.from_items(jtree, items, SEQ_LEN, SEQ_LEN, items.shape[1])
    np.testing.assert_array_equal(win.item_codes, jwin.item_codes)
    assert win.item_codes.dtype == jwin.item_codes.dtype == np.int32
    assert (len(win), win.n_win) == (len(jwin), jwin.n_win)


def test_window_gather_matches_jax_formula(setup):
    """The device gather against tdm.py:637-644's formula on one set of
    logical rows (every user's first and last window among them)."""
    _, _, _, seqs, targets, win = setup
    rng = np.random.default_rng(0)
    idx = np.concatenate([[0, win.n_win - 1, len(win) - 1], rng.integers(0, len(win), 200)])
    items = jnp.asarray(win.item_codes)
    ji = jnp.asarray(idx)
    u = ji // win.n_win
    t = win.t_lo + ji % win.n_win
    cols = t[:, None] + jnp.arange(-SEQ_LEN, 0)[None, :]
    jsc, jtc = np.asarray(items[u[:, None], cols]), np.asarray(items[u, t])
    tc, sc = window_rows(torch.as_tensor(win.item_codes), torch.as_tensor(idx), SEQ_LEN,
                         win.t_lo, win.n_win)
    np.testing.assert_array_equal(tc.numpy(), jtc)
    np.testing.assert_array_equal(sc.numpy(), jsc)
    # and both are the flat expansion's rows
    tree = setup[0]
    np.testing.assert_array_equal(tc.numpy(), tree.ids_to_codes(targets[idx]))
    np.testing.assert_array_equal(sc.numpy(), tree.ids_to_codes(seqs[idx]))


@pytest.mark.parametrize("sparse_kw", [
    {"sparse_embed_update": False},
    {"sparse_embed_update": True, "sparse_format": "pmv"},
    {"sparse_embed_update": True, "sparse_format": "pmv", "model_type": "deepfm"},
    {"sparse_embed_update": True, "embed_dtype": torch.bfloat16, "model_type": "deepfm"},
], ids=["dense", "pmv", "deepfm_pmv", "deepfm_bf16_mv"])
def test_chunk_size_bit_invariant(setup, sparse_kw):
    """A bf16 DeepFM table takes the mv route (pmv needs an f32 table)."""
    tree, _, _, seqs, targets, _ = setup
    a = _trainer(tree, **sparse_kw)
    a.train_resident((seqs, targets), iterations=20, chunk=20)
    b = _trainer(tree, **sparse_kw)
    b.train_resident((seqs, targets), iterations=20, chunk=3)
    assert a._pmv == b._pmv == ("sparse_format" in sparse_kw)
    assert a.model.embedding.dtype == (sparse_kw.get("embed_dtype") or torch.float32)
    assert_params_equal(a, b)
    if "embed_dtype" in sparse_kw:
        assert a.emb_state["count"] == 20
        np.testing.assert_array_equal(a.emb_state["mv"].numpy(), b.emb_state["mv"].numpy())


@pytest.mark.parametrize("sparse_kw", [
    {"sparse_embed_update": False},
    {"sparse_embed_update": True, "sparse_format": "pmv"},
], ids=["dense", "pmv"])
def test_spans_count_the_steps_and_change_no_bit(setup, sparse_kw):
    """With recording on, every step opens tdm.step over sampler.sample and
    row_step.step and counts one step, every chunk one tdm.drain; the
    parameters are those of the run with recording off, bit for bit."""
    tree, _, _, _, _, win = setup
    iters, chunk = 10, 4
    a = _trainer(tree, **sparse_kw)
    a.train_resident(win, iterations=iters, chunk=chunk)
    b = _trainer(tree, **sparse_kw)
    profiling.reset()
    profiling.enable(True)
    try:
        b.train_resident(win, iterations=iters, chunk=chunk)
        snap = profiling.snapshot()
        raw = list(profiling._rec.raw)
    finally:
        profiling.enable(False)
        profiling.reset()
    assert_params_equal(a, b)
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    assert calls == {"tdm.step": iters, "sampler.sample": iters, "row_step.step": iters,
                     "tdm.drain": -(-iters // chunk)}
    assert snap["counters"]["tdm.steps"] == iters
    steps = [i for i, r in enumerate(raw) if r[0] == "tdm.step"]
    assert {r[0] for r in raw if r[3] in steps} == {"sampler.sample", "row_step.step"}
    assert all(r[3] == -1 for r in raw if r[0] in ("tdm.step", "tdm.drain"))


def test_windows_equals_flat(setup):
    tree, _, _, seqs, targets, win = setup
    a = _trainer(tree)
    a.train_resident((seqs, targets), iterations=12, chunk=4)
    b = _trainer(tree)
    b.train_resident(win, iterations=12, chunk=4)
    assert_params_equal(a, b)


def test_loss_decreases_and_epoch_crossing(setup):
    tree, _, _, seqs, targets, _ = setup
    tr = _trainer(tree)
    steps_per_epoch = len(targets) // tr.num_targets_per_batch
    iters = steps_per_epoch * 2 + 3  # crosses two epoch boundaries
    logs = tr.train_resident((seqs, targets), iterations=iters, chunk=16,
                             progress_interval=5)
    assert logs[-1]["iteration"] == iters
    assert all(np.isfinite(lg["train_loss"]) for lg in logs)
    assert logs[-1]["train_loss"] < logs[0]["train_loss"]


def test_resident_resume_bit_compatible(setup, tmp_path):
    tree, _, _, seqs, targets, _ = setup
    ckpt = str(tmp_path / "res_step")
    ref = _trainer(tree)
    ref.train_resident((seqs, targets), iterations=30, chunk=7)
    part = _trainer(tree)
    part.train_resident((seqs, targets), iterations=22, chunk=7,
                        checkpoint_path=ckpt, checkpoint_every=10)
    assert (tmp_path / "res_step.npz").exists()
    del part  # snapshots at 10 and 20; steps 21-22 are lost to the kill
    res = _trainer(tree)
    res.train_resident((seqs, targets), iterations=30, chunk=7,
                       checkpoint_path=ckpt, checkpoint_every=10)
    assert_params_equal(ref, res)


def test_resident_refuses_a_mesh_and_tiny_datasets(setup):
    tree, _, _, seqs, targets, _ = setup
    tr = _trainer(tree)
    with pytest.raises(ValueError, match="smaller than one batch"):
        tr.train_resident((seqs[:3], targets[:3]), iterations=1)
    tr.mesh = object()  # the JAX package's guard (tdm.py:684-685)
    with pytest.raises(ValueError, match="single-chip; use train"):
        tr.train_resident((seqs, targets), iterations=1)
