"""bf16 embedding tables in the port against the JAX package
(``embed_dtype``), for both scorers (DIN and DeepFM): the rounding of a
dense and an mv step, the auto route and the pmv refusal, the row add on a
bf16 table, bf16 checkpoints, and the trainer's bf16 contract
(tests/test_tdm_train.py:132-146, 227-246).

Tolerances: a bf16 table is compared as uint16 bits, with none.  Given the
same row gradients, the port's updates equal the JAX package's compiled
CPU step bit for bit (table, moments).  From the same state on the JAX
sampler's batch, each package differentiates on its own: the f32 row
gradients then differ in their last bits (summation order), which the
bf16 table, the dense route's bf16-rounded gradient and its moments absorb
here bit for bit; the mv route's f32 moments keep those last bits and are
held to the f32 trainer tests' tolerances (rtol 2e-4, atol 2e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core.checkpoint import load_pytree as j_load_pytree
from dismember_tpu.core.checkpoint import save_pytree as j_save_pytree
from dismember_tpu.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu.data.tdm_dataset import generate_split_samples
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.models import deepfm as jdeepfm
from dismember_tpu.models import din as jdin
from dismember_tpu.models.losses import bce_with_logits as j_bce
from dismember_tpu.train import sparse_adam as jsparse_adam
from dismember_tpu.train.tdm import TDMTrainer as JTDMTrainer
from dismember_tpu_torch.core.checkpoint import load_pytree, save_pytree
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.ops import row_writer
from dismember_tpu_torch.train import sparse_adam
from dismember_tpu_torch.train.tdm import TDMTrainer

NEG_COUNTS = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
KW = dict(model_type="din", embed_size=8, learning_rate=3e-3, total_batch_size=512,
          layer_neg_counts=NEG_COUNTS, seed=7, topk=5, beam_size=8)
MODES = {"dense": dict(sparse_embed_update=False), "mv": dict(sparse_embed_update=True)}
MODELS = ("din", "deepfm")


def _kw(model_type: str, e: int = 8) -> dict:
    return {**KW, "model_type": model_type, "embed_size": e}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and parallel test
    workers with a thread per core each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def pipeline(small_csv, tmp_path_factory):
    raw = read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    path = str(tmp_path_factory.mktemp("tree") / "tree.bin")
    write_tree(path, sorted_ids, codes, stat=samples.stat)
    return JArrayTree.from_file(path), ArrayTree.from_file(path), samples


def u16(a) -> np.ndarray:
    """A bf16 array or tensor as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def as_bf16(a) -> torch.Tensor:
    return torch.from_numpy(u16(a).astype(np.int16)).view(torch.bfloat16)


def _batch(tree, samples, n):
    return tree.ids_to_codes(samples.train_seqs[:n]), tree.ids_to_codes(samples.train_targets[:n])


def _carried(jtree, tree, samples, mode, key, kw):
    """A JAX bf16 trainer after two steps, the port's trainer holding its
    state, and the JAX sampler's batch for the next step."""
    jtr = JTDMTrainer(tree=jtree, embed_dtype=jnp.bfloat16, **kw, **MODES[mode])
    sc, tc = _batch(jtree, samples, jtr.num_targets_per_batch)
    for k in (1, 2):
        jtr.params, jtr.opt_state, _ = jtr._train_step(
            jtr.params, jtr.opt_state, jax.random.PRNGKey(k), jnp.asarray(tc), jnp.asarray(sc))
    tr = TDMTrainer(tree=tree, device="cpu", embed_dtype=torch.bfloat16, **kw, **MODES[mode])
    tr.load_numpy(jax.tree.map(np.asarray, jtr.params), jax.tree.map(np.asarray, jtr.opt_state))
    sstate = jtr.sampler.device_state()
    batch = jax.jit(jtr.sampler.sample)(jax.random.PRNGKey(key), jnp.asarray(tc), sstate)
    return jtr, tr, sc, tc, sstate, batch


@pytest.mark.parametrize("key", [3])
@pytest.mark.parametrize("mode", ["dense", "mv"])
@pytest.mark.parametrize("model_type,e", [("din", 8), ("deepfm", 8), ("deepfm", 16)])
def test_bf16_step_from_carried_jax_state_matches_jax(pipeline, mode, key, model_type, e):
    """One step from a carried JAX bf16 state on the JAX sampler's batch:
    the table's bits, and the dense route's moments (f32 mu, bf16 nu: optax
    keeps nu in the parameter's dtype), equal the JAX package's.  DeepFM's
    rows take gradient through its FM sums and DNN product, DIN's through
    attention: other f32 cotangents, the same bf16 sums."""
    jtree, tree, samples = pipeline
    jtr, tr, sc, tc, sstate, (codes, labels, weights) = _carried(
        jtree, tree, samples, mode, key, _kw(model_type, e))
    assert tr.model.embedding.dtype == torch.bfloat16 and not tr._pmv
    jtr.sampler.sample = lambda *_: (codes, labels, weights)
    jp, jo, jloss = jax.jit(jtr._step_impl)(jtr.params, jtr.opt_state, jax.random.PRNGKey(key),
                                            jnp.asarray(tc), jnp.asarray(sc), sstate)
    loss = tr.step_from_samples(*(torch.tensor(np.asarray(a))
                                  for a in (sc, codes, labels, weights)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    changed = u16(jp["embedding"]) != u16(jtr.params["embedding"])
    assert changed.sum() > 1000
    np.testing.assert_array_equal(u16(tr.model.embedding), u16(jp["embedding"]))
    if mode == "dense":
        np.testing.assert_array_equal(tr.adam["mu"]["embedding"].numpy(),
                                      np.asarray(jo[0].mu["embedding"]))
        assert tr.adam["nu"]["embedding"].dtype == torch.bfloat16
        np.testing.assert_array_equal(u16(tr.adam["nu"]["embedding"]), u16(jo[0].nu["embedding"]))
    else:
        np.testing.assert_allclose(tr.emb_state["mv"].numpy(), np.asarray(jo[1]["mv"]),
                                   rtol=P_RTOL, atol=P_ATOL)
        assert tr.emb_state["count"] == int(jo[1]["count"]) == 3


@pytest.mark.parametrize("jmod", [jdin, jdeepfm], ids=MODELS)
def test_bf16_dense_update_given_row_gradients_matches_jax(pipeline, jmod):
    """The dense route on the JAX package's own row gradients (through the
    JAX scorer module's ``ctx_from_seq_emb`` / ``apply_from_emb``): the bf16
    table gradient (each gather's cotangents summed serially in bf16, then
    the two sums added: the two scatter-adds of the JAX step's optimized
    HLO, whose combiner rounds to bf16 after every add) and optax's bf16
    Adam step are bit for bit JAX's compiled CPU step."""
    jtree, _, samples = pipeline
    model_type = jmod.__name__.rsplit(".", 1)[1]
    jtr = JTDMTrainer(tree=jtree, embed_dtype=jnp.bfloat16, **_kw(model_type),
                      **MODES["dense"])
    sc, tc = _batch(jtree, samples, jtr.num_targets_per_batch)
    for k in (1, 2):
        jtr.params, jtr.opt_state, _ = jtr._train_step(
            jtr.params, jtr.opt_state, jax.random.PRNGKey(k), jnp.asarray(tc), jnp.asarray(sc))
    codes, labels, weights = jax.jit(jtr.sampler.sample)(
        jax.random.PRNGKey(3), jnp.asarray(tc), jtr.sampler.device_state())
    p = jtr.params
    table = p["embedding"]
    item_e = table[jnp.maximum(codes, 0)].astype(jnp.float32) * (codes >= 0)[..., None]
    seq_e = table[jnp.maximum(sc, 0)].astype(jnp.float32) * (sc >= 0)[..., None]

    def loss_rows(ie, se):
        ctx = jmod.ctx_from_seq_emb(p, se, (jnp.asarray(sc) < 0)[:, None, :])
        return j_bce(jmod.apply_from_emb(p, ie, ctx), labels, weights)

    gi, gs = jax.jit(jax.grad(loss_rows, argnums=(0, 1)))(item_e, seq_e)
    g_table = jax.jit(jax.grad(lambda q: j_bce(jmod.forward(q, codes, jnp.asarray(sc)),
                                               labels, weights)))(p)["embedding"]
    flat = torch.tensor(np.concatenate([np.asarray(codes).ravel(), np.asarray(sc).ravel()]))
    g_rows = torch.tensor(np.concatenate([np.asarray(gi).reshape(-1, 8),
                                          np.asarray(gs).reshape(-1, 8)]))
    n_items = np.asarray(codes).size
    v_rows = table.shape[0]
    parts = [sparse_adam.serial_bf16_sums(flat[s], g_rows[s], v_rows)
             for s in (slice(0, n_items), slice(n_items, None))]
    g = parts[0].add(parts[1]).to(torch.bfloat16)
    np.testing.assert_array_equal(u16(g), u16(g_table))
    upd, new_state = jax.jit(jtr.optimizer.update)({**jax.tree.map(jnp.zeros_like, p),
                                                     "embedding": g_table}, jtr.opt_state, p)
    new_table = jax.jit(lambda a, b: (a.astype(jnp.float32) + b).astype(jnp.bfloat16))(
        table, upd["embedding"])
    adam = new_state[0]
    p_new, m_new, v_new = sparse_adam.adam_update_bf16(
        as_bf16(table), torch.tensor(np.asarray(jtr.opt_state[0].mu["embedding"])),
        as_bf16(jtr.opt_state[0].nu["embedding"]), g.float(), int(adam.count), 3e-3)
    np.testing.assert_array_equal(m_new.numpy(), np.asarray(adam.mu["embedding"]))
    np.testing.assert_array_equal(u16(v_new), u16(adam.nu["embedding"]))
    np.testing.assert_array_equal(u16(p_new), u16(new_table))


def test_bf16_mv_update_given_row_gradients_matches_jax():
    """The mv route's row update on a bf16 table, three steps on the same
    row gradients (a code repeated 50 times, padding rows): table and m|v
    state bit for bit the JAX package's ``sparse_adam.apply_rows``."""
    rng = np.random.default_rng(0)
    v_rows, e, r = 4000, 8, 600
    table = (rng.standard_normal((v_rows, e)) * 0.05).astype(np.float32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    js = jsparse_adam.init_state(jt)
    tt = as_bf16(jt)
    ts = sparse_adam.init_state(tt)
    codes = rng.integers(-1, v_rows, r).astype(np.int32)
    codes[:50] = 7
    step = jax.jit(lambda t, s, c, g: jsparse_adam.apply_rows(t, s, c, g, 3e-3))
    for _ in range(3):
        g = (rng.standard_normal((r, e)) * 1e-3).astype(np.float32)
        jt, js = step(jt, js, jnp.asarray(codes), jnp.asarray(g))
        sparse_adam.apply_rows(tt, ts, torch.from_numpy(codes).long(), torch.from_numpy(g), 3e-3)
        np.testing.assert_array_equal(u16(tt), u16(jt))
        np.testing.assert_array_equal(ts["mv"].numpy(), np.asarray(js["mv"]))


@pytest.mark.parametrize("model_type", MODELS)
def test_auto_route_and_pmv_refusal_match_jax(pipeline, model_type):
    jtree, tree, _ = pipeline
    kw = dict(model_type=model_type, embed_size=8, layer_neg_counts=NEG_COUNTS)
    for sparse in (None, False, True):
        j = JTDMTrainer(tree=jtree, sparse_embed_update=sparse, embed_dtype=jnp.bfloat16, **kw)
        t = TDMTrainer(tree=tree, device="cpu", sparse_embed_update=sparse,
                       embed_dtype=torch.bfloat16, **kw)
        assert (t._sparse, t._pmv) == (j._sparse, j._pmv)
        assert t.model.embedding.dtype == torch.bfloat16
    t = TDMTrainer(tree=tree, device="cpu", sparse_embed_update=True, **kw)
    assert t._pmv  # an f32 table still takes pmv
    for make in (lambda: JTDMTrainer(tree=jtree, sparse_embed_update=True, sparse_format="pmv",
                                     embed_dtype=jnp.bfloat16, **kw),
                 lambda: TDMTrainer(tree=tree, device="cpu", sparse_embed_update=True,
                                    sparse_format="pmv", embed_dtype=torch.bfloat16, **kw)):
        with pytest.raises(ValueError, match="pmv needs .* an f32 table"):
            make()
    with pytest.raises(ValueError, match="embed_dtype"):
        TDMTrainer(tree=tree, device="cpu", embed_dtype=torch.float16, **kw)


def test_add_rows_plain_bf16_matches_jax():
    """``table.at[idx].add(rows.astype(bf16))`` on a bf16 table, unique
    indices, rows dropped out of range."""
    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.standard_normal((300, 16)).astype(np.float32)).astype(jnp.bfloat16)
    idx = rng.permutation(300)[:120]
    rows = (rng.standard_normal((120, 16)) * 0.01).astype(np.float32)
    want = table.at[jnp.asarray(idx)].add(jnp.asarray(rows).astype(jnp.bfloat16))
    t_idx = torch.tensor(np.concatenate([idx, [-1, 300]]))
    t_rows = torch.cat([torch.tensor(rows), torch.ones(2, 16)]).to(torch.bfloat16)
    got = row_writer.add_rows_plain(as_bf16(table), t_idx, t_rows)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(u16(got), u16(want))
    # a CPU tensor takes the plain version
    got = row_writer.add_rows(as_bf16(table), t_idx, t_rows)
    np.testing.assert_array_equal(u16(got), u16(want))


@pytest.mark.parametrize("model_type", MODELS)
def test_bf16_checkpoints_load_in_either_package(pipeline, tmp_path, model_type):
    """A bf16 table saved by either package loads in the other with the
    same bits (npz leaves of raw bf16 bits, descriptor V2)."""
    jtree, tree, _ = pipeline
    jtr = JTDMTrainer(tree=jtree, embed_dtype=jnp.bfloat16, **_kw(model_type))
    tr = TDMTrainer(tree=tree, device="cpu", embed_dtype=torch.bfloat16, **_kw(model_type))
    j_save_pytree(str(tmp_path / "jax"), jtr.params)
    tr.load_numpy(load_pytree(str(tmp_path / "jax"), tr.params))
    assert tr.model.embedding.dtype == torch.bfloat16
    np.testing.assert_array_equal(u16(tr.model.embedding), u16(jtr.params["embedding"]))
    save_pytree(str(tmp_path / "port"), tr.params)
    back = j_load_pytree(str(tmp_path / "port"), jtr.params)
    assert back["embedding"].dtype.itemsize == 2
    np.testing.assert_array_equal(back["embedding"].view(np.uint16), u16(jtr.params["embedding"]))
    np.testing.assert_array_equal(back["mlp1"]["weight"], np.asarray(jtr.params["mlp1"]["weight"]))


@pytest.mark.parametrize("model_type", MODELS)
def test_bf16_embedding_training(pipeline, model_type):
    """tests/test_tdm_train.py:132-146: a bf16 table trains (dense, auto
    route here), stays bf16, and serves."""
    _, tree, samples = pipeline
    tr = TDMTrainer(tree=tree, device="cpu", embed_dtype=torch.bfloat16,
                    **{**_kw(model_type), "total_batch_size": 1024, "beam_size": 10})
    assert not tr._sparse
    logs = tr.train(samples.train_seqs, samples.train_targets, iterations=20,
                    progress_interval=10)
    assert all(np.isfinite(lg["train_loss"]) for lg in logs)
    assert tr.model.embedding.dtype == torch.bfloat16
    assert len(tr.recommend(samples.eval_seqs[0], topk=5)) == 5


@pytest.mark.parametrize("model_type", MODELS)
def test_sparse_with_bf16_table(pipeline, model_type):
    """tests/test_tdm_train.py:227-246: the sparse route on a bf16 table
    keeps f32 moments, casts row updates to bf16 and reduces the loss."""
    _, tree, samples = pipeline
    tr = TDMTrainer(tree=tree, device="cpu", embed_dtype=torch.bfloat16,
                    sparse_embed_update=True, **{**_kw(model_type), "seed": 3})
    assert tr.emb_state["mv"].dtype == torch.float32
    logs = tr.train(samples.train_seqs, samples.train_targets, iterations=40,
                    progress_interval=20)
    assert tr.model.embedding.dtype == torch.bfloat16
    assert logs[-1]["train_loss"] < logs[0]["train_loss"]


@pytest.mark.parametrize("model_type", MODELS)
def test_bf16_serving_routes_match_jax(pipeline, tmp_path, model_type):
    """With identical bf16 params: recommend (the classic route over rows
    upcast to f32; DIN through K1's plain version here, DeepFM in plain
    ops), evaluate's metrics and the export file equal the JAX trainer's."""
    jtree, tree, samples = pipeline
    jtr = JTDMTrainer(tree=jtree, embed_dtype=jnp.bfloat16, **_kw(model_type))
    jtr.train(samples.train_seqs, samples.train_targets, iterations=20, progress_interval=20)
    tr = TDMTrainer(tree=tree, device="cpu", embed_dtype=torch.bfloat16, **_kw(model_type))
    tr.load_numpy(jax.tree.map(np.asarray, jtr.params))
    seqs = samples.eval_seqs[:64]
    for a, b in zip(tr.recommend_batch(seqs), jtr.recommend_batch(seqs)):
        np.testing.assert_array_equal(a, b)
    eval_data = (seqs, samples.eval_labels[:64], samples.eval_users[:64])
    ev, jev = tr.evaluate(eval_data, samples.user_consumed), jtr.evaluate(eval_data,
                                                                          samples.user_consumed)
    for k in ("precision", "recall", "ndcg"):
        np.testing.assert_allclose(getattr(ev, k), getattr(jev, k), rtol=1e-12, err_msg=k)
    jtr.export_embeddings(str(tmp_path / "j.csv"))
    tr.export_embeddings(str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
