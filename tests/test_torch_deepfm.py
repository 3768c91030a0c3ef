"""The port's DeepFM scorer against the JAX package's ``models/deepfm.py``:
its functions at E = 8, L = 6, checkpoints in both directions, packed
serving against classic, dense/mv/pmv steps from a carried JAX state on
the JAX sampler's batch, one OTM batch, and the ``tdm-*``/``jtm-*`` and
``otm-*`` CLI with ``model.deep_model DeepFM`` on the CPU.

DeepFM has no TPU kernel (the JAX package scores it through XLA ops), so
the port scores it in plain PyTorch ops on every device; the scores differ
from the JAX package's only in f32 summation order.  Its FM term subtracts
two sums of squares, so the score tolerance is absolute at the scale of
those sums."""

import dataclasses
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core.checkpoint import load_pytree as jax_load_pytree
from dismember_tpu.core.checkpoint import save_pytree as jax_save_pytree
from dismember_tpu.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu.data.otm_dataset import build_otm_data
from dismember_tpu.data.tdm_dataset import generate_split_samples
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.models import deepfm as jdeepfm
from dismember_tpu.serving import TDMServing as JTDMServing
from dismember_tpu.train import otm as jotm
from dismember_tpu.train.tdm import TDMTrainer as JTDMTrainer
from dismember_tpu.train.tdm import packed_fns as jax_packed_fns
from dismember_tpu.train.tdm import serving_fns as jax_serving_fns
from dismember_tpu_torch.cli.main import main as cli
from dismember_tpu_torch.core.checkpoint import load_meta, load_pytree, save_pytree
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.models.deepfm import DeepFM, deepfm_params_from_numpy
from dismember_tpu_torch.ops import din_kernel, packed_level_kernel
from dismember_tpu_torch.retrieval.packed_beam import make_packed_beam_fn, make_packed_tree
from dismember_tpu_torch.retrieval.tree_beam import make_beam_fn
from dismember_tpu_torch.serving import OTMServing, TDMServing
from dismember_tpu_torch.train import sparse_adam
from dismember_tpu_torch.train.otm import OTMTrainer
from dismember_tpu_torch.train.tdm import TDMTrainer, packed_fns, serving_fns

REPO = pathlib.Path(__file__).resolve().parent.parent
E, L = 8, 6
# scores: f32 summation order of the FM's sums of squares (O(1) inputs)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-5
# tests/test_tdm_train.py's dense-vs-sparse tolerances: loss rtol 1e-5;
# params rtol 2e-4, atol 2e-6 (summation order of the f32 backward)
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
NEG = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"
TDM_KW = dict(model_type="deepfm", embed_size=E, learning_rate=3e-3, total_batch_size=512,
              layer_neg_counts=NEG, seed=7, topk=5, beam_size=8, seq_len=10)
MODES = {"dense": dict(sparse_embed_update=False),
         "mv": dict(sparse_embed_update=True, sparse_format="mv"),
         "pmv": dict(sparse_embed_update=True, sparse_format="pmv")}


def _params(num_index, seq_len, seed, std=0.5):
    """A DeepFM params pytree from numpy at O(1) scale."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    t = seq_len + 1
    return {"embedding": f(num_index, E), "mlp1": {"weight": f(t, t * E), "bias": f(t)},
            "mlp2": {"weight": f(1, t), "bias": f(1)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipeline(small_csv, tmp_path_factory):
    raw = read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    path = str(tmp_path_factory.mktemp("tree") / "tree.bin")
    write_tree(path, sorted_ids, codes, stat=samples.stat)
    return path, JArrayTree.from_file(path), ArrayTree.from_file(path), samples


# ---------------------------------------------------------------- model
def _model_inputs(seed):
    rng = np.random.default_rng(seed)
    p = _params(63, L, seed)
    items = rng.integers(-1, 63, (5, 7))
    seqs = rng.integers(-1, 63, (5, L))
    seqs[0] = -1  # an all-padding sequence: zero rows, no terms
    return p, items, seqs


@pytest.mark.parametrize("fn", ["forward", "precompute_apply", "apply_from_emb",
                                "ctx_from_seq_emb"])
def test_deepfm_functions_match_jax(fn):
    p, items, seqs = _model_inputs(3)
    jp, ji, js = _jax(p), jnp.asarray(items), jnp.asarray(seqs)
    model = deepfm_params_from_numpy(p, device="cpu")
    ti, ts = torch.as_tensor(items), torch.as_tensor(seqs)
    table = p["embedding"]
    item_e = np.where((items >= 0)[..., None], table[np.maximum(items, 0)], 0.0)
    seq_e = np.where((seqs >= 0)[..., None], table[np.maximum(seqs, 0)], 0.0)
    pad = (seqs < 0).astype(np.float32)
    with torch.inference_mode():
        if fn == "forward":
            got, ref = model(ti, ts), jdeepfm.forward(jp, ji, js)
        elif fn == "precompute_apply":
            got = model.apply_with_ctx(ti, model.precompute_seq(ts))
            ref = jdeepfm.apply_with_ctx(jp, ji, jdeepfm.precompute_seq(jp, js))
        elif fn == "apply_from_emb":
            ctx = model.ctx_from_seq_emb(torch.as_tensor(seq_e, dtype=torch.float32),
                                         torch.as_tensor(pad))
            got = model.apply_from_emb(torch.as_tensor(item_e, dtype=torch.float32), ctx)
            ref = jdeepfm.apply_from_emb(
                jp, jnp.asarray(item_e, jnp.float32),
                jdeepfm.ctx_from_seq_emb(jp, jnp.asarray(seq_e, jnp.float32), jnp.asarray(pad)))
        else:
            got = torch.cat([c.reshape(len(seqs), -1) for c in model.ctx_from_seq_emb(
                torch.as_tensor(seq_e, dtype=torch.float32), torch.as_tensor(pad))], 1)
            ref = jnp.concatenate([c.reshape(len(seqs), -1) for c in jdeepfm.ctx_from_seq_emb(
                jp, jnp.asarray(seq_e, jnp.float32), jnp.asarray(pad))], 1)
            np.testing.assert_allclose(
                got.numpy(), np.concatenate([c.reshape(len(seqs), -1) for c in
                                             jdeepfm.precompute_seq(jp, js)], 1),
                rtol=SCORE_RTOL, atol=SCORE_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_init_is_seeded_and_launches_no_kernel():
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    a, b = DeepFM(31, E, L, device="cpu", generator=gen()), DeepFM(31, E, L, device="cpu",
                                                                  generator=gen())
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert a.mlp1.weight.shape == (L + 1, (L + 1) * E) and a.seq_len == L
    assert float(a.mlp1.bias.detach().abs().sum()) == 0.0
    assert 0.03 < float(a.embedding.std()) < 0.07  # N(0, 0.05)
    k1, k3 = din_kernel.launches, packed_level_kernel.launches
    a(torch.zeros(2, 3, dtype=torch.long), torch.zeros(2, L, dtype=torch.long)).sum().backward()
    assert (din_kernel.launches, packed_level_kernel.launches) == (k1, k3)
    assert a.embedding.grad is not None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_either_package(tmp_path, writer):
    p = _params(63, L, 5)
    path = str(tmp_path / "deepfm")
    meta = {"model": "deepfm", "embed_size": E, "seq_len": L}
    if writer == "jax":
        jax_save_pytree(path, _jax(p), meta=meta)
    else:
        save_pytree(path, deepfm_params_from_numpy(p, device="cpu").params_numpy(), meta=meta)
    like = jdeepfm.init_params(jax.random.PRNGKey(0), 63, E, L)
    model = DeepFM(63, E, L, device="cpu")
    model.load_numpy(load_pytree(path, model.param_tree()))
    assert load_meta(path) == meta
    for got, ref in ((model.params_numpy(), p), (_np(jax_load_pytree(path, like)), p)):
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------- serving
def _seqs(tree, batch=8, seq_len=10, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.choice(tree.item_ids, size=(batch, seq_len)).astype(np.int64)
    raw[0, 3:] = 0
    raw[1, :] = 0
    return raw


def test_packed_matches_classic(pipeline):
    """tests/test_packed_beam.py::test_packed_matches_classic_deepfm in the
    port: the packed loop scores DeepFM's levels through its own
    apply_from_emb on the gathered rows, with no kernel."""
    _, _, tree, _ = pipeline
    model = deepfm_params_from_numpy(_params(tree.total_codes, 10, 9), device="cpu")
    codes = torch.as_tensor(tree.ids_to_codes(_seqs(tree, seed=7)), dtype=torch.long)
    pre, app = serving_fns("deepfm")
    classic = make_beam_fn(DeepFM.forward, tree, 4, precompute=pre, apply=app, device="cpu")
    packed = make_packed_beam_fn(make_packed_tree(tree, model.embedding.detach(), 4),
                                 packed_fns("deepfm")[0])
    k3 = packed_level_kernel.launches
    ids_c, sc_c = classic(model, codes)
    ids_p, sc_p = packed(model, codes)
    assert packed_level_kernel.launches == k3
    for i in range(len(codes)):  # block order against interleaved: compare as sets
        oc, op = np.argsort(ids_c[i].numpy()), np.argsort(ids_p[i].numpy())
        np.testing.assert_array_equal(ids_p[i].numpy()[op], ids_c[i].numpy()[oc])
        alive = ids_c[i].numpy()[oc] >= 0
        np.testing.assert_allclose(sc_p[i].numpy()[op][alive], sc_c[i].numpy()[oc][alive],
                                   rtol=1e-6)


@pytest.mark.parametrize("route", ["packed", "classic"])
def test_tdm_serving_matches_jax(pipeline, tmp_path, route):
    """A DeepFM checkpoint the JAX package saved, served by both facades: the
    same lists and predict scores; the auto table rule keeps DeepFM on f32
    even past the bf16 threshold (tests/test_packed_beam.py:388)."""
    path, jtree, tree, _ = pipeline
    ckpt = str(tmp_path / "deepfm")
    jax_save_pytree(ckpt, _jax(_params(tree.total_codes, 10, 11)),
                    meta={"model": "deepfm", "embed_size": E, "seq_len": 10})
    kw = dict(topk=5, candidate_num=4, packed=route == "packed")
    serv = TDMServing.load(ckpt, path, device="cpu", **kw)
    jserv = JTDMServing.load(ckpt, path, **kw)
    assert serv.model_type == "deepfm" and isinstance(serv.params, DeepFM)
    serv._BF16_TABLE_BYTES = 0
    assert serv.pair_table_dtype() == torch.float32
    raw = _seqs(tree, seed=5)
    for got, ref in zip(serv.recommend_batch(raw), jserv.recommend_batch(raw)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(serv.recommend(raw[2], consumed=raw[2, :3]),
                                  jserv.recommend(raw[2], consumed=raw[2, :3]))
    items = tree.item_ids[:20].astype(np.int64)
    np.testing.assert_allclose(serv.predict(raw[3], items), jserv.predict(raw[3], items),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)


# ---------------------------------------------------------------- steps
def _assert_params(got: dict, ref: dict):
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_params(got[k], ref[k])
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]),
                                       rtol=P_RTOL, atol=P_ATOL, err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_step_from_carried_jax_state_matches_jax(pipeline, mode):
    """The JAX DeepFM trainer's params and optimizer state carried to the
    port, then one step on the JAX sampler's batch in both packages."""
    _, jtree, tree, samples = pipeline
    jtr = JTDMTrainer(tree=jtree, **TDM_KW, **MODES[mode])
    assert (jtr._sparse, jtr._pmv) == (mode != "dense", mode == "pmv")
    n = jtr.num_targets_per_batch
    sc = jtree.ids_to_codes(samples.train_seqs[:n])
    tc = jtree.ids_to_codes(samples.train_targets[:n])
    tr = TDMTrainer(tree=tree, device="cpu", **TDM_KW, **MODES[mode])
    assert isinstance(tr.model, DeepFM)
    tr.load_numpy(_np(jtr.params), _np(jtr.opt_state))
    sstate = jtr.sampler.device_state()
    codes, labels, weights = jax.jit(jtr.sampler.sample)(
        jax.random.PRNGKey(3), jnp.asarray(tc), sstate)
    jtr.sampler.sample = lambda *_: (codes, labels, weights)
    carry = ({k: v for k, v in jtr.params.items() if k != "embedding"}
             if mode == "pmv" else jtr.params)
    jp, jo, jloss = jax.jit(jtr._step_impl)(carry, jtr.opt_state, jax.random.PRNGKey(3),
                                            jnp.asarray(tc), jnp.asarray(sc), sstate)
    loss = tr.step_from_samples(
        *(torch.tensor(np.asarray(a)) for a in (sc, codes, labels, weights)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    if mode == "pmv":
        np.testing.assert_allclose(tr.emb_state["pmv"].numpy(), np.asarray(jo[1]["pmv"]),
                                   rtol=P_RTOL, atol=P_ATOL)
        tr._sync_mirrors()
        jp = dict(jp, embedding=sparse_adam.pmv_unpack(
            {"pmv": torch.tensor(np.asarray(jo[1]["pmv"]))}, *tr.model.embedding.shape))
    _assert_params(tr.params, jp)
    assert tr.adam["count"] == 1


def test_bf16_table_is_refused_for_deepfm(pipeline, tmp_path):
    """A bf16 DeepFM table is no longer refused: it is served as the JAX
    package serves it.  The JAX package's trained bf16 DeepFM params in the
    port's trainer: ``evaluate``'s metrics and ``recommend``'s top-10 (a
    heavy user's widened beam) equal the JAX trainer's; the port's
    checkpoint of that trainer through ``TDMServing.load`` takes the packed
    route over an f32 pair table (DeepFM is not matmul-first) and gives the
    JAX facade's top-10 on the same bf16 params."""
    path, jtree, tree, samples = pipeline
    kw = {**TDM_KW, "topk": 10}
    jtr = JTDMTrainer(tree=jtree, embed_dtype=jnp.bfloat16, **kw)
    jtr.train(samples.train_seqs, samples.train_targets, iterations=20, progress_interval=20)
    tr = TDMTrainer(tree=tree, device="cpu", embed_dtype=torch.bfloat16, **kw)
    tr.load_numpy(_np(jtr.params))
    assert tr.model.embedding.dtype == torch.bfloat16
    n = 48
    eval_data = (samples.eval_seqs[:n], samples.eval_labels[:n], samples.eval_users[:n])
    ev, jev = (t.evaluate(eval_data, samples.user_consumed) for t in (tr, jtr))
    for k in ("precision", "recall", "ndcg"):  # the eval loss draws each package's negatives
        np.testing.assert_allclose(getattr(ev, k), getattr(jev, k), rtol=1e-12, err_msg=k)
    heavy = max(samples.user_consumed, key=lambda u: len(samples.user_consumed[u]))
    consumed = samples.user_consumed[heavy]
    seq = samples.eval_seqs[0]
    np.testing.assert_array_equal(tr.recommend(seq, consumed=consumed),
                                  jtr.recommend(seq, consumed=consumed))
    ckpt = str(tmp_path / "deepfm_bf16")
    save_pytree(ckpt, tr.params, meta={"model": "deepfm", "embed_size": E, "seq_len": 10})
    serv = TDMServing.load(ckpt, path, device="cpu", topk=10, candidate_num=20)
    pre, app = jax_serving_fns("deepfm")
    jserv = JTDMServing(jtr.params, jtr.forward, jtree, precompute=pre, apply=app,
                        apply_emb=jax_packed_fns("deepfm")[1], model_type="deepfm",
                        topk=10, candidate_num=20)
    assert serv._use_packed(20) and jserv._use_packed(20)
    serv._BF16_TABLE_BYTES = 0
    assert serv.pair_table_dtype() == torch.float32
    raw = samples.eval_seqs[:n]
    for got, ref in zip(serv.recommend_batch(raw), jserv.recommend_batch(raw)):
        np.testing.assert_array_equal(got, ref)
    assert serv._pair_table.dtype == torch.float32
    np.testing.assert_array_equal(serv._pair_table[:, : 2 * E].reshape(-1, E).numpy(),
                                  tr.model.embedding.detach()[1:].float().numpy())


# ---------------------------------------------------------------- OTM
def test_one_otm_batch_matches_jax(small_csv):
    """One OTM DeepFM batch (pseudo targets, trajectory, n_levels Adam steps)
    from the same params in both packages: per-level losses and params."""
    d = build_otm_data(small_csv, seq_len=10, min_seq_len=2, split_ratio=0.8,
                       leaf_init_mode="category", label_num=3, seed=1)
    d = dataclasses.replace(d, eval_seqs=d.eval_seqs[:8], eval_labels=d.eval_labels[:8],
                            eval_users=d.eval_users[:8])
    kw = dict(model_type="deepfm", embed_size=E, beam_size=4, topk=5, learning_rate=3e-3,
              total_train_batch_size=256, total_eval_batch_size=256, seed=0, seq_len=10)
    p = _params(d.num_tree_nodes, 10, 2)
    jtr = jotm.OTMTrainer(d, **kw)
    with jtr._ctx():
        jtr.params = _jax(p)
    tr = OTMTrainer(d, device="cpu", **kw)
    tr.load_numpy(p)
    seqs, targets = d.train_seqs[:32], d.train_labels[:32]
    with jtr._ctx():
        jtr.params, jtr.opt_state, j_losses = jtr._train_batch(
            jtr.params, jtr.opt_state, jnp.asarray(seqs, jnp.int32),
            jnp.asarray(targets, jnp.int32))
    losses = tr._train_batch(*(torch.as_tensor(a, dtype=torch.long) for a in (seqs, targets)))
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), rtol=LOSS_RTOL)
    _assert_params(tr.params, _np(jtr.params))


# ---------------------------------------------------------------- CLI
TDM_CONF = """
init.seq_len             10
init.min_seq_len         2
init.split_for_eval      true
init.split_ratio         0.8
init.data_path           data/example.csv
init.train_path          data/train.csv
init.eval_path           data/eval.csv
init.stat_path           data/stat.txt
init.leaf_id_path        data/leaf.txt
init.tree_protobuf_path  data/tree.bin
init.user_consumed_path  data/consumed.txt

model.deep_model         DeepFM
model.train_path         data/train.csv
model.eval_path          data/eval.csv
model.tree_protobuf_path data/tree.bin
model.user_consumed_path data/consumed.txt
model.evaluate_during_training false
model.total_batch_size   2048
model.total_eval_batch_size 2048
model.seq_len            10
model.layer_negative_counts {neg}
model.sample_with_probability false
model.start_sample_level 1
model.embed_size         8
model.learning_rate      3e-3
model.iteration_number   10
model.show_progress_interval 10
model.topk_number        10
model.beam_size          20
model.model_path         data/model.bin
model.embed_path         data/embed.csv

cluster.embed_path          data/embed.csv
cluster.tree_protobuf_path  data/tree.bin
cluster.cluster_type        kmeans
cluster.cluster_iter        3

tree.data_path            data/train.csv
tree.model_path           data/model.bin
tree.tree_protobuf_path   data/tree.bin
tree.deep_model           DeepFM
tree.gap                  2
tree.seq_len              10
tree.hierarchical_preference false
tree.min_level            0
""".format(neg=NEG)


def test_tdm_jtm_cli_with_deepfm(small_csv, tmp_path, monkeypatch):
    """init -> train -> cluster -> jtm-tree-learning with
    ``model.deep_model DeepFM`` on the CPU; the checkpoint is a DeepFM the
    JAX package loads, and every stage's tree keeps its items on distinct
    leaves."""
    (tmp_path / "data").mkdir()
    shutil.copy(small_csv, tmp_path / "data" / "example.csv")
    (tmp_path / "tdm.conf").write_text(TDM_CONF)
    monkeypatch.chdir(tmp_path)
    items = None
    for command in ("tdm-initialize-tree", "tdm-train-deep-model", "tdm-cluster-tree",
                    "jtm-tree-learning"):
        assert cli([command, "--conf", "tdm.conf", "--device", "cpu", "--quiet"]) == 0
        tree = ArrayTree.from_file(str(tmp_path / "data" / "tree.bin"))
        items = items or set(tree.item_ids.tolist())
        assert set(tree.item_ids.tolist()) == items, command
        assert len(np.unique(tree.item_codes)) == tree.num_items, command
    path = str(tmp_path / "data" / "model.bin")
    assert load_meta(path)["model"] == "deepfm"
    like = jdeepfm.init_params(jax.random.PRNGKey(0), tree.total_codes, E, 10)
    assert jax.tree.structure(jax_load_pytree(path, like)) == jax.tree.structure(like)


def test_otm_cli_with_deepfm(small_csv, tmp_path, monkeypatch):
    """otm-train-deep-model -> otm-construct-tree -> otm-train-deep-model
    under the learned mapping with DeepFM on the CPU (a cut of
    configs/otm.conf: one epoch, E = 8), then OTMServing."""
    (tmp_path / "data").mkdir()
    shutil.copy(small_csv, tmp_path / "data" / "example_data.csv")
    cut = {"model.deep_model": "DeepFM", "tree.deep_model": "DeepFM", "model.epoch_num": "1",
           "model.embed_size": str(E), "model.train_batch_size": "2048"}
    lines = []
    for ln in (REPO / "configs" / "otm.conf").read_text().splitlines():
        key = ln.split()[0] if ln.strip() and not ln.startswith("#") else None
        lines.append(f"{key} {cut[key]}" if key in cut else ln)
    conf = tmp_path / "otm.conf"
    conf.write_text("\n".join(lines) + "\n")
    monkeypatch.chdir(tmp_path)
    run = lambda c: cli([c, "--conf", "otm.conf", "--device", "cpu", "--quiet"])  # noqa: E731
    assert run("otm-train-deep-model") == 0
    assert load_meta(str(tmp_path / "data" / "otm_model.bin"))["model"] == "deepfm"
    first = (tmp_path / "data" / "otm_mapping.txt").read_text()
    assert run("otm-construct-tree") == 0
    assert (tmp_path / "data" / "otm_mapping.txt").read_text() != first
    conf.write_text(conf.read_text().replace("model.initialize_mapping        true",
                                             "model.initialize_mapping        false"))
    assert run("otm-train-deep-model") == 0
    serv = OTMServing.load(str(tmp_path / "data" / "otm_model.bin"),
                           str(tmp_path / "data" / "otm_mapping.txt"),
                           str(tmp_path / "data" / "example_data.csv"), device="cpu")
    assert isinstance(serv._trainer.model, DeepFM)
    data = serv._trainer.data
    full = data.eval_seqs[(data.eval_seqs >= 0).all(axis=1)][0]  # DeepFM takes L positions
    rec = serv.recommend(np.asarray([data.code_to_item[int(c)] for c in full]))
    assert len(rec) == 10 and len(set(rec.tolist())) == 10
