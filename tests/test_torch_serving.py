"""The port's serving slice against the JAX package: classic and packed beams,
``TDMServing`` end to end, the CUDA-by-default entry points, and the rule
that the port imports neither jax nor the JAX package."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core.checkpoint import save_pytree
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.models import din as jdin
from dismember_tpu.retrieval.packed_beam import make_packed_beam_fn_pallas
from dismember_tpu.retrieval.packed_beam import make_packed_tree as j_make_packed_tree
from dismember_tpu.retrieval.tree_beam import make_beam_fn as j_make_beam_fn
from dismember_tpu.serving import TDMServing as JTDMServing
from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.data.dr_dataset import DRData
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.models.din import DIN, params_from_numpy
from dismember_tpu_torch.models.dr_models import dr_params_from_numpy
from dismember_tpu_torch.retrieval.packed_beam import (
    build_pair_table,
    make_packed_beam_fn,
    make_packed_tree,
)
from dismember_tpu_torch.retrieval.tree_beam import make_beam_fn
from dismember_tpu_torch.serving import DRServing, TDMServing
from dismember_tpu_torch.train.dr import DRTrainer
from dismember_tpu_torch.train.sampler import TreeSampler
from dismember_tpu_torch.train.tdm import TDMTrainer, build_model, packed_fns, serving_fns

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-4, 1e-5
NEG_COUNTS = ",".join(str(min(i, 2**i - 1)) for i in range(12))


@pytest.fixture(scope="module", params=[16, 47, 300])
def tree_path(tmp_path_factory, request):
    # 47 items leave dead slots on the bottom level; 300 items give a
    # 9-level tree, which TDMServing serves through the packed loop
    n = request.param
    ids = np.arange(1, n + 1)
    cats = np.repeat(np.arange((n + 9) // 10), 10)[:n]
    sorted_ids, codes = category_sorted_codes(ids, cats)
    path = str(tmp_path_factory.mktemp("tree") / f"tree{n}.bin")
    write_tree(path, sorted_ids, codes)
    return path


def _params(tree, e=16, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jdin.init_params(jax.random.PRNGKey(seed), tree.total_codes, e)
    )


def _seqs(tree, batch=6, seq_len=8, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.choice(tree.item_ids, size=(batch, seq_len)).astype(np.int64)
    raw[0, 3:] = 0  # padding
    raw[1, :] = 0  # an all-padding query
    return raw


def _assert_same_sets(ids_p, sc_p, ids_j, sc_j):
    """Per row, the alive (id, score) pairs agree as id-sorted sets: the two
    top-k implementations order ties differently and K3 emits children
    block-ordered (tests/test_packed_beam.py)."""
    for i in range(len(ids_j)):
        ap, aj = ids_p[i] >= 0, ids_j[i] >= 0
        op, oj = np.argsort(ids_p[i][ap]), np.argsort(ids_j[i][aj])
        np.testing.assert_array_equal(ids_p[i][ap][op], ids_j[i][aj][oj])
        np.testing.assert_allclose(sc_p[i][ap][op], sc_j[i][aj][oj], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("beam", [4, 8])
def test_classic_beam_matches_jax(tree_path, beam):
    jtree, tree = JArrayTree.from_file(tree_path), ArrayTree.from_file(tree_path)
    p = _params(tree, seed=beam)
    raw = _seqs(tree, seed=beam)
    jfn = j_make_beam_fn(jdin.forward, jtree, beam=beam,
                         precompute=jdin.precompute_seq, apply=jdin.apply_with_ctx)
    ids_j, sc_j = jax.device_get(jfn(jax.tree_util.tree_map(jnp.asarray, p),
                                     jnp.asarray(jtree.ids_to_codes(raw))))
    pre, app = serving_fns("din")
    fn = make_beam_fn(DIN.forward, tree, beam, precompute=pre, apply=app, device="cpu")
    model = params_from_numpy(p, device="cpu")
    ids_p, sc_p = fn(model, torch.as_tensor(tree.ids_to_codes(raw), dtype=torch.long))
    _assert_same_sets(ids_p.numpy(), sc_p.numpy(), ids_j, sc_j)


@pytest.mark.parametrize("beam", [4, 8])
def test_packed_beam_matches_jax_pallas(tree_path, beam):
    jtree, tree = JArrayTree.from_file(tree_path), ArrayTree.from_file(tree_path)
    p = _params(tree, seed=10 + beam)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jpacked = j_make_packed_tree(jtree, jp["embedding"], beam=beam)
    raw = _seqs(tree, seed=20 + beam)
    jfn = make_packed_beam_fn_pallas(jpacked, tile_b=4, interpret=True)
    ids_j, sc_j = jax.device_get(jfn(jp, jnp.asarray(jtree.ids_to_codes(raw))))
    model = params_from_numpy(p, device="cpu")
    packed = make_packed_tree(tree, model.embedding.detach(), beam)
    np.testing.assert_array_equal(packed.pair_table.numpy(), np.asarray(jpacked.pair_table))
    fn = make_packed_beam_fn(packed, packed_fns("din")[0])
    ids_p, sc_p = fn(model, torch.as_tensor(tree.ids_to_codes(raw), dtype=torch.long))
    _assert_same_sets(ids_p.numpy(), sc_p.numpy(), ids_j, sc_j)


@pytest.mark.parametrize("route", ["auto", "classic"])
def test_tdm_serving_matches_jax(tree_path, tmp_path, route):
    """JAX TDMServing.load vs the port's TDMServing.load(device="cpu"): same
    item lists from recommend_batch and recommend, same predict scores."""
    jtree = JArrayTree.from_file(tree_path)
    p = _params(jtree, seed=3)
    ckpt = str(tmp_path / "din")
    save_pytree(ckpt, p, meta={"model": "din", "embed_size": 16, "seq_len": 8})
    kw = {} if route == "auto" else {"packed": False}
    jserv = JTDMServing.load(ckpt, tree_path, topk=5, candidate_num=4, **kw)
    serv = TDMServing.load(ckpt, tree_path, device="cpu", topk=5, candidate_num=4, **kw)
    packed = serv._use_packed(4)
    assert packed == (route == "auto" and jtree.max_level >= 8)
    if packed:
        # the JAX facade's packed loop scores in f32 on the CPU; K3 rounds
        # matmul operands to bf16 as the TPU's MXU does, so the reference
        # side serves through the Pallas level body (interpret mode)
        jpacked = j_make_packed_tree(jtree, jnp.asarray(p["embedding"]), beam=4)
        jserv._beam_fns[4] = make_packed_beam_fn_pallas(jpacked, tile_b=4, interpret=True)
    raw = _seqs(jtree, batch=8, seed=5)
    got, ref = serv.recommend_batch(raw), jserv.recommend_batch(raw)
    assert len(got) == len(ref) == len(raw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    consumed = raw[2, :3]
    np.testing.assert_array_equal(
        serv.recommend(raw[2], consumed=consumed),
        jserv.recommend(raw[2], consumed=consumed),
    )
    items = jtree.item_ids[:7]
    np.testing.assert_allclose(serv.predict(raw[3], items), jserv.predict(raw[3], items),
                               rtol=RTOL)


def test_recommend_batch_records_its_spans_and_serves_the_same_lists(tree_path, tmp_path):
    """With recording on, each recommend_batch call opens its spans once
    under one top-level span, counts one batch and one native filter pass
    (the packed loop's search span on the 300-item tree only), and serves
    the lists it serves with recording off."""
    tree = ArrayTree.from_file(tree_path)
    ckpt = str(tmp_path / "din")
    save_pytree(ckpt, _params(tree, seed=4), meta={"model": "din", "embed_size": 16,
                                                   "seq_len": 8})
    serv = TDMServing.load(ckpt, tree_path, device="cpu", topk=5, candidate_num=4)
    raw = _seqs(tree, batch=8, seed=6)
    consumed = [row[row > 0][:2] for row in raw]
    calls = 3
    off = [serv.recommend_batch(raw, consumed=consumed) for _ in range(calls)]
    profiling.reset()
    profiling.enable(True)
    try:
        on = [serv.recommend_batch(raw, consumed=consumed) for _ in range(calls)]
        snap = profiling.snapshot()
        tops = {r[4] for r in profiling._rec.raw}
    finally:
        profiling.enable(False)
        profiling.reset()
    for a, b in zip(off, on):
        assert len(a) == len(b) == len(raw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    names = {"serving.recommend_batch", "serving.codes", "serving.download",
             "tree_beam.filter_topk"}
    if serv._use_packed(4):
        names.add("packed_beam.search")
    assert {k: v["calls"] for k, v in snap["spans"].items()} == dict.fromkeys(names, calls)
    assert snap["counters"]["serving.batches"] == calls and len(tops) == calls
    assert snap["counters"]["tree_beam.filter_native"] == calls  # the native pass each batch
    top = snap["spans"]["serving.recommend_batch"]
    assert 0 <= top["self_s"] < top["total_s"]


def test_entry_points_need_cuda_unless_cpu_is_asked(tree_path, tmp_path, monkeypatch):
    tree = ArrayTree.from_file(tree_path)
    p = _params(tree)
    ckpt = str(tmp_path / "din")
    save_pytree(ckpt, p, meta={"model": "din", "embed_size": 16, "seq_len": 8})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDMServing.load(ckpt, tree_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("din", tree.max_level, 16, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(p)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_beam_fn(DIN.forward, tree, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDMTrainer(tree=tree, layer_neg_counts=NEG_COUNTS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TreeSampler.build(tree, NEG_COUNTS)
    dr_data = DRData(item_to_id={}, id_to_item={}, num_items=30,
                     train_seqs=np.zeros((4, 8), np.int64), train_targets=np.arange(4),
                     eval_seqs=np.zeros((0, 8), np.int64), eval_labels=np.zeros((0, 1), np.int64),
                     eval_users=np.zeros(0, np.int64), user_consumed={})
    dr_kw = dict(num_nodes=4, embed_size=8, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DRTrainer(dr_data, **dr_kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DRServing.load(str(tmp_path / "dr_model"), str(tmp_path / "dr_mapping"), "data.csv")
    dr = DRTrainer(dr_data, device="cpu", **dr_kw)
    assert dr.layer_params["embedding"].device == torch.device("cpu")
    layer = jax.tree.map(lambda t: t.numpy(), dr.layer_params)
    rerank = jax.tree.map(lambda t: t.numpy(), dr.rerank_params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dr_params_from_numpy(layer, rerank)
    assert dr_params_from_numpy(layer, rerank, device="cpu")[0]["heads"][2]["bias"].shape == (4,)
    serv = TDMServing.load(ckpt, tree_path, device="cpu")
    assert serv.device == torch.device("cpu")
    trainer = TDMTrainer(tree=tree, layer_neg_counts=NEG_COUNTS, device="cpu")
    assert trainer.device == trainer.sampler.exists_rows.device == torch.device("cpu")
    deepfm = build_model("deepfm", tree.max_level, 16, 8, device="cpu")
    assert deepfm.model_type == "deepfm" and deepfm.mlp1.weight.shape == (9, 9 * 16)
    with pytest.raises(ValueError, match="unknown deep model"):
        build_model("dssm", tree.max_level, 16, 8, device="cpu")
    # the bf16 pair table is ported: it builds on the CPU when the CPU is asked
    assert build_pair_table(torch.zeros(tree.total_codes, 16), tree.node_exists, tree.node_id,
                            tree.total_codes, dtype=torch.bfloat16).dtype == torch.bfloat16


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "dismember_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "examples" / "recommend_demo_torch.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "dismember_tpu", "ml_dtypes")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{f.relative_to(REPO)} imports {name}"


def test_ops_and_core_import_nothing_above_them():
    """The kernels (``ops/``) and the shared core (``core/``) sit below the
    retrieval loops, the trainers, the serving facades and the CLI: no
    module of theirs imports one of those, inside a function either."""
    pkg = REPO / "dismember_tpu_torch"
    files = sorted((pkg / "ops").rglob("*.py")) + sorted((pkg / "core").rglob("*.py"))
    assert len(files) > 5
    above = ("retrieval", "train", "serving", "cli")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{f.relative_to(REPO)}: a relative import"
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                parts = name.split(".")
                assert not (parts[0] == "dismember_tpu_torch" and len(parts) > 1
                            and parts[1] in above), f"{f.relative_to(REPO)} imports {name}"
