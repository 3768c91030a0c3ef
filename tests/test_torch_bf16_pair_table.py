"""The bf16 pair table in the port against the JAX package, mirroring
tests/test_packed_beam.py:208-275 and 320-335: the table bit for bit, the
chunked build, the id digits, the packed beam over it, and TDMServing's
automatic dtype choice.

Tolerances: tables and ids bit for bit (uint16 views for bf16), none.  A
bf16 table and an f32 table on the bf16 grid give the port's packed beam
bit-equal ids and scores (K3 rounds every embedding to bf16 anyway).
Against the JAX package's Pallas level body (interpret mode, K3's
reference; its CPU XLA path scores in f32), scores are held to the
serving tests' rtol 2e-4 / atol 1e-5 and ids compared as sets per row
(the two top-k implementations order ties differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.models import din as jdin
from dismember_tpu.retrieval import packed_beam as jpb
from dismember_tpu.serving import TDMServing as JTDMServing
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.models.din import DIN, params_from_numpy
from dismember_tpu_torch.ops.packed_level_kernel import (
    ID_BASE,
    ID_DIGITS,
    decode_id_digits,
    encode_id_digits,
)
from dismember_tpu_torch.retrieval import packed_beam as pb
from dismember_tpu_torch.serving import TDMServing
from dismember_tpu_torch.train.tdm import packed_fns, serving_fns

RTOL, ATOL = 2e-4, 1e-5
E = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and parallel test
    workers with a thread per core each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    # 300 items in categories of 10: a 9-level tree with dead slots
    ids = np.arange(1, 301)
    sorted_ids, codes = category_sorted_codes(ids, np.repeat(np.arange(30), 10))
    path = str(tmp_path_factory.mktemp("tree") / "tree.bin")
    write_tree(path, sorted_ids, codes)
    return JArrayTree.from_file(path), ArrayTree.from_file(path)


def _grid_params(tree, seed):
    """DIN params at O(1) scale with the embedding on the bf16 grid."""
    p = jax.tree_util.tree_map(np.asarray, jdin.init_params(jax.random.PRNGKey(seed),
                                                            tree.total_codes, E))
    rng = np.random.default_rng(seed)
    p["embedding"] = np.asarray(jnp.asarray(rng.standard_normal(p["embedding"].shape),
                                            jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))
    for k in ("att_linear", "mlp1", "mlp2"):
        p[k] = {n: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
                for n, v in p[k].items()}
    return p


def _seqs(tree, batch=6, seq_len=8, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.choice(tree.item_ids, size=(batch, seq_len)).astype(np.int64)
    raw[0, 3:] = 0  # padding
    raw[1, :] = 0  # an all-padding query
    return raw


def u16(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_bf16_table_equals_jax_bit_for_bit(trees, emb_dtype):
    """From an f32 embedding (rounded to nearest even) and from a bf16 one."""
    jtree, tree = trees
    emb = np.random.default_rng(1).standard_normal((tree.total_codes, E)).astype(np.float32)
    jemb = jnp.asarray(emb).astype(getattr(jnp, emb_dtype))
    temb = torch.from_numpy(emb).to(getattr(torch, emb_dtype))
    jt = jpb.build_pair_table(jemb, jtree.node_exists, jtree.node_id, jtree.total_codes,
                              dtype=jnp.bfloat16)
    t = pb.build_pair_table(temb, tree.node_exists, tree.node_id, tree.total_codes,
                            dtype=torch.bfloat16)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == tuple(jt.shape)
    assert t.shape[1] == pb.pair_row_width(E, torch.bfloat16) == 128
    np.testing.assert_array_equal(u16(t), u16(jt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_build_matches_one_shot(trees, monkeypatch, dtype):
    """Row-chunked builds (the threshold cut to 512 bytes: chunks of one f32
    row or two bf16 rows, the last one short) equal the one-shot build bit
    for bit."""
    _, tree = trees
    emb = torch.randn(tree.total_codes, E, generator=torch.Generator().manual_seed(3))
    dt = getattr(torch, dtype)
    one = pb.build_pair_table(emb, tree.node_exists, tree.node_id, tree.total_codes, dtype=dt)
    monkeypatch.setattr(pb, "_ONE_SHOT_BUILD_BYTES", 512)
    chunked = pb.build_pair_table(emb, tree.node_exists, tree.node_id, tree.total_codes,
                                  dtype=dt)
    assert torch.equal(one.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                       chunked.view(torch.int16 if dtype == "bfloat16" else torch.int32))


def test_id_digit_roundtrip():
    """Every id the tree codec can produce, -1 included, decodes exactly
    from both layouts' digits held in the lane dtype; the digits match the
    JAX package's."""
    ids = np.array([-1, 0, 1, 255, 256, 4095, 4096, 2**23 - 1, 2**23, 2**31 - 1, 2**31 - 2],
                   np.int64)
    for dtype in (torch.float32, torch.bfloat16):
        k, base = ID_DIGITS[dtype], ID_BASE[dtype]
        digits = encode_id_digits(ids, dtype)
        np.testing.assert_array_equal(digits, jpb._encode_id_digits(ids, k, base))
        lanes = torch.from_numpy(digits).to(dtype)
        assert torch.equal(lanes.float(), torch.from_numpy(digits))  # exact in the lane dtype
        np.testing.assert_array_equal(decode_id_digits(lanes, dtype).numpy(), ids)
    assert (ID_DIGITS[torch.float32], ID_BASE[torch.float32]) == jpb._id_layout(jnp.float32)
    assert (ID_DIGITS[torch.bfloat16], ID_BASE[torch.bfloat16]) == jpb._id_layout(jnp.bfloat16)
    assert jpb._id_layout(jnp.bfloat16) == (4, 256)


@pytest.mark.parametrize("beam", [4, 8])
def test_packed_beam_over_bf16_table(trees, beam):
    """On a bf16-grid embedding the port's packed beam over the bf16 table
    equals the one over the f32 table bit for bit (ids and scores), and the
    JAX package's packed beam (its K3 reference, the Pallas level body in
    interpret mode) over the same values; the JAX package's own packed beam
    over its bf16 table equals its f32 one in ids."""
    jtree, tree = trees
    p = _grid_params(tree, seed=beam)
    model = params_from_numpy(p, device="cpu")
    raw = _seqs(tree, seed=beam)
    codes = torch.as_tensor(tree.ids_to_codes(raw), dtype=torch.long)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        packed = pb.make_packed_tree(tree, model.embedding.detach(), beam, dtype=dt)
        assert packed.pair_table.dtype == dt
        out[dt] = pb.make_packed_beam_fn(packed, packed_fns("din")[0])(model, codes)
    assert torch.equal(out[torch.float32][0], out[torch.bfloat16][0])
    assert torch.equal(out[torch.float32][1].view(torch.int32),
                       out[torch.bfloat16][1].view(torch.int32))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jcodes = jnp.asarray(jtree.ids_to_codes(raw))
    jfn = jpb.make_packed_beam_fn_pallas(jpb.make_packed_tree(jtree, jp["embedding"], beam),
                                         tile_b=2, interpret=True)
    ids_j, sc_j = jax.device_get(jfn(jp, jcodes))
    ids_p, sc_p = (t.numpy() for t in out[torch.bfloat16])
    for i in range(len(ids_j)):
        ap, aj = ids_p[i] >= 0, ids_j[i] >= 0
        op, oj = np.argsort(ids_p[i][ap]), np.argsort(ids_j[i][aj])
        np.testing.assert_array_equal(ids_p[i][ap][op], ids_j[i][aj][oj])
        np.testing.assert_allclose(sc_p[i][ap][op], sc_j[i][aj][oj], rtol=RTOL, atol=ATOL)
    jid = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jpt = jpb.make_packed_tree(jtree, jp["embedding"], beam, dtype=dt)
        jid[dt] = jax.device_get(jpb.make_packed_beam_fn(jpt, jdin.precompute_seq,
                                                         jdin.apply_from_emb)(jp, jcodes))[0]
    np.testing.assert_array_equal(jid[jnp.bfloat16], jid[jnp.float32])


@pytest.mark.parametrize("model_type", ["din", None, "deepfm"])
@pytest.mark.parametrize("threshold", ["zero", "below", "at", "default"])
def test_serving_auto_dtype_matches_jax(trees, monkeypatch, model_type, threshold):
    """TDMServing's pair-table dtype against the JAX facade's over table
    sizes around the threshold (monkeypatched) and the scorers: bf16 only
    when the f32 table passes it and the scorer is matmul-first (None
    counts as DIN); explicit packed_dtype wins."""
    jtree, tree = trees
    p = _grid_params(tree, seed=2)
    f32_bytes = (tree.total_codes - 1) // 2 * pb.pair_row_width(E) * 4
    limit = {"zero": 0, "below": f32_bytes - 1, "at": f32_bytes, "default": None}[threshold]
    if limit is not None:
        monkeypatch.setattr(JTDMServing, "_BF16_TABLE_BYTES", limit)
        monkeypatch.setattr(TDMServing, "_BF16_TABLE_BYTES", limit)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    pre, app = serving_fns("din")
    model = params_from_numpy(p, device="cpu")
    for explicit in (None, "float32", "bfloat16"):
        jserv = JTDMServing(jp, jdin.forward, jtree, precompute=jdin.precompute_seq,
                            apply=jdin.apply_with_ctx, apply_emb=jdin.apply_from_emb,
                            packed=True, packed_dtype=explicit, model_type=model_type)
        serv = TDMServing(model, DIN.forward, tree, precompute=pre, apply=app,
                          apply_emb=packed_fns("din")[1], packed=True, packed_dtype=explicit,
                          model_type=model_type)
        jserv._beam_fn(4)
        serv._beam_fn(4)
        want = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
            jnp.dtype(jserv._pair_table.dtype).type]
        assert serv.pair_table_dtype() == serv._pair_table.dtype == want
    auto = TDMServing(model, DIN.forward, tree, precompute=pre, apply=app,
                      apply_emb=packed_fns("din")[1], model_type=model_type)
    expect_bf16 = threshold in ("zero", "below") and model_type != "deepfm"
    assert auto.pair_table_dtype() == (torch.bfloat16 if expect_bf16 else torch.float32)


def test_load_passes_packed_dtype(trees, tmp_path):
    """TDMServing.load hands packed_dtype to the constructor; a bf16 table
    serves the same lists as the f32 one on a bf16-grid model."""
    from dismember_tpu_torch.core.checkpoint import save_pytree

    _, tree = trees
    p = _grid_params(tree, seed=7)
    ckpt = str(tmp_path / "din")
    save_pytree(ckpt, p, meta={"model": "din", "embed_size": E, "seq_len": 8})
    path = str(tmp_path / "tree.bin")
    ids = np.arange(1, 301)
    write_tree(path, *category_sorted_codes(ids, np.repeat(np.arange(30), 10)))
    lists = {}
    for dt in ("float32", "bfloat16"):
        serv = TDMServing.load(ckpt, path, device="cpu", packed_dtype=dt, topk=5,
                               candidate_num=4)
        lists[dt] = serv.recommend_batch(_seqs(tree, batch=8, seed=4))
        assert serv._pair_table.dtype == getattr(torch, dt)
    for a, b in zip(lists["float32"], lists["bfloat16"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="packed_dtype"):
        TDMServing.load(ckpt, path, device="cpu", packed_dtype="float16")
