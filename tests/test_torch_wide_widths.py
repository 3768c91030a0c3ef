"""K1 and K3 at the wide embedding widths E = 64, 96 and 128, held on the CPU.

The CUDA instances at those widths run only on the card (``chip_smoke.py``'s
build and wide phases); here their plain versions, which the wrappers take
for CPU tensors, go against the JAX package's Pallas kernels (interpret
mode), the packed serving route at E = 64 and 128 against the JAX facade on
the Pallas level body, the sparse route and dense steps against the JAX
trainer, the wide-scorer recipe script on the CPU, and the width gate that
lets these widths onto the card."""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core.checkpoint import save_pytree
from dismember_tpu.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu.data.tdm_dataset import generate_split_samples
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.ops.din_kernel import din_forward_pallas
from dismember_tpu.ops.packed_level_kernel import packed_level_pallas
from dismember_tpu.retrieval.packed_beam import make_packed_beam_fn_pallas
from dismember_tpu.retrieval.packed_beam import make_packed_tree as j_make_packed_tree
from dismember_tpu.serving import TDMServing as JTDMServing
from dismember_tpu.train import sparse_adam as j_sparse_adam
from dismember_tpu.train.sampler import TreeSampler as JTreeSampler
from dismember_tpu.train.tdm import TDMTrainer as JTDMTrainer
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.ops.din_kernel import KERNEL_WIDTHS, check_kernel_width
from dismember_tpu_torch.ops import packed_level_kernel
from dismember_tpu_torch.ops.packed_level_kernel import NEG_INF, packed_level, pair_row_width
from dismember_tpu_torch.serving import TDMServing
from dismember_tpu_torch.train import sparse_adam
from dismember_tpu_torch.train.sampler import TreeSampler
from dismember_tpu_torch.train.tdm import TDMTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RTOL, ATOL = 2e-4, 1e-5  # tests/test_pallas_din.py's tolerance
# tests/test_tdm_train.py's dense tolerances: loss rtol 1e-5; params rtol
# 2e-4, atol 2e-6 (summation order of the f32 backward)
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 2e-6
WIDE = (64, 96, 128)
NEG = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"


def _params(rng, num_index, e, std=0.3):
    f = lambda *s: rng.normal(0, std, s).astype(np.float32)  # noqa: E731
    return {"embedding": f(num_index, e), "att_linear": {"weight": f(e, e)},
            "mlp1": {"weight": f(e, 2 * e), "bias": f(e)},
            "mlp2": {"weight": f(1, e), "bias": f(1)}}


def _jax(params):
    return jax.tree.map(jnp.asarray, params)


def _level_inputs(rng, b, beam, e, l):
    """f32 pair rows of the JAX width (2 base-4096 id digits a child)."""
    rows = np.zeros((b, beam, pair_row_width(e)), np.float32)
    rows[..., : 2 * e] = rng.normal(0, 0.5, (b, beam, 2 * e))
    rows[..., 2 * e : 2 * e + 2] = rng.random((b, beam, 2)) < 0.85
    ids = rng.integers(-1, 1 << 20, (b, beam, 2))
    rows[..., 2 * e + 2 : 2 * e + 6] = np.stack([ids // 4096, ids % 4096], -1).reshape(b, beam, 4)
    alive = rng.random((b, beam)) < 0.9
    alive[1] = False
    pad = (rng.random((b, l)) < 0.3).astype(np.float32)
    pad[0] = 1.0
    seq_e = rng.normal(0, 0.5, (b, l, e)).astype(np.float32)
    seq_e[pad > 0] = 0.0
    return rows, alive, seq_e, pad


@pytest.mark.parametrize("e", WIDE)
@pytest.mark.parametrize("u,l", [(40, 10), (2, 24)])
def test_k1_plain_matches_pallas_at_wide_width(e, u, l):
    """K1's plain version at the serving and the long-sequence shapes."""
    rng = np.random.default_rng(e * 10 + u + l)
    p = _params(rng, 127, e, std=0.3 * (16 / e) ** 0.5)
    items = rng.integers(-1, 127, (4, u))
    seqs = rng.integers(-1, 127, (4, l))
    seqs[0] = -1
    pal = np.asarray(din_forward_pallas(_jax(p), jnp.asarray(items), jnp.asarray(seqs),
                                        tile_b=2, interpret=True))
    with torch.inference_mode():
        got = params_from_numpy(p, device="cpu")(torch.as_tensor(items),
                                                 torch.as_tensor(seqs)).numpy()
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("e", WIDE)
def test_k3_plain_matches_pallas_at_wide_width(e):
    rng = np.random.default_rng(e)
    p = _params(rng, 31, e, std=0.3 * (16 / e) ** 0.5)
    rows, alive, seq_e, pad = _level_inputs(rng, 4, 20, e, 10)
    js, jh = packed_level_pallas(_jax(p), jnp.asarray(rows), jnp.asarray(alive),
                                 jnp.asarray(seq_e), jnp.asarray(pad), e, tile_b=2,
                                 interpret=True)
    with torch.inference_mode():
        ts, th = packed_level(*(torch.as_tensor(a) for a in (rows, alive, seq_e, pad)),
                              *params_from_numpy(p, device="cpu").scorer_weights(), e)
    np.testing.assert_array_equal(th.numpy().view(np.int32), np.asarray(jh).view(np.int32))
    np.testing.assert_array_equal(ts.numpy() > NEG_INF / 2, np.asarray(js) > NEG_INF / 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


def test_k3_bf16_rows_score_as_f32_rows_at_e128():
    """A bf16 pair row (4 base-256 digits a child, 266 used lanes of 384)
    scores bit for bit as an f32 row holding the same bf16-grid values."""
    e = 128
    rng = np.random.default_rng(e)
    w = params_from_numpy(_params(rng, 31, e, std=0.1), device="cpu").scorer_weights()
    rows, alive, seq_e, pad = (torch.as_tensor(a) for a in _level_inputs(rng, 4, 12, e, 10))
    emb = rows[..., : 2 * e + 2].to(torch.bfloat16)
    b16 = torch.zeros(4, 12, pair_row_width(e, torch.bfloat16), dtype=torch.bfloat16)
    assert b16.shape[2] == 384
    b16[..., : 2 * e + 2] = emb
    b16[..., 2 * e + 2 : 2 * e + 10] = torch.as_tensor(rng.integers(0, 128, (4, 12, 8)),
                                                       dtype=torch.bfloat16)
    f32 = torch.zeros(4, 12, pair_row_width(e))
    f32[..., : 2 * e + 2] = emb.float()
    with torch.inference_mode():
        s16, d16 = packed_level(b16, alive, seq_e, pad, *w, e)
        s32, _ = packed_level(f32, alive, seq_e, pad, *w, e)
    assert d16.dtype == torch.bfloat16 and d16.shape == (4, 24, 4)
    assert torch.equal(d16[:, 12:], b16[..., 2 * e + 6 : 2 * e + 10])
    assert torch.equal(s16, s32)


@pytest.mark.parametrize("e", [64, 128])
def test_packed_serving_matches_jax_at_wide_width(tmp_path, small_csv, e):
    """TDMServing.load of a DIN checkpoint at E = 64 and 128 on the packed
    route (256- and 384-lane pair rows) against the JAX facade served
    through the Pallas level body, from tie-free seeded weights."""
    raw = read_csv(small_csv)
    ids, cats = unique_items_with_category(raw)
    sid, codes = category_sorted_codes(ids, cats)
    tree_path = str(tmp_path / "tree.bin")
    write_tree(tree_path, sid, codes)
    jtree = JArrayTree.from_file(tree_path)
    p = _params(np.random.default_rng(e), jtree.total_codes, e, std=0.5 * (16 / e) ** 0.5)
    ckpt = str(tmp_path / "din")
    save_pytree(ckpt, _jax(p), meta={"model": "din", "embed_size": e, "seq_len": 10})
    serv = TDMServing.load(ckpt, tree_path, device="cpu", topk=5, candidate_num=4, packed=True)
    assert serv._use_packed(4)
    jserv = JTDMServing.load(ckpt, tree_path, topk=5, candidate_num=4, packed=True)
    jserv._beam_fns[4] = make_packed_beam_fn_pallas(
        j_make_packed_tree(jtree, jnp.asarray(p["embedding"]), beam=4), tile_b=4,
        interpret=True)
    rng = np.random.default_rng(e + 1)
    seqs = rng.choice(jtree.item_ids, size=(6, 10)).astype(np.int64)
    seqs[0, 4:] = 0
    for got, ref in zip(serv.recommend_batch(seqs), jserv.recommend_batch(seqs)):
        np.testing.assert_array_equal(got, ref)
    assert serv._pair_table.shape[1] == pair_row_width(e)


@pytest.fixture(scope="module")
def pipeline(small_csv, tmp_path_factory):
    raw = read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    path = str(tmp_path_factory.mktemp("tree") / "tree.bin")
    write_tree(path, sorted_ids, codes, stat=samples.stat)
    return JArrayTree.from_file(path), ArrayTree.from_file(path), samples


@pytest.mark.parametrize("e", WIDE)
def test_auto_route_matches_jax_at_wide_width(pipeline, tmp_path, e):
    """``sparse_format="auto"`` picks the JAX trainer's route: on a table
    above 2^20 rows the cost model (the trainer's own call, with a 20-level
    tree's sampler unit) answers as the JAX package's, sparse at E = 64 and,
    where the split format's dearer rows still pay, at 2^25 rows for 96 and
    128; the sparse step then takes the JAX format: no pmv past E = 42 (3E
    > 128), packed m|v rows at E = 64 only (2E divides 128), split m and v
    at 96 and 128."""
    jtree, tree, _ = pipeline
    leaves = np.arange(64) * (1 << 14) + (1 << 20) - 1  # 64 leaves at level 20
    write_tree(str(tmp_path / "deep.bin"), np.arange(1, 65), leaves)
    deep = JArrayTree.from_file(str(tmp_path / "deep.bin"))
    assert deep.max_level == 20
    unit = JTreeSampler.build(deep, NEG).unit
    port_deep = ArrayTree.from_file(str(tmp_path / "deep.bin"))
    assert TreeSampler.build(port_deep, NEG, device="cpu").unit == unit
    targets = max(1, 8192 // unit)
    touched = targets * (unit + 10)
    rows = (1 << (deep.max_level + 1)) - 1
    assert rows > 1 << 20
    # the JAX cost model's answer at this table, and at 2^25 rows (the 10M
    # catalog's), where every width goes sparse
    for n in (rows, (1 << 25) - 1):
        assert (sparse_adam.sparse_worthwhile(n, touched, embed_dim=e)
                == j_sparse_adam.sparse_worthwhile(n, touched, embed_dim=e))
    assert j_sparse_adam.sparse_worthwhile(rows, touched, embed_dim=e) == (e == 64)
    assert sparse_adam.sparse_worthwhile((1 << 25) - 1, touched, embed_dim=e)
    kw = dict(embed_size=e, layer_neg_counts=NEG, sparse_embed_update=True, sparse_format="auto")
    j = JTDMTrainer(tree=jtree, **kw)
    t = TDMTrainer(tree=tree, device="cpu", **kw)
    assert (t._sparse, t._pmv) == (j._sparse, j._pmv) == (True, False)
    assert set(t.emb_state) == set(j.opt_state[1])
    assert ("mv" in t.emb_state) == (e == 64)
    assert sparse_adam.pmv_slots(e) == j_sparse_adam.pmv_slots(e) == 0


@pytest.mark.parametrize("e", [64, 128])
def test_dense_steps_match_jax_at_wide_width(pipeline, e):
    """Three dense steps from the JAX trainer's init, each on the batch the
    JAX sampler drew for it, land within the dense tolerances, at
    configs/tdm.conf's learning rate.  (At the recipe's 3e-3 one table entry
    of 524,224 at E = 64, whose gradient sums to ~1e-9, f32 noise, moves
    2e-5 apart by the third step: Adam's m / (sqrt(v) + eps) with sqrt(v)
    below eps scales that noise by lr / eps, in either package.)"""
    jtree, tree, samples = pipeline
    kw = dict(model_type="din", embed_size=e, learning_rate=1e-4, total_batch_size=512,
              layer_neg_counts=NEG, seed=3, topk=5, beam_size=8, sparse_embed_update=False)
    jtr = JTDMTrainer(tree=jtree, **kw)
    tr = TDMTrainer(tree=tree, device="cpu", **kw)
    tr.load_numpy(jax.tree_util.tree_map(np.asarray, jtr.params),
                  jax.tree_util.tree_map(np.asarray, jtr.opt_state))
    n = jtr.num_targets_per_batch
    sstate = jtr.sampler.device_state()
    sample = jax.jit(jtr.sampler.sample)
    for step in range(3):
        sc = jtree.ids_to_codes(samples.train_seqs[step * n : (step + 1) * n])
        tc = jtree.ids_to_codes(samples.train_targets[step * n : (step + 1) * n])
        drawn = sample(jax.random.PRNGKey(step), jnp.asarray(tc), sstate)
        jtr.sampler.sample = lambda *_, d=drawn: d
        jtr.params, jtr.opt_state, jloss = jtr._step_impl(
            jtr.params, jtr.opt_state, jax.random.PRNGKey(step), jnp.asarray(tc),
            jnp.asarray(sc), sstate)
        loss = tr.step_from_samples(
            *(torch.tensor(np.asarray(a)) for a in (sc, *drawn)))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    got = tr.params
    for path, ref in jax.tree_util.tree_flatten_with_path(jtr.params)[0]:
        keys = [k.key for k in path]
        g = got
        for k in keys:
            g = g[k]
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(ref), rtol=P_RTOL,
                                   atol=P_ATOL, err_msg="/".join(keys))


def test_recipe_script_runs_three_stages_on_the_cpu(small_csv, tmp_path, capsys, monkeypatch):
    """scripts/quality_push_torch.py at E = 64 on the CPU: one line a stage,
    and each stage's tree holds every item at a leaf of its own."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    quality_push_torch = importlib.import_module("quality_push_torch")
    out = tmp_path / "push"
    quality_push_torch.main(["e64x6k", "--iters", "2", "--device", "cpu", "--csv", small_csv,
                             "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["run"] for ln in lines] == ["e64x6k-stage1-category", "e64x6k-stage2-cluster",
                                           "e64x6k-stage3-jtm"]
    assert all(ln["embed"] == 64 and ln["iters"] == 2 and ln["device"] == "cpu"
               and 0.0 <= ln["recall"] <= 1.0 for ln in lines)
    items = set(unique_items_with_category(read_csv(small_csv))[0].tolist())
    for i in (1, 2, 3):
        t = ArrayTree.from_file(str(out / f"e64x6k_t{i}.bin"))
        assert set(t.item_ids.tolist()) == items
        assert len(set(t.item_codes.tolist())) == len(items)


def test_widths_gate_lets_the_wide_widths_onto_the_card():
    """The wide widths pass the CUDA width check, 24 and 48 still raise, and
    chip_smoke holds every instance the build makes to a register cap and
    every built width to a flip share."""
    import chip_smoke

    assert set(WIDE) <= set(KERNEL_WIDTHS) == {e for e, _ in packed_level_kernel.launches_by_width}
    for e in WIDE:
        check_kernel_width("din", e, torch.device("cuda"))
    for e in (24, 48):
        with pytest.raises(ValueError, match="built for E in"):
            check_kernel_width("din", e, torch.device("cuda"))
    instances = {f"K1 E={e}" for e in KERNEL_WIDTHS} | {
        f"K3 E={e} {r} {t}" for e in KERNEL_WIDTHS for r in ("f32", "bf16")
        for t in ("one-tile", "tiles")}
    assert all(0 < chip_smoke.reg_cap(n) <= 255 for n in instances)
    assert set(chip_smoke.FLIP_SHARE) == set(KERNEL_WIDTHS)
    assert all(chip_smoke.FLIP_SHARE[e] <= 1e-2 for e in KERNEL_WIDTHS)
    assert chip_smoke.instance_name(
        "_ZN12_GLOBAL__N_121din_score_wide_kernelILi128EEEvPKfS2_S2_S2_Pfiii") == "K1 E=128"
