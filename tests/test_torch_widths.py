"""K1 and K3 at the embedding widths E = 8 and 32, held on the CPU.

The CUDA instances at those widths run only on the card
(``chip_smoke.py``'s build and kernels phases); here their plain versions,
which the wrappers take for CPU tensors, go against the JAX package's
Pallas kernels (interpret mode) at each width, the packed serving route at
E = 8 and 32 against the JAX facade on the Pallas level body, and the
wrapper's own width logic: the widths it launches and the pair-row width it
takes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core.checkpoint import save_pytree
from dismember_tpu.index.arraytree import ArrayTree as JArrayTree
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.ops.din_kernel import din_forward_pallas
from dismember_tpu.ops.packed_level_kernel import packed_level_pallas
from dismember_tpu.retrieval.packed_beam import build_pair_table, make_packed_beam_fn_pallas
from dismember_tpu.retrieval.packed_beam import make_packed_tree as j_make_packed_tree
from dismember_tpu.serving import TDMServing as JTDMServing
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.ops import packed_level_kernel
from dismember_tpu_torch.ops.din_kernel import KERNEL_WIDTHS
from dismember_tpu_torch.ops.packed_level_kernel import (
    NEG_INF,
    packed_level,
    pair_row_width,
)
from dismember_tpu_torch.serving import TDMServing

RTOL, ATOL = 2e-4, 1e-5  # tests/test_pallas_din.py's tolerance
WIDTHS = (8, 32)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    checks on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda")


def _params(rng, num_index, e, std=0.3):
    f = lambda *s: rng.normal(0, std, s).astype(np.float32)  # noqa: E731
    return {"embedding": f(num_index, e), "att_linear": {"weight": f(e, e)},
            "mlp1": {"weight": f(e, 2 * e), "bias": f(e)},
            "mlp2": {"weight": f(1, e), "bias": f(1)}}


def _jax(params):
    return jax.tree.map(jnp.asarray, params)


def _level_inputs(rng, b, beam, e, l):
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


@pytest.mark.parametrize("e", WIDTHS)
@pytest.mark.parametrize("u,l", [(40, 10), (4, 10), (2, 24)])
def test_k1_plain_matches_pallas_at_width(e, u, l):
    """K1's plain version at the serving, sweep and long-sequence shapes."""
    rng = np.random.default_rng(e * 10 + u + l)
    p = _params(rng, 127, e)
    items = rng.integers(-1, 127, (6, u))
    seqs = rng.integers(-1, 127, (6, l))
    seqs[0] = -1
    pal = np.asarray(din_forward_pallas(_jax(p), jnp.asarray(items), jnp.asarray(seqs),
                                        tile_b=2, interpret=True))
    with torch.inference_mode():
        got = params_from_numpy(p, device="cpu")(torch.as_tensor(items),
                                                 torch.as_tensor(seqs)).numpy()
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("e", WIDTHS)
@pytest.mark.parametrize("beam,l", [(20, 10), (5, 24), (110, 10)])
def test_k3_plain_matches_pallas_at_width(e, beam, l):
    rng = np.random.default_rng(e + beam + l)
    p = _params(rng, 31, e)
    rows, alive, seq_e, pad = _level_inputs(rng, 4, beam, e, l)
    js, jh = packed_level_pallas(_jax(p), jnp.asarray(rows), jnp.asarray(alive),
                                 jnp.asarray(seq_e), jnp.asarray(pad), e, tile_b=2,
                                 interpret=True)
    with torch.inference_mode():
        ts, th = packed_level(*(torch.as_tensor(a) for a in (rows, alive, seq_e, pad)),
                              *params_from_numpy(p, device="cpu").scorer_weights(), e)
    np.testing.assert_array_equal(th.numpy().view(np.int32), np.asarray(jh).view(np.int32))
    np.testing.assert_array_equal(ts.numpy() > NEG_INF / 2, np.asarray(js) > NEG_INF / 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("e", WIDTHS)
def test_k3_bf16_rows_score_as_f32_rows_at_width(e):
    """A bf16 pair row (4 base-256 digits a child, 2E + 10 used lanes) scores
    bit for bit as an f32 row holding the same bf16-grid values."""
    rng = np.random.default_rng(e)
    w = params_from_numpy(_params(rng, 31, e), device="cpu").scorer_weights()
    rows, alive, seq_e, pad = (torch.as_tensor(a) for a in _level_inputs(rng, 4, 12, e, 10))
    emb = rows[..., : 2 * e + 2].to(torch.bfloat16)
    b16 = torch.zeros(4, 12, pair_row_width(e, torch.bfloat16), dtype=torch.bfloat16)
    b16[..., : 2 * e + 2] = emb
    b16[..., 2 * e + 2 : 2 * e + 10] = torch.as_tensor(rng.integers(0, 128, (4, 12, 8)),
                                                       dtype=torch.bfloat16)
    f32 = torch.zeros(4, 12, pair_row_width(e))
    f32[..., : 2 * e + 2] = emb.float()
    with torch.inference_mode():
        s16, d16 = packed_level(b16, alive, seq_e, pad, *w, e)
        s32, _ = packed_level(f32, alive, seq_e, pad, *w, e)
    assert d16.dtype == torch.bfloat16 and d16.shape == (4, 24, 4)
    assert torch.equal(d16[:, :12], b16[..., 2 * e + 2 : 2 * e + 6])
    assert torch.equal(s16, s32)


def test_pair_rows_fit_one_128_lane_row_at_every_built_width():
    """A pair row is one 128-lane row up to E = 32 and, past it, as many as
    the JAX package's ``build_pair_table`` gives its rows (256 lanes at E =
    64 and 96, 384 at 128), at every built width and both row dtypes."""
    for e in KERNEL_WIDTHS:
        emb = jnp.zeros((7, e), jnp.float32)
        for dt, k in packed_level_kernel.ID_DIGITS.items():
            jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
            ref = build_pair_table(emb, np.ones(7, bool), np.arange(7, dtype=np.int32), 7, jdt)
            assert 2 * e + 2 + 2 * k <= pair_row_width(e, dt) == ref.shape[1]
            assert (pair_row_width(e, dt) == 128) == (e <= 32)


@pytest.mark.parametrize("e", [24, 48])
def test_wrapper_refuses_a_width_not_built(e):
    w = params_from_numpy(_params(np.random.default_rng(0), 7, e), device="cpu").scorer_weights()
    rows = torch.zeros(2, 3, pair_row_width(e)).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match=r"built for E in \[8, 16, 32, 64, 96, 128\]"):
        packed_level(rows, torch.ones(2, 3), torch.zeros(2, 4, e), torch.ones(2, 4), *w, e)


@pytest.mark.parametrize("e", WIDTHS)
def test_wrapper_checks_the_pair_row_width(e):
    w = params_from_numpy(_params(np.random.default_rng(0), 7, e), device="cpu").scorer_weights()
    rows = torch.zeros(2, 3, 2 * e + 6).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="rows has shape"):
        packed_level(rows, torch.ones(2, 3), torch.zeros(2, 4, e), torch.ones(2, 4), *w, e)


@pytest.mark.parametrize("e", WIDTHS)
def test_packed_serving_matches_jax_at_width(tmp_path, small_csv, e):
    """TDMServing.load of a DIN checkpoint at E = 8 and 32 on the packed
    route against the JAX facade served through the Pallas level body."""
    from dismember_tpu.data.ingest import read_csv, unique_items_with_category

    raw = read_csv(small_csv)
    ids, cats = unique_items_with_category(raw)
    sid, codes = category_sorted_codes(ids, cats)
    tree_path = str(tmp_path / "tree.bin")
    write_tree(tree_path, sid, codes)
    jtree = JArrayTree.from_file(tree_path)
    p = _params(np.random.default_rng(e), jtree.total_codes, e, std=0.5)
    ckpt = str(tmp_path / "din")
    save_pytree(ckpt, _jax(p), meta={"model": "din", "embed_size": e, "seq_len": 10})
    serv = TDMServing.load(ckpt, tree_path, device="cpu", topk=5, candidate_num=4, packed=True)
    jserv = JTDMServing.load(ckpt, tree_path, topk=5, candidate_num=4, packed=True)
    jserv._beam_fns[4] = make_packed_beam_fn_pallas(
        j_make_packed_tree(jtree, jnp.asarray(p["embedding"]), beam=4), tile_b=4,
        interpret=True)
    rng = np.random.default_rng(e + 1)
    seqs = rng.choice(jtree.item_ids, size=(8, 10)).astype(np.int64)
    seqs[0, 4:] = 0
    for got, ref in zip(serv.recommend_batch(seqs), jserv.recommend_batch(seqs)):
        np.testing.assert_array_equal(got, ref)
    items = jtree.item_ids[:16].astype(np.int64)
    np.testing.assert_allclose(serv.predict(seqs[1], items),
                               np.asarray(jserv.predict(seqs[1], items)), rtol=RTOL, atol=ATOL)


def test_chip_smoke_reads_every_instance_and_its_cap():
    """chip_smoke's build phase names each K1 and K3 instance from nvcc's
    report (from E = 32 K1's wide kernel and its prologue in the width's
    instance)
    and holds it to its register cap: 64 for K1 and the one-tile K3 at E <=
    16, 128 for K1 at E = 32 and 64 and for K1's direct kernel at E = 8
    (an instance of its own), 255 for K3 past one tile at E <= 16
    and for K3 from E = 32 on, but 168 where a block holds three warpgroups
    (one tile at E = 32, on bf16 rows at E = 128)."""
    import chip_smoke

    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116din_score_kernelILi32ELi10EEEvPKfS2_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 105 registers, used 1 barriers, 17424 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116din_score_kernelILi32ELi0EEEvPKfS2_' for 'sm_90a'
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 103 registers, used 1 barriers, 17424 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125packed_level_wgmma_kernelILb1E13__nv_bfloat16Li8EEEvPKT0_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112write_kernelILb1EfEEvPT0_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121din_score_wide_kernelILi96EEEvPKfS2_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119din_prologue_kernelILi96EEEvPKfS2_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers
"""
    usage = chip_smoke.instance_usage(log)
    assert usage == {"K1 E=32": {"registers": 105, "spill_bytes": 8},
                     "K3 E=8 bf16 one-tile": {"registers": 56, "spill_bytes": 0},
                     "K1 E=96": {"registers": 120, "spill_bytes": 0}}
    caps = {n: chip_smoke.reg_cap(n) for n in ("K1 E=8", "K1 E=16", "K1 E=32", "K1 E=64",
                                               "K1 E=128", "K3 E=16 f32 one-tile",
                                               "K3 E=32 f32 one-tile", "K3 E=32 bf16 tiles",
                                               "K3 E=128 bf16 one-tile")}
    assert caps == {"K1 E=8": 64, "K1 E=16": 64, "K1 E=32": 128, "K1 E=64": 128,
                    "K1 E=128": 255, "K3 E=16 f32 one-tile": 64, "K3 E=32 f32 one-tile": 168,
                    "K3 E=32 bf16 tiles": 255, "K3 E=128 bf16 one-tile": 168}
    assert chip_smoke.instance_name("_ZN12_GLOBAL__N_112write_kernelILb0EfEEv") is None
    direct = "_ZN12_GLOBAL__N_123din_score_direct_kernelILi8ELi10EEEvPKfS2_"
    assert chip_smoke.instance_name(direct) == "K1 E=8 direct"
    assert chip_smoke.reg_cap("K1 E=8 direct") == 128


def test_chip_smoke_holds_each_width_to_its_flip_share():
    """K3's share of candidates beyond K1's tolerance is held per width; the
    f32 scorer's ~97% fails every width."""
    import chip_smoke

    ref = torch.linspace(-3.0, 3.0, 1000)
    got = ref.clone()
    got[:3] += 0.01  # 0.3% of the candidates one bf16 ulp apart
    assert not chip_smoke.agreement("packed_level", got, ref, 16)["ok"]
    assert chip_smoke.agreement("packed_level", got, ref, 32)["ok"]
    assert not chip_smoke.agreement("packed_level", ref + 0.01, ref, 32)["ok"]
