"""The port's lazy sparse Adam and K2 row writer against the JAX package:
the same numpy tables, codes and gradients go through
``dismember_tpu.train.sparse_adam`` (whose row writer takes its XLA
scatter-set on the CPU) and ``dismember_tpu_torch.train.sparse_adam`` (whose
wrappers take their plain PyTorch versions for CPU tensors)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.ops.row_writer import write_rows_128 as j_write_rows_128
from dismember_tpu.train import sparse_adam as jsa
from dismember_tpu_torch.ops import _cuda, row_writer
from dismember_tpu_torch.train import sparse_adam as tsa

# apply_rows tolerance of tests/test_sparse_packed.py (ulp-level storage
# rounding that compounds over steps)
RTOL, ATOL = 1e-6, 1e-7


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    checks on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda")


def _np(state: dict) -> dict:
    return {k: np.asarray(v) for k, v in state.items()}


def _batch(rng, v, e, r, step):
    codes = rng.integers(0, v, size=r).astype(np.int32)
    codes[: 5 + step] = codes[0]  # duplicates: grads must sum
    codes[-3:] = -1  # padding slots: dropped
    return codes, rng.normal(size=(r, e)).astype(np.float32)


def test_dedup_rows_byte_equal():
    rng = np.random.default_rng(0)
    codes, g = _batch(rng, 50, 8, 64, 3)
    ju, jg, jl = (np.asarray(a) for a in jsa.dedup_rows(jnp.asarray(codes), jnp.asarray(g)))
    tu, tg, tl = tsa.dedup_rows(torch.as_tensor(codes).long(), torch.as_tensor(g))
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert tg.numpy().tobytes() == jg.tobytes()


@pytest.mark.parametrize("e,packed", [(16, True), (16, False), (8, True), (48, None)])
def test_init_state_layouts_byte_equal(e, packed):
    table = np.random.default_rng(1).normal(size=(257, e)).astype(np.float32)
    js = _np(jsa.init_state(jnp.asarray(table), packed=packed))
    ts = tsa.init_state(torch.as_tensor(table), packed=packed)
    assert sorted(js) == sorted(ts)
    for k in js:
        got = np.asarray(ts[k]) if k == "count" else ts[k].numpy()
        assert got.shape == js[k].shape and got.tobytes() == js[k].astype(got.dtype).tobytes()


@pytest.mark.parametrize("e", [16, 32, 64])
@pytest.mark.parametrize("packed", [False, True])
def test_apply_rows_matches_jax(e, packed):
    rng = np.random.default_rng(e)
    v = 1000
    table0 = rng.normal(size=(v, e)).astype(np.float32)
    jt, js = jnp.asarray(table0), jsa.init_state(jnp.asarray(table0), packed=packed)
    tt = torch.as_tensor(table0.copy())
    ts = tsa.init_state(tt, packed=packed)
    for step in range(4):
        codes, g = _batch(rng, v, e, 64, step)
        jt, js = jsa.apply_rows(jt, js, jnp.asarray(codes), jnp.asarray(g), 1e-3)
        tt, ts = tsa.apply_rows(tt, ts, torch.as_tensor(codes).long(),
                                torch.as_tensor(g), 1e-3)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL, atol=ATOL,
                                   err_msg=f"table diverged at step {step}")
        for k in ("mv",) if packed else ("m", "v"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} diverged at step {step}")
        assert ts["count"] == int(js["count"]) == step + 1
    if packed:  # the scratch row stays zero
        assert not ts["mv"][-1].any()


@pytest.mark.parametrize("e,v", [(16, 1000), (17, 257), (8, 100), (40, 31)])
def test_pmv_layout_byte_equal(e, v):
    """pmv_init / gather / unpack / refresh against the JAX package, bit for
    bit (E=17 leaves pad lanes, E=40 packs one slot a row)."""
    rng = np.random.default_rng(v)
    table = rng.normal(size=(v, e)).astype(np.float32)
    js = jsa.pmv_init(jnp.asarray(table))
    ts = tsa.pmv_init(torch.as_tensor(table))
    assert ts["pmv"].numpy().tobytes() == np.asarray(js["pmv"]).tobytes()
    codes = rng.integers(0, v, size=40)
    got = tsa.pmv_gather(ts["pmv"], torch.as_tensor(codes), e).numpy()
    ref = np.asarray(jsa.pmv_gather(js["pmv"], jnp.asarray(codes, jnp.int32), e))
    assert got.tobytes() == ref.tobytes()
    # moments in place, then a refresh from a new table keeps them
    ts["pmv"][:-1] += torch.as_tensor(rng.normal(size=ts["pmv"][:-1].shape),
                                      dtype=torch.float32)
    js = {"pmv": jnp.asarray(ts["pmv"].numpy()), "count": js["count"]}
    new = rng.normal(size=(v, e)).astype(np.float32)
    js = jsa.pmv_refresh(js, jnp.asarray(new))
    ts = tsa.pmv_refresh(ts, torch.as_tensor(new))
    assert ts["pmv"].numpy().tobytes() == np.asarray(js["pmv"]).tobytes()
    got = tsa.pmv_unpack(ts, v, e).numpy()
    assert got.tobytes() == np.asarray(jsa.pmv_unpack(js, v, e)).tobytes()
    np.testing.assert_array_equal(got, new)


@pytest.mark.parametrize("e", [16, 8])
def test_pmv_apply_rows_matches_jax(e):
    rng = np.random.default_rng(100 + e)
    v = 1000
    table0 = rng.normal(size=(v, e)).astype(np.float32)
    js = jsa.pmv_init(jnp.asarray(table0))
    ts = tsa.pmv_init(torch.as_tensor(table0))
    split_t, split_s = torch.as_tensor(table0.copy()), None
    split_s = tsa.init_state(split_t, packed=False)
    for step in range(4):
        codes, g = _batch(rng, v, e, 64, step)
        js = jsa.pmv_apply_rows(js, jnp.asarray(codes), jnp.asarray(g), 1e-3)
        tc, tg = torch.as_tensor(codes).long(), torch.as_tensor(g)
        ts = tsa.pmv_apply_rows(ts, tc, tg, 1e-3)
        split_t, split_s = tsa.apply_rows(split_t, split_s, tc, tg, 1e-3)
        np.testing.assert_allclose(ts["pmv"].numpy(), np.asarray(js["pmv"]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {step}")
        # same per-row Adam as the split format
        np.testing.assert_allclose(tsa.pmv_unpack(ts, v, e).numpy(), split_t.numpy(),
                                   rtol=RTOL, atol=ATOL)
    assert not ts["pmv"][-1].any()


def test_sparse_worthwhile_same_decision_grid():
    for rows in (1, 1000, 8191, 1 << 20, 2_097_151, 33_554_431):
        for touched in (1, 100, 8400, 9100, 57_344, 1 << 20):
            for e in (None, 8, 16, 17, 32, 48, 64, 128):
                assert tsa.sparse_worthwhile(rows, touched, e) == \
                    jsa.sparse_worthwhile(rows, touched, e), (rows, touched, e)


@pytest.mark.parametrize("r", [1, 511, 513, 8704])
def test_write_rows_128_plain_with_dups_byte_equal(r):
    """A pmv commit's shape at row counts around the Pallas kernel's 512-row
    grid step (which the port no longer pads to): distinct rows, a tail that
    repeats the scratch row with zero payloads, one non-adjacent repeat with
    an equal payload and one out-of-range row (dropped)."""
    rng = np.random.default_rng(r)
    p = 2 * r + 2
    scratch = p - 1
    table = rng.normal(size=(p, 128)).astype(np.float32)
    n_distinct = max(1, (3 * r) // 4)
    idx = np.full(r, scratch)
    idx[:n_distinct] = np.sort(rng.choice(scratch, n_distinct, replace=False))
    rows = rng.normal(size=(r, 128)).astype(np.float32)
    rows[idx == scratch] = 0.0
    if r > 2:
        idx[n_distinct // 2] = idx[0]  # a non-adjacent repeat: equal payloads
        rows[n_distinct // 2] = rows[0]
        idx[-1] = p  # out of range: dropped
    ref = np.asarray(j_write_rows_128(jnp.asarray(table), jnp.asarray(idx, jnp.int32),
                                      jnp.asarray(rows), use_pallas=False))
    before = dict(row_writer.launches)
    got = row_writer.write_rows_128(torch.as_tensor(table.copy()), torch.as_tensor(idx),
                                    torch.as_tensor(rows))
    assert got.numpy().tobytes() == ref.tobytes()
    assert row_writer.launches == before  # the plain version does not count


@pytest.mark.parametrize("w", [16, 32, 64, 128])
def test_row_kernels_plain_versions(w):
    rng = np.random.default_rng(w)
    table = rng.normal(size=(300, w)).astype(np.float32)
    idx = rng.choice(300, size=64, replace=False)
    rows = rng.normal(size=(64, w)).astype(np.float32)
    ref_set, ref_add = table.copy(), table.copy()
    ref_set[idx] = rows
    ref_add[idx] += rows
    t = torch.as_tensor(table.copy())
    assert row_writer.write_rows(t, torch.as_tensor(idx), torch.as_tensor(rows)) is t
    np.testing.assert_array_equal(t.numpy(), ref_set)
    t = torch.as_tensor(table.copy())
    row_writer.add_rows(t, torch.as_tensor(idx), torch.as_tensor(rows))
    np.testing.assert_array_equal(t.numpy(), ref_add)


def test_row_kernels_refuse_on_cuda_instead_of_falling_back():
    """On a CUDA tensor the wrappers launch or raise: non-f32 tables and
    widths that are not a multiple of 4 raise before any launch."""
    idx = torch.zeros(2, dtype=torch.long)
    for name, fn in (("write_rows", row_writer.write_rows), ("add_rows", row_writer.add_rows)):
        with pytest.raises(ValueError, match="expected torch.float32"):
            fn(torch.zeros(4, 8, dtype=torch.float64).as_subclass(_FakeCuda), idx,
               torch.zeros(2, 8, dtype=torch.float64))
        with pytest.raises(ValueError, match="multiple of 4"):
            fn(torch.zeros(4, 6).as_subclass(_FakeCuda), idx, torch.zeros(2, 6))
        meta = torch.empty(4, 8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, idx.to("meta"), torch.empty(2, 8, device="meta"))
    assert [s.name for s in _cuda.SOURCES] == ["din_kernels.cu", "dr_rerank.cu", "row_writer.cu"]
    src = _cuda.SOURCES[2].read_text()
    for sym in ("write_rows_f32", "add_rows_f32", "cudaGetLastError"):
        assert sym in src
