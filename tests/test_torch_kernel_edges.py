"""Edges of the tensor-core K3 tiling and of K2's row skipping, held on the
CPU, and the bound helpers of ``chip_smoke.py``.

K3 scores a query row's 2*beam candidates in m-tiles of 16 (beam 20: 16 +
16 + 8) with the sequence padded to 16: its plain version must agree with
the JAX package's Pallas kernel (interpret mode) on a ragged batch, an
all-padding row and a row whose parents are all dead.  The bound helpers
turn shapes and indices into the least time the H100 could take."""

import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dismember_tpu.ops.packed_level_kernel import packed_level_pallas
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.ops import _cuda
from dismember_tpu_torch.ops.packed_level_kernel import NEG_INF, packed_level

RTOL, ATOL = 2e-4, 1e-5  # tests/test_pallas_din.py's tolerance
ROOT = Path(__file__).resolve().parent.parent


def _params(rng, e):
    f = lambda *s: rng.normal(0, 0.05, s).astype(np.float32)  # noqa: E731
    return {
        "embedding": f(31, e),
        "att_linear": {"weight": f(e, e)},
        "mlp1": {"weight": f(e, 2 * e), "bias": f(e)},
        "mlp2": {"weight": f(1, e), "bias": f(1)},
    }


@pytest.mark.parametrize("pad_row,dead_row", [(0, 3), (6, 6)])
def test_k3_plain_matches_pallas_on_ragged_tiles(pad_row, dead_row):
    """E=16, L=10, beam=20 (m-tiles 16 + 16 + 8), B=7 (ragged against the
    Pallas kernel's tile of 4 and the CUDA kernel's block of 4 rows)."""
    b, beam, e, l, row = 7, 20, 16, 10, 128
    rng = np.random.default_rng(100 * pad_row + dead_row)
    p = _params(rng, e)
    rows = rng.normal(0, 0.05, (b, beam, row)).astype(np.float32)
    rows[..., 2 * e : 2 * e + 2] = rng.random((b, beam, 2)) < 0.85  # missing children
    ids = rng.integers(-1, 1 << 20, (b, beam, 2))
    rows[..., 2 * e + 2 : 2 * e + 6] = np.stack(
        [ids // 4096, ids % 4096], axis=-1).reshape(b, beam, 4)
    alive = rng.random((b, beam)) < 0.9
    alive[dead_row] = False  # every parent dead
    pad = (rng.random((b, l)) < 0.3).astype(np.float32)
    pad[pad_row] = 1.0  # every position padding
    seq_e = rng.normal(0, 0.05, (b, l, e)).astype(np.float32)
    seq_e[pad > 0] = 0.0
    js, jh = packed_level_pallas(
        {k: jnp.asarray(v) if not isinstance(v, dict) else
         {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in p.items()},
        jnp.asarray(rows), jnp.asarray(alive), jnp.asarray(seq_e), jnp.asarray(pad), e,
        tile_b=4, interpret=True,
    )
    with torch.inference_mode():
        ts, th = packed_level(
            torch.as_tensor(rows), torch.as_tensor(alive), torch.as_tensor(seq_e),
            torch.as_tensor(pad), *params_from_numpy(p, device="cpu").scorer_weights(), e,
        )
    js, ts = np.asarray(js), ts.numpy()
    assert ts.shape == (b, 2 * beam) and th.shape == (b, 2 * beam, 2)
    np.testing.assert_array_equal(th.numpy().view(np.int32), np.asarray(jh).view(np.int32))
    assert (ts[dead_row] == np.float32(NEG_INF)).all()
    live = ts > NEG_INF / 2
    np.testing.assert_array_equal(live, np.asarray(js) > NEG_INF / 2)
    assert live[pad_row].any() or pad_row == dead_row
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)


def test_k3_source_runs_on_the_tensor_cores():
    src = (ROOT / "dismember_tpu_torch" / "csrc" / "din_kernels.cu").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


def test_k3_bound_is_bytes_at_the_serving_shape():
    """K3 at B=4096, beam 20, L=10, E=16: ~17.5 MB (38 of 128 lanes of each
    pair row, sequence tiles, outputs) against ~0.36 GFLOP of bf16 products
    on the tensor cores and ~14 MFLOP on the CUDA cores."""
    ms, by = chip_smoke.k3_bound(4096, 20, 10, 16)
    assert by == "bytes"
    assert abs(ms * 1e3 - 5.2) <= 0.2
    mm, rest = chip_smoke.din_flops(4096 * 40, 10, 16)
    ops_ms, _ = chip_smoke.bound(0, f32_flops=rest, mma_flops=mm)
    assert ops_ms * 1e3 < 1.0  # operations: well under the bytes bound


def _commit(rng, p, n_distinct, tail):
    """A pmv commit as ``_merge_slots`` hands it to K2: the scratch row
    (padding codes sort first), the sorted distinct rows, then a tail that
    repeats the scratch row."""
    scratch = p - 1
    d = np.sort(rng.choice(scratch, n_distinct, replace=False))
    return torch.as_tensor(np.concatenate([[scratch], d, np.full(tail, scratch)]))


def test_row_bound_counts_one_write_per_distinct_row():
    rng = np.random.default_rng(1)
    p, w = 5000, 128
    idx = _commit(rng, p, 1000, 300)
    idx[5] = p + 7  # dropped: never read, never written
    written, ms, by = chip_smoke.row_bound(idx, p, w, add=False)
    assert written == 1000  # 999 distinct rows kept + the scratch row, once
    assert by == "bytes"
    want = (idx.numel() * 8 + written * w * 4 * 2) / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(want)
    written_add, ms_add, _ = chip_smoke.row_bound(idx, p, w, add=True)
    assert written_add == written and ms_add > ms  # the add reads each row once more


def test_distinct_prefix_drops_the_scratch_tail():
    rng = np.random.default_rng(2)
    idx = _commit(rng, 5000, 700, 250)
    n = chip_smoke.distinct_prefix(idx)
    assert n == 701
    assert torch.unique(idx[:n]).numel() == n
    assert chip_smoke.distinct_prefix(idx[:n]) == n
    bad = idx.clone()
    bad[-1] = 3  # the tail does not repeat one row
    with pytest.raises(RuntimeError, match="repeated row"):
        chip_smoke.distinct_prefix(bad)


def test_time_ms_reports_the_median_and_spread(monkeypatch):
    """Per-call event pairs: the median and p10/p90/min/max under a prefix."""
    clock = iter(range(10_000))

    class Event:
        def __init__(self, enable_timing=False):
            self.t = 0

        def record(self):
            self.t = next(clock)

        def elapsed_time(self, other):
            return float(other.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    calls = []
    got = chip_smoke.time_ms(lambda: calls.append(1), "plain_", iters=7, warmup=2)
    assert len(calls) == 9
    assert got == {"plain_ms": 1.0, "plain_ms_p10": 1.0, "plain_ms_p90": 1.0,
                   "plain_ms_min": 1.0, "plain_ms_max": 1.0}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """No CUDA here: the script exits non-zero and prints no result; alone
    in a directory it cannot even import the port."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
