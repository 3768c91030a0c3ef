"""K1's folded order of the DIN scorer, held on the CPU against the JAX
package, and the facts of its kernel source and bound.

The CUDA kernel ``din_score_f32`` scores a candidate from the query row's
ctx_l = M . seq_l with M = w1[:, E:] @ att_w (by linearity, w1[:, E:] .
att_w . sum_l p_l seq_l = sum_l p_l ctx_l), takes the softmax over all L
positions at once for L <= 10 and past that over chunks of 4 with a running
max and sum, and one reciprocal of the sum.
``_folded`` mirrors that order in plain float32 torch; it must agree with
``din.forward``, ``din_forward_pallas(interpret=True)`` and the port's
``din_score_plain`` within K1's tolerance at O(1)-scale inputs, with an
all-padding row and zero (invalid) item rows."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dismember_tpu.models import din as jdin
from dismember_tpu.ops.din_kernel import din_forward_pallas
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.models.embedding import embed_lookup
from dismember_tpu_torch.ops.din_kernel import _MASK_F32, din_score_plain

RTOL, ATOL = 2e-4, 1e-5  # K1's tolerance (chip_smoke.TOL["din_score"])
SHORT_L, CHUNK = 10, 4  # positions a kernel thread holds at once, short and long
CSRC = Path(__file__).resolve().parent.parent / "dismember_tpu_torch" / "csrc"


def _folded(item_e, seq_e, pad, att_w, w1, b1, w2, b2):
    """The kernel's order of operations in float32: M and ctx once per query
    row, the scores with padding as a multiply-add, the softmax at once or,
    past 10 positions, chunk by chunk (the running sum and accumulator
    rescaled to each new max), one reciprocal, and h from ctx."""
    e, l = item_e.shape[-1], seq_e.shape[1]
    chunk = l if l <= SHORT_L else CHUNK
    ctx = seq_e @ (w1[:, e:] @ att_w).T  # [B, L, E]
    real = pad <= 0.5
    mul = torch.where(real, 1.0 / math.sqrt(e), 0.0)[:, None, :]
    add = torch.where(real, 0.0, _MASK_F32)[:, None, :]
    scores = torch.einsum("bue,ble->bul", item_e, seq_e) * mul + add
    mx = torch.full(scores.shape[:2], _MASK_F32)
    total = torch.zeros(scores.shape[:2])
    acc = torch.zeros(item_e.shape)
    for l0 in range(0, l, chunk):
        s = scores[..., l0 : l0 + chunk]
        cmx = torch.maximum(mx, s.max(-1).values)
        r = torch.exp(mx - cmx)
        total, acc = total * r, acc * r[..., None]
        mx = cmx
        x = torch.exp(s - mx[..., None])
        total = total + x.sum(-1)
        acc = acc + torch.einsum("bul,bli->bui", x, ctx[:, l0 : l0 + chunk])
    inv = 1.0 / total
    h = torch.relu(item_e @ w1[:, :e].T + inv[..., None] * acc + b1)
    return (h @ w2.T + b2)[..., 0]


def _params(rng, num_index, e):
    """O(1) scale, as chip_smoke.py's: embeddings N(0, 1), weights and biases
    N(0, 0.5)."""
    f = lambda std, *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return {
        "embedding": f(1.0, num_index, e),
        "att_linear": {"weight": f(0.5, e, e)},
        "mlp1": {"weight": f(0.5, e, 2 * e), "bias": f(0.5, e)},
        "mlp2": {"weight": f(0.5, 1, e), "bias": f(0.5, 1)},
    }


def _jax(params):
    if isinstance(params, dict):
        return {k: _jax(v) for k, v in params.items()}
    return jnp.asarray(params)


@pytest.mark.parametrize("u", [40, 91])
@pytest.mark.parametrize("l", [1, 10, 24])
def test_k1_folded_order_matches_jax_and_plain(u, l):
    """B=64, E=16: 30% padding, row 0 all padding, 10% zero item rows."""
    b, e, num_index = 64, 16, 255
    rng = np.random.default_rng(1000 * l + u)
    p = _params(rng, num_index, e)
    items = rng.integers(0, num_index, (b, u))
    items[rng.random((b, u)) < 0.1] = -1  # invalid: zero rows
    seqs = rng.integers(0, num_index, (b, l))
    seqs[rng.random((b, l)) < 0.3] = -1  # padding
    seqs[0] = -1  # an all-padding row: uniform over its L zero rows
    ref = np.asarray(jdin.forward(_jax(p), jnp.asarray(items), jnp.asarray(seqs)))
    pal = np.asarray(din_forward_pallas(_jax(p), jnp.asarray(items), jnp.asarray(seqs),
                                        tile_b=16, interpret=True))
    model = params_from_numpy(p, device="cpu")
    w = tuple(t.detach() for t in model.scorer_weights())
    with torch.no_grad():
        items_t, seqs_t = torch.as_tensor(items), torch.as_tensor(seqs)
        item_e = embed_lookup(model.embedding, items_t)
        seq_e = embed_lookup(model.embedding, seqs_t)
        pad = (seqs_t < 0).float()
        got = _folded(item_e, seq_e, pad, *w)
        plain = din_score_plain(item_e, seq_e, pad, *w).numpy()
    got = got.numpy()
    assert got.shape == (b, u) and np.isfinite(got).all()
    assert (item_e[items_t < 0] == 0).all()
    for want in (ref, pal, plain):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the all-padding row: h = w1[:, :E] . item + b1 (zero ctx rows)
    w1, b1, w2, b2 = w[1], w[2], w[3], w[4]
    direct = (torch.relu(item_e[0] @ w1[:, :e].T + b1) @ w2.T + b2)[..., 0]
    np.testing.assert_allclose(got[0], direct.numpy(), rtol=RTOL, atol=ATOL)


def test_k1_source_takes_one_reciprocal_a_candidate():
    """No division per probability and no shared-memory softmax scratch: the
    scores, exponentials and sums stay in registers."""
    src = (CSRC / "din_kernels.cu").read_text()
    k1 = src[src.index("// K1's DIN score of one candidate"):src.index("-- K3\n")]
    k1 = re.sub(r"//.*", "", k1)  # the code, without its comments
    assert "rcp(sum)" in k1
    assert "/ sum" not in k1 and not re.search(r"\bs_p\b", k1)
    assert "__launch_bounds__(kMaxThreads, kK1MinBlocks<E>)" in k1


def test_row_add_runs_through_the_write_kernel():
    src = (CSRC / "row_writer.cu").read_text()
    assert "add_kernel" not in src and "launch_add" not in src
    assert "launch_rows<true>" in src and "launch_rows<false>" in src
    # one kernel for the write and the add, templated on the table's element type
    assert "template <bool kAdd, typename T>" in src


def test_k1_bound_is_bytes_after_the_fold():
    """At the serving shape (B=4096, U=40, L=10, E=16): ~13.9 MB (~4.2 us at
    the HBM rate) against ~0.24 GFLOP of folded work (~3.5 us at the f32
    rate); the direct formula's ~0.38 GFLOP set the old bound (~5.6 us)."""
    b, u, l, e = 4096, 40, 10, 16
    n_bytes = 4 * (b * u * e + b * l * e + b * l + b * u + 3 * e * e + 2 * e + 1)
    ms, by = chip_smoke.bound(n_bytes, chip_smoke.din_folded_flops(b, u, l, e))
    assert by == "bytes" and abs(ms * 1e3 - 4.16) <= 0.05
    ops_ms, _ = chip_smoke.bound(0, chip_smoke.din_folded_flops(b, u, l, e))
    assert abs(ops_ms * 1e3 - 3.5) <= 0.1
    old_ms, old_by = chip_smoke.bound(n_bytes, sum(chip_smoke.din_flops(b * u, l, e)))
    assert old_by == "operations" and abs(old_ms * 1e3 - 5.60) <= 0.01


def test_ptxas_usage_reads_registers_and_spills():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116din_score_kernelILi16EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116din_score_kernelILi16EEEvPKf
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, 4240 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119packed_level_kernelEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119packed_level_kernelEPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, 464 bytes cmem[0]
"""
    assert chip_smoke.ptxas_usage(log, "din_score_kernel") == {"registers": 64,
                                                               "spill_bytes": 20}
    assert chip_smoke.ptxas_usage(log, "packed_level_kernel") == {"registers": 72,
                                                                  "spill_bytes": 0}
