"""Port kernels K1 (DIN scorer) and K3 (packed level body) against the JAX
package: the same numpy inputs go through the Pallas kernels (interpret
mode), the JAX DIN forward and the port's wrappers, which take their plain
PyTorch versions for CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.models import din as jdin
from dismember_tpu.ops.din_kernel import din_forward_pallas
from dismember_tpu.ops.packed_level_kernel import packed_level_pallas
from dismember_tpu_torch.models.din import DIN, params_from_numpy
from dismember_tpu_torch.ops import _cuda, din_kernel, packed_level_kernel
from dismember_tpu_torch.ops.din_kernel import din_score
from dismember_tpu_torch.ops.packed_level_kernel import packed_level

RTOL, ATOL = 2e-4, 1e-5  # tests/test_pallas_din.py's tolerance


def _params(rng, num_index, e):
    f = lambda *s: rng.normal(0, 0.05, s).astype(np.float32)  # noqa: E731
    return {
        "embedding": f(num_index, e),
        "att_linear": {"weight": f(e, e)},
        "mlp1": {"weight": f(e, 2 * e), "bias": f(e)},
        "mlp2": {"weight": f(1, e), "bias": f(1)},
    }


def _jax(params):
    if isinstance(params, dict):
        return {k: _jax(v) for k, v in params.items()}
    return jnp.asarray(params)


@pytest.mark.parametrize("b,u,l,e", [(5, 8, 4, 16), (16, 40, 10, 16), (3, 6, 6, 8),
                                     (4, 40, 10, 32)])
def test_k1_plain_matches_pallas_and_forward(b, u, l, e):
    rng = np.random.default_rng(b * 100 + u)
    num_index = 127
    p = _params(rng, num_index, e)
    items = rng.integers(-1, num_index, (b, u))
    seqs = rng.integers(-1, num_index, (b, l))
    seqs[0] = -1  # an all-padding row: uniform probabilities over zero rows
    ref = np.asarray(jdin.forward(_jax(p), jnp.asarray(items), jnp.asarray(seqs)))
    pal = np.asarray(din_forward_pallas(
        _jax(p), jnp.asarray(items), jnp.asarray(seqs), tile_b=4, interpret=True
    ))
    model = params_from_numpy(p, device="cpu")
    with torch.inference_mode():
        got = model(torch.as_tensor(items), torch.as_tensor(seqs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)


def test_k1_all_padding_row():
    """tests/test_pallas_din.py's case: every position padded."""
    rng = np.random.default_rng(1)
    p = _params(rng, 63, 8)
    items, seqs = np.array([[1, 2]]), np.full((1, 4), -1)
    ref = np.asarray(jdin.forward(_jax(p), jnp.asarray(items), jnp.asarray(seqs)))
    got = params_from_numpy(p, device="cpu")(
        torch.as_tensor(items), torch.as_tensor(seqs)
    ).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _level_inputs(rng, b, beam, e, l, row=128):
    rows = rng.normal(0, 0.05, (b, beam, row)).astype(np.float32)
    rows[..., 2 * e : 2 * e + 2] = rng.integers(0, 2, (b, beam, 2))  # missing children
    ids = rng.integers(-1, 1 << 20, (b, beam, 2))
    rows[..., 2 * e + 2 : 2 * e + 6] = np.stack(
        [ids // 4096, ids % 4096], axis=-1
    ).reshape(b, beam, 4)
    alive = rng.random((b, beam)) < 0.8  # dead parents
    pad = (rng.random((b, l)) < 0.3).astype(np.float32)
    pad[0] = 1.0  # all-padding row
    seq_e = rng.normal(0, 0.05, (b, l, e)).astype(np.float32)
    seq_e[pad > 0] = 0.0
    return rows, alive, seq_e, pad


@pytest.mark.parametrize("b,beam,e,l", [(6, 8, 16, 10), (5, 4, 16, 6), (3, 20, 8, 10),
                                         (3, 20, 32, 10)])
def test_k3_plain_matches_pallas(b, beam, e, l):
    rng = np.random.default_rng(b + beam + e)
    p = _params(rng, 31, e)
    rows, alive, seq_e, pad = _level_inputs(rng, b, beam, e, l)
    js, jh = packed_level_pallas(
        _jax(p), jnp.asarray(rows), jnp.asarray(alive), jnp.asarray(seq_e),
        jnp.asarray(pad), e, tile_b=2, interpret=True,
    )
    model = params_from_numpy(p, device="cpu")
    with torch.inference_mode():
        ts, th = packed_level(
            torch.as_tensor(rows), torch.as_tensor(alive), torch.as_tensor(seq_e),
            torch.as_tensor(pad), *model.scorer_weights(), e,
        )
    js, ts = np.asarray(js), ts.numpy()
    assert ts.shape == (b, 2 * beam) and th.shape == (b, 2 * beam, 2)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))  # bit-exact ids
    # block order: column k < beam is the left child of parent k
    np.testing.assert_array_equal(th.numpy()[:, :beam], rows[..., 2 * e + 2 : 2 * e + 4])
    dead = ~np.concatenate([alive, alive], 1)
    assert (ts[dead] == np.float32(-3.4e38)).all()


def test_k3_rounds_operands_to_bf16():
    """K3 differs from the f32 scorer only by its bf16 operand rounding."""
    rng = np.random.default_rng(3)
    e, beam = 16, 4
    p = _params(rng, 31, e)
    rows, alive, seq_e, pad = _level_inputs(rng, 4, beam, e, 10)
    rows[..., 2 * e : 2 * e + 2] = 1.0
    alive[:] = True
    model = params_from_numpy(p, device="cpu")
    with torch.inference_mode():
        ts, _ = packed_level(
            torch.as_tensor(rows), torch.as_tensor(alive), torch.as_tensor(seq_e),
            torch.as_tensor(pad), *model.scorer_weights(), e,
        )
        item_e = torch.cat([torch.as_tensor(rows[..., :e]),
                            torch.as_tensor(rows[..., e : 2 * e])], 1)
        f32 = din_score(item_e, torch.as_tensor(seq_e), torch.as_tensor(pad),
                        *model.scorer_weights())
    diff = np.abs(ts.numpy() - f32.numpy())
    assert diff.max() > 0  # rounding happened
    np.testing.assert_allclose(ts.numpy(), f32.numpy(), rtol=2e-2, atol=2e-4)


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    model = DIN(15, 8, device="cpu", generator=torch.Generator().manual_seed(0))
    w = model.scorer_weights()
    k1, k3 = din_kernel.launches, packed_level_kernel.launches
    with torch.inference_mode():
        din_score(torch.zeros(2, 3, 8), torch.zeros(2, 4, 8), torch.ones(2, 4), *w)
        packed_level(torch.zeros(2, 3, 128), torch.ones(2, 3), torch.zeros(2, 4, 8),
                     torch.ones(2, 4), *w, 8)
    assert (din_kernel.launches, packed_level_kernel.launches) == (k1, k3)
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        din_score(meta(2, 3, 8), meta(2, 4, 8), meta(2, 4), *w)
    with pytest.raises(ValueError, match="unsupported device"):
        packed_level(meta(2, 3, 128), meta(2, 3), meta(2, 4, 8), meta(2, 4), *w, 8)


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    """The kernels are built from csrc/ for sm_90a; with no nvcc the build
    raises instead of falling back."""
    assert [s.name for s in _cuda.SOURCES] == ["din_kernels.cu", "dr_rerank.cu", "row_writer.cu"]
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
    src = _cuda.SOURCES[0].read_text()
    for sym in ("din_score_f32", "packed_level_bf16", "cudaGetLastError"):
        assert sym in src
    src = _cuda.SOURCES[1].read_text()
    for sym in ("dr_block_rerank_topk", "cudaGetLastError"):
        assert sym in src
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda.shutil, "which", lambda _: None)
    monkeypatch.setattr(_cuda.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.library_path()


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    checks on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda")


def test_k1_refuses_inputs_that_require_grad_on_cuda():
    """K1 has no backward: on CUDA it raises instead of returning a detached
    result; without grad it goes on to its launch checks."""
    model = DIN(15, 8, device="cpu", generator=torch.Generator().manual_seed(0))
    w = model.scorer_weights()
    item = torch.zeros(2, 3, 8).as_subclass(_FakeCuda)
    with pytest.raises(RuntimeError, match="no backward"):
        din_score(item, torch.zeros(2, 4, 8), torch.ones(2, 4), *w)
    with torch.no_grad(), pytest.raises(ValueError, match="expected cuda"):
        din_score(item, torch.zeros(2, 4, 8), torch.ones(2, 4), *w)


def test_train_scorer_gradients_match_jax():
    """DIN.train_apply_from_emb under autograd against jax.grad of the JAX
    package's apply_from_emb: BCE gradients w.r.t. the gathered rows and
    every scorer weight."""
    import jax

    from dismember_tpu.models.losses import bce_with_logits as j_bce
    from dismember_tpu_torch.models.losses import bce_with_logits

    rng = np.random.default_rng(7)
    b, u, l, e = 4, 6, 5, 8
    p = _params(rng, 31, e)
    item_e = rng.normal(0, 0.5, (b, u, e)).astype(np.float32)
    seq_e = rng.normal(0, 0.5, (b, l, e)).astype(np.float32)
    pad = rng.random((b, l)) < 0.3
    pad[0] = True
    labels = (rng.random((b, u)) < 0.3).astype(np.float32)
    weights = (rng.random((b, u)) < 0.9).astype(np.float32)

    def jloss(pp, ie, se):
        ctx = jdin.ctx_from_seq_emb(pp, se, jnp.asarray(pad)[:, None, :])
        return j_bce(jdin.apply_from_emb(pp, ie, ctx), labels, weights)

    jl, (jg_p, jg_i, jg_s) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        _jax(p), jnp.asarray(item_e), jnp.asarray(seq_e))
    model = params_from_numpy(p, device="cpu")
    ie = torch.tensor(item_e, requires_grad=True)
    se = torch.tensor(seq_e, requires_grad=True)
    ctx = DIN.ctx_from_seq_emb(se, torch.as_tensor(pad).float())
    loss = bce_with_logits(model.train_apply_from_emb(ie, ctx), torch.as_tensor(labels),
                           torch.as_tensor(weights))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ie.grad.numpy(), np.asarray(jg_i), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(se.grad.numpy(), np.asarray(jg_s), rtol=RTOL, atol=1e-7)
    for name, (t, g) in {"att_linear": (model.att_linear.weight, jg_p["att_linear"]["weight"]),
                         "mlp1": (model.mlp1.weight, jg_p["mlp1"]["weight"]),
                         "mlp1_bias": (model.mlp1.bias, jg_p["mlp1"]["bias"]),
                         "mlp2": (model.mlp2.weight, jg_p["mlp2"]["weight"]),
                         "mlp2_bias": (model.mlp2.bias, jg_p["mlp2"]["bias"])}.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL, atol=1e-7,
                                   err_msg=name)
