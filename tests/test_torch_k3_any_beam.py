"""K3 at any beam and any sequence length, held on the CPU.

Where the kernel stages a query row's beam (E = 8 on bf16 rows) the
staging grows with the beam, so the wrapper splits a beam wider than one
launch takes into chunks of parents and puts the chunks' block-ordered
outputs back together; sequences past one 16-position
tile go through the kernel in tiles.  The split is plain Python: with the
chunk forced small it must equal the unsplit plain level.  The plain level
takes any L and must agree with the JAX package's Pallas kernel (interpret
mode) past one tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.ops.packed_level_kernel import packed_level_pallas
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.ops.packed_level_kernel import (
    NEG_INF,
    _split_beam,
    packed_level,
    packed_level_plain,
)

RTOL, ATOL = 2e-4, 1e-5  # tests/test_pallas_din.py's tolerance
E = 16


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    checks on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda")


def _params(rng):
    f = lambda *s: rng.normal(0, 0.3, s).astype(np.float32)  # noqa: E731
    return {"embedding": f(31, E), "att_linear": {"weight": f(E, E)},
            "mlp1": {"weight": f(E, 2 * E), "bias": f(E)},
            "mlp2": {"weight": f(1, E), "bias": f(1)}}


def _inputs(rng, b, beam, l):
    rows = rng.normal(0, 0.5, (b, beam, 128)).astype(np.float32)
    rows[..., 2 * E : 2 * E + 2] = rng.random((b, beam, 2)) < 0.85
    ids = rng.integers(-1, 1 << 20, (b, beam, 2))
    rows[..., 2 * E + 2 : 2 * E + 6] = np.stack(
        [ids // 4096, ids % 4096], axis=-1).reshape(b, beam, 4)
    alive = rng.random((b, beam)) < 0.9
    alive[1] = False
    pad = (rng.random((b, l)) < 0.3).astype(np.float32)
    pad[0] = 1.0
    seq_e = rng.normal(0, 0.5, (b, l, E)).astype(np.float32)
    seq_e[pad > 0] = 0.0
    return [torch.as_tensor(a) for a in (rows, alive, seq_e, pad)]


@pytest.mark.parametrize("beam,chunk", [(65, 16), (110, 32), (37, 5), (9, 9), (9, 1)])
def test_beam_split_equals_the_unsplit_level(beam, chunk):
    rng = np.random.default_rng(beam * 7 + chunk)
    w = params_from_numpy(_params(rng), device="cpu").scorer_weights()
    rows, alive, seq_e, pad = _inputs(rng, 5, beam, 10)
    with torch.inference_mode():
        want_s, want_h = packed_level_plain(rows, alive, seq_e, pad, *w, E)
        got_s, got_h = _split_beam(packed_level_plain, chunk, rows, alive, seq_e, pad, *w, E)
    assert got_s.shape == (5, 2 * beam) and got_h.shape == (5, 2 * beam, 2)
    np.testing.assert_array_equal(got_h.numpy().view(np.int32), want_h.numpy().view(np.int32))
    np.testing.assert_array_equal(got_s.numpy(), want_s.numpy())


@pytest.mark.parametrize("l", [17, 24, 40])
def test_plain_level_past_one_tile_matches_pallas(l):
    rng = np.random.default_rng(l)
    p = _params(rng)
    rows, alive, seq_e, pad = _inputs(rng, 6, 12, l)
    js, jh = packed_level_pallas(
        {k: jnp.asarray(v) if not isinstance(v, dict) else
         {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in p.items()},
        jnp.asarray(rows.numpy()), jnp.asarray(alive.numpy()), jnp.asarray(seq_e.numpy()),
        jnp.asarray(pad.numpy()), E, tile_b=2, interpret=True)
    with torch.inference_mode():
        ts, th = packed_level(rows, alive, seq_e, pad,
                              *params_from_numpy(p, device="cpu").scorer_weights(), E)
    np.testing.assert_array_equal(th.numpy().view(np.int32), np.asarray(jh).view(np.int32))
    np.testing.assert_array_equal(ts.numpy() > NEG_INF / 2, np.asarray(js) > NEG_INF / 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("beam,l", [(3, 17), (1500, 40)])
def test_wrapper_takes_long_sequences_and_wide_beams_on_cuda(beam, l):
    """Sequences past one tile and beams past one launch's fit pass the
    wrapper's own checks and reach its device checks (the launch itself
    needs the card)."""
    w = params_from_numpy(_params(np.random.default_rng(0)), device="cpu").scorer_weights()
    rows = torch.zeros(2, beam, 128).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="expected cuda"):
        packed_level(rows, torch.ones(2, beam), torch.zeros(2, l, E), torch.ones(2, l), *w, E)
