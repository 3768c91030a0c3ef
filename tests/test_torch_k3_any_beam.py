"""K3 at any beam and any sequence length, held on the CPU.

One launch takes any beam (the kernel's shared memory does not grow with
it), and sequences past one 16-position tile go through the kernel in
tiles.  The plain level takes any beam and any L and must agree with the
JAX package's Pallas kernel (interpret mode) at wide beams and past one
tile.

Tolerances: ids and dead masks bit for bit; scores within RTOL/ATOL, as
tests/test_pallas_din.py holds them.  Both sides round six operands to
bf16 after f32 sums taken in different orders, so now and then one side
rounds an operand to the neighbouring bf16 value (a flip, ~0.4% of the
logit): at beams past 12, whose rows hold 74 candidates and more, a
share FLIP_SHARE of the scores may pass RTOL/ATOL (beam 65 at L = 17 has
one flip in 780), each within K3's tolerance K3_ATOL/K3_RTOL
(chip_smoke.TOL)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.ops.packed_level_kernel import packed_level_pallas
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.ops.packed_level_kernel import (
    NEG_INF,
    packed_level,
)

RTOL, ATOL = 2e-4, 1e-5  # tests/test_pallas_din.py's tolerance
K3_ATOL, K3_RTOL = 1e-1, 1e-2
FLIP_SHARE = 1e-2
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


@pytest.mark.parametrize("beam,l", [(12, 17), (12, 24), (12, 40), (65, 17), (110, 24),
                                    (37, 40), (9, 17), (9, 24)])
def test_plain_level_past_one_tile_matches_pallas(beam, l):
    rng = np.random.default_rng(1000 * beam + l)
    p = _params(rng)
    rows, alive, seq_e, pad = _inputs(rng, 6, beam, l)
    js, jh = packed_level_pallas(
        {k: jnp.asarray(v) if not isinstance(v, dict) else
         {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in p.items()},
        jnp.asarray(rows.numpy()), jnp.asarray(alive.numpy()), jnp.asarray(seq_e.numpy()),
        jnp.asarray(pad.numpy()), E, tile_b=2, interpret=True)
    with torch.inference_mode():
        ts, th = packed_level(rows, alive, seq_e, pad,
                              *params_from_numpy(p, device="cpu").scorer_weights(), E)
    got, want = ts.numpy(), np.asarray(js)
    np.testing.assert_array_equal(th.numpy().view(np.int32), np.asarray(jh).view(np.int32))
    np.testing.assert_array_equal(got > NEG_INF / 2, want > NEG_INF / 2)
    if beam <= 12:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=K3_RTOL, atol=K3_ATOL)
        flips = np.abs(got - want) > ATOL + RTOL * np.abs(want)
        assert flips.mean() <= FLIP_SHARE, f"{flips.sum()} of {flips.size} scores past RTOL"


@pytest.mark.parametrize("beam,l", [(3, 17), (1500, 40)])
def test_wrapper_takes_long_sequences_and_wide_beams_on_cuda(beam, l):
    """Sequences past one tile and wide beams pass the wrapper's own checks
    and reach its device checks (the launch itself needs the card)."""
    w = params_from_numpy(_params(np.random.default_rng(0)), device="cpu").scorer_weights()
    rows = torch.zeros(2, beam, 128).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="expected cuda"):
        packed_level(rows, torch.ones(2, beam), torch.zeros(2, l, E), torch.ones(2, l), *w, E)
