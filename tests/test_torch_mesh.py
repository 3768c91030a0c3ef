"""The port's mesh rules against the JAX package's, without spawning ranks:
the rank layout against JAX's device reshape, the padded row counts of the
sharded tables, the ranks' pmv slices against the JAX package's stacked
pmv format, and the sharded m|v state's geometry and moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core import mesh as jmesh
from dismember_tpu.train import spmd as jspmd, spmd_dr as jspmd_dr, spmd_sparse as jspmd_sparse
from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.train import sparse_adam, spmd, spmd_dr, spmd_sparse

SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1), (1, 1)]


class _Shape:
    """The axis sizes of a mesh, as the padding rules read them."""

    mesh_dim_names = (meshlib.DATA_AXIS, meshlib.MODEL_AXIS)

    def __init__(self, n_data: int, n_model: int):
        self._sizes = (n_data, n_model)

    def size(self, dim: int) -> int:
        return self._sizes[dim]


class _Rank(_Shape):
    """The rank at (0, ``model``) of a (1, n_model) mesh, as the row-block
    helpers read it."""

    def __init__(self, n_model: int, model: int):
        super().__init__(1, n_model)
        self._model = model

    def get_local_rank(self, axis: str) -> int:
        return {meshlib.DATA_AXIS: 0, meshlib.MODEL_AXIS: self._model}[axis]


def _jax_mesh(n_data, n_model):
    return jmesh.make_mesh(n_data=n_data, n_model=n_model,
                           devices=jax.devices()[: n_data * n_model])


@pytest.mark.parametrize("shape", SHAPES)
def test_rank_layout_matches_jax_device_reshape(shape):
    ids = np.vectorize(lambda d: d.id)(_jax_mesh(*shape).devices)
    np.testing.assert_array_equal(meshlib.rank_layout(*shape).numpy(), ids)


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_row_counts_match_jax(shape):
    jm, pm = _jax_mesh(*shape), _Shape(*shape)
    for v in (1, 63, 64, 101, 1023, 4097):
        assert spmd.padded_num_index(v, pm) == jspmd.padded_num_index(v, jm)
        for e in (8, 16, 24, 32, 48):
            assert spmd_sparse.sparse_padded_rows(v, pm, e) == \
                jspmd_sparse.sparse_padded_rows(v, jm, e)
            if 3 * e <= 128:
                assert spmd_dr.pmv_sharded_rows(v, e, shape[1]) == \
                    jspmd_dr.pmv_sharded_rows(v, e, shape[1])


def test_stacked_pmv_roundtrip_matches_jax():
    """Each rank's ``ShardedPmv`` slice is its shard of the JAX package's
    stacked [n_model * phys, 128] state, after init and after a refresh
    (p lanes replaced, moments kept); the slices unpack to the table."""
    rng = np.random.default_rng(0)
    v, e, n_model = 101, 16, 8  # pads to 112 (slots=2 -> multiples of 16)
    table = rng.normal(size=(v, e)).astype(np.float32)
    assert spmd_dr.pmv_sharded_rows(v, e, n_model) == 112
    ranks = [spmd_dr.ShardedPmv(torch.from_numpy(table), _Rank(n_model, k))
             for k in range(n_model)]
    stack = lambda: torch.cat([r.state["pmv"] for r in ranks]).numpy()  # noqa: E731
    unpack = lambda: torch.cat([sparse_adam.pmv_unpack(r.state, r.v_shard, e)  # noqa: E731
                                for r in ranks])
    jst = jspmd_dr.pmv_init_sharded(jnp.pad(jnp.asarray(table), ((0, 11), (0, 0))), n_model)
    np.testing.assert_array_equal(stack(), np.asarray(jst["pmv"]))
    assert torch.equal(unpack()[:v], torch.from_numpy(table))
    t2 = rng.normal(size=(112, e)).astype(np.float32)
    for r in ranks:
        r.refresh(torch.from_numpy(t2))
    jst2 = jspmd_dr.pmv_refresh_sharded(jst, jnp.asarray(t2), n_model)
    np.testing.assert_array_equal(stack(), np.asarray(jst2["pmv"]))
    assert torch.equal(unpack(), torch.from_numpy(t2))


@pytest.mark.parametrize("v,e,n_model", [(64, 16, 8), (64, 48, 8), (96, 8, 4), (32, 16, 1)])
def test_sharded_state_geometry_and_moments(v, e, n_model):
    """Each rank's state is one shard of the JAX package's stack; the stack
    of the port's slices has its shape, and state_moments reads the same
    [V, E] moments out of the same numbers."""
    shards = [spmd_sparse.sharded_state_zeros(v, e, n_model) for _ in range(n_model)]
    jst = jspmd_sparse.sharded_state_zeros(v, e, n_model)
    assert set(shards[0]) == set(jst)
    rng = np.random.default_rng(1)
    stack = {}
    for k in jst:
        if k == "count":
            continue
        assert sum(s[k].shape[0] for s in shards) == jst[k].shape[0]
        assert shards[0][k].shape[1:] == jst[k].shape[1:]
        stack[k] = rng.normal(size=jst[k].shape).astype(np.float32)
    m, vv = spmd_sparse.state_moments(stack, v, e, n_model)
    jm, jv = jspmd_sparse.state_moments(stack, v, e, n_model)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(vv, jv)
    assert m.shape == (v, e)


def test_a_non_mesh_is_refused():
    with pytest.raises(TypeError, match="DeviceMesh with mesh_dim_names"):
        meshlib.check_mesh(object())
    with pytest.raises(RuntimeError, match="not initialized"):
        meshlib.make_mesh(1, 1, device="cpu")
