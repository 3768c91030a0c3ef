"""The ('data', 'model') device mesh over ``torch.distributed``.

Port of ``dismember_tpu/core/mesh.py``.  The JAX package runs one program
over a mesh of devices; the port runs one process a device, each rank
running the same trainer code on the same global host batch, keeping its
"data" rows and its "model" table rows, and meeting the other ranks only in
collectives:

- P1 data parallelism: batches split on "data"; the tower gradients are
  summed over "data" and normalised by the global batch weight sum;
- P2 optimizer-state sharding: Adam moments follow their parameter's rows;
- P3 row-sharded tables: a 2-D ``embedding`` is row-sharded on "model";
  row lookups are a masked local gather plus an all-reduce over "model"
  (``train/spmd_sparse.gather_rows_sharded``).

The JAX package states these rules as sharding specs (``param_spec``,
``opt_state_spec``, ``batch_spec``); PyTorch has no object to return for
them, so the port applies them where the tensors are made: the trainers
keep the table's rows of their "model" shard (``train/row_step.py``,
``train/spmd_dr.py``) with their moments beside them, and every batch is
cut to the rank's "data" rows (:func:`data_rows`).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("data", "model")``; rank r sits at (r // n_model,
r % n_model), the JAX package's ``devices.reshape(n_data, n_model)`` order.
The backend is nccl on the cards and gloo on the CPU unless the caller names
one.  Two ranks cannot share one card under nccl, so ranks sharing a card
take gloo, which moves CUDA buffers through host memory itself.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dismember_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(
    init_method: str = "env://",
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device: str | torch.device = "cuda",
) -> torch.device:
    """Start the default process group (a ``file://`` or ``env://`` store)
    and return this rank's device: ``cuda:{local_rank % device_count}`` (the
    local rank from ``LOCAL_RANK``, else the rank), or the CPU when
    ``device="cpu"``.  The backend defaults to nccl on CUDA, gloo on the
    CPU.  A no-op apart from the device when the group is already up."""
    dev = resolve_device(device)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    return dev


def rank_layout(n_data: int, n_model: int) -> torch.Tensor:
    """[n_data, n_model] ranks: rank r at (r // n_model, r % n_model)."""
    return torch.arange(n_data * n_model).reshape(n_data, n_model)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """The ("data", "model") mesh over every rank of the default group;
    raises when n_data * n_model is not the world size."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call init_distributed first")
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} ranks")
    return DeviceMesh(dev.type, rank_layout(n_data, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself, or a TypeError naming what a mesh must be."""
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != (DATA_AXIS, MODEL_AXIS):
        raise TypeError(
            "mesh must be a torch.distributed DeviceMesh with mesh_dim_names "
            f"('data', 'model') (core.mesh.make_mesh), got {type(mesh).__name__}")
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def trainer_device(mesh, device: torch.device) -> torch.device:
    """The device of a trainer or learner given ``mesh``: ``device`` off a
    mesh; on one, the rank's device, which must be of ``device``'s type."""
    if mesh is None:
        return device
    check_mesh(mesh)
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh lies on {mesh.device_type}, the trainer on {device.type}")
    return mesh_device(mesh)


def data_size(mesh) -> int:
    """The "data" axis size (1 off a mesh)."""
    return 1 if mesh is None else axis_size(mesh, DATA_AXIS)


def data_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's "data" rows of a global batch (all of it off a mesh)."""
    return t if mesh is None else local_rows(t, mesh, DATA_AXIS)


def backend(mesh: DeviceMesh) -> str:
    """The collectives' transport: "nccl", or "gloo" (through host memory
    for CUDA tensors)."""
    return str(dist.get_backend(mesh.get_group(DATA_AXIS)))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# -- collectives ------------------------------------------------------------


def psum(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of ``t`` over ``axis``, in place (``t`` must be contiguous and
    own its buffer); returns ``t``."""
    dist.all_reduce(t.view(-1), group=mesh.get_group(axis))
    return t


def all_gather_rows(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on dim 0, in axis order
    (every rank's ``t`` has the same shape)."""
    n = axis_size(mesh, axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts, 0)


# -- row blocks ------------------------------------------------------------


def local_rows(full: torch.Tensor, mesh: DeviceMesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's row block of ``full`` (a view); the rows must split
    evenly over ``axis``."""
    n = axis_size(mesh, axis)
    if full.shape[0] % n:
        raise ValueError(f"{full.shape[0]} rows don't split over {n} '{axis}' shards")
    per = full.shape[0] // n
    i = axis_index(mesh, axis)
    return full[i * per : (i + 1) * per]


def full_rows(shard: torch.Tensor, mesh: DeviceMesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Inverse of :func:`local_rows`: the whole tensor on every rank."""
    return all_gather_rows(shard, mesh, axis)


def set_local_rows(shard: torch.Tensor, whole, mesh: DeviceMesh,
                   axis: str = MODEL_AXIS) -> None:
    """Copy this rank's row block of ``whole`` (a tensor or array holding
    the first rows of the whole tensor, as :func:`local_rows` splits it)
    into ``shard`` in place; rows past ``whole``'s end (padding) keep their
    values."""
    per = shard.shape[0]
    lo = axis_index(mesh, axis) * per
    rows = whole[lo : lo + per]
    if len(rows):
        shard[: len(rows)] = torch.as_tensor(rows).to(shard.device, shard.dtype)


def with_whole_table(method):
    """Run a trainer method inside the trainer's ``whole_table()`` block:
    on a mesh the row-sharded tables are gathered whole for the call and
    dropped after it (``train/row_step.py``, ``train/dr.py``)."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self.whole_table():
            return method(self, *args, **kwargs)

    return run
