"""Multi-process coordination helpers.

Port of ``dismember_tpu/core/multihost.py``.  Every process runs the same
program on the same global host batch; host-built artifacts (trees, path
mappings) are broadcast from rank 0 so the index is bitwise identical
everywhere, and each rank feeds its "data" rows of every global batch
(:func:`device_batch`).  Under ``torch.distributed`` a process is one
device, so the JAX package's per-host shard (``host_shard``) is the rank's
"data" rows here, and its placement of host values on the devices
(``replicated``) is a plain ``.to(device)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dismember_tpu_torch.core import mesh as meshlib


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _comm_device() -> torch.device:
    """Where the default group's collectives take their buffers."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_host0(arrays: list[np.ndarray]) -> list[np.ndarray]:
    """Rank 0's arrays on every rank (every rank passes arrays of the same
    shapes and dtypes).  Single-process: identity."""
    if process_count() == 1:
        return arrays
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(_comm_device())
        dist.broadcast(t, src=0)
        out.append(t.cpu().numpy())
    return out


def device_batch(mesh, *arrays: np.ndarray):
    """Global host batches -> this rank's "data" rows as tensors on the
    rank's device.  Each array is the full global batch (the same on every
    rank); its rows must split evenly over "data"."""
    dev = meshlib.mesh_device(mesh)
    out = []
    for a in arrays:
        rows = meshlib.local_rows(torch.from_numpy(np.ascontiguousarray(a)), mesh,
                                  meshlib.DATA_AXIS)
        out.append(rows.to(dev))
    return out[0] if len(out) == 1 else tuple(out)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def gather_to_host(tree, mesh=None, axis: str | None = None):
    """A full numpy pytree on every rank: with ``axis``, every leaf is this
    rank's row block along it and is all-gathered first; without, the
    leaves are replicated and only converted."""

    def conv(leaf):
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        if axis is not None:
            t = meshlib.all_gather_rows(t, mesh, axis)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    return _map(conv, tree)


def assert_same_across_hosts(x: np.ndarray, name: str = "array") -> None:
    """Guard: an index artifact must be identical on every process."""
    if process_count() == 1:
        return
    (ref,) = broadcast_from_host0([np.asarray(x)])
    same = np.array_equal(ref, x)
    flag = torch.tensor([0 if same else 1], device=_comm_device())
    dist.all_reduce(flag)
    if not same:
        raise AssertionError(
            f"{name} differs across hosts; broadcast it from host 0 "
            "(core.multihost.broadcast_from_host0)")
    if int(flag.item()):
        raise AssertionError(f"{name} differs on another host")
