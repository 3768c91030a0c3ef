"""Within-stage (step-level) checkpoint and resume for the train loops.

Port of ``dismember_tpu/train/step_resume.py``.  A periodic snapshot of
(params, optimizer state, random-stream cursors, loop position) makes a
killed train stage restartable bit for bit: the resumed run replays the
numpy permutation stream, the trainer's ``torch.Generator`` and the
optimizer trajectory of an uninterrupted one.

Atomicity: ONE ``.npz`` per snapshot, with the loop meta inside the archive
as a uint8-encoded JSON leaf (``__step_resume_meta__``), written to a
``.tmp`` file and ``os.replace``d, so a kill mid-write never leaves a
readable snapshot whose arrays and meta disagree.

Random streams: each trainer saves the numpy bit-generator state captured
right before the current epoch's permutation draw, plus the position in
the epoch; resume restores the state, re-draws the same permutation and
seeks.  The JAX package's PRNG key has its counterpart in the trainer's
``torch.Generator`` state (:func:`generator_state`), a uint8 leaf; a
generator on the card is saved the same way.  Leaves are flattened with
``core/checkpoint.flatten``'s key paths; bf16 leaves are stored as their
bits.

Mesh trainers: every rank gathers its row blocks into the layout a
single-device trainer saves (the same keys and arrays; padding rows cut),
rank 0 writes it, and on resume each rank takes its rows back.  A mesh's
snapshot thus equals the single-device trainer's at the same step (at a
(1, N) mesh, whose steps are the single-device ones) and loads on either.
The loop meta holds the trainer's step count (``"steps"``), which names
the sampling stream of a mesh trainer's next step.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from dismember_tpu_torch.core.checkpoint import flatten, to_numpy, to_tensor

_META_KEY = "__step_resume_meta__"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_step_state(path: str, tree: Any, meta: dict, mesh=None) -> None:
    """Atomically persist nested dicts and lists of arrays (tensors, numpy
    arrays or Python numbers) and JSON-able loop meta.  With a ``mesh``
    every rank calls it with the same whole ``tree``: rank 0 writes the
    file, and every rank waits at a barrier until it is in place."""
    if mesh is None or dist.get_rank() == 0:
        _write(path, tree, meta)
    if mesh is not None:
        dist.barrier()


def _write(path: str, tree: Any, meta: dict) -> None:
    arrays = {k: to_numpy(v) for k, v in flatten(tree).items()}
    if _META_KEY in arrays:
        raise ValueError(f"leaf name collides with {_META_KEY}")
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    dest = _npz_path(path)
    tmp = dest + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, dest)


def load_step_state(path: str, like: Any) -> tuple[Any, dict] | None:
    """A snapshot as (the structure of ``like`` with numpy leaves, meta);
    None when there is none."""
    dest = _npz_path(path)
    if not os.path.exists(dest):
        return None
    with np.load(dest) as data:
        meta = json.loads(bytes(data[_META_KEY]).decode("utf-8"))
        return _fill(like, "", data), meta


def saved_steps(meta: dict, mesh=None) -> int:
    """The trainer's step count a snapshot's meta holds (``"steps"``): a
    mesh trainer draws each step's samples from that step's stream.  A
    snapshot without it (the JAX package's) resumes a single-device
    trainer, which draws from its generator and needs no count."""
    if "steps" in meta:
        return int(meta["steps"])
    if mesh is not None:
        raise ValueError("the snapshot holds no step count; a mesh trainer cannot resume it")
    return 0


def _fill(node, prefix: str, data):
    if isinstance(node, dict):
        return {k: _fill(v, f"{prefix}/{k}" if prefix else str(k), data) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, f"{prefix}/{i}" if prefix else str(i), data)
                          for i, v in enumerate(node))
    return data[prefix]


def to_torch(loaded: Any, like: Any) -> Any:
    """``loaded`` (numpy leaves from :func:`load_step_state`) with every
    leaf taking the type of ``like``'s: a tensor of its dtype on its device,
    a Python int, or a numpy array."""
    if isinstance(like, dict):
        return {k: to_torch(loaded[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(to_torch(a, b) for a, b in zip(loaded, like))
    if isinstance(like, torch.Tensor):
        return to_tensor(loaded, like.dtype, like.device)
    if isinstance(like, int):
        return int(loaded)
    return np.asarray(loaded)


def generator_state(gen: torch.Generator) -> np.ndarray:
    """A ``torch.Generator``'s state (on any device) as uint8 bytes."""
    return gen.get_state().numpy().copy()


def set_generator_state(gen: torch.Generator, state) -> None:
    gen.set_state(torch.from_numpy(np.asarray(state, np.uint8).copy()))


def rng_state_to_json(rng: np.random.Generator) -> dict:
    """Bit-generator state as a JSON-able dict (PCG64 states are plain
    Python ints, which JSON round-trips at any precision)."""
    return rng.bit_generator.state


def rng_state_from_json(rng: np.random.Generator, state: dict) -> None:
    rng.bit_generator.state = state
