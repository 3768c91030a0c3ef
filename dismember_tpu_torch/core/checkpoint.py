"""Checkpoints of parameter trees: the JAX package's ``.npz`` format.

A tree is nested dicts and lists of arrays (numpy or torch).  It is
flattened to ``/``-joined key paths (``embedding``, ``att_linear/weight``,
``heads/0/bias``, ...), the key scheme of ``dismember_tpu/core/checkpoint.py``
(a dict key or a list index per level), plus an optional ``.meta.json``
sidecar, so a checkpoint saved by either package loads in the other.

A bf16 leaf is stored as the JAX package's ``np.savez`` stores a JAX bf16
array: its raw 2-byte bits under a ``V2`` descriptor.  :func:`to_tensor`
reads such a leaf (from a file, or a JAX array's numpy view) back as
``torch.bfloat16`` bits, so no bf16 numpy dtype package is needed.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from dismember_tpu_torch.core.io import open_file, stage_in, stage_out


def _children(node):
    """(key, child) pairs of an inner node, in the JAX package's order
    (dict keys sorted, list entries by index); None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Nested dicts and lists -> {"a/0/b": leaf}: the checkpoints' key paths."""
    out: dict[str, Any] = {}
    for k, v in _children(tree):
        path = f"{prefix}/{k}" if prefix else k
        if _children(v) is None:
            out[path] = v
        else:
            out.update(flatten(v, path))
    return out


_BF16_BITS = np.dtype("V2")


def to_numpy(v) -> np.ndarray:
    """A leaf as numpy; a bf16 tensor as its raw bits under ``V2``."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(_BF16_BITS)
        return v.numpy()
    return np.asarray(v)


def to_tensor(a, dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """A numpy leaf as a tensor (a copy), then cast to ``dtype``: 2-byte
    void leaves (``V2`` from a checkpoint, or a JAX bf16 array's numpy
    view) are bf16 bits."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def save_pytree(path: str, tree, meta: dict | None = None) -> None:
    """Save nested dicts and lists of arrays to ``path`` (.npz) with
    optional meta."""
    arrays = {k: to_numpy(v) for k, v in flatten(tree).items()}
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with stage_out(npz_path) as local:
        np.savez(local, **arrays)
    if meta is not None:
        with open_file(_meta_path(path), "w", encoding="utf-8") as f:
            f.write(json.dumps(meta))


def load_pytree(path: str, like):
    """Load the arrays saved by :func:`save_pytree` (either package) into
    nested dicts and lists of numpy arrays shaped as ``like``."""
    npz_path = path if path.endswith(".npz") else path + ".npz"

    def fill(node, prefix: str, data):
        if _children(node) is None:
            return data[prefix]
        out = {k: fill(v, f"{prefix}/{k}" if prefix else k, data)
               for k, v in _children(node)}
        if isinstance(node, dict):
            return {k: out[str(k)] for k in node}
        return type(node)(out[str(i)] for i in range(len(node)))

    with stage_in(npz_path) as local:
        with np.load(local) as data:
            return fill(like, "", data)


def load_meta(path: str) -> dict:
    with open_file(_meta_path(path), "r", encoding="utf-8") as f:
        return json.loads(f.read())


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"
