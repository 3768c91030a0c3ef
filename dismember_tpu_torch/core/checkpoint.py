"""Checkpoints of parameter trees: the JAX package's ``.npz`` format.

A tree is nested dicts and lists of arrays (numpy or torch).  It is
flattened to ``/``-joined key paths (``embedding``, ``att_linear/weight``,
``heads/0/bias``, ...), the key scheme of ``dismember_tpu/core/checkpoint.py``
(a dict key or a list index per level), plus an optional ``.meta.json``
sidecar, so a checkpoint saved by either package loads in the other.
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


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_pytree(path: str, tree, meta: dict | None = None) -> None:
    """Save nested dicts and lists of arrays to ``path`` (.npz) with
    optional meta."""
    arrays = {k: _to_numpy(v) for k, v in flatten(tree).items()}
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
