"""Checkpoints of parameter trees: the JAX package's ``.npz`` format.

A tree is a nested dict of arrays (numpy or torch).  It is flattened to
``/``-joined key paths (``embedding``, ``att_linear/weight``, ``mlp1/bias``,
...), the key scheme of ``dismember_tpu/core/checkpoint.py``, plus an
optional ``.meta.json`` sidecar, so a checkpoint saved by either package
loads in the other.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from dismember_tpu_torch.core.io import open_file, stage_in, stage_out


def flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {"a/b": leaf}, keys sorted: the checkpoints' key paths."""
    out: dict[str, Any] = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_pytree(path: str, tree: dict, meta: dict | None = None) -> None:
    """Save a nested dict of arrays to ``path`` (.npz) with optional meta."""
    arrays = {k: _to_numpy(v) for k, v in flatten(tree).items()}
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with stage_out(npz_path) as local:
        np.savez(local, **arrays)
    if meta is not None:
        with open_file(_meta_path(path), "w", encoding="utf-8") as f:
            f.write(json.dumps(meta))


def load_pytree(path: str, like: dict) -> dict:
    """Load the arrays saved by :func:`save_pytree` (either package) into a
    nested dict of numpy arrays with the keys of ``like``."""
    npz_path = path if path.endswith(".npz") else path + ".npz"

    def fill(node: dict, prefix: str, data) -> dict:
        out = {}
        for k, v in node.items():
            p = f"{prefix}/{k}" if prefix else str(k)
            out[k] = fill(v, p, data) if isinstance(v, dict) else data[p]
        return out

    with stage_in(npz_path) as local:
        with np.load(local) as data:
            return fill(like, "", data)


def load_meta(path: str) -> dict:
    with open_file(_meta_path(path), "r", encoding="utf-8") as f:
        return json.loads(f.read())


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"
