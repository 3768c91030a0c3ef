"""What the drivers share: the program's DIN built around the benchmark's
weights, the category-sorted tree, and small helpers.

A driver is a class ``Driver(cfg, mix, seed, device)`` whose constructor is
the cell's set-up, with ``METRIC`` (its end-to-end rate) and
``PEAK_FLOPS``, and the methods ``warmup()``, ``unit(spans) -> work``,
``drain()``, ``layer_stretch(spans)``, ``profile_stretch() -> units``,
``kernel_bounds()``, ``model_flops(window)``, ``release()``,
``check(limits) -> {name: {"value", "limit"}}`` and, for ``calibrate.py``
after ``check``, ``calibrate() -> {"control" | "fault_*": {name: value}}``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import flops
import inputs


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def now() -> float:
    return time.perf_counter()


def scale(cfg: dict) -> tuple[float, float]:
    """(embedding std, weight std) of the benchmark's weights."""
    s = cfg["assumed"]["weights"]
    return s["embedding_std"], s["weight_std"]


def din_module(w: dict, dev: torch.device):
    """The program's DIN holding the benchmark's weights (no copy of the
    table: its parameter is the tensor)."""
    from dismember_tpu_torch.models.din import DIN

    model = DIN(1, w["table"].shape[1], device=dev)
    model.embedding.data = w["table"]
    _copy_towers(model, w)
    return model


def load_into(model, w: dict) -> None:
    """Copy the benchmark's weights into a program model's parameters."""
    with torch.no_grad():
        model.embedding.copy_(w["table"])
    _copy_towers(model, w)


@torch.no_grad()
def _copy_towers(model, w: dict) -> None:
    model.att_linear.weight.copy_(w["att_w"])
    model.mlp1.weight.copy_(w["w1"])
    model.mlp1.bias.copy_(w["b1"])
    model.mlp2.weight.copy_(w["w2"])
    model.mlp2.bias.copy_(w["b2"])


def k2_commit_bound(flat: torch.Tensor, e: int) -> float:
    """K2's least seconds for the pmv commit of one step touching the codes
    ``flat`` (-1 pads): the distinct physical rows of its live codes, and
    the scratch row where a slot is dead or repeated."""
    from dismember_tpu_torch.train.sparse_adam import pmv_slots

    live = torch.unique(flat[flat >= 0])
    written = int(torch.unique(live // pmv_slots(e)).numel()) + int(len(live) < len(flat))
    return flops.row_bound(len(flat), written, 128)[0]


def program_tree(cfg: dict):
    """The program's category-sorted tree of the catalog, built in memory as
    ``tdm-initialize-tree`` builds it."""
    from dismember_tpu_torch.index.arraytree import ArrayTree
    from dismember_tpu_torch.index.tree_io import build_tree, category_sorted_codes

    ids, cats = inputs.catalog(cfg)
    sid, codes = category_sorted_codes(ids, cats)
    return ArrayTree.from_loaded(build_tree(sid, codes))


def weights(cfg: dict, seed: int, num_index: int, dev) -> dict:
    emb_std, w_std = scale(cfg)
    return inputs.din_weights(seed, num_index, cfg["embed_size"], dev, emb_std, w_std)


def tower(w: dict) -> dict:
    """The towers of a weight dict keyed as the reference takes them."""
    return {k: w[k] for k in ("att_w", "w1", "b1", "w2", "b2")}


def finite(x: float, cap: float = 1e30) -> float:
    """A number the result line can carry (JSON has no infinity)."""
    x = float(x)
    return cap if not np.isfinite(x) else min(x, cap)
