"""The yardstick's frozen counts for Deep Retrieval serving: the model's
operations a query and the least time of a batch (its roofline bound).
Imports nothing of the program; the peaks are ``flops.py``'s.

A query's candidates are counted at their expected number, ``beam`` paths
of ``J N / K^D`` items each (the mapping is drawn uniformly, and the beam's
paths are chosen by weights drawn apart from it), so no count depends on
the program's layout or on the batch's data.
"""

from __future__ import annotations

import flops


def shape(cfg: dict) -> dict:
    """The serving shape of a configuration."""
    return {"l": cfg["seq_len"], "e": cfg["embed_size"], "k": cfg["num_node"],
            "depth": cfg["num_layer"], "beam": cfg["beam_size"], "topk": cfg["topk_number"],
            "j": cfg["num_path_per_item"], "items": cfg["items"]}


def candidates(s: dict) -> float:
    """Expected items on a query's beam paths."""
    return s["beam"] * s["j"] * s["items"] / s["k"] ** s["depth"]


def window_flops(s: dict) -> int:
    """A query's window part: each layer's ``Linear`` over the L window rows
    (2 L E K, once a query, shared by its paths) and the rerank user vector
    (2 L E E and the bias E)."""
    l, e, k = s["l"], s["e"], s["k"]
    return s["depth"] * 2 * l * e * k + 2 * l * e * e + e


def beam_flops(s: dict) -> int:
    """A query's path beam past the window part: at layer d, for each of
    its W paths (1 at d = 0, beam after), the prefix part 2 d E K, the bias
    K, the softmax 3K (exp, sum, divide) and, past d = 0, the joint product
    K."""
    e, k = s["e"], s["k"]
    total = 0
    for d in range(s["depth"]):
        w = 1 if d == 0 else s["beam"]
        total += w * (2 * d * e * k + k + 3 * k + (k if d else 0))
    return total


def rerank_flops(s: dict) -> float:
    """A query's candidate scores: ``w_i . u`` (2E) and the bias (1)."""
    return candidates(s) * (2 * s["e"] + 1)


def model_flops(s: dict) -> float:
    """All of the model's operations a query."""
    return window_flops(s) + beam_flops(s) + rerank_flops(s)


def serve_bound(s: dict, batch: int, consumed: int) -> float:
    """The least seconds of a batch of ``batch`` queries with ``consumed``
    ids each, stage by stage the larger of its bytes at HBM bandwidth and
    its operations at the f32 peak:

    - window: the int64 window and consumed ids, the window's bf16 layer
      and rerank rows (2E lanes a position), the heads' window weights and
      the rerank map (f32); the window part's operations;
    - beam: the heads' prefix weights and biases, the node rows, the int64
      paths out; the beam's operations;
    - rerank: a path-table entry (int32) and the path's items read once
      (bf16 weights and bias, an int32 id), the top-k ids (int64) and
      scores (f32) out; the scores' operations."""
    l, e, k, depth, beam = s["l"], s["e"], s["k"], s["depth"], s["beam"]
    window_bytes = (batch * (8 * l + 8 * consumed + 2 * 2 * e * l)
                    + 4 * (depth * k * l * e + e * l * e + e))
    beam_bytes = (4 * (sum(k * d * e + k for d in range(depth)) + k * (depth - 1) * e)
                  + 8 * batch * beam * depth)
    rerank_bytes = (batch * beam * 4 + batch * candidates(s) * (2 * (e + 1) + 4)
                    + batch * s["topk"] * (8 + 4))
    stages = ((window_bytes, batch * window_flops(s)), (beam_bytes, batch * beam_flops(s)),
              (rerank_bytes, batch * rerank_flops(s)))
    return sum(flops.bound(int(b), f32_flops=int(f))[0] for b, f in stages)
