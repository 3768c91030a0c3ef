"""Batched Deep Retrieval path beam search.

Port of ``dismember_tpu/retrieval/path_beam.py`` (deep-retrieval's
CandidateSearcher.scala:22-58): from the bare sequence, at each of the D
layers score all K nodes for every kept path, multiply the softmax over K
by the running path probability, and keep the top ``beam`` of the W*K
joint probabilities.  The whole batch advances a layer at a time: each
head's sequence part is computed once a query, the prefix part is a
[B, W, dE] x [dE, K] product.  Selection is ``torch.topk`` + ``gather``
(the JAX package's one-hot select is a TPU workaround); ``torch.topk``
orders equal probabilities differently from ``lax.top_k``, so beams agree
as sets on near ties.  The search is the span ``path_beam.search`` (the D
layers issued, no synchronize).
"""

from __future__ import annotations

import torch

from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.models.dr_models import layer_forward_beam, layer_seq_parts


@torch.no_grad()
def path_beam_search(params: dict, seqs: torch.Tensor, beam: int, num_items: int,
                     num_nodes: int, num_layers: int, seq_parts=None):
    """(paths [B, beam, D] int64, probs [B, beam] f32) for sequences
    [B, L] (-1 pad).  ``seq_parts``: the per-layer sequence contributions
    when the caller computed them (the block serving route does, from its
    bf16 table).  With K < beam the first layer's beam is padded with node
    0 at probability 0, as in the JAX package."""
    with profiling.span("path_beam.search"):
        b = seqs.shape[0]
        if seq_parts is None:
            seq_parts = layer_seq_parts(params, seqs)
        empty = torch.zeros((b, 1, 0), dtype=torch.long, device=seqs.device)
        logits0 = layer_forward_beam(params, seq_parts[0], empty, 0, num_items, num_nodes)
        probs0 = torch.softmax(logits0[:, 0, :], dim=-1)  # [B, K]
        k_eff = min(beam, num_nodes)
        probs, nodes = torch.topk(probs0, k_eff, dim=1)
        if k_eff < beam:
            pad = beam - k_eff
            probs = torch.nn.functional.pad(probs, (0, pad))
            nodes = torch.nn.functional.pad(nodes, (0, pad))
        paths = nodes[:, :, None]  # [B, beam, 1]
        for d in range(1, num_layers):
            logits = layer_forward_beam(params, seq_parts[d], paths, d, num_items, num_nodes)
            joint = probs[:, :, None] * torch.softmax(logits, dim=-1)  # [B, beam, K]
            probs, top_idx = torch.topk(joint.reshape(b, -1), beam, dim=1)
            prev = torch.gather(paths, 1, (top_idx // num_nodes)[:, :, None].expand(-1, -1, d))
            paths = torch.cat([prev, (top_idx % num_nodes)[:, :, None]], 2)
        return paths, probs
