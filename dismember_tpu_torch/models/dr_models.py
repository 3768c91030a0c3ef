"""Deep Retrieval models: the D-head layer model, the rerank model and the
sampled softmax.

Port of ``dismember_tpu/models/dr_models.py`` (deep-retrieval's
LayerModel.scala, RerankModel.scala and scalann's SampledSoftmaxLoss.scala):
- layer model: one embedding over ``num_items + K*(D-1)`` rows (item ids,
  then path node ``node`` at position i in row ``num_items + i*K + node``);
  head d maps (sequence ++ path[0..d)) embeddings flattened through
  Linear((L+d)E, K), split into a sequence part computed once per query and
  a prefix part;
- rerank model: item embedding -> flatten -> Linear(LE, E) user vector,
  scored against per-item softmax weight rows plus biases;
- sampled softmax (batchMode=false): per row, the label and ``num_sampled``
  uniform negatives without replacement that exclude it; CE at position 0.

Parameters are plain dicts of tensors keyed as the JAX package's pytrees
(``{"embedding", "heads": [{"weight", "bias"}, ...]}`` and
``{"embedding", "linear": {"weight", "bias"}, "softmax_w", "softmax_b"}``),
all applied as ``x @ W.T``, so checkpoints load in either package.  Init
draws N(0, 0.05) from an explicit ``torch.Generator`` on the tables' device
(the 10M-item tables are built there, not copied from the host), so a seed
gives the same model on every device of one type, not JAX's draws.
Negatives come from a ``torch.Generator`` too; :func:`sampled_softmax_loss_given`
takes them as given, which is how the tests feed both packages the same
ones.  No kernel runs here: the products are small matmuls.
"""

from __future__ import annotations

import numpy as np
import torch

from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.models.embedding import embed_lookup

_INIT_STD = 0.05

# exact Gumbel-top-k negative sampling materializes [B, num_items]; above
# this catalog size the rejection draw is used instead
_EXACT_SAMPLING_MAX = 1 << 18
# full_softmax_loss materializes [B, num_items] logits; above this item
# count it takes a chunked log-sum-exp (the same result)
_FULL_SOFTMAX_MAX = 1 << 18


def _randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * _INIT_STD


# --------------------------------------------------------------------------
# Layer model
# --------------------------------------------------------------------------


def init_layer_params(generator: torch.Generator, num_items: int, num_nodes: int,
                      num_layers: int, seq_len: int, embed_size: int,
                      device="cuda") -> dict:
    dev = resolve_device(device)
    rows = num_items + num_nodes * (num_layers - 1)
    return {
        "embedding": _randn((rows, embed_size), generator, dev),
        "heads": [{"weight": _randn((num_nodes, (seq_len + d) * embed_size), generator, dev),
                   "bias": torch.zeros(num_nodes, device=dev)}
                  for d in range(num_layers)],
    }


def prefix_rows(paths: torch.Tensor, num_items: int, num_nodes: int, depth: int) -> torch.Tensor:
    """Embedding rows of the first ``depth`` nodes of ``paths`` [..., D]."""
    offsets = num_items + torch.arange(depth, device=paths.device) * num_nodes
    return paths[..., :depth].long() + offsets


def layer_logits_from_emb(heads: list, seq_e: torch.Tensor, prefix_e: torch.Tensor,
                          num_nodes: int) -> list[torch.Tensor]:
    """Per-layer logits [B, J, K] from gathered embeddings: ``seq_e``
    [B, L, E] (padding rows zeroed) and ``prefix_e`` [B, J, D-1, E], the
    path nodes by position; layer d reads positions [0, d)."""
    b, l, e = seq_e.shape
    j = prefix_e.shape[1]
    seq_flat = seq_e.reshape(b, l * e)
    out = []
    for d, head in enumerate(heads):
        w, bias = head["weight"], head["bias"]
        seq_part = seq_flat @ w[:, : l * e].T  # [B, K], shared by the J paths
        if d == 0:
            out.append((seq_part[:, None, :] + bias).expand(b, j, num_nodes))
        else:
            prefix_flat = prefix_e[:, :, :d].reshape(b, j, d * e)
            out.append(seq_part[:, None, :] + prefix_flat @ w[:, l * e :].T + bias)
    return out


def layer_forward_training(params: dict, seqs: torch.Tensor, paths: torch.Tensor,
                           num_items: int, num_nodes: int) -> list[torch.Tensor]:
    """Logits per layer, a list of [B, J, K]: layer d scores the sequence
    [B, L] (-1 pad) plus the path prefix ``paths[:, :, :d]`` of [B, J, D]."""
    table = params["embedding"]
    depth = paths.shape[2] - 1
    prefix_e = table[prefix_rows(paths, num_items, num_nodes, depth)]
    return layer_logits_from_emb(params["heads"], embed_lookup(table, seqs), prefix_e,
                                 num_nodes)


def layer_seq_parts(params: dict, seqs: torch.Tensor) -> list[torch.Tensor]:
    """Per-layer sequence contributions [B, K], computed once a query."""
    table = params["embedding"]
    b, l = seqs.shape
    seq_flat = embed_lookup(table, seqs).reshape(b, -1)
    return [seq_flat @ h["weight"][:, : seq_flat.shape[1]].T for h in params["heads"]]


def layer_forward_beam(params: dict, seq_part_d: torch.Tensor, prefix: torch.Tensor,
                       d: int, num_items: int, num_nodes: int) -> torch.Tensor:
    """Layer d's logits [B, W, K] for W candidate prefixes [B, W, d],
    gathered from the node region of the table (rows past the items)."""
    bias = params["heads"][d]["bias"]
    if d == 0:
        return seq_part_d[:, None, :] + bias
    table = params["embedding"]
    node_table = table[num_items:]
    e = table.shape[1]
    offsets = torch.arange(d, device=prefix.device) * num_nodes
    bsz, w_beam = prefix.shape[:2]
    prefix_flat = node_table[prefix.long() + offsets].reshape(bsz, w_beam, d * e)
    w = params["heads"][d]["weight"]
    return seq_part_d[:, None, :] + prefix_flat @ w[:, w.shape[1] - d * e :].T + bias


# --------------------------------------------------------------------------
# Rerank model
# --------------------------------------------------------------------------


def init_rerank_params(generator: torch.Generator, num_items: int, seq_len: int,
                       embed_size: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {
        "embedding": _randn((num_items, embed_size), generator, dev),
        "linear": {"weight": _randn((embed_size, seq_len * embed_size), generator, dev),
                   "bias": torch.zeros(embed_size, device=dev)},
        "softmax_w": _randn((num_items, embed_size), generator, dev),
        "softmax_b": torch.zeros(num_items, device=dev),
    }


def user_vector_from_emb(linear: dict, seq_e: torch.Tensor) -> torch.Tensor:
    """[B, L, E] sequence embeddings -> user vectors [B, E]."""
    return seq_e.reshape(seq_e.shape[0], -1) @ linear["weight"].T + linear["bias"]


def rerank_user_vector(params: dict, seqs: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, E]."""
    return user_vector_from_emb(params["linear"], embed_lookup(params["embedding"], seqs))


def sample_negatives(generator: torch.Generator, labels: torch.Tensor, num_items: int,
                     num_sampled: int) -> torch.Tensor:
    """[B] labels -> [B, S] uniform negatives, no duplicates, != label.

    Exact without-replacement Gumbel top-k up to 2^18 items; above that the
    first S of ``2S+16`` uniform candidates ranked valid-first (not the
    label, not an earlier candidate's repeat): the residual chance of a
    repeat or the label is below S*(2S+16)/2^18 a row."""
    b = labels.shape[0]
    dev = labels.device
    labels = labels.long()
    if num_items <= _EXACT_SAMPLING_MAX:
        u = torch.rand((b, num_items), generator=generator, device=dev).clamp_(1e-20, 1.0)
        g = -torch.log(-torch.log(u))
        g[torch.arange(b, device=dev), labels] = -float("inf")
        return torch.topk(g, num_sampled, dim=1).indices
    m = 2 * num_sampled + 16
    cand = torch.randint(0, num_items, (b, m), generator=generator, device=dev)
    tri = torch.ones(m, m, dtype=torch.bool, device=dev).tril(-1)
    dup = ((cand[:, :, None] == cand[:, None, :]) & tri).any(-1)
    ok = (cand != labels[:, None]) & ~dup
    arange = torch.arange(m, device=dev)
    rank = torch.where(ok, arange, m + arange)
    order = torch.argsort(rank, dim=1)[:, :num_sampled]
    return torch.gather(cand, 1, order)


def sampled_logits(user_vecs: torch.Tensor, w_rows: torch.Tensor,
                   b_rows: torch.Tensor) -> torch.Tensor:
    """[B, E] user vectors against candidate rows [B, C, E] and biases
    [B, C] -> logits [B, C]."""
    return torch.einsum("be,bce->bc", user_vecs, w_rows) + b_rows


def sampled_softmax_loss_given(params: dict, user_vecs: torch.Tensor, labels: torch.Tensor,
                               negs: torch.Tensor) -> torch.Tensor:
    """The sampled softmax CE on given negatives [B, S]: candidates are
    [label, negatives...], the target is position 0."""
    cand = torch.cat([labels.long()[:, None], negs.long()], 1)  # [B, 1+S]
    logits = sampled_logits(user_vecs, params["softmax_w"][cand], params["softmax_b"][cand])
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()


def sampled_softmax_loss(params: dict, user_vecs: torch.Tensor, labels: torch.Tensor,
                         generator: torch.Generator, num_sampled: int) -> torch.Tensor:
    """Per-row sampled softmax (batchMode=false) with negatives drawn from
    ``generator``."""
    negs = sample_negatives(generator, labels, params["softmax_w"].shape[0], num_sampled)
    return sampled_softmax_loss_given(params, user_vecs, labels, negs)


def full_softmax_loss(params: dict, user_vecs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Exact softmax CE over all items (SampledSoftmaxLoss.fullEvaluate);
    above 2^18 items the log-sum-exp streams the catalog in chunks."""
    w, bias = params["softmax_w"], params["softmax_b"]
    n = w.shape[0]
    labels = labels.long()
    if n <= _FULL_SOFTMAX_MAX:
        logp = torch.log_softmax(user_vecs @ w.T + bias, dim=-1)
        return -torch.gather(logp, 1, labels[:, None])[:, 0].mean()
    chunk = _FULL_SOFTMAX_MAX >> 2
    lse = torch.full((user_vecs.shape[0],), -float("inf"), device=user_vecs.device)
    for s in range(0, n, chunk):
        logits = user_vecs @ w[s : s + chunk].T + bias[s : s + chunk]
        lse = torch.logaddexp(lse, torch.logsumexp(logits, dim=-1))
    picked = (user_vecs * w[labels]).sum(-1) + bias[labels]
    return -(picked - lse).mean()


def rerank_scores(params: dict, user_vecs: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Score candidate items [B, C] (-1 pads score as item 0) against user
    vectors [B, E]."""
    safe = candidates.long().clamp_min(0)
    return sampled_logits(user_vecs, params["softmax_w"][safe], params["softmax_b"][safe])


# --------------------------------------------------------------------------


def to_device_tree(tree, device):
    """Nested dicts and lists of arrays -> the same of f32 tensors on
    ``device``, copies (a trainer updates its tensors in place, and must
    not write through to the caller's arrays)."""
    if isinstance(tree, dict):
        return {k: to_device_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device_tree(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def dr_params_from_numpy(layer: dict, rerank: dict, device="cuda") -> tuple[dict, dict]:
    """(layer params, rerank params) as f32 tensors on ``device`` from
    pytrees of arrays (names and shapes as the JAX package's
    ``init_layer_params``/``init_rerank_params``)."""
    dev = resolve_device(device)
    return to_device_tree(layer, dev), to_device_tree(rerank, dev)
