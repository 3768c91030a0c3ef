"""DIN scorer: shared embedding + scaled-dot attention + MLP.

Port of ``dismember_tpu/models/din.py`` (DIN.scala in the reference):
- one embedding table over all tree-node codes, shared by the target item
  and the behavior sequence;
- attention: Q = target embedding, K = V = sequence embeddings, scores
  scaled by 1/sqrt(E), padded positions masked to MASK_VALUE before the
  softmax, output through a bias-free Linear(E, E);
- concat([item, attention]) -> Linear(2E, E) -> ReLU -> Linear(E, 1) logit.

Weights are stored as the JAX package stores them: ``att_linear`` [E, E],
``mlp1`` [E, 2E] + bias [E], ``mlp2`` [1, E] + bias [1], all applied as
``x @ W.T`` (``nn.Linear``'s layout).  Serving scores go through K1
(``ops/din_kernel.din_score``), which is forward only and refuses inputs
that require grad on CUDA.  Training scores through
:meth:`DIN.train_apply_from_emb`: the same arithmetic in plain PyTorch ops
under autograd, as the JAX package differentiates ``din.apply_from_emb`` in
XLA outside any Pallas kernel.  Init: N(0, 0.05) weights, zero biases,
drawn on the CPU from an explicit ``torch.Generator`` so a seed gives the
same model on every device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dismember_tpu_torch.constants import PADDING_IDX
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.models.embedding import embed_lookup
from dismember_tpu_torch.models.scorer import TreeScorer
from dismember_tpu_torch.ops.din_kernel import din_score, score_chain


class DIN(TreeScorer):
    model_type = "din"

    def __init__(self, num_index: int, embed_size: int, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        e = embed_size
        self.embedding = nn.Parameter(torch.empty(num_index, e, device=dev))
        self.att_linear = nn.Linear(e, e, bias=False, device=dev)
        self.mlp1 = nn.Linear(2 * e, e, device=dev)
        self.mlp2 = nn.Linear(e, 1, device=dev)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self._init_normal((self.embedding, self.att_linear.weight, self.mlp1.weight,
                           self.mlp2.weight), (self.mlp1.bias, self.mlp2.bias), generator)

    def param_tree(self) -> dict:
        """Parameters keyed as the JAX package's params pytree."""
        return {
            "embedding": self.embedding,
            "att_linear": {"weight": self.att_linear.weight},
            "mlp1": {"weight": self.mlp1.weight, "bias": self.mlp1.bias},
            "mlp2": {"weight": self.mlp2.weight, "bias": self.mlp2.bias},
        }

    def scorer_weights(self) -> tuple[torch.Tensor, ...]:
        """(att_w, w1, b1, w2, b2) as the kernels take them."""
        return (self.att_linear.weight, self.mlp1.weight, self.mlp1.bias,
                self.mlp2.weight, self.mlp2.bias)

    def precompute_seq(self, seqs: torch.Tensor):
        """Per-query context, computed once for all beam levels:
        (sequence embeddings [B, L, E], padding mask [B, L] float32)."""
        seq_e = embed_lookup(self.embedding, seqs)
        return seq_e, (seqs == PADDING_IDX).to(torch.float32)

    def apply_from_emb(self, item_e: torch.Tensor, ctx) -> torch.Tensor:
        """Score candidates whose embeddings [B, U, E] are already gathered."""
        seq_e, pad = ctx
        return din_score(item_e, seq_e, pad, *self.scorer_weights())

    @staticmethod
    def ctx_from_seq_emb(seq_e: torch.Tensor, pad: torch.Tensor):
        """precompute_seq from already-gathered sequence embeddings [B, L, E]
        and the padding mask [B, L] (float32, 1.0 where padding); used by the
        trainers, which differentiate w.r.t. the gathered rows."""
        return seq_e, pad

    def train_apply_from_emb(self, item_e: torch.Tensor, ctx) -> torch.Tensor:
        """:meth:`apply_from_emb` with gradients: plain PyTorch ops on any
        device, for the train steps."""
        seq_e, pad = ctx
        return score_chain(item_e, seq_e, pad, *self.scorer_weights())


def params_from_numpy(params: dict, device="cuda") -> DIN:
    """A DIN holding the weights of a params pytree of arrays (names and
    shapes as the JAX package's ``din.init_params``)."""
    num_index, embed_size = np.shape(params["embedding"])
    model = DIN(num_index, embed_size, device=device)
    model.load_numpy(params)
    return model
