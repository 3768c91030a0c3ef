"""DeepFM scorer: factorization machine + DNN over [item; sequence] embeddings.

Port of ``dismember_tpu/models/deepfm.py`` (DeepFM.scala and scalann
FM.scala in the reference):
- one embedding table over all tree-node codes, shared by the target item
  and the behaviour sequence;
- FM term over the T = L + 1 vectors v_i of [item; seq]:
  (||sum_i v_i||^2 - sum_i ||v_i||^2) / 2;
- DNN: flatten -> Linear(T*E, T) -> ReLU -> Linear(T, 1);
- logit = FM + DNN.  No attention mask: padded positions are zero rows,
  whose FM and DNN terms vanish (useMask=false for DeepFM).

Grouped as DIN is: U candidates share one sequence, whose sum, squared norm
and DNN product (``precompute_seq``) are level-invariant.  Weights are
stored as the JAX package stores them: ``mlp1`` [T, T*E] + bias [T],
``mlp2`` [1, T] + bias [1], applied as ``x @ W.T``.  The JAX package scores
DeepFM through XLA ops, outside any Pallas kernel, so the port scores it
through plain PyTorch ops on every device, the products through
``torch.matmul``: it launches neither K1 nor K3, and its forward is
differentiable as it is.  Init: N(0, 0.05) weights, zero biases, drawn on
the CPU from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dismember_tpu_torch.constants import PADDING_IDX
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.models.embedding import embed_lookup
from dismember_tpu_torch.models.scorer import TreeScorer


class DeepFM(TreeScorer):
    model_type = "deepfm"

    def __init__(self, num_index: int, embed_size: int, seq_len: int, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        e, total = embed_size, seq_len + 1
        self.embedding = nn.Parameter(torch.empty(num_index, e, device=dev))
        self.mlp1 = nn.Linear(total * e, total, device=dev)
        self.mlp2 = nn.Linear(total, 1, device=dev)
        self._init_normal((self.embedding, self.mlp1.weight, self.mlp2.weight),
                          (self.mlp1.bias, self.mlp2.bias), generator)

    @property
    def seq_len(self) -> int:
        return self.mlp1.weight.shape[0] - 1

    def param_tree(self) -> dict:
        """Parameters keyed as the JAX package's params pytree."""
        return {
            "embedding": self.embedding,
            "mlp1": {"weight": self.mlp1.weight, "bias": self.mlp1.bias},
            "mlp2": {"weight": self.mlp2.weight, "bias": self.mlp2.bias},
        }

    def precompute_seq(self, seqs: torch.Tensor):
        """Per-query context, computed once for all beam levels: (sequence
        sum [B, E], squared norm [B], DNN sequence product [B, T])."""
        seq_e = embed_lookup(self.embedding, seqs)
        return self.ctx_from_seq_emb(seq_e, (seqs == PADDING_IDX).to(torch.float32))

    def ctx_from_seq_emb(self, seq_e: torch.Tensor, pad: torch.Tensor):
        """precompute_seq from already-gathered sequence embeddings [B, L, E];
        ``pad`` is unused, padded rows being zero already."""
        del pad
        e = seq_e.shape[-1]
        seq_sum = seq_e.sum(dim=1)
        seq_sq = (seq_e * seq_e).sum(dim=(1, 2))
        seq_dnn = seq_e.reshape(seq_e.shape[0], -1) @ self.mlp1.weight[:, e:].T
        return seq_sum, seq_sq, seq_dnn

    def apply_from_emb(self, item_e: torch.Tensor, ctx) -> torch.Tensor:
        """Score candidates whose embeddings [B, U, E] are already gathered;
        differentiable, so it is also the trainers' scorer."""
        seq_sum, seq_sq, seq_dnn = ctx
        e = item_e.shape[-1]
        total_sum = item_e + seq_sum[:, None, :]
        sum_square = (total_sum * total_sum).sum(dim=-1)
        square_sum = (item_e * item_e).sum(dim=-1) + seq_sq[:, None]
        fm = (sum_square - square_sum) * 0.5
        h = torch.relu(item_e @ self.mlp1.weight[:, :e].T + seq_dnn[:, None, :] + self.mlp1.bias)
        dnn = (h @ self.mlp2.weight.T + self.mlp2.bias)[..., 0]
        return fm + dnn

    def train_apply_from_emb(self, item_e: torch.Tensor, ctx) -> torch.Tensor:
        """The train steps' scorer: :meth:`apply_from_emb` itself."""
        return self.apply_from_emb(item_e, ctx)


def deepfm_params_from_numpy(params: dict, device="cuda") -> DeepFM:
    """A DeepFM holding the weights of a params pytree of arrays (names and
    shapes as the JAX package's ``deepfm.init_params``)."""
    num_index, embed_size = np.shape(params["embedding"])
    seq_len = np.shape(params["mlp1"]["weight"])[0] - 1
    model = DeepFM(num_index, embed_size, seq_len, device=device)
    model.load_numpy(params)
    return model
