"""What the tree scorers (``DIN``, ``DeepFM``) share: parameters keyed as the
JAX package's params pytree, their numpy form, and the grouped forward built
from the scorer's own ``precompute_seq`` and ``apply_from_emb``.

A scorer takes candidate codes [B, U] (-1 invalid) and query sequences
[B, L] (-1 padding) and returns logits [B, U].  Serving hoists the
level-invariant sequence side out of the beam loop (``precompute_seq``);
the packed loop feeds gathered candidate embeddings (``apply_from_emb``);
the trainers differentiate ``train_apply_from_emb`` on gathered rows, with
the sequence side from ``ctx_from_seq_emb``.
"""

from __future__ import annotations

import torch
from torch import nn

from dismember_tpu_torch.core.checkpoint import to_numpy, to_tensor
from dismember_tpu_torch.models.embedding import embed_lookup

INIT_STD = 0.05  # N(0, 0.05) weights, as both JAX scorers' init_params


class TreeScorer(nn.Module):
    """Base of the scorers; a subclass sets ``model_type`` and defines
    ``param_tree``, ``precompute_seq``, ``ctx_from_seq_emb``,
    ``apply_from_emb`` and ``train_apply_from_emb``."""

    model_type: str
    embedding: nn.Parameter

    @property
    def embed_size(self) -> int:
        return self.embedding.shape[1]

    @torch.no_grad()
    def _init_normal(self, weights, biases, generator: torch.Generator | None) -> None:
        """``weights`` drawn N(0, INIT_STD) in order on the CPU from
        ``generator`` (the same model on every device), ``biases`` zeroed."""
        for w in weights:
            w.copy_(torch.randn(w.shape, generator=generator) * INIT_STD)
        for b in biases:
            b.zero_()

    def param_tree(self) -> dict:
        raise NotImplementedError

    def params_numpy(self) -> dict:
        """The params pytree as numpy arrays (loads into the JAX package)."""

        def conv(node):
            if isinstance(node, dict):
                return {k: conv(v) for k, v in node.items()}
            return to_numpy(node)

        return conv(self.param_tree())

    @torch.no_grad()
    def load_numpy(self, params: dict) -> None:
        """Copy a params pytree of arrays in, each at its parameter's dtype;
        shapes must match."""

        def copy(dst, src, path):
            if isinstance(dst, dict):
                for k in dst:
                    copy(dst[k], src[k], f"{path}/{k}" if path else k)
                return
            src = to_tensor(src, dst.dtype)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{path}: shape {tuple(src.shape)}, expected {tuple(dst.shape)}"
                )
            dst.copy_(src)

        copy(self.param_tree(), params, "")

    def forward(self, items: torch.Tensor, seqs: torch.Tensor) -> torch.Tensor:
        """Grouped forward: items [B, U] codes (-1 invalid), seqs [B, L] codes
        (-1 padding) -> logits [B, U] (pre-sigmoid)."""
        return self.apply_with_ctx(items, self.precompute_seq(seqs))

    def apply_with_ctx(self, items: torch.Tensor, ctx) -> torch.Tensor:
        """forward() with the sequence side from ``precompute_seq``."""
        return self.apply_from_emb(embed_lookup(self.embedding, items), ctx)
