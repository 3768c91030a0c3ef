"""Embedding lookup with padding semantics: index -1 (PADDING_IDX) yields a
zero row (scalann LookupTable)."""

from __future__ import annotations

import torch

from dismember_tpu_torch.constants import PADDING_IDX


def embed_lookup(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table [V, E], indices [...] int -> [..., E] float32 with -1 -> zeros."""
    valid = indices != PADDING_IDX
    out = table[torch.where(valid, indices, 0)]
    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out * valid[..., None].to(out.dtype)
