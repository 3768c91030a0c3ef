"""TDM model construction and the scorer functions serving needs.

Port of ``build_model``, ``serving_fns``, ``packed_fns`` and
``MATMUL_FIRST_SCORERS`` from ``dismember_tpu/train/tdm.py``, DIN only.  The
scorer functions are unbound ``DIN`` methods, so they take the model first,
as the JAX package's take the params first.  The trainer comes with the
training slice.
"""

from __future__ import annotations

import torch

from dismember_tpu_torch.models.din import DIN

_DEEPFM_TODO = (
    "the DeepFM scorer is not ported yet (ROADMAP queue 1 item 9: "
    "models/deepfm.py)"
)


def build_model(model_type: str, tree_max_level: int, embed_size: int,
                seq_len: int, generator: torch.Generator | None = None,
                device="cuda") -> DIN:
    """The scorer over tree-node codes, num_index = 2^(max_level+1) - 1
    (DIN.buildModel).  ``seq_len`` sizes DeepFM, which is not ported."""
    num_index = (1 << (tree_max_level + 1)) - 1
    if model_type == "din":
        return DIN(num_index, embed_size, device=device, generator=generator)
    if model_type == "deepfm":
        raise NotImplementedError(_DEEPFM_TODO)
    raise ValueError(f"unknown deep model: {model_type}")


def _din_only(model_type: str) -> None:
    if model_type == "deepfm":
        raise NotImplementedError(_DEEPFM_TODO)
    if model_type != "din":
        raise ValueError(f"unknown deep model: {model_type}")


def serving_fns(model_type: str):
    """(precompute, apply) pair with the level-invariant sequence side hoisted
    out of the beam-search level loop."""
    _din_only(model_type)
    return DIN.precompute_seq, DIN.apply_with_ctx


def packed_fns(model_type: str):
    """(precompute, apply_from_emb) pair for the packed pair-table loop."""
    _din_only(model_type)
    return DIN.precompute_seq, DIN.apply_from_emb


# Scorers whose every use of the candidate embedding flows through a matmul,
# so bf16 pair-table lanes cannot change their scores.
MATMUL_FIRST_SCORERS = frozenset({"din"})
