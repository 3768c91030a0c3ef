"""Gradient compression codec for exchanges between hosts.

Port of ``dismember_tpu/core/compress.py``: capability parity with the
reference's FP16CompressedTensor (scalann parameters/FP16CompressedTensor.scala:
fp32 -> fp16 compress / decompress / parallel add, a parameter-server
heritage that is unused in-repo but part of the surface).  The trees are
nested dicts, lists and tuples of tensors; a cast rounds to nearest even,
as the JAX package's ``astype`` does, so both give the same bits.  bf16 is
the default; fp16 keeps the reference codec's format.
"""

from __future__ import annotations

import torch


def _map(fn, *trees):
    """``fn`` over the tensors of one or more trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def compress(tree, dtype: torch.dtype = torch.bfloat16):
    """fp32 tree -> reduced-precision tree."""
    return _map(lambda x: x.to(dtype), tree)


def decompress(tree, dtype: torch.dtype = torch.float32):
    return _map(lambda x: x.to(dtype), tree)


def compressed_add(a, b, acc_dtype: torch.dtype = torch.float32):
    """Add two compressed trees with fp32 accumulation (parAdd parity: the
    reference sums fp16 buffers slice-parallel; accumulating in fp32 avoids
    its precision loss); the sums keep ``a``'s dtype."""
    return _map(lambda x, y: (x.to(acc_dtype) + y.to(acc_dtype)).to(x.dtype), a, b)
