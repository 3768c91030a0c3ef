"""K3: one level of the packed pair-row beam search.

Replaces the Pallas kernel
``dismember_tpu/ops/packed_level_kernel.py::_level_kernel`` (scorer
``_score_chain``, entry ``packed_level_pallas``).  Per query row it takes
the gathered pair rows of the ``beam`` surviving parents,

  lanes [0, E)         left-child embedding     lanes [E, 2E)   right child
  lanes [2E, 2E+2)     child exists flags (l, r)
  lanes [2E+2, 2E+6)   child id hi/lo floats (hi_l, lo_l, hi_r, lo_r)

scores both children with the DIN scorer, matmul operands rounded to bf16
with f32 accumulation (the TPU MXU's default precision), sets -3.4e38 where
the child is missing or its parent is dead, and copies the id lanes through
bit-exactly.  Outputs are block-ordered: scores [B, 2*beam] = [left | right]
and hilo [B, 2*beam, 2].

:func:`packed_level` launches ``packed_level_bf16`` (``csrc/din_kernels.cu``)
for CUDA tensors and :func:`packed_level_plain` for CPU tensors; the kernel
is built for E=16 and L <= 16 only.  It runs its products on the tensor
cores (bf16 operands are the contract), so on the H100 at the serving
shapes (B=4096, beam=20) it is bound by bytes: of each 128-lane row it needs
the 2E+6 = 38 used lanes (~12.5 MB a level, ~17.5 MB with the sequence
tiles and outputs).  The row gather stays outside it.
"""

from __future__ import annotations

import torch

from dismember_tpu_torch.ops import _cuda
from dismember_tpu_torch.ops.din_kernel import score_chain

NEG_INF = -3.4e38  # score of a missing child or dead parent
_MAX_L = 16  # the kernel pads the sequence to one 16-wide mma tile

# K3 launches on CUDA tensors; chip_smoke.py zeroes and reads it
launches = 0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def packed_level_plain(rows, alive, seq_e, pad, att_w, w1, b1, w2, b2,
                       embed_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's plain version: the same six bf16 roundings as the kernel."""
    e = embed_size
    item_e = torch.cat([rows[..., :e], rows[..., e : 2 * e]], dim=1)
    exists = torch.cat([rows[..., 2 * e], rows[..., 2 * e + 1]], dim=1) > 0
    hilo = torch.cat(
        [rows[..., 2 * e + 2 : 2 * e + 4], rows[..., 2 * e + 4 : 2 * e + 6]], dim=1
    )
    ok = exists & (alive > 0).repeat(1, 2)
    logit = score_chain(item_e, seq_e, pad, att_w, w1, b1, w2, b2, rnd=_bf16)
    return torch.where(ok, logit, NEG_INF), hilo


def packed_level(
    rows: torch.Tensor,  # [B, beam, ROW] float32 gathered pair rows
    alive: torch.Tensor,  # [B, beam] bool/float parent-alive mask
    seq_e: torch.Tensor,  # [B, L, E]
    pad: torch.Tensor,  # [B, L] float32, 1.0 where padding
    att_w: torch.Tensor,  # [E, E]
    w1: torch.Tensor,  # [E, 2E]
    b1: torch.Tensor,  # [E]
    w2: torch.Tensor,  # [1, E]
    b2: torch.Tensor,  # [1]
    embed_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-ordered (scores [B, 2*beam], id hi/lo [B, 2*beam, 2]): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    global launches
    dev = rows.device
    if dev.type == "cpu":
        return packed_level_plain(rows, alive, seq_e, pad, att_w, w1, b1, w2, b2,
                                  embed_size)
    if dev.type != "cuda":
        raise ValueError(f"packed_level: unsupported device {dev}")
    b, beam, row = rows.shape
    l, e = seq_e.shape[1], embed_size
    alive = alive.to(torch.float32)
    name = "packed_level"
    if l > _MAX_L:
        raise ValueError(f"{name}: the kernel takes sequences of at most {_MAX_L}, got {l}")
    _cuda.check_inputs(name, dev, rows=rows, alive=alive, seq_e=seq_e, pad=pad,
                       att_w=att_w, w1=w1, b1=b1, w2=w2, b2=b2)
    for arg, t, shape in (("alive", alive, (b, beam)), ("seq_e", seq_e, (b, l, e)),
                          ("pad", pad, (b, l)), ("att_w", att_w, (e, e)),
                          ("w1", w1, (e, 2 * e)), ("b1", b1, (e,)),
                          ("w2", w2, (1, e)), ("b2", b2, (1,))):
        _cuda.check_shape(name, arg, t, shape)
    scores = torch.empty((b, 2 * beam), dtype=torch.float32, device=dev)
    hilo = torch.empty((b, 2 * beam, 2), dtype=torch.float32, device=dev)
    code = _cuda.library().packed_level_bf16(
        rows.data_ptr(), alive.data_ptr(), seq_e.data_ptr(), pad.data_ptr(),
        att_w.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), scores.data_ptr(), hilo.data_ptr(),
        b, beam, row, l, e, _cuda.stream_handle(dev),
    )
    _cuda.check_launch(name, code)
    launches += 1
    return scores, hilo
