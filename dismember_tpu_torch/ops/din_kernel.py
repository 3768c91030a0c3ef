"""K1: the DIN scorer forward on pre-gathered embeddings.

Replaces the Pallas kernel ``dismember_tpu/ops/din_kernel.py::_din_kernel``
(entry ``din_forward_pallas``).  :func:`din_score` launches the CUDA kernel
``din_score_f32`` (``csrc/din_kernels.cu``) for CUDA tensors and runs
:func:`din_score_plain`, the same arithmetic in plain PyTorch, for CPU
tensors.  It scores every forward-only DIN call of the port: the classic
beam loop's levels, ``TDMServing.predict``, the trainer's eval loss and the
JTM sweep's [8192, 4] score batches (``train/jtm.py``).

On the H100 at the serving shapes (B=4096, U=40, L=10, E=16) the kernel is
bound by bytes: ~13.9 MB of candidate and sequence embeddings, padding and
logits against ~0.23 GFLOP of f32 work on the CUDA cores.  At E = 16 (and
at E = 32 past U = L up to L = 10, and E = 8 past L = 10) it folds the
sequence side once per query row (ctx_l = (w1[:, E:] @ att_w) . seq_l, by
linearity), so one thread scores one candidate with ~1.3 kFLOP in
registers: L scores with padding as a multiply-add, the softmax with one
reciprocal of its sum, and h from ctx.  At E = 8 and L <= 10 one thread
scores one candidate in the unfolded order with nothing staged.  At E = 64,
96 and 128, and at E = 32 where U <= L (the JTM sweep's batches) or L > 10,
a prologue kernel writes [w1[:, :E] | M]^T (M = w1[:, E:] @ att_w) into
scratch this wrapper allocates (``_cuda.din_scratch``); in each block four
warps take the candidates' scores and an online softmax while four others
compute h = [item | att] . [w1[:, :E] | M]^T of the chunk before on the
tensor cores in 3xTF32 (each operand split into a TF32 part and its rest,
three TF32 products, f32 sums), which keeps f32 accuracy; there the
E^2-deep products bound it by operations.  The sums run in another order
than :func:`din_score_plain`'s, within f32 rounding.  The kernel is built for
``KERNEL_WIDTHS``.  Forward only: on CUDA it raises when grad mode is on
and an input requires grad (the trainers score through the plain version
under autograd, ``DIN.train_apply_from_emb``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from dismember_tpu_torch.constants import MASK_VALUE
from dismember_tpu_torch.ops import _cuda

# MASK_VALUE rounded to float32 (-FLT_MAX): the double literal lies just past
# the float32 range, which torch.where refuses
_MASK_F32 = float(np.float32(MASK_VALUE))

# the embedding widths K1 and K3 are built for (csrc/din_kernels.cu)
KERNEL_WIDTHS = (8, 16, 32, 64, 96, 128)

# K1 launches on CUDA tensors, in all and by width; chip_smoke.py zeroes
# and reads them
launches = 0
launches_by_width = dict.fromkeys(KERNEL_WIDTHS, 0)


def check_kernel_width(model_type: str, embed_size: int, device: torch.device) -> None:
    """Raise when a DIN scorer of width ``embed_size`` would run on CUDA at
    a width K1 and K3 are not built for; the CPU scores any width through the
    plain versions, and DeepFM, which launches neither kernel, runs at any
    width.  Called where a trainer, a server or a tree learner is built, so
    a run fails before it trains, not at its first evaluation."""
    if model_type == "din" and device.type == "cuda" and embed_size not in KERNEL_WIDTHS:
        raise ValueError(
            f"embed_size={embed_size}: the CUDA kernels K1 and K3 are built for "
            f"E in {list(KERNEL_WIDTHS)} only; use a built width, or device='cpu'"
        )


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def score_chain(
    item_e: torch.Tensor,  # [B, U, E]
    seq_e: torch.Tensor,  # [B, L, E]
    pad: torch.Tensor,  # [B, L] float32, 1.0 where padding
    att_w: torch.Tensor,  # [E, E]
    w1: torch.Tensor,  # [E, 2E]
    b1: torch.Tensor,  # [E]
    w2: torch.Tensor,  # [1, E]
    b2: torch.Tensor,  # [1]
    rnd: Callable[[torch.Tensor], torch.Tensor] = _identity,
) -> torch.Tensor:
    """DIN scorer in plain PyTorch -> [B, U] logits.  ``rnd`` is applied to
    every matmul operand (K3 rounds them to bf16; K1 leaves them f32)."""
    e = item_e.shape[-1]
    scale = 1.0 / math.sqrt(e)
    scores = torch.einsum("bue,ble->bul", rnd(item_e), rnd(seq_e)) * scale
    scores = torch.where(pad[:, None, :] > 0.5, _MASK_F32, scores)
    probs = torch.softmax(scores, dim=-1)
    att = torch.einsum("bul,ble->bue", rnd(probs), rnd(seq_e))
    att_lin = rnd(att) @ rnd(att_w).T
    h = rnd(item_e) @ rnd(w1[:, :e]).T + rnd(att_lin) @ rnd(w1[:, e:]).T + b1
    h = torch.relu(h)
    logit = rnd(h) @ rnd(w2).T + b2
    return logit[..., 0]


def din_score_plain(item_e, seq_e, pad, att_w, w1, b1, w2, b2) -> torch.Tensor:
    """K1's plain version: all f32."""
    return score_chain(item_e, seq_e, pad, att_w, w1, b1, w2, b2)


def din_score(
    item_e: torch.Tensor,  # [B, U, E] candidate embeddings (zero rows = invalid)
    seq_e: torch.Tensor,  # [B, L, E] sequence embeddings
    pad: torch.Tensor,  # [B, L] float32, 1.0 where padding
    att_w: torch.Tensor,  # [E, E]
    w1: torch.Tensor,  # [E, 2E]
    b1: torch.Tensor,  # [E]
    w2: torch.Tensor,  # [1, E]
    b2: torch.Tensor,  # [1]
) -> torch.Tensor:
    """DIN logits [B, U]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global launches
    dev = item_e.device
    if dev.type == "cpu":
        return din_score_plain(item_e, seq_e, pad, att_w, w1, b1, w2, b2)
    if dev.type != "cuda":
        raise ValueError(f"din_score: unsupported device {dev}")
    name = "din_score"
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (item_e, seq_e, pad, att_w, w1, b1, w2, b2)
    ):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; score under "
            "torch.no_grad() or train through DIN.train_apply_from_emb"
        )
    b, u, e = item_e.shape
    l = seq_e.shape[1]
    _cuda.check_inputs(name, dev, item_e=item_e, seq_e=seq_e, pad=pad,
                       att_w=att_w, w1=w1, b1=b1, w2=w2, b2=b2)
    for arg, t, shape in (("seq_e", seq_e, (b, l, e)), ("pad", pad, (b, l)),
                          ("att_w", att_w, (e, e)), ("w1", w1, (e, 2 * e)),
                          ("b1", b1, (e,)), ("w2", w2, (1, e)), ("b2", b2, (1,))):
        _cuda.check_shape(name, arg, t, shape)
    out = torch.empty((b, u), dtype=torch.float32, device=dev)
    scratch = _cuda.din_scratch(e, dev)
    code = _cuda.library().din_score_f32(
        item_e.data_ptr(), seq_e.data_ptr(), pad.data_ptr(), att_w.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, u, l, e, _cuda.stream_handle(dev),
    )
    _cuda.check_launch(name, code)
    launches += 1
    launches_by_width[e] += 1
    return out
