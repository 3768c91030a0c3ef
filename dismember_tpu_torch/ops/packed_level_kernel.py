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
and hilo [B, 2*beam, 2].  The rows may also be a bf16 pair table's (the
JAX package's bf16 layout, ``retrieval/packed_beam.py``): lanes [2E+2,
2E+10) then hold 4 base-256 id digits a child (42 used lanes), and the
digit output is [B, 2*beam, 4] bf16.  Since the scorer rounds every
embedding to bf16 anyway, bf16 rows score as f32 rows holding the same
values.

:func:`packed_level` launches ``packed_level_bf16`` (f32 rows) or
``packed_level_bf16_bf16rows`` (bf16 rows; ``csrc/din_kernels.cu``) for
CUDA tensors and :func:`packed_level_plain` for CPU tensors; the kernel is
built for ``KERNEL_WIDTHS`` (E = 8 pads its products' depth to 16 with
zeros; past E = 32 a pair row passes 128 lanes, ``pair_row_width``) and
takes any L (in 16-position tiles).  The kernel stages nothing: a warp
reads its 16 candidates' embeddings into registers, and a warpgroup runs
the weight products of 64 candidates (which may span query rows) with
``wgmma`` from bf16 weights held once a block in shared memory (0.8 KB at
E = 8 to 96 KB at E = 128), so shared memory does not grow with the beam
and one launch takes any beam up to 2^30 - 8 parents (``2 * beam + 15``
stays a 32-bit int), at every width and over either row type.
The kernel runs its products on the tensor cores (bf16 operands are the
contract), so on the H100 at the serving shapes (B=4096, beam=20, E=16) it
is bound by bytes: of each 128-lane row it needs the 2E+6 = 38 used lanes
(~12.5 MB a level, ~17.5 MB with the sequence tiles and outputs).  The
row gather stays outside it.
"""

from __future__ import annotations

import numpy as np
import torch

from dismember_tpu_torch.ops import _cuda
from dismember_tpu_torch.ops.din_kernel import KERNEL_WIDTHS, score_chain

NEG_INF = -3.4e38  # score of a missing child or dead parent

# The id codec, by lane dtype: digits an id and their base.  Every digit is
# an exact integer in the lane dtype: f32 takes 2 base-4096 digits (the top
# digit <= 2^19 for int32 ids), bf16 (integers up to 256 exact) 4 base-256
# digits (the top digit <= 127).
ID_DIGITS = {torch.float32: 2, torch.bfloat16: 4}
ID_BASE = {torch.float32: 4096, torch.bfloat16: 256}

# K3 launches on CUDA tensors, over f32 rows and over bf16 rows, and by
# (width, row dtype); chip_smoke.py zeroes and reads them
launches = 0
launches_bf16_rows = 0
launches_by_width = {(e, dt): 0 for e in KERNEL_WIDTHS for dt in ID_DIGITS}


def pair_row_width(embed_size: int, dtype=torch.float32) -> int:
    """Lanes of a pair row: the used lanes (2E + 2 + 2 id digit groups)
    rounded up to 128, as the JAX package's ``build_pair_table`` lays them
    out (128 lanes up to E = 32, 256 at E = 64 and 96, 384 at E = 128)."""
    used = 2 * embed_size + 2 + 2 * ID_DIGITS[dtype]
    return (used + 127) // 128 * 128


def encode_id_digits(ids: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """[N] int -> [N, ID_DIGITS[dtype]] float32 radix digits in base
    ``ID_BASE[dtype]``; the top digit keeps the full remaining quotient (and
    the sign: -1 -> (-1, base-1, ...), which decodes back to -1 under the
    floor-division radix identity)."""
    k, base = ID_DIGITS[dtype], ID_BASE[dtype]
    rem = ids.astype(np.int64)
    digits = []
    for _ in range(k - 1):
        q = np.floor_divide(rem, base)
        digits.append(rem - base * q)
        rem = q
    digits.append(rem)
    return np.stack(digits[::-1], axis=-1).astype(np.float32)


def decode_id_digits(digits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[..., k] digit lanes of a ``dtype`` table (in any float dtype that
    holds them exactly) -> [...] exact int64 ids."""
    base = ID_BASE[dtype]
    acc = digits[..., 0].long()
    for i in range(1, digits.shape[-1]):
        acc = acc * base + digits[..., i].long()
    return acc


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def score_pair_rows(score, rows, alive, embed_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A packed level in plain ops, as K3 reads its rows: the children's
    embeddings [B, 2*beam, E] in block order (left | right), upcast to f32,
    scored by ``score``; -3.4e38 where the child is missing or its parent
    dead; the id digits copied as they are."""
    e, k = embed_size, ID_DIGITS[rows.dtype]
    f = rows.float()
    item_e = torch.cat([f[..., :e], f[..., e : 2 * e]], dim=1)
    exists = torch.cat([f[..., 2 * e], f[..., 2 * e + 1]], dim=1) > 0
    hilo = torch.cat(
        [rows[..., 2 * e + 2 : 2 * e + 2 + k], rows[..., 2 * e + 2 + k : 2 * e + 2 + 2 * k]], dim=1
    )
    ok = exists & (alive > 0).repeat(1, 2)
    return torch.where(ok, score(item_e), NEG_INF), hilo


def packed_level_plain(rows, alive, seq_e, pad, att_w, w1, b1, w2, b2,
                       embed_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's plain version: the same six bf16 roundings as the kernel; bf16
    rows are upcast for the scores and their digits kept as they are."""
    return score_pair_rows(
        lambda item_e: score_chain(item_e, seq_e, pad, att_w, w1, b1, w2, b2, rnd=_bf16),
        rows, alive, embed_size)


def packed_level(
    rows: torch.Tensor,  # [B, beam, ROW] gathered pair rows, float32 or bfloat16
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
    """Block-ordered (scores [B, 2*beam], id digits [B, 2*beam, 2 or 4] in
    the rows' dtype): one launch of the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    global launches, launches_bf16_rows
    dev = rows.device
    weights = (att_w, w1, b1, w2, b2)
    if dev.type == "cpu":
        return packed_level_plain(rows, alive, seq_e, pad, *weights, embed_size)
    if dev.type != "cuda":
        raise ValueError(f"packed_level: unsupported device {dev}")
    if rows.dtype not in ID_DIGITS:
        raise ValueError(f"packed_level: rows are {rows.dtype}, expected float32 or bfloat16")
    b, beam, _ = rows.shape
    l, e = seq_e.shape[1], embed_size
    alive = alive.to(torch.float32)
    name = "packed_level"
    if e not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: E={e}; the kernel is built for E in {list(KERNEL_WIDTHS)}")
    _cuda.check_shape(name, "rows", rows, (b, beam, pair_row_width(e, rows.dtype)))
    _cuda.check_inputs(name, dev, rows.dtype, rows=rows)
    _cuda.check_inputs(name, dev, alive=alive, seq_e=seq_e, pad=pad,
                       att_w=att_w, w1=w1, b1=b1, w2=w2, b2=b2)
    for arg, t, shape in (("alive", alive, (b, beam)), ("seq_e", seq_e, (b, l, e)),
                          ("pad", pad, (b, l)), ("att_w", att_w, (e, e)),
                          ("w1", w1, (e, 2 * e)), ("b1", b1, (e,)),
                          ("w2", w2, (1, e)), ("b2", b2, (1,))):
        _cuda.check_shape(name, arg, t, shape)
    bf16_rows = rows.dtype == torch.bfloat16
    scores = torch.empty((b, 2 * beam), dtype=torch.float32, device=dev)
    hilo = torch.empty((b, 2 * beam, ID_DIGITS[rows.dtype]), dtype=rows.dtype, device=dev)
    lib = _cuda.library()
    code = (lib.packed_level_bf16_bf16rows if bf16_rows else lib.packed_level_bf16)(
        rows.data_ptr(), alive.data_ptr(), seq_e.data_ptr(), pad.data_ptr(),
        att_w.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), scores.data_ptr(), hilo.data_ptr(),
        b, beam, rows.shape[2], l, e, _cuda.stream_handle(dev),
    )
    _cuda.check_launch(name, code)
    if bf16_rows:
        launches_bf16_rows += 1
    else:
        launches += 1
    launches_by_width[e, rows.dtype] += 1
    return scores, hilo
