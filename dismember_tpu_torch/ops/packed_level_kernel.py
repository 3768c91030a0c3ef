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
stays a 32-bit int).  But at E = 8 on bf16 rows a warp stages one query
row's pair rows in shared memory (the kernel's narrow plan), so the
staging grows with the beam: a beam wider than one row of a block can
hold (``packed_level_max_beam_bf16rows(L, 8)``, ~3,050 parents at L <= 16
on an H100) is split here into chunks of parents, one launch each, and
the chunks' outputs are put back into block order.  Each parent's two
children are scored independently of the other parents, so the split
changes no score.
The kernel runs its products on the tensor cores (bf16 operands are the
contract), so on the H100 at the serving shapes (B=4096, beam=20, E=16) it
is bound by bytes: of each 128-lane row it needs the 2E+6 = 38 used lanes
(~12.5 MB a level, ~17.5 MB with the sequence tiles and outputs).  The
row gather stays outside it.
"""

from __future__ import annotations

import functools

import torch

from dismember_tpu_torch.ops import _cuda
from dismember_tpu_torch.ops.din_kernel import KERNEL_WIDTHS, score_chain

NEG_INF = -3.4e38  # score of a missing child or dead parent

# id digits a child, by the pair rows' dtype
ID_DIGITS = {torch.float32: 2, torch.bfloat16: 4}

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


@functools.cache
def _kernel_max_beam(l: int, e: int, device_index: int, bf16_rows: bool = False) -> int:
    """The widest beam one launch takes at sequence length ``l`` and width
    ``e`` on a card."""
    lib = _cuda.library()
    with torch.cuda.device(device_index):
        beam = (lib.packed_level_max_beam_bf16rows if bf16_rows
                else lib.packed_level_max_beam)(l, e)
    if beam < 1:
        raise RuntimeError(f"packed_level: no beam fits a block at L={l}, E={e}")
    return beam


def _split_beam(level_fn, max_beam: int, rows, alive, *rest):
    """``level_fn`` over chunks of at most ``max_beam`` parents, its
    block-ordered outputs put back together: every chunk's left children,
    then every chunk's right children."""
    beam = rows.shape[1]
    parts = [level_fn(rows[:, k : k + max_beam].contiguous(),
                      alive[:, k : k + max_beam].contiguous(), *rest)
             for k in range(0, beam, max_beam)]
    halves = [(s.shape[1] // 2, s, h) for s, h in parts]
    scores = torch.cat([s[:, :c] for c, s, _ in halves] + [s[:, c:] for c, s, _ in halves], 1)
    hilo = torch.cat([h[:, :c] for c, _, h in halves] + [h[:, c:] for c, _, h in halves], 1)
    return scores, hilo


def _launch(rows, alive, seq_e, pad, att_w, w1, b1, w2, b2,
            embed_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One K3 launch over the whole beam, on checked CUDA tensors."""
    global launches, launches_bf16_rows
    dev = rows.device
    b, beam, row = rows.shape
    bf16_rows = rows.dtype == torch.bfloat16
    scores = torch.empty((b, 2 * beam), dtype=torch.float32, device=dev)
    hilo = torch.empty((b, 2 * beam, ID_DIGITS[rows.dtype]), dtype=rows.dtype, device=dev)
    lib = _cuda.library()
    code = (lib.packed_level_bf16_bf16rows if bf16_rows else lib.packed_level_bf16)(
        rows.data_ptr(), alive.data_ptr(), seq_e.data_ptr(), pad.data_ptr(),
        att_w.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), scores.data_ptr(), hilo.data_ptr(),
        b, beam, row, seq_e.shape[1], embed_size, _cuda.stream_handle(dev),
    )
    _cuda.check_launch("packed_level", code)
    if bf16_rows:
        launches_bf16_rows += 1
    else:
        launches += 1
    launches_by_width[embed_size, rows.dtype] += 1
    return scores, hilo


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
    the rows' dtype): the CUDA kernel for CUDA tensors, in chunks of parents
    through the beam split when the beam is wider than one launch takes;
    the plain version for CPU tensors."""
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
    max_beam = _kernel_max_beam(l, e, dev.index if dev.index is not None
                                else torch.cuda.current_device(), rows.dtype == torch.bfloat16)
    if beam > max_beam:
        return _split_beam(_launch, max_beam, rows, alive, seq_e, pad, *weights, embed_size)
    return _launch(rows, alive, seq_e, pad, *weights, embed_size)
