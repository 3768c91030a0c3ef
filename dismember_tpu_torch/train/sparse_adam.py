"""Lazy row-sparse Adam for giant embedding tables.

Port of ``dismember_tpu/train/sparse_adam.py``.  At deep catalogs the dense
train step's traffic scales with the table: a dense [V, E] gradient and
dense Adam over the parameters and both moments.  This module takes the
gradient w.r.t. the *gathered rows* and applies Adam only to the touched
rows, so a step moves O(R * E) bytes, R ~ batch * unit.

Semantics: "lazy Adam" (TF ``LazyAdamOptimizer`` / torch ``SparseAdam``):
rows not touched in a step keep their moments un-decayed and receive no
momentum-only update; touched rows get optax's Adam (same moments, same bias
correction).

Duplicates: a code may appear many times in a step.  :func:`dedup_rows`
sums its partial gradients with one stable sort and a segment sum that is
sequential within each segment, so the sum is the same bits on every run
and device order (no float atomics).

State layouts are the JAX package's, byte for byte, so a JAX state loads as
it is:
- split: ``{"m": [V, E], "v": [V, E], "count"}``;
- mv: ``{"mv": [P, 128], "count"}``, logical row r keeps m|v at lanes
  [(r%S)*2E, (r%S+1)*2E) of physical row r//S, plus a scratch row at P-1;
- pmv: ``{"pmv": [P, 128], "count"}``, slot s of a physical row holds
  [p | m | v | pad] at lanes [s*128/S, (s+1)*128/S), plus a scratch row.
The JAX package moves slots through int32 one-hot contractions because a
TPU dot rounds f32 operands to bf16; here slots are selected by indexing a
[P, S, per] view, which is exact.  The packed formats commit their rows
through K2 (``ops/row_writer.write_rows_128``) and the table and split
moments through :func:`~dismember_tpu_torch.ops.row_writer.add_rows`; both
update in place, so a step returns the same (mutated) buffers it was given.

A bf16 table keeps f32 moments; its rows take their updates rounded to
bf16 through the add (``add_rows_bf16`` on the card), and its row update
follows the JAX package's compiled CPU step (:func:`adam_update_xla`), so
the table's bits equal the JAX package's.  The dense route's bf16 table
(``train/row_step.py``) sums its gradient with :func:`serial_bf16_sums` and
steps with :func:`adam_update_bf16`.
"""

from __future__ import annotations

import numpy as np
import torch

from dismember_tpu_torch.ops import row_writer

# Relative per-row costs of the auto dense/sparse decision: dimensionless,
# only their ratios matter.  They are the JAX package's values, so both
# packages take the same route for every (rows, touched, E); the port has not
# measured its own yet.  The packed sparse step pays per touched row, the
# split format more, the dense step per table row plus its dense-gradient
# scatter per touched row.
_SPARSE_PER_TOUCHED_ROW = 200.0
_SPLIT_PER_TOUCHED_ROW = 350.0
_DENSE_PER_TABLE_ROW = 0.8
_DENSE_PER_TOUCHED_ROW = 100.0

_INT32_MIN = -(2**31)


def sparse_worthwhile(
    table_rows: int,
    touched_rows_per_step: int,
    embed_dim: int | None = None,
) -> bool:
    """Auto-mode decision: lazy sparse Adam when its per-touched-row cost
    undercuts dense Adam's O(table) traffic plus its own dense-gradient
    scatter.  ``embed_dim`` charges the format the trainer would get: the
    packed step when the width packs into 128-lane rows (mv or p|m|v), the
    split step otherwise; ``None`` assumes packable."""
    cost = _SPARSE_PER_TOUCHED_ROW
    if embed_dim is not None and not (
        _packed_slots(embed_dim) > 0 or pmv_slots(embed_dim) > 0
    ):
        cost = _SPLIT_PER_TOUCHED_ROW
    return touched_rows_per_step * cost < (
        table_rows * _DENSE_PER_TABLE_ROW
        + touched_rows_per_step * _DENSE_PER_TOUCHED_ROW
    )


def _packed_slots(embed_dim: int) -> int:
    """Logical rows per 128-lane physical row of the packed m|v table
    (0 = packing not applicable for this width)."""
    if embed_dim <= 0 or 128 % (2 * embed_dim) != 0:
        return 0
    return 128 // (2 * embed_dim)


def init_state(table: torch.Tensor, packed: bool | None = None) -> dict:
    """Adam moments (f32) + step count for one [V, E] f32 table; packed m|v
    rows when the width divides a 128-lane row (``packed=None``: auto)."""
    v_rows, e = table.shape
    s = _packed_slots(e)
    if packed is None:
        packed = s > 0
    if packed:
        if s == 0:
            raise ValueError(f"cannot pack moments for embed width {e}")
        phys = -(-v_rows // s) + 1  # +1 sacrificial scratch row
        return {"mv": torch.zeros(phys, 128, device=table.device), "count": 0}
    return {"m": torch.zeros_like(table, dtype=torch.float32),
            "v": torch.zeros_like(table, dtype=torch.float32), "count": 0}


def dedup_rows(
    flat_codes: torch.Tensor, g_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine duplicate row gradients: (codes_u [R], g_sum [R, E], live [R]).

    ``flat_codes``: [R] row ids, -1 = padding (dropped).  Output slot i holds
    the i-th segment of the stably sorted codes; slots past the last segment
    hold code INT32_MIN and zeros (the JAX package's empty segments);
    ``live`` marks slots that own a real row."""
    r = flat_codes.shape[0]
    s, order = torch.sort(flat_codes, stable=True)
    gs = g_rows[order]
    start = torch.ones(r, dtype=torch.bool, device=s.device)
    start[1:] = s[1:] != s[:-1]
    seg = torch.cumsum(start, 0) - 1
    lengths = torch.zeros(r, dtype=torch.long, device=s.device).index_put_(
        (seg,), torch.ones_like(seg), accumulate=True)  # integer adds: exact
    g_sum = torch.segment_reduce(gs, "sum", lengths=lengths, unsafe=True, initial=0)
    codes_u = torch.full((r,), _INT32_MIN, dtype=flat_codes.dtype, device=s.device)
    codes_u[seg] = s  # every writer of a segment stores the same code
    live = (lengths > 0) & (codes_u >= 0)
    return codes_u, g_sum, live


def adam_update(m_rows, v_rows, g, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax's Adam, in its order of operations, for step ``count`` (1, 2,
    ...): (m_new, v_new, update), update = -lr * m_hat / (sqrt(v_hat) + eps)."""
    m_new = b1 * m_rows + (1.0 - b1) * g
    v_new = b2 * v_rows + (1.0 - b2) * (g * g)
    m_hat = m_new / (1.0 - b1**count)
    v_hat = v_new / (1.0 - b2**count)
    return m_new, v_new, (m_hat / (torch.sqrt(v_hat) + eps)) * (-lr)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), kept as float32."""
    return x.to(torch.bfloat16).float()


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32: the product of two f32 values is
    exact in float64, so only the sum rounds before the final rounding."""
    return (a.double() * float(b) + c.double()).float()


def serial_bf16_sums(flat_codes: torch.Tensor, g_rows: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """[n_rows, E] per-code sums of ``g_rows`` (-1 codes dropped) as the JAX
    package's CPU backend computes the gradient of a bf16 table's gather:
    each row gradient rounded to bf16, then added into its code's sum in
    occurrence order, the sum rounded to bf16 after every add.  Returned as
    float32 holding bf16 values."""
    keep = flat_codes >= 0
    codes, g = flat_codes[keep], _bf16(g_rows[keep].float())
    s, order = torch.sort(codes, stable=True)
    g = g[order]
    r = s.shape[0]
    start = torch.ones(r, dtype=torch.bool, device=s.device)
    start[1:] = s[1:] != s[:-1]
    pos = torch.arange(r, device=s.device)
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = pos - first
    acc = torch.zeros(n_rows, g_rows.shape[1], device=g_rows.device)
    for j in range(int(rank.max()) + 1 if r else 0):
        at = rank == j  # one occurrence of each code: no collisions
        acc[s[at]] = _bf16(acc[s[at]] + g[at])
    return acc


def adam_update_bf16(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                     count: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam(lr, b1, b2, eps, mu_dtype=float32) on a bf16 parameter
    ``p`` with an f32 first moment ``m`` and a bf16 second moment ``v``
    (optax's ``zeros_like(params)``), in the order and roundings of the JAX
    package's compiled CPU step: the scalars of the bf16 terms are rounded
    to bf16 (weak typing), every bf16 op rounds, ``b1 * m + bf16(1 - b1) *
    g`` and ``p + update * -lr`` are fused multiply-adds, ``m_hat / (sqrt +
    eps)`` is ``m / (bias1 * (sqrt + eps))``, and the bias corrections are
    float32 powers.  ``g`` holds bf16 values.  Returns (p_new bf16, m_new,
    v_new bf16)."""
    f32 = np.float32
    as_bf16 = lambda x: float(torch.tensor(x, dtype=torch.float64).to(torch.bfloat16))  # noqa: E731
    g = g.float()
    m_new = _fma(m, f32(b1), as_bf16(1.0 - b1) * g)
    v_new = _bf16(_bf16(_bf16(g * g) * as_bf16(1.0 - b2)) + _bf16(as_bf16(b2) * v.float()))
    bias1 = float(f32(1.0) - f32(b1) ** f32(count))
    bias2 = as_bf16(float(f32(1.0) - f32(b2) ** f32(count)))
    root = _bf16(torch.sqrt(_bf16(v_new / bias2)))
    upd = m_new / (bias1 * (root + as_bf16(eps)))
    p_new = _fma(upd, f32(-lr), p.float()).to(torch.bfloat16)
    return p_new, m_new, v_new.to(torch.bfloat16)


def adam_update_xla(m_rows, v_rows, g, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """:func:`adam_update` in the order and roundings of the JAX package's
    compiled CPU sparse step, which the bf16 tables' row updates follow bit
    for bit: the moments' updates are fused multiply-adds, and ``m_hat /
    (sqrt(v_hat) + eps)`` is ``m / (bias1 * (sqrt(v / bias2) + eps))`` with
    float32 bias corrections."""
    f32 = np.float32
    m_new = _fma(m_rows, f32(b1), g * float(f32(1.0 - b1)))
    v_new = _fma(v_rows, f32(b2), (g * g) * float(f32(1.0 - b2)))
    bias1 = float(f32(1.0) - f32(b1) ** f32(count))
    bias2 = float(f32(1.0) - f32(b2) ** f32(count))
    upd = (m_new / (bias1 * (torch.sqrt(v_new / bias2) + float(f32(eps))))) * float(f32(-lr))
    return m_new, v_new, upd


def _row_adam(table: torch.Tensor):
    """The row update a table takes: the JAX package's compiled order for a
    bf16 table (its bits are pinned), optax's order for an f32 one."""
    return adam_update_xla if table.dtype == torch.bfloat16 else adam_update


def apply_rows(
    table: torch.Tensor,
    state: dict,
    flat_codes: torch.Tensor,
    g_rows: torch.Tensor,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, dict]:
    """One lazy-Adam step on the rows named by ``flat_codes`` (split or mv
    state); ``g_rows`` [R, E] are per-occurrence gradients.  Updates
    ``table`` and the state in place and returns them."""
    if "mv" in state:
        return _apply_rows_packed(table, state, flat_codes, g_rows, lr, b1, b2, eps)
    codes_u, g, live = dedup_rows(flat_codes, g_rows)
    count = state["count"] + 1
    safe = torch.where(live, codes_u, 0)
    m_rows, v_rows = state["m"][safe], state["v"][safe]
    m_new, v_new, upd = _row_adam(table)(m_rows, v_rows, g.float(), count, lr, b1, b2, eps)
    # delta-form adds, as the JAX package's scatter-adds; dead slots point
    # past the table and are dropped, so the live indices are unique
    dst = torch.where(live, codes_u, table.shape[0])
    row_writer.add_rows(table, dst, upd.to(table.dtype))
    row_writer.add_rows(state["m"], dst, m_new - m_rows)
    row_writer.add_rows(state["v"], dst, v_new - v_rows)
    state["count"] = count
    return table, state


def _merge_slots(buf, phys, slot, payload, rows128):
    """The new contents of every physical row a step touches.

    ``phys`` [R] is non-decreasing over runs (sorted codes // S; dead slots
    at the scratch row), so equal physical rows form consecutive segments.
    Segment j's row starts as the gathered old row and takes the payload of
    each live slot in it (live codes are unique, so (segment, slot) pairs
    never collide).  Returns (phys_w [R], new_rows [R, 128]): empty segments
    and the scratch row's get zero rows aimed at the scratch row."""
    r = phys.shape[0]
    scratch = buf.shape[0] - 1
    dev = phys.device
    start = torch.ones(r, dtype=torch.bool, device=dev)
    start[1:] = phys[1:] != phys[:-1]
    segp = torch.cumsum(start, 0) - 1
    new_rows = torch.zeros(r, 128, device=dev)
    new_rows[segp] = rows128  # every writer of a segment stores the same row
    n_slots = 128 // payload.shape[1]
    new_rows.view(r, n_slots, -1)[segp, slot] = payload  # dead writers zeroed below
    phys_u = torch.full((r,), -1, dtype=phys.dtype, device=dev)
    phys_u[segp] = phys
    phys_w = torch.where(phys_u >= 0, phys_u, scratch)
    new_rows = torch.where((phys_w == scratch)[:, None], 0.0, new_rows)
    return phys_w, new_rows


def _apply_rows_packed(table, state, flat_codes, g_rows, lr, b1, b2, eps):
    """mv format: one 128-lane gather + one K2 row write for m|v, one
    scatter-add for the table; the same per-row Adam math as split."""
    e = table.shape[1]
    s_per = _packed_slots(e)
    mv = state["mv"]
    codes_u, g, live = dedup_rows(flat_codes, g_rows)
    r = codes_u.shape[0]
    count = state["count"] + 1
    safe = torch.where(live, codes_u, 0)
    phys = torch.where(live, safe // s_per, mv.shape[0] - 1)
    slot = torch.where(live, safe % s_per, 0)
    rows128 = mv[phys]  # [R, 128] one gather covers m and v
    old = rows128.view(r, s_per, 2 * e)[torch.arange(r, device=phys.device), slot]
    m_new, v_new, upd = _row_adam(table)(old[:, :e], old[:, e:], g.float(), count, lr, b1, b2,
                                         eps)
    phys_w, new_rows = _merge_slots(mv, phys, slot, torch.cat([m_new, v_new], 1), rows128)
    row_writer.write_rows_128(mv, phys_w, new_rows)
    row_writer.add_rows(table, torch.where(live, codes_u, table.shape[0]),
                        upd.to(table.dtype))
    state["count"] = count
    return table, state


# --------------------------------------------------------------------------
# pmv: params + both moments packed into one 128-lane row
# --------------------------------------------------------------------------


def pmv_slots(embed_dim: int) -> int:
    """Logical rows per 128-lane physical row of a p|m|v packed table
    (0 = packing not applicable for this width): the largest power of two S
    with 128/S >= 3*E."""
    if embed_dim <= 0 or 3 * embed_dim > 128:
        return 0
    s = 1
    while 2 * s <= 128 // (3 * embed_dim):
        s *= 2
    return s


def _pmv_geometry(v_rows: int, e: int) -> tuple[int, int, int]:
    s = pmv_slots(e)
    if s == 0:
        raise ValueError(f"cannot pack p|m|v for embed width {e}")
    per = 128 // s  # lanes per logical row (p:e | m:e | v:e | pad:per-3e)
    return s, per, -(-v_rows // s)


def _p_lanes(pmv: torch.Tensor, phys: int, s: int, per: int, e: int) -> torch.Tensor:
    """The [phys*S, E] view of the p lanes (scratch row excluded)."""
    return pmv[:phys].view(phys * s, per)[:, :e]


def pmv_init(table: torch.Tensor) -> dict:
    """Pack a [V, E] f32 param table into p|m|v rows with zero moments:
    ``{"pmv": [phys+1, 128] f32, "count": 0}`` (the +1 is the scratch row)."""
    v_rows, e = table.shape
    s, per, phys = _pmv_geometry(v_rows, e)
    pmv = torch.zeros(phys + 1, 128, device=table.device)
    _p_lanes(pmv, phys, s, per, e)[:v_rows] = table
    return {"pmv": pmv, "count": 0}


def pmv_refresh(state: dict, table: torch.Tensor) -> dict:
    """Overwrite the p lanes from ``table`` in place, keeping moments and
    count; used when an external load replaced the trainer's mirror."""
    v_rows, e = table.shape
    s, per, phys = _pmv_geometry(v_rows, e)
    p = _p_lanes(state["pmv"], phys, s, per, e)
    p[:v_rows] = table
    p[v_rows:] = 0.0
    return state


def pmv_unpack(state: dict, v_rows: int, e: int) -> torch.Tensor:
    """Materialize the [V, E] param table from the packed state."""
    s, per, phys = _pmv_geometry(v_rows, e)
    return _p_lanes(state["pmv"], phys, s, per, e)[:v_rows].clone()


def pmv_gather(pmv: torch.Tensor, codes: torch.Tensor, e: int) -> torch.Tensor:
    """Gather param rows [R, E] from the packed table (codes must be >= 0;
    mask padding on the caller side as with a plain table gather)."""
    s = pmv_slots(e)
    rows = pmv[codes // s].view(-1, s, 128 // s)
    return rows[torch.arange(rows.shape[0], device=codes.device), codes % s, :e]


def pmv_apply_rows(
    state: dict,
    flat_codes: torch.Tensor,
    g_rows: torch.Tensor,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> dict:
    """One lazy-Adam step on the packed p|m|v table: one row gather and one
    K2 row write.  Same per-touched-row Adam math as :func:`apply_rows`.
    Updates ``state`` in place and returns it."""
    e = g_rows.shape[1]
    s_per = pmv_slots(e)
    per = 128 // s_per
    pmv = state["pmv"]
    codes_u, g, live = dedup_rows(flat_codes, g_rows)
    r = codes_u.shape[0]
    count = state["count"] + 1
    safe = torch.where(live, codes_u, 0)
    phys = torch.where(live, safe // s_per, pmv.shape[0] - 1)
    slot = torch.where(live, safe % s_per, 0)
    rows128 = pmv[phys]  # [R, 128] covers p, m and v
    old = rows128.view(r, s_per, per)[torch.arange(r, device=phys.device), slot]
    p_rows, m_rows, v_rows = old[:, :e], old[:, e : 2 * e], old[:, 2 * e : 3 * e]
    m_new, v_new, upd = adam_update(m_rows, v_rows, g.float(), count, lr, b1, b2, eps)
    payload = torch.zeros(r, per, device=phys.device)
    payload[:, : 3 * e] = torch.cat([p_rows + upd, m_new, v_new], 1)
    phys_w, new_rows = _merge_slots(pmv, phys, slot, payload, rows128)
    row_writer.write_rows_128(pmv, phys_w, new_rows)
    state["count"] = count
    return state
