"""K3's warpgroup plan at every built width (E = 8 to 128) and row type,
held on the CPU.

The CUDA kernel (``packed_level_wgmma_kernel`` in ``csrc/din_kernels.cu``)
runs only on the card.  Here a plain-PyTorch emulation of its schedule
goes against K3's plain version and the JAX package's Pallas kernel
(interpret mode): m16 tiles of candidates numbered as (query row, m0)
pairs in block order, four consecutive tiles gathered into one 64-row
tile across query rows (``walk_groups``), each tile's scores, softmax
and att against its own query row, then att_lin and h on the 64-row
tiles with the contract's
bf16 roundings, each operand's k-steps in the kernel's k order and E =
8's one k-step padded to 16 with zeros, masks and digits put back in
block order.  At E = 8 and 16 the kernel walks query rows instead: a
64-row tile is tile m of four consecutive query rows.  Also the build gate
that holds every K3 instance to wgmma, and the wrapper's single launch at
any beam."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.ops.packed_level_kernel import packed_level_pallas
from dismember_tpu_torch.constants import MASK_VALUE
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.ops import _cuda, packed_level_kernel
from dismember_tpu_torch.ops.packed_level_kernel import (
    ID_DIGITS,
    NEG_INF,
    packed_level,
    packed_level_plain,
    pair_row_width,
)

CSRC = Path(__file__).resolve().parent.parent / "dismember_tpu_torch" / "csrc" / "din_kernels.cu"
RTOL, ATOL = 2e-4, 1e-5  # tests/test_pallas_din.py's tolerance
# The emulation and the plain version sum the same f32 products in another
# order (a [64, E] matmul against a batched einsum).  Where that moves a
# sum across a bf16 rounding boundary of att, att_lin or h the logit moves
# by a bf16 ulp of a term; such candidates may be at most FLIP of all,
# within K3's own tolerance (atol 0.1 + rtol 0.01).
FLIP, K3_ATOL, K3_RTOL = 5e-3, 1e-1, 1e-2
_MASK_F32 = float(np.float32(MASK_VALUE))


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrapper's CUDA
    path on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda")


def item_k(k: int) -> int:
    """csrc's item_k: fragment column k of an item k-step to the item lane
    it holds (lane t loads lanes 4t .. 4t+3 of each 16)."""
    return 4 * (k >> 1) + (k & 1) if k < 8 else 4 * ((k - 8) >> 1) + 2 + (k & 1)


def att_k(k: int) -> int:
    """csrc's att_k: column k (< 16) of a 16-column group of att as its
    accumulator holds it to the sequence lane it sums (lane g reads lanes
    2g and 2g + 1 of a position as one pair)."""
    return 2 * (k & 7) + (k >> 3)


def k_lanes(fn, e: int) -> torch.Tensor:
    """The lane each column of an E-deep operand's k-steps holds in the
    kernel (16 columns a k-step, ``fn`` the order within one), -1 where
    the column lies past E (E = 8's one k-step is 16 deep)."""
    lanes = [16 * (c // 16) + fn(c % 16) for c in range(-(-e // 16) * 16)]
    return torch.tensor([lane if lane < e else -1 for lane in lanes])


def _in_k_order(x: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """x's last dimension laid out as the columns ``lanes`` name, zero at -1."""
    return torch.where(lanes >= 0, x[..., lanes.clamp(min=0)], 0.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def tile_order(k: int, t: int) -> int:
    """csrc's tile_order: the m16 tile a row walk scores k-th of a row's t,
    the halves alternating (0, h, 1, h + 1, ...)."""
    return t if k >= t else (t + 1) // 2 + k // 2 if k & 1 else k // 2


def walk_groups(b: int, t: int, e: int) -> list:
    """The kernel's groups of four m16 tiles, (valid, query row, m0) a warp:
    at E <= 16 (the row walk) the k-th tile (tile_order) of four consecutive
    query rows, a warp past the last row on row 0; past it four consecutive
    tiles numbered (query row, m0), a warp past the last tile on row 0."""
    if e <= 16:
        return [[(q < b, q if q < b else 0, 16 * tile_order(k, t))
                 for q in range(4 * rg, 4 * rg + 4)]
                for rg in range(-(-b // 4)) for k in range(t)]
    n_tiles = b * t
    return [[(mt < n_tiles, *((mt // t, mt % t * 16) if mt < n_tiles else (0, 0)))
             for mt in range(4 * grp, 4 * grp + 4)] for grp in range(-(-n_tiles // 4))]


def wgmma_schedule(rows, alive, seq_e, pad, att_w, w1, b1, w2, b2, e: int):
    """K3 as the warpgroup plan schedules it, in plain ops: block-ordered
    (scores [B, 2*beam], id digits [B, 2*beam, k])."""
    b, beam, _ = rows.shape
    u, k = 2 * beam, ID_DIGITS[rows.dtype]
    t = -(-u // 16)  # m16 tiles a query row
    f = rows.float()
    # k orders: items in item_k order; att in att_k order (E = 8's one
    # n-tile in lane order); att_lin in lane order
    ki = k_lanes(item_k, e)
    ka = k_lanes(att_k if e % 16 == 0 else (lambda k: k), e)
    kl = k_lanes(lambda k: k, e)
    w1a = _in_k_order(_bf16(w1[:, :e]), ki)  # the shared B of h's item half
    aw = _in_k_order(_bf16(att_w), ka)  # att_lin's B
    w1b, w2b = _in_k_order(_bf16(w1[:, e:]), kl), _bf16(w2)
    scores = torch.full((b, u), float("nan"))
    digits = torch.zeros((b, u, k), dtype=rows.dtype)
    for group in walk_groups(b, t, e):
        item64, att64, tiles = torch.zeros(64, e), torch.zeros(64, e), []
        for wq, (valid, bq, m0) in enumerate(group):  # the last group may be partly empty
            c = m0 + torch.arange(16)
            side = c >= beam
            kk = torch.clamp(c - side.long() * beam, max=beam - 1)  # a real row
            item = torch.where(side[:, None], f[bq, kk, e : 2 * e], f[bq, kk, :e])
            item = _bf16(torch.where((c < u)[:, None], item, 0.0))
            # the per-query part, against this tile's own query row
            s = item @ _bf16(seq_e[bq]).T * (1.0 / e ** 0.5)
            s = torch.where(pad[bq][None] > 0.5, _MASK_F32, s)
            att64[16 * wq : 16 * wq + 16] = _bf16(torch.softmax(s, -1)) @ _bf16(seq_e[bq])
            item64[16 * wq : 16 * wq + 16] = item
            tiles.append((valid, bq, c, side, kk))
        # the weight products on the 64-row tile, each operand's columns as
        # its A fragments hold them (att's as its accumulator holds them)
        att_lin = _in_k_order(_bf16(att64), ka) @ aw.T
        h = _in_k_order(item64, ki) @ w1a.T + _in_k_order(_bf16(att_lin), kl) @ w1b.T + b1
        logit = (_bf16(torch.relu(h)) @ w2b.T + b2)[:, 0]
        for wq, (valid, bq, c, side, kk) in enumerate(tiles):
            keep = (c < u) & valid  # rows past 2 * beam and empty warps store nothing
            if not keep.any():
                continue
            cs, sd, kp = c[keep], side[keep], kk[keep]
            exists = f[bq, kp, 2 * e + sd.long()] > 0
            live = exists & (alive[bq, kp] > 0)
            scores[bq, cs] = torch.where(live, logit[16 * wq : 16 * wq + 16][keep], NEG_INF)
            lo = 2 * e + 2 + k * sd.long()
            digits[bq, cs] = rows[bq, kp[:, None], lo[:, None] + torch.arange(k)]
    return scores, digits


def _params(rng, e):
    std = 0.5 * min(1.0, 16 / e) ** 0.5  # chip_smoke.w_std
    f = lambda *s: rng.normal(0, std, s).astype(np.float32)  # noqa: E731
    return {"embedding": f(31, e), "att_linear": {"weight": f(e, e)},
            "mlp1": {"weight": f(e, 2 * e), "bias": f(e)},
            "mlp2": {"weight": f(1, e), "bias": f(1)}}


def _inputs(rng, b, beam, e, l, dtype=torch.float32):
    """Pair rows of the port's width for ``dtype`` (15% missing children,
    random id digits), alive (10% dead, row 1 all dead), a sequence with
    30% padding and one all-padding row."""
    k = ID_DIGITS[dtype]
    rows = np.zeros((b, beam, pair_row_width(e, dtype)), np.float32)
    rows[..., : 2 * e] = rng.normal(0, 0.5, (b, beam, 2 * e))
    rows[..., 2 * e : 2 * e + 2] = rng.random((b, beam, 2)) < 0.85
    rows[..., 2 * e + 2 : 2 * e + 2 + 2 * k] = rng.integers(0, 128 if k == 4 else 4096,
                                                            (b, beam, 2 * k))
    alive = rng.random((b, beam)) < 0.9
    alive[min(1, b - 1)] = False
    pad = (rng.random((b, l)) < 0.3).astype(np.float32)
    pad[0] = 1.0
    seq_e = rng.normal(0, 0.5, (b, l, e)).astype(np.float32)
    seq_e[pad > 0] = 0.0
    return (torch.as_tensor(rows).to(dtype), torch.as_tensor(alive),
            torch.as_tensor(seq_e), torch.as_tensor(pad))


def _hold(got, want, rows):
    """Digits and the dead mask bit for bit; live scores within the sum-order
    tolerance (FLIP beyond K1's f32 tolerance, all within K3's)."""
    gs, gd = got
    ws, wd = want
    assert not torch.isnan(gs).any(), "a candidate was never stored"
    assert gd.dtype == rows.dtype and torch.equal(gd.view(torch.int16 if gd.dtype == torch.bfloat16
                                                          else torch.int32),
                                                  wd.view(torch.int16 if wd.dtype == torch.bfloat16
                                                          else torch.int32))
    live = ws > NEG_INF / 2
    assert torch.equal(gs > NEG_INF / 2, live)
    assert torch.equal(gs[~live], ws[~live])
    err = (gs[live] - ws[live]).abs()
    ref = ws[live].abs()
    assert bool((err <= K3_ATOL + K3_RTOL * ref).all()), err.max()
    assert (err > ATOL + RTOL * ref).float().mean().item() <= FLIP


@pytest.mark.parametrize("e,beam,l,dtype", [
    *((32, beam, l, dt) for dt in (torch.float32, torch.bfloat16)  # two k-steps, four n-tiles
      for beam, l in ((1, 10), (20, 10), (110, 10), (20, 24))),
    # E = 16: one k-step, two n-tiles; E = 8: one k-step padded to 16, one
    # n-tile
    *((e, beam, l, dt) for e, dt in ((8, torch.float32), (8, torch.bfloat16),
                                      (16, torch.float32), (16, torch.bfloat16))
      for beam, l in ((1, 10), (20, 10), (110, 10), (20, 24))),
    (64, 1, 10, torch.float32),     # four query rows in one 64-row tile
    (64, 7, 24, torch.float32),     # one 16-row tile a row, two sequence tiles
    (128, 20, 10, torch.float32),   # 3 tiles a row: rows straddle 64-row tiles
    (128, 20, 10, torch.bfloat16),  # bf16 rows, 4 base-256 digits a child
    (64, 110, 10, torch.float32),   # 14 tiles a row, a partly empty last group
    (128, 7, 24, torch.bfloat16),
])
def test_schedule_matches_the_plain_level(e, beam, l, dtype):
    rng = np.random.default_rng(e + beam + l)
    w = params_from_numpy(_params(rng, e), device="cpu").scorer_weights()
    b = 5 if beam == 110 else 11  # 11 * 3 = 33 tiles: the last group holds one
    rows, alive, seq_e, pad = _inputs(rng, b, beam, e, l, dtype)
    with torch.inference_mode():
        got = wgmma_schedule(rows, alive, seq_e, pad, *w, e)
        want = packed_level_plain(rows, alive, seq_e, pad, *w, e)
    _hold(got, want, rows)


@pytest.mark.parametrize("e,beam", [(8, 20), (16, 20), (32, 20), (64, 7), (128, 20)])
def test_schedule_matches_pallas(e, beam):
    """Against the JAX package's Pallas level body in interpret mode, as
    tests/test_torch_wide_widths.py runs it, on the JAX layout's f32 rows."""
    rng = np.random.default_rng(e * 3 + beam)
    p = _params(rng, e)
    rows, alive, seq_e, pad = _inputs(rng, 4, beam, e, 10)
    js, jh = packed_level_pallas(jax.tree.map(jnp.asarray, p), jnp.asarray(rows.numpy()),
                                 jnp.asarray(alive.numpy()), jnp.asarray(seq_e.numpy()),
                                 jnp.asarray(pad.numpy()), e, tile_b=2, interpret=True)
    with torch.inference_mode():
        got = wgmma_schedule(rows, alive, seq_e, pad,
                             *params_from_numpy(p, device="cpu").scorer_weights(), e)
    _hold(got, (torch.as_tensor(np.array(js)), torch.as_tensor(np.array(jh))), rows)


@pytest.mark.parametrize("t", [1, 2, 3, 14, 15])
def test_tile_order_walks_every_tile_once(t):
    """The row walk's tile order is a permutation of a row's tiles, and the
    source defines the same map."""
    assert sorted(tile_order(k, t) for k in range(t)) == list(range(t))
    assert tile_order(t, t) == t
    assert "  return k >= T ? T : k & 1 ? (T + 1) / 2 + k / 2 : k / 2;" in CSRC.read_text()


def test_k_orders_are_the_fragment_layouts():
    """item_k and att_k are permutations within each 16 k (so the tensor
    cores' sums over a k-step keep their terms): item_k puts a lane's four
    loaded lanes (4t .. 4t+3) in its fragment columns 2t, 2t+1, 2t+8, 2t+9,
    att_k puts lanes 2g and 2g + 1 in column g of n-tiles 2s and 2s + 1;
    the source defines the same maps."""
    for fn in (item_k, att_k):
        assert sorted(fn(k) for k in range(16)) == list(range(16))
    for t in range(4):
        assert [item_k(c) for c in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)] == [
            4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3]
    for g in range(8):
        assert [att_k(g), att_k(8 + g)] == [2 * g, 2 * g + 1]
    src = CSRC.read_text()
    assert ("return k < 8 ? 4 * (k >> 1) + (k & 1) : 4 * ((k - 8) >> 1) + 2 + (k & 1);"
            in src)
    assert "constexpr int att_k(int k) { return 2 * (k & 7) + (k >> 3); }" in src


@pytest.mark.parametrize("bad", ["K3 E=64 f32 one-tile", "K3 E=128 bf16 tiles",
                                 "K3 E=32 f32 one-tile", "K3 E=32 bf16 tiles",
                                 "K3 E=16 f32 one-tile", "K3 E=8 f32 tiles",
                                 "K3 E=8 bf16 one-tile"])
def test_tensor_core_gate_wants_hgmma_in_every_wide_k3(bad):
    """chip_smoke's build gate: a K3 instance (the warpgroup plan, at every
    width and row type) on mma.sync alone (HMMA, no HGMMA) fails it, as does
    any K3 or wide K1 instance (E = 32, whose sweep batches take the wide
    kernel, and up) without either; the wide K1 passes on HMMA alone."""
    import chip_smoke

    mangled = {"K3 E=64 f32 one-tile": "packed_level_wgmma_kernelILb1EfLi64EEvPKT0_",
               "K3 E=128 bf16 tiles":
                   "packed_level_wgmma_kernelILb0E13__nv_bfloat16Li128EEvPKT0_",
               "K3 E=32 f32 one-tile": "packed_level_wgmma_kernelILb1EfLi32EEvPKT0_",
               "K3 E=32 bf16 tiles":
                   "packed_level_wgmma_kernelILb0E13__nv_bfloat16Li32EEvPKT0_",
               "K3 E=16 f32 one-tile": "packed_level_wgmma_kernelILb1EfLi16EEvPKT0_",
               "K3 E=8 f32 tiles": "packed_level_wgmma_kernelILb0EfLi8EEvPKT0_",
               "K3 E=8 bf16 one-tile":
                   "packed_level_wgmma_kernelILb1E13__nv_bfloat16Li8EEvPKT0_"}[bad]
    assert chip_smoke.instance_name(f"_ZN12_GLOBAL__N_1{len('packed_level_wgmma_kernel')}"
                                    f"{mangled}") == bad
    counts = {n: {"HMMA": 4, "HGMMA": 0} for n in (
        {f"K3 E={e} {r} {t}" for e in (8, 16, 32, 64, 96, 128) for r in ("f32", "bf16")
         for t in ("one-tile", "tiles")} | {f"K1 E={e}" for e in (32, 64, 96, 128)})}
    for n in counts:
        if n.startswith("K3"):
            counts[n]["HGMMA"] = 24
    assert chip_smoke.tensor_core_gate(counts) == []
    counts[bad] = {"HMMA": 40, "HGMMA": 0}
    assert chip_smoke.tensor_core_gate(counts) == [bad]
    counts["K1 E=96"] = {"HMMA": 0, "HGMMA": 0}
    assert chip_smoke.tensor_core_gate(counts) == sorted([bad, "K1 E=96"])
    assert chip_smoke.reg_cap(bad) == {"K3 E=32 f32 one-tile": 168, "K3 E=16 f32 one-tile": 64,
                                       "K3 E=8 bf16 one-tile": 64}.get(bad, 255)


@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("e", [8, 16, 32, 64, 96, 128])
def test_wrapper_launches_a_wide_beam_once(monkeypatch, e, rows):
    """At every built width and row type the wrapper takes beam 1,500
    (wider than the ~1,340 parents a block of the plan the warpgroup plan
    replaced held at E = 16, and the ~3,050 the narrow plan held at E = 8 on
    bf16 rows, each of which split a wider beam) in one launch, and the
    source's single-launch limit (kWgMaxBeam) lies past it."""
    src = CSRC.read_text()
    m = re.search(r"constexpr int kWgMaxBeam = \(1 << (\d+)\) - (\d+);", src)
    assert (1 << int(m[1])) - int(m[2]) > 1500
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[rows]
    calls = []

    class _Lib:
        def packed_level_bf16(self, *args):
            calls.append(args[11:16])  # B, beam, row width, L, E
            return 0

        packed_level_bf16_bf16rows = packed_level_bf16

    monkeypatch.setattr(_cuda, "library", lambda: _Lib())
    monkeypatch.setattr(_cuda, "stream_handle", lambda dev: 0)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    fake = lambda *s, dtype=torch.float32: (  # noqa: E731
        torch.zeros(*s, dtype=dtype).as_subclass(_FakeCuda))
    b, beam, l = 2, 1500, 10
    w = [t.as_subclass(_FakeCuda) for t in params_from_numpy(
        _params(np.random.default_rng(0), e), device="cpu").scorer_weights()]
    width = pair_row_width(e, dt)
    n0 = packed_level_kernel.launches_by_width[e, dt]
    scores, hilo = packed_level(fake(b, beam, width, dtype=dt), fake(b, beam),
                                fake(b, l, e), fake(b, l), *w, e)
    assert calls == [(b, beam, width, l, e)]
    assert scores.shape == (b, 2 * beam) and hilo.shape[:2] == (b, 2 * beam)
    assert packed_level_kernel.launches_by_width[e, dt] == n0 + 1
