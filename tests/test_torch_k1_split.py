"""K1's h product in 3xTF32 (the wide kernel: E = 64, 96 and 128, and E =
32 where U <= L or L > 10), held on the CPU.

The CUDA kernel ``din_score_wide_kernel`` computes h = [item | att] . B with
B = [w1[:, :E] | M]^T (M = w1[:, E:] @ att_w, summed in f64) on the tensor
cores: each operand x = big + small, big = x rounded to TF32 (nearest, ties
away), small = x - big, which the mma reads truncated to TF32; per 8-deep
k-step small(A).big(B), big(A).small(B) and big(A).big(B) go into an f32
accumulator that restarts every 16 k and is then added to the running sum.
``_emulate`` repeats that arithmetic in torch, with each mma's sum of exact
products added to its accumulator and rounded toward zero (the tensor
cores' f32 sums are not IEEE round-to-nearest), on chip_smoke.py's draws;
it must lie within half of K1's tolerance of a float64 evaluation of
``din_score_plain``, and a single TF32 product (the control) must fail K1's
tolerance at every width.  Also the layout the kernel reads its mma
fragments from, and K1's re-priced bound (chip_smoke.k1_bound)."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.ops.din_kernel import _MASK_F32, din_score_plain, score_chain

ATOL, RTOL = chip_smoke.TOL["din_score"]
WIDE = chip_smoke.K1_WIDE  # the widths with the wide kernel: 32, 64, 96, 128
K_STEP, K_CHUNK = 8, 16  # an m16n8k8 mma's depth; k summed apart, then added
CSRC = Path(__file__).resolve().parent.parent / "dismember_tpu_torch" / "csrc"


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, as cvt.rna.tf32.f32 and the kernel's split_tf32: add half of the
    dropped bits' range to the magnitude bits and clear them."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the mma reads an f32 operand: its low 13 mantissa bits dropped."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a . b with the products exact and the sum rounded toward zero
    to f32 once a k-step."""
    exact = acc.double() + a.double() @ b.double()
    y = exact.float()
    return torch.where(y.double().abs() > exact.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _product(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """[N, K] . [K, n] in the kernel's order: 3xTF32 (``split``) or one
    TF32 product a k-step, an accumulator a K_CHUNK of k added to the
    running f32 sum."""
    run = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], K_CHUNK):
        acc = torch.zeros_like(run)
        for s in range(k0, k0 + K_CHUNK, K_STEP):
            x, w = a[:, s : s + K_STEP], b[s : s + K_STEP]
            xb, wb = _tf32_rna(x), _tf32_rna(w)
            if split:
                for p, q in ((_tf32_trunc(x - xb), wb), (xb, _tf32_trunc(w - wb)), (xb, wb)):
                    acc = _mma(acc, p, q)
            else:
                acc = _mma(acc, xb, wb)
        run = run + acc
    return run


def _emulate(item_e, seq_e, pad, att_w, w1, b1, w2, b2, split=True):
    """The wide K1 on [B, U] candidates: the attention pass in f32, M in f64
    rounded once, h in 3xTF32 (or TF32), ReLU(h + b1) . w2 + b2 in f32."""
    b, u, e = item_e.shape
    scores = torch.einsum("bue,ble->bul", item_e, seq_e) * (1.0 / math.sqrt(e))
    scores = torch.where(pad[:, None, :] > 0.5, _MASK_F32, scores)
    att = torch.einsum("bul,ble->bue", torch.softmax(scores, -1), seq_e)
    m = (w1[:, e:].double() @ att_w.double()).float()
    a = torch.cat([item_e, att], -1).reshape(b * u, 2 * e)
    h = _product(a, torch.cat([w1[:, :e], m], 1).T.contiguous(), split) + b1
    return (torch.relu(h) @ w2.T + b2)[..., 0].reshape(b, u)


def _draws(e: int, seed: int):
    """chip_smoke.py's draws at width e: EMB_STD embeddings, w_std(e)
    weights, 30% padding, an all-padding row, 10% zero candidates; 2,000
    candidates (50 query rows of 40)."""
    g = torch.Generator().manual_seed(seed)
    weights = tuple(t.detach() for t in params_from_numpy(
        chip_smoke.seed_params(7, np.random.default_rng(seed), e), device="cpu").scorer_weights())
    seq_e, pad = chip_smoke.seq_inputs(g, 50, chip_smoke.SEQ_LEN, "cpu", e)
    item_e = torch.randn(50, 2 * chip_smoke.BEAM, e, generator=g) * chip_smoke.EMB_STD
    item_e[torch.rand(50, 2 * chip_smoke.BEAM, generator=g) < 0.1] = 0.0
    return (item_e, seq_e, pad, *weights)


def _err_over_tol(got: torch.Tensor, args) -> float:
    exact = score_chain(*(t.double() for t in args))
    return ((got.double() - exact).abs() / (ATOL + RTOL * exact.abs())).max().item()


@pytest.mark.parametrize("e", WIDE)
def test_3xtf32_product_within_half_of_k1_tolerance(e):
    args = _draws(e, 100 + e)
    with torch.no_grad():
        got = _emulate(*args)
        plain = din_score_plain(*args)
    assert got.shape == (50, 2 * chip_smoke.BEAM) and torch.isfinite(got).all()
    assert _err_over_tol(got, args) <= 0.5
    # the f32 plain version itself, for scale: the chip check compares the
    # kernel with it, so their two errors add up to less than K1's tolerance
    assert _err_over_tol(plain, args) <= 0.5


@pytest.mark.parametrize("e", WIDE)
def test_tf32_product_fails_k1_tolerance(e):
    """The control: one TF32 product a k-step (~3 digits) misses K1's
    tolerance by far."""
    args = _draws(e, 100 + e)
    with torch.no_grad():
        got = _emulate(*args, split=False)
    assert _err_over_tol(got, args) > 10.0


def _wide_pos(k: int) -> int:
    """The kernel's wide_pos: k = 8s + 4j + t of each 16 sits at 4t + 2s + j."""
    return (k & ~15) | ((k & 3) << 2) | (((k >> 3) & 1) << 1) | ((k >> 2) & 1)


def test_fragment_layout_reads_both_k_steps_as_one_float4():
    """A row of 2E k at wide_pos: the float4 at 16c + 4t holds, in order,
    k = 16c + t, + 4, + 8, + 12 (a0/a2 or b0/b1 of k-steps 0 and 1 of
    lane t); the attention pass writes float4 q of a candidate (k = 4q +
    i) at 16 (q // 4) + (q % 4) + 4i; the kernel's source says so."""
    e = 128
    pos = [_wide_pos(k) for k in range(2 * e)]
    assert sorted(pos) == list(range(2 * e))
    for c in range(2 * e // 16):
        for t in range(4):
            got = [pos.index(16 * c + 4 * t + i) for i in range(4)]
            assert got == [16 * c + t, 16 * c + t + 4, 16 * c + t + 8, 16 * c + t + 12]
    for q in range(2 * e // 4):
        for i in range(4):
            assert pos[4 * q + i] == 16 * (q >> 2) + (q & 3) + 4 * i
    src = (CSRC / "din_kernels.cu").read_text()
    assert "return (k & ~15) | ((k & 3) << 2) | (((k >> 3) & 1) << 1) | ((k >> 2) & 1);" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in src


@pytest.mark.parametrize("shape,e,want_ms,want_by,f32_core_ms", [
    # the serving shape: the fold's products at the 3xTF32 rate
    ((4096, 40, 10), 128, 0.04781, "operations", 0.1148),
    ((4096, 40, 10), 96, 0.02826, "operations", 0.06732),
    ((4096, 40, 10), 64, 0.01591, "bytes", 0.03240),
    # the JTM sweep's batches: U < L, so the unfolded order is less work
    ((8192, 4, 10), 128, 0.01772, "bytes", 0.05906),
    ((8192, 4, 10), 64, 0.008916, "bytes", 0.01550),
    ((4096, 40, 24), 128, 0.06652, "operations", 0.1606),
    # E = 32's sweep shape, on the wide kernel: bytes either way
    ((8192, 4, 10), 32, 0.004523, "bytes", 0.004523),
    # E <= 32 keeps its bytes bound
    ((4096, 40, 10), 16, 0.004158, "bytes", 0.004158),
])
def test_k1_bound_prices_products_on_the_tensor_cores(shape, e, want_ms, want_by, f32_core_ms):
    b, u, l = shape
    n_bytes = 4 * (b * u * e + b * l * e + b * l + b * u + 3 * e * e + 2 * e + 1)
    ms, by = chip_smoke.k1_bound(n_bytes, b, u, l, e)
    assert by == want_by and ms == pytest.approx(want_ms, rel=1e-3)
    old, _ = chip_smoke.bound(n_bytes, chip_smoke.din_folded_flops(b, u, l, e))
    assert old == pytest.approx(f32_core_ms, rel=1e-3) and ms <= old
    (folded, rest), (unfolded, rest_u) = chip_smoke.k1_flops(b, u, l, e)
    assert rest == rest_u and (folded < unfolded) == (u > l)
    assert folded + rest == chip_smoke.din_folded_flops(b, u, l, e)


def test_kernel_probes_apply_to_the_source():
    """scripts/compare_torch_kernels.py splits K1's and K3's time with
    source-edited variants; each edit must find its text in din_kernels.cu,
    or the A/B stops on the card before it times anything."""
    import importlib.util

    path = CSRC.parent.parent / "scripts" / "compare_torch_kernels.py"
    spec = importlib.util.spec_from_file_location("compare_torch_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (CSRC / "din_kernels.cu").read_text()
    for probes in (mod.PROBES, mod.WIDE_PROBES, mod.NARROW_PROBES, mod.WIDE_K1_PROBES,
                   mod.NARROW_K1_PROBES):
        for name, edits in probes.items():
            for old, _ in edits:
                assert old in src, f"probe {name}: {old!r}"
