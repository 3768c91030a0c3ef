"""K1's plans at E = 8 and 32, held on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py``); here a mirror
of their launch plans in Python, held to the kernel source's constants: K1
takes the wide kernel at E = 32 where U <= L (the JTM sweep's batches) or
L > 10, the direct kernel (``din_score_direct_kernel``) at E = 8 and L <=
10, and the block-staged fold (``din_score_kernel``, unchanged) otherwise.
At every shape the main path gives the two new routes, their blocks hold
four warps or more and the wide kernel's grid is at most one wave.  The
direct kernel's unfolded order and the fold's order (``din_score_kernel``'s,
candidate for candidate) at E = 8 and 32 against the JAX package's scorer
and its Pallas kernel in interpret mode."""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dismember_tpu.models import din as jdin
from dismember_tpu.ops.din_kernel import din_forward_pallas
from dismember_tpu_torch.models.din import params_from_numpy
from dismember_tpu_torch.models.embedding import embed_lookup
from dismember_tpu_torch.ops.din_kernel import _MASK_F32, din_score_plain
from test_torch_k1_fold import ATOL, RTOL, _folded, _jax

CSRC = Path(__file__).resolve().parent.parent / "dismember_tpu_torch" / "csrc"
SHORT_L = 10  # kShortL
DIRECT_THREADS, DIRECT_REGS = 128, 128  # kDirectThreads; its launch bounds' registers
# the wide kernel at E = 32: kWideThreads, kWideCands, the registers its
# launch bounds allow (kK1WideMinBlocks<32> = 4 blocks an SM)
WIDE_THREADS, WIDE_CANDS, WIDE_REGS = 256, 32, 64
# an H100's limits (cudaDeviceGetAttribute): SMs, threads, registers and
# shared memory an SM, shared memory reserved a block
H100 = {"sms": 132, "threads_sm": 2048, "regs_sm": 65536, "smem_sm": 233472,
        "smem_reserved": 1024}
# every K1 shape of chip_smoke.py's paths at E = 8 and 32: serving, the
# sweep's batches, predict over the example and the 1M catalogs, the E = 8
# trainer's evaluate and recommend (beam 45: 90 candidates; its last
# levels), and L = 24
SHAPES = [(4096, 40, 10), (8192, 4, 10), (8192, 2, 10), (1, 3325, 10), (1, 1_000_000, 10),
          (512, 90, 10), (19, 90, 10), (3750, 178, 10), (1, 90, 10), (4096, 40, 24)]


def route(e: int, u: int, l: int) -> str:
    """din_score_f32's kernel at width ``e`` for U = ``u``, L = ``l``."""
    if e >= 64 or e == 32 and (u <= l or l > SHORT_L):
        return "wide"
    if e == 8 and l <= SHORT_L:
        return "direct"
    return "staged"


# the main path's shapes on the two new routes (the staged one is PR 4's
# plan, unchanged)
NEW_ROUTES = [(e, shape) for e in (8, 32) for shape in SHAPES
              if route(e, *shape[1:]) in ("direct", "wide")]


def blocks_an_sm(threads: int, regs: int, smem: int) -> int:
    """Blocks an SM holds: by threads, registers (a warp's in 256s) and
    shared memory (with the block's reserve)."""
    d = H100
    warp_regs = -(-32 * regs // 256) * 256
    return min(d["threads_sm"] // threads, 32, d["regs_sm"] // (threads // 32 * warp_regs),
               d["smem_sm"] // (smem + d["smem_reserved"]))


def direct_grid(b: int, u: int, e: int) -> tuple[int, int]:
    """launch_din_direct<E>'s blocks an SM (B's rows of 2E + 4 floats in
    shared memory) and grid: a block every DIRECT_THREADS candidates."""
    return (blocks_an_sm(DIRECT_THREADS, DIRECT_REGS, 4 * e * (2 * e + 4)),
            -(-b * u // DIRECT_THREADS))


def wide_smem(e: int) -> int:
    """wide_smem_bytes<E>: B's rows of 2E + 16 floats with b1, w2 and b2,
    two buffers of WIDE_CANDS candidate rows, the partial logits."""
    row = 2 * e + 16
    return 4 * ((e * row + 2 * e + 4) + 2 * WIDE_CANDS * row + 2 * 4 * WIDE_CANDS)


def wide_grid(b: int, u: int, e: int) -> tuple[int, int, int]:
    """launch_din_wide<E>'s blocks an SM (at the launch bounds' registers),
    its grid (at most the blocks the card holds at once, at most a chunk a
    block) and its chunks of WIDE_CANDS candidates."""
    per_sm = blocks_an_sm(WIDE_THREADS, WIDE_REGS, wide_smem(e))
    chunks = -(-b * u // WIDE_CANDS)
    return per_sm, min(chunks, H100["sms"] * per_sm), chunks


def test_mirror_reads_the_kernel_source():
    src = (CSRC / "din_kernels.cu").read_text()
    for line in (f"constexpr int kShortL = {SHORT_L};",
                 "constexpr bool kWideK1 = E >= 64;",
                 "constexpr bool kWideUnfoldedK1 = E == 32;",
                 "constexpr bool kDirectK1 = E == 8;",
                 f"constexpr int kDirectThreads = {DIRECT_THREADS};",
                 "constexpr int kDirectMinBlocks = 4;",
                 f"constexpr int kWideThreads = {WIDE_THREADS};",
                 f"constexpr int kWideCands = {WIDE_CANDS};",
                 "constexpr int kWideBuffers = 2;",
                 "constexpr int kWideRow = 2 * E + 16;",
                 "__launch_bounds__(kWideThreads, kK1WideMinBlocks<E>)",
                 "constexpr int kK1WideMinBlocks = E == 32 ? 4 : E <= 64 ? 2 : 1;",
                 "  const int grid = (int)std::min<long long>(chunks, blocks);",
                 "  unrolled[L - 1]<<<(int)((n + kDirectThreads - 1) / kDirectThreads), "
                 "kDirectThreads, 0,",
                 "      if constexpr (kWideUnfoldedK1<W>)\n        if (U <= L || L > kShortL)",
                 "      if constexpr (kDirectK1<W>)\n        if (L <= kShortL)"):
        assert line in src, line


@pytest.mark.parametrize("e,shape", NEW_ROUTES)
def test_blocks_hold_four_warps_and_the_grid_one_wave(e, shape):
    """The direct kernel: four-warp blocks, a block every 128 candidates,
    several an SM; the wide kernel at E = 32: eight-warp blocks, four an SM
    at its launch bounds, a grid of at most one wave and at most a block a
    chunk of 32 candidates."""
    b, u, l = shape
    if route(e, u, l) == "direct":
        per_sm, grid = direct_grid(b, u, e)
        assert DIRECT_THREADS // 32 >= 4 and per_sm >= 4
        assert (grid - 1) * DIRECT_THREADS < b * u <= grid * DIRECT_THREADS
        return
    per_sm, grid, chunks = wide_grid(b, u, e)
    assert WIDE_THREADS // 32 >= 4 and per_sm == 4
    assert 1 <= grid <= H100["sms"] * per_sm and grid <= chunks
    assert (chunks - 1) * WIDE_CANDS < b * u <= chunks * WIDE_CANDS


def test_plans_at_the_main_shapes():
    """The sweep's batches at E = 8: four-warp blocks of the direct kernel,
    one every 128 candidates, all in one wave of four blocks an SM
    (din_score_kernel gave 1,024 one-warp blocks there); the serving shape
    at E = 8 in 2.4 waves (a grid of one wave whose threads walked
    candidates a wave apart spilled).  E = 32's sweep batches take the wide
    kernel: 32 KB of shared memory a block, four eight-warp blocks an SM,
    one wave of 528 blocks over 1,024 chunks at U = 4 and 512 chunks at U =
    2, and its L = 24 shape 5,120 chunks."""
    assert direct_grid(8192, 4, 8) == (4, 256) and 256 <= 4 * H100["sms"]
    assert direct_grid(4096, 40, 8) == (4, 1280)
    assert wide_smem(32) == 32016
    assert wide_grid(8192, 4, 32) == (4, 528, 1024)
    assert wide_grid(8192, 2, 32) == (4, 512, 512)
    assert wide_grid(4096, 40, 32) == (4, 528, 5120)


def test_routes_by_width():
    """E = 32 takes the wide kernel where the fold is no less work (U <= L,
    chip_smoke.k1_flops) or takes its chunked softmax (L > 10),
    din_score_kernel otherwise; E = 8 the direct kernel up to L = 10,
    din_score_kernel past it; E = 16 din_score_kernel, E >= 64 the wide
    kernel."""
    for b, u, l in SHAPES:
        (folded, _), (unfolded, _) = chip_smoke.k1_flops(b, u, l, 32)
        assert (route(32, u, l) == "wide") == (folded >= unfolded or l > SHORT_L)
        assert route(8, u, l) == ("direct" if l <= SHORT_L else "staged")
        assert route(16, u, l) == "staged" and route(64, u, l) == "wide"


def _direct(item_e, seq_e, pad, att_w, w1, b1, w2, b2):
    """The direct kernel's order in float32: the scores with padding, the
    softmax with one reciprocal of its sum, att = inv * sum_l x_l seq_l, h
    = [item | att] . [w1[:, :E] | M]^T + b1 with M = w1[:, E:] @ att_w."""
    e = item_e.shape[-1]
    scores = torch.einsum("bue,ble->bul", item_e, seq_e) * (1.0 / math.sqrt(e))
    scores = torch.where(pad[:, None, :] > 0.5, _MASK_F32, scores)
    x = torch.exp(scores - scores.max(-1, keepdim=True).values)
    att = torch.einsum("bul,ble->bue", x, seq_e) * (1.0 / x.sum(-1, keepdim=True))
    m = w1[:, e:] @ att_w
    h = torch.relu(torch.cat([item_e, att], -1) @ torch.cat([w1[:, :e], m], 1).T + b1)
    return (h @ w2.T + b2)[..., 0]


def _inputs(e: int, u: int, l: int, seed: int):
    """B = 32 query rows at chip_smoke.py's weight scale for the width: 30%
    padding, an all-padding row, 10% zero (invalid) items; the JAX
    package's DIN forward and its Pallas kernel (interpret mode) on them,
    and the port's embeddings and weights."""
    b, num_index = 32, 255
    rng = np.random.default_rng(seed)
    p = chip_smoke.seed_params(num_index, rng, e)
    items = rng.integers(0, num_index, (b, u))
    items[rng.random((b, u)) < 0.1] = -1
    seqs = rng.integers(0, num_index, (b, l))
    seqs[rng.random((b, l)) < 0.3] = -1
    seqs[0] = -1
    ref = np.asarray(jdin.forward(_jax(p), jnp.asarray(items), jnp.asarray(seqs)))
    pal = np.asarray(din_forward_pallas(_jax(p), jnp.asarray(items), jnp.asarray(seqs),
                                        tile_b=16, interpret=True))
    model = params_from_numpy(p, device="cpu")
    w = tuple(t.detach() for t in model.scorer_weights())
    items_t, seqs_t = torch.as_tensor(items), torch.as_tensor(seqs)
    with torch.no_grad():
        args = (embed_lookup(model.embedding, items_t), embed_lookup(model.embedding, seqs_t),
                (seqs_t < 0).float(), *w)
    return args, (ref, pal)


@pytest.mark.parametrize("e", [8, 32])
@pytest.mark.parametrize("u,l", [(40, 10), (4, 10), (90, 24)])
def test_fold_order_at_width_matches_jax_and_plain(e, u, l):
    """The folded order (din_score_kernel's, which E = 32 runs past U = L
    up to L = 10 and E = 8 past L = 10: M and ctx a query row, the softmax
    at once or in chunks of 4 past L = 10, one reciprocal) at E = 8 and 32 against the JAX package's DIN forward, its Pallas kernel in
    interpret mode and the port's plain version."""
    args, jax_refs = _inputs(e, u, l, 100 * e + u + l)
    with torch.no_grad():
        got = _folded(*args).numpy()
        plain = din_score_plain(*args).numpy()
    assert got.shape == (32, u) and np.isfinite(got).all()
    for want in (*jax_refs, plain):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("u,l", [(40, 10), (4, 10), (2, 10), (90, 1)])
def test_direct_order_at_e8_matches_jax_and_plain(u, l):
    """The direct kernel's unfolded order at E = 8 (L <= 10) against the
    JAX package's DIN forward, its Pallas kernel in interpret mode and the
    port's plain version; the all-padding row scores the item alone."""
    args, jax_refs = _inputs(8, u, l, 200 + u + l)
    with torch.no_grad():
        got = _direct(*args)
        plain = din_score_plain(*args).numpy()
    assert got.shape == (32, u) and torch.isfinite(got).all()
    for want in (*jax_refs, plain):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    item_e, _, _, _, w1, b1, w2, b2 = args
    direct = (torch.relu(item_e[0] @ w1[:, :8].T + b1) @ w2.T + b2)[..., 0]
    np.testing.assert_allclose(got[0].numpy(), direct.numpy(), rtol=RTOL, atol=ATOL)
