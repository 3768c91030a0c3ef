"""The yardstick's frozen counts: the H100's published peaks, the least time
of a kernel call (its roofline bound), and DIN's model operations.

A copy of the bound functions that ``chip_smoke.py`` used while the port was
brought up, taken out of the program so that a change to the program cannot
move the yardstick.  Each input byte is counted once and each output byte
once, whatever a kernel reads again; where the work depends on the data (the
distinct rows of a row write), the caller counts what its inputs need.
Imports nothing of the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_MMA_FLOP_PER_S = 989e12
# f32-accurate products on the tensor cores: 3xTF32 (three TF32 products a
# product) at a third of the dense TF32 rate
TF32X3_FLOP_PER_S = 495e12 / 3

# id digits a child in a pair row, by the row's element size in bytes (f32
# rows: 2 base-4096 digits; bf16 rows: 4 base-256 digits)
ID_DIGITS = {4: 2, 2: 4}

# substrings of the device kernels' names in a profiler trace
KERNEL_NAMES = {
    "k1": ("din_score", "din_prologue"),
    "k3": ("packed_level",),
    "k2": ("write_kernel",),
}


def bound(bytes_moved: int, f32_flops: int = 0, mma_flops: int = 0,
          tf32x3_flops: int = 0) -> tuple[float, str]:
    """The least time in seconds for moving ``bytes_moved`` through HBM and
    doing ``f32_flops`` on the CUDA cores, ``mma_flops`` on the bf16 tensor
    cores and ``tf32x3_flops`` f32-accurate on the tensor cores, and which of
    bytes and operations sets it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = (f32_flops / F32_FLOP_PER_S + mma_flops / BF16_MMA_FLOP_PER_S
             + tf32x3_flops / TF32X3_FLOP_PER_S)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def din_flops(n_candidates: int, l: int, e: int) -> tuple[int, int]:
    """Operations of DIN scores as (matmul, rest): the matmuls are scores
    2LE + probs.seq 2LE + att Linear 2E^2 + mlp1 4E^2 + mlp2 2E; the rest is
    the scale L + softmax 4L + bias/ReLU 2E + the last bias 1."""
    return (n_candidates * (4 * l * e + 6 * e * e + 2 * e),
            n_candidates * (5 * l + 2 * e + 1))


def din_model_flops(n_candidates: int, l: int, e: int) -> int:
    """All of DIN's forward operations over ``n_candidates`` candidates."""
    return sum(din_flops(n_candidates, l, e))


def k1_flops(b: int, u: int, l: int, e: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """K1's operations over [b, u] candidates in its two orders, each as
    (products, rest): folded (M = w1[:, E:] @ att_w once, ctx_l = M . seq_l a
    query row, per candidate the scores, sum_l x_l ctx_l and w1[:, :E] .
    item) and unfolded (M once, per candidate the scores 2LE, att 2LE and h
    = [item | att] . [w1[:, :E] | M]^T 4E^2).  The rest is the same in both:
    padding and scale 2L, softmax 4L, att's normalisation, bias and ReLU 4E,
    w2 2E and the last bias 1."""
    rest = b * u * (6 * l + 6 * e + 1)
    folded = 2 * e**3 + b * 2 * l * e * e + b * u * (4 * l * e + 2 * e * e)
    unfolded = 2 * e**3 + b * u * (4 * l * e + 4 * e * e)
    return (folded, rest), (unfolded, rest)


def k1_bytes(b: int, u: int, l: int, e: int) -> int:
    """K1's f32 inputs and output over [b, u] candidates: candidate and
    sequence embeddings, padding, the five weights and the logits."""
    return 4 * (b * u * e + b * l * e + b * l + e * e + 2 * e * e + e + e + 1 + b * u)


def k1_bound(b: int, u: int, l: int, e: int) -> tuple[float, str]:
    """K1's bound over [b, u] candidates: its products f32-accurate on the
    tensor cores, the rest at the f32 rate, in whichever order takes less
    time."""
    n_bytes = k1_bytes(b, u, l, e)
    return min((bound(n_bytes, f32_flops=rest, tf32x3_flops=mm)
                for mm, rest in k1_flops(b, u, l, e)), key=lambda t: t[0])


def k3_bytes(b: int, beam: int, l: int, e: int, row_bytes: int = 4) -> int:
    """K3's bytes on [b, beam] pair rows: of each row the lanes it needs
    (2E + 2 + 2 id digit groups), the alive mask, the sequence tiles and
    padding, the weights, its f32 scores and its id digits."""
    u = 2 * beam
    k = ID_DIGITS[row_bytes]
    return (row_bytes * (b * beam * (2 * e + 2 + 2 * k) + b * u * k)
            + 4 * (b * beam + b * l * e + b * l + 3 * e * e + 2 * e + 1 + b * u))


def k3_bound(b: int, beam: int, l: int, e: int, row_bytes: int = 4) -> tuple[float, str]:
    """K3's bound: its bytes, its matmuls at the bf16 tensor-core rate
    (their operands are bf16), the rest at the f32 rate."""
    mm, rest = din_flops(b * 2 * beam, l, e)
    return bound(k3_bytes(b, beam, l, e, row_bytes), f32_flops=rest, mma_flops=mm)


def row_bound(n_idx: int, written: int, width: int, add: bool = False,
              elem_bytes: int = 4) -> tuple[float, str]:
    """A row write's (K2) or row add's bound: ``n_idx`` int64 indices, one
    payload row per distinct destination (``written``) read once, each
    destination written once and, by the add, read once more; the add does
    one f32 add a lane of each destination."""
    row_b = elem_bytes * width
    return bound(8 * n_idx + written * row_b * (3 if add else 2),
                 f32_flops=written * width if add else 0)
