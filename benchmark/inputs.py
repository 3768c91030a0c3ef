"""What the benchmark makes from ``--seed`` and hands to both the program and
the reference: the scorer's weights, the catalog, and the traffic that the
one general generator draws from a mix file's parameters.

Everything random is drawn on the card from ``torch.Generator``s seeded by
(seed, stream), so the same seed gives the same inputs, and in a few large
calls.  Sizes never depend on the seed: only values and order do.
"""

from __future__ import annotations

import numpy as np
import torch

# generator streams of one run
WEIGHTS, TRAFFIC, MAPPING, SAMPLE = 1, 2, 3, 4


def stream_seed(seed: int, stream: int, *more: int) -> int:
    """A 63-bit generator seed for (seed, stream, ...); ``seed`` may pass 32
    bits."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, stream, *more]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device, *more: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream, *more))
    return g


def din_weights(seed: int, num_index: int, e: int, device, emb_std: float,
                w_std: float) -> dict:
    """DIN's parameters, float32 on ``device``: the [num_index, E] table at
    ``emb_std`` and the towers (att_w, w1, b1, w2, b2) at ``w_std``, biases
    drawn too, in two calls of one generator."""
    g = generator(seed, WEIGHTS, device)
    table = torch.randn((num_index, e), generator=g, device=device).mul_(emb_std)
    sizes = {"att_w": (e, e), "w1": (e, 2 * e), "b1": (e,), "w2": (1, e), "b2": (1,)}
    flat = torch.randn(sum(int(np.prod(s)) for s in sizes.values()), generator=g,
                       device=device).mul_(w_std)
    out, at = {"table": table}, 0
    for k, s in sizes.items():
        n = int(np.prod(s))
        out[k] = flat[at : at + n].view(s).clone()
        at += n
    return out


def catalog(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """(item ids 1..items, categories id % categories)."""
    ids = np.arange(1, cfg["items"] + 1, dtype=np.int64)
    return ids, ids % cfg["categories"]


class Popularity:
    """Item draws by popularity rank: Zipf(s) over ranks 1..n, rank r is
    item id r."""

    def __init__(self, n_items: int, popularity: dict, device):
        if popularity["kind"] != "zipf":
            raise ValueError(f"unknown popularity {popularity['kind']!r}")
        w = torch.arange(1, n_items + 1, dtype=torch.float64, device=device).pow_(
            -float(popularity["exponent"]))
        self.cdf = torch.cumsum(w, 0).div_(w.sum())
        self.n = n_items

    def draw(self, g: torch.Generator, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=g, device=self.cdf.device, dtype=torch.float64)
        return torch.searchsorted(self.cdf, u).clamp_(max=self.n - 1).add_(1)


def windows(pop: Popularity, g: torch.Generator, n: int, seq_len: int, min_seq_len: int,
            short_share: float) -> torch.Tensor:
    """[n, seq_len] behaviour windows of item ids: a share ``short_share``
    holds fewer than ``seq_len`` items (uniform in [min_seq_len, seq_len)),
    left-padded with id 0 as the upstream TreeInit pads a user's first
    windows."""
    seqs = pop.draw(g, (n, seq_len))
    short = torch.rand(n, generator=g, device=seqs.device) < short_share
    length = torch.randint(min_seq_len, seq_len, (n,), generator=g, device=seqs.device)
    length = torch.where(short, length, seq_len)
    pos = torch.arange(seq_len, device=seqs.device)
    return torch.where(pos[None, :] >= (seq_len - length)[:, None], seqs, 0)
