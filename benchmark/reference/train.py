"""The train step of TDM and OTM in plain PyTorch, followed step by step on
the rows it touches: the candidates' and the sequences' embedding rows
gathered, DIN's logits and the weighted BCE differentiated by autograd, the
row gradients summed per code, lazy Adam on the touched rows (rows a step
does not touch keep their moments; the bias correction counts every step)
and Adam on the towers (optax's order: m, v, bias-corrected m / (sqrt(v) +
eps)).  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable

import torch

from reference import din

B1, B2, EPS = 0.9, 0.999, 1e-8
TOWERS = ("att_w", "w1", "b1", "w2", "b2")


def adam(p, m, v, g, count: int, lr: float):
    m.mul_(B1).add_((1 - B1) * g)
    v.mul_(B2).add_((1 - B2) * g * g)
    mh = m / (1 - B1**count)
    vh = v / (1 - B2**count)
    p.add_(-lr * mh / (torch.sqrt(vh) + EPS))


class Follower:
    """Follows the steps of a trainer from the benchmark's initial weights:
    ``table`` (the whole [V, E] table; only the rows of ``codes`` are kept)
    and the towers.  ``rnd`` rounds every matmul operand (a control);
    ``keep`` leaves all but the first ``keep`` batch rows out of each step
    (a fault put in the program's place)."""

    def __init__(self, table: torch.Tensor, towers: dict, codes: torch.Tensor, lr: float,
                 rnd: Callable | None = None, keep: int | None = None):
        self.codes = torch.unique(codes[codes >= 0])
        self.rows0 = table[self.codes].clone()
        self.rows = self.rows0.clone()
        self.m = torch.zeros_like(self.rows)
        self.v = torch.zeros_like(self.rows)
        self.t0 = {k: towers[k].clone() for k in TOWERS}
        self.t = {k: towers[k].clone() for k in TOWERS}
        self.tm = {k: torch.zeros_like(x) for k, x in self.t.items()}
        self.tv = {k: torch.zeros_like(x) for k, x in self.t.items()}
        self.count = 0
        self.lr, self.rnd, self.keep = lr, rnd or (lambda x: x), keep
        self.first_grad: dict | None = None
        self.m1: dict | None = None  # first moments after the first step

    def rows_of(self, codes: torch.Tensor) -> torch.Tensor:
        """The current rows of ``codes`` (all kept codes), zero at -1."""
        ok = codes >= 0
        pos = torch.searchsorted(self.codes, codes.clamp_min(0)).clamp_max(len(self.codes) - 1)
        if not bool((self.codes[pos] == codes)[ok].all()):
            raise KeyError("a code outside the rows this follower keeps")
        return self.rows[pos] * ok[..., None]

    def logits(self, seq: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """Frozen logits [B, U] of candidate codes with the current weights."""
        return din.logits(self.rows_of(cand), self.rows_of(seq), seq == din.PAD, self.t, self.rnd)

    def step(self, seq: torch.Tensor, codes: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor) -> float:
        """One step on [B, L] sequences and [B, U] candidates with labels and
        weights; returns the loss before the update."""
        if self.keep is not None:
            seq, codes, labels, weights = (x[: self.keep] for x in (seq, codes, labels, weights))
        b, u = codes.shape
        e = self.rows.shape[1]
        flat = torch.cat([codes.reshape(-1), seq.reshape(-1)])
        ok = flat >= 0
        pos = torch.searchsorted(self.codes, flat.clamp_min(0))
        r = (self.rows[pos] * ok[:, None]).requires_grad_()
        tw = {k: x.clone().requires_grad_() for k, x in self.t.items()}
        with torch.enable_grad():
            x = din.logits(r[: b * u].view(b, u, e), r[b * u:].view(b, -1, e),
                           seq == din.PAD, tw, self.rnd)
            loss = din.bce(x, labels, weights)
            g_r, *g_t = torch.autograd.grad(loss, [r, *tw.values()])
        g = torch.zeros_like(self.rows).index_add_(0, pos[ok], g_r[ok])
        touched = torch.zeros(len(self.codes), dtype=torch.bool, device=g.device)
        touched[pos[ok]] = True
        self.count += 1
        if self.first_grad is None:
            self.first_grad = {"embedding": float(g[touched].norm()),
                               **{k: float(gt.norm()) for k, gt in zip(self.t, g_t)}}
        with torch.no_grad():
            idx = touched.nonzero()[:, 0]
            p, m, v = self.rows[idx], self.m[idx], self.v[idx]
            adam(p, m, v, g[idx], self.count, self.lr)
            self.rows[idx], self.m[idx], self.v[idx] = p, m, v
            for k, gt in zip(self.t, g_t):
                adam(self.t[k], self.tm[k], self.tv[k], gt, self.count, self.lr)
            if self.m1 is None:
                self.m1 = {"embedding": m.clone(), **{k: x.clone() for k, x in self.tm.items()}}
        return float(loss.detach())

    def state(self) -> dict:
        """The kept rows and the towers as they stand."""
        return {"embedding": self.rows.clone(), **{k: x.clone() for k, x in self.t.items()}}

    def change(self) -> dict:
        """Norm of each leaf's change since the start (the embedding over the
        kept rows)."""
        return {"embedding": float((self.rows - self.rows0).norm()),
                **{k: float((self.t[k] - self.t0[k]).norm()) for k in TOWERS}}
