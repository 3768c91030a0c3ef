"""TDM training at scale: ``TDMTrainer.train_resident`` over
``ResidentWindows``, called in calls of a fixed number of chunks.

Set-up builds the category-sorted tree, the trainer (the auto route is pmv
at this catalog: one K2 commit a step) with the benchmark's weights copied
in, and a UserBehavior-sized dataset drawn from the seed: every user's
behaviours as item ids, left-padded as the upstream TreeInit pads a user's
first windows, the train split's windows resident on the card.  It then
drives the trainer through the window's own call for the first steps that
the check follows, recording each step's inputs, draws and loss by wrapping
the trainer's ``sample`` and ``step_from_samples`` on the instance, and the
optimizer's state after the first step.

The check (``reference/train.py``) follows those steps from the seed's
weights in plain f32 and compares each step's loss, the first gradient as
the optimizer got it, and each leaf's change after the steps; it also holds
every draw to the sampler's guarantees on the reference's own tree, and
every step's rows to the dataset's windows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import flops
import inputs
from drivers import common
from reference import din as ref_din
from reference import precision
from reference import train as ref_train
from reference import tree as ref_tree


def pmv_lanes(trainer, codes: torch.Tensor, lane: int) -> torch.Tensor:
    """Lane group ``lane`` (0 params, 1 first moment) of ``codes``' rows in
    the trainer's packed p|m|v state (``train/sparse_adam.py``'s layout)."""
    from dismember_tpu_torch.train.sparse_adam import pmv_slots

    e = trainer.embed_size
    s = pmv_slots(e)
    rows = trainer.emb_state["pmv"][codes // s].view(-1, s, 128 // s)
    return rows[torch.arange(len(codes), device=codes.device), codes % s,
                lane * e:(lane + 1) * e]


def tower_params(model) -> dict:
    return {"att_w": model.att_linear.weight, "w1": model.mlp1.weight, "b1": model.mlp1.bias,
            "w2": model.mlp2.weight, "b2": model.mlp2.bias}


TOWER_NAMES = {"att_w": "att_linear/weight", "w1": "mlp1/weight", "b1": "mlp1/bias",
               "w2": "mlp2/weight", "b2": "mlp2/bias"}


class Capture:
    """Records a trainer's steps by wrapping ``sample`` and
    ``step_from_samples`` on the instance (the class is untouched); after
    the first step it reads the optimizer's first moments."""

    def __init__(self, trainer, first_state: bool = True):
        self.trainer, self.first_state = trainer, first_state
        self.steps: list[dict] = []
        self._targets = None
        self._sample, self._step = trainer.sample, trainer.step_from_samples
        trainer.sample = self.sample
        trainer.step_from_samples = self.step

    def sample(self, target_codes):
        self._targets = target_codes
        return self._sample(target_codes)

    def step(self, seq_codes, codes, labels, weights):
        loss = self._step(seq_codes, codes, labels, weights)
        rec = {"targets": self._targets, "seq": seq_codes, "codes": codes, "labels": labels,
               "weights": weights, "loss": loss}
        if self.first_state and not self.steps:
            rec["m1"] = self.first_moments(torch.cat([codes.reshape(-1), seq_codes.reshape(-1)]))
        self.steps.append(rec)
        return loss

    def first_moments(self, flat: torch.Tensor) -> dict:
        t = self.trainer
        codes = torch.unique(flat[flat >= 0])
        out = {"embedding": pmv_lanes(t, codes, 1).clone()}
        for k, name in TOWER_NAMES.items():
            out[k] = t.adam["mu"][name].detach().clone()
        return out

    def close(self) -> None:
        del self.trainer.sample, self.trainer.step_from_samples


class Driver:
    METRIC = "tdm_train_rows_per_s"
    PEAK_FLOPS = flops.F32_FLOP_PER_S  # the step computes in f32

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        from dismember_tpu_torch.ops import row_writer
        from dismember_tpu_torch.train.tdm import ResidentWindows, TDMTrainer

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.k2 = row_writer.launches
        tree = common.program_tree(cfg)
        self.trainer = TDMTrainer(
            tree=tree, model_type="din", embed_size=cfg["embed_size"],
            learning_rate=cfg["learning_rate"], total_batch_size=cfg["total_batch_size"],
            total_eval_batch_size=cfg["total_eval_batch_size"], seq_len=cfg["seq_len"],
            layer_neg_counts=cfg["layer_negative_counts"],
            sample_with_prob=cfg["sample_with_probability"],
            sample_tolerance=cfg["sample_tolerance"], start_sample_level=cfg["start_sample_level"],
            topk=cfg["topk_number"], beam_size=cfg["beam_size"], seed=seed, device=dev)
        t = self.trainer
        if not (t._sparse and t._pmv):
            raise RuntimeError("the cell's route is pmv; the trainer chose another")
        self.num_index = t.model.embedding.shape[0]
        common.load_into(t.model, common.weights(cfg, seed, self.num_index, dev))
        self.b, self.unit_rows = t.num_targets_per_batch, t.sampler.unit
        self.items = self._behaviours()
        # the train split's windows (TreeInit's): targets from the first
        # behaviour after min_seq_len on, behind the padding columns
        train_num = math.ceil((cfg["behaviours_per_user"] - cfg["min_seq_len"]) * cfg["split_ratio"])
        self.t_lo, self.t_hi = cfg["seq_len"], cfg["seq_len"] + train_num
        self.windows = ResidentWindows.from_items(tree, self.items, cfg["seq_len"],
                                                  self.t_lo, self.t_hi)
        self.call_steps = mix["call_chunks"] * mix["chunk"]
        cap = Capture(t)
        t.train_resident(self.windows, mix["check"]["steps"], chunk=mix["chunk"],
                         progress_interval=1 << 40)
        cap.close()
        self.steps = cap.steps
        with torch.no_grad():
            self.after = {"embedding": self._touched_p(), **{
                k: p.detach().clone() for k, p in tower_params(t.model).items()}}

    def _behaviours(self) -> np.ndarray:
        """[users, pad + behaviours] item ids, the first ``seq_len -
        min_seq_len`` columns padding (id 0)."""
        c = self.cfg
        g = inputs.generator(self.seed, inputs.TRAFFIC, self.dev)
        pop = inputs.Popularity(c["items"], self.mix["popularity"], self.dev)
        items = pop.draw(g, (c["users"], c["behaviours_per_user"]))
        pad = torch.zeros(c["users"], c["seq_len"] - c["min_seq_len"], dtype=items.dtype,
                          device=self.dev)
        return torch.cat([pad, items], 1).cpu().numpy()

    def _touched_codes(self) -> torch.Tensor:
        flat = torch.cat([torch.cat([s["codes"].reshape(-1), s["seq"].reshape(-1)])
                          for s in self.steps])
        return torch.unique(flat[flat >= 0])

    def _touched_p(self) -> torch.Tensor:
        return pmv_lanes(self.trainer, self._touched_codes(), 0).clone()

    def warmup(self) -> None:
        self._call(self.mix["chunk"], self.mix["chunk"])
        self.k2_start = self.k2["write_rows"]
        self.steps_run = 0

    def _call(self, steps: int, chunk: int) -> None:
        self.trainer.train_resident(self.windows, steps, chunk=chunk, progress_interval=1 << 40)

    def unit(self, spans: dict | None) -> int:
        self._call(self.call_steps, self.mix["chunk"])
        self.steps_run += self.call_steps
        return self.call_steps * self.b * self.unit_rows

    def drain(self) -> None:
        pass

    def layer_stretch(self, spans: dict) -> None:
        """A ``train_resident`` call of the window's chunk with the
        instance's ``sample`` timed, a synchronize before and after each."""
        t, n = self.trainer, self.mix["sample_steps"]
        real = t.sample

        def timed(target_codes):
            common.sync(self.dev)
            t0 = common.now()
            out = real(target_codes)
            common.sync(self.dev)
            spans.setdefault("tdm_train.sample", []).append(common.now() - t0)
            return out

        t.sample = timed
        try:
            self._call(n, min(n, self.mix["chunk"]))
        finally:
            del t.sample
        self.steps_run += n

    def profile_stretch(self) -> int:
        n = self.mix["profile_steps"]
        cap = Capture(self.trainer, first_state=False)
        with torch.profiler.record_function("tdm.train_resident"):
            self._call(n, n)
        cap.close()
        self.profiled = cap.steps
        self.steps_run += n
        return n

    def kernel_bounds(self) -> dict:
        """K2's least time over the profiled steps' commits."""
        e = self.cfg["embed_size"]
        return {"k2": sum(common.k2_commit_bound(
            torch.cat([st["codes"].reshape(-1), st["seq"].reshape(-1)]), e)
            for st in self.profiled)}

    def model_flops(self, win: dict) -> float:
        c = self.cfg
        per_step = 3 * flops.din_model_flops(self.b * self.unit_rows, c["seq_len"],
                                             c["embed_size"])
        return per_step * win["units"] * self.call_steps

    def release(self) -> None:
        self.k2_launches = self.k2["write_rows"] - self.k2_start
        self.trainer = None
        self.windows = None

    # -- the check ---------------------------------------------------------
    def check(self, limits: dict) -> dict:
        c, dev = self.cfg, self.dev
        tree = ref_tree.category_tree(*inputs.catalog(c))
        w = common.weights(c, self.seed, (1 << (tree.max_level + 1)) - 1, dev)
        numbers = {"draw_faults": self._draw_faults(tree),
                   "window_faults": self._window_faults(tree)}
        numbers.update(self.follow(w, self.steps, self.after))
        if dev.type == "cuda":  # K2 runs once a step on the card
            numbers["k2_launches_off"] = abs(self.k2_launches - self.steps_run)
        return {n: {"value": common.finite(v), "limit": limits[n]} for n, v in numbers.items()}

    def follow(self, w: dict, steps: list, after: dict) -> dict:
        """The training numbers of recorded steps and the state ``after``
        them against the reference follower."""
        f = ref_train.Follower(w["table"], common.tower(w), self._touched_codes(),
                               self.cfg["learning_rate"])
        ref_losses = [f.step(s["seq"], s["codes"], s["labels"], s["weights"]) for s in steps]
        return compare(steps, ref_losses, f, after, w)

    def calibrate(self) -> dict:
        """The control (TF32 operands where the step computes in float32)
        and the fault (half of the batch left out, the mean over the rest)
        put in the program's place, read as ``check`` reads the program (a
        state left unchanged reads 1 by this comparison and needs no run)."""
        w = common.weights(self.cfg, self.seed, self.num_index, self.dev)
        out = {}
        for name, kw in (("control", {"rnd": precision.tf32}),
                         ("fault_half_batch", {"keep": self.b // 2})):
            out[name] = self.follow(w, *self.stand_in(w, **kw))
        return out

    def stand_in(self, w: dict, **follower) -> tuple[list, dict]:
        """The recorded steps taken by a reference follower in the program's
        place (a control or a fault), recorded as the program's are."""
        f = ref_train.Follower(w["table"], common.tower(w), self._touched_codes(),
                               self.cfg["learning_rate"], **follower)
        steps = [dict(s, loss=f.step(s["seq"], s["codes"], s["labels"], s["weights"]))
                 for s in self.steps]
        steps[0] = dict(steps[0], m1=f.m1)
        return steps, f.state()

    def _draw_faults(self, tree) -> int:
        """Draws that break the sampler's guarantees: per level, the first
        slot is the target's ancestor with label 1; the negatives are
        distinct existing nodes of the level, none the positive, label 0,
        weight 1 (weight 0 only on an unfilled -1 slot)."""
        counts = [int(x) for x in self.cfg["layer_negative_counts"].split(",")]
        exists = torch.as_tensor(tree.exists, device=self.dev)
        faults = 0
        for s in self.steps:
            tc, codes = s["targets"], s["codes"]
            labels, weights = s["labels"], s["weights"]
            at = 0
            for level in range(self.cfg["start_sample_level"], tree.max_level + 1):
                n = counts[level]
                pos = ((tc + 1) >> (tree.max_level - level)) - 1
                faults += int((codes[:, at] != pos).sum() + (labels[:, at] != 1).sum()
                              + (weights[:, at] != 1).sum())
                neg = codes[:, at + 1: at + 1 + n]
                lo, hi = (1 << level) - 1, (1 << (level + 1)) - 1
                filled = neg >= 0
                ok = (neg >= lo) & (neg < hi) & exists[neg.clamp(0, len(exists) - 1)]
                ok &= neg != pos[:, None]
                dup = (neg[:, :, None] == neg[:, None, :]) & filled[:, :, None]
                dup &= torch.ones(n, n, dtype=torch.bool, device=neg.device).tril(-1)
                faults += int((filled & ~ok).sum() + dup.any(-1).sum() + (~filled).sum())
                faults += int((labels[:, at + 1: at + 1 + n] != 0).sum())
                faults += int((weights[:, at + 1: at + 1 + n] != filled.float()).sum())
                at += 1 + n
            faults += int(at != codes.shape[1])
        return faults

    def _window_faults(self, tree) -> int:
        """Rows of the followed steps that are no window of the dataset: the
        target at some user's position t in [t_lo, t_hi) with the L codes
        before it as the sequence, in the reference's codes."""
        lut = torch.full((self.cfg["items"] + 1,), ref_din.PAD, dtype=torch.int64)
        lut[torch.as_tensor(tree.item_ids)] = torch.as_tensor(tree.leaf_codes)
        m = lut.to(self.dev)[torch.as_tensor(self.items, device=self.dev)]
        l = self.cfg["seq_len"]
        faults = 0
        for s in self.steps:
            for tc, sc in zip(s["targets"].tolist(), s["seq"]):
                u, t = (m[:, self.t_lo:self.t_hi] == tc).nonzero(as_tuple=True)
                t = t + self.t_lo
                cols = t[:, None] + torch.arange(-l, 0, device=self.dev)
                found = (m[u[:, None], cols] == sc[None, :]).all(-1).any()
                faults += int(not bool(found))
        return faults


def compare(steps: list, ref_losses: list, f, after: dict, w: dict) -> dict:
    """The training numbers: each step's loss, the first gradient as the
    optimizer holds it after one step (first moment / (1 - b1)), and each
    leaf's change after the steps, against the reference follower ``f``.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the gradient and the change."""
    loss = max(abs(float(s["loss"]) - r) / max(abs(r), 1e-30) for s, r in zip(steps, ref_losses))
    m1 = steps[0]["m1"]
    g_prog = {k: float(v.norm()) / (1 - ref_train.B1) for k, v in m1.items()}
    g_ref = f.first_grad
    med = float(np.median(list(g_ref.values())))
    skip = {k for k, v in g_ref.items() if v < 1e-3 * med}
    d_prog = {"embedding": float((after["embedding"] - f.rows0).norm())}
    for k in ref_train.TOWERS:
        d_prog[k] = float((after[k] - w[k]).norm())
    d_ref = f.change()
    return {"loss_gap": loss, "grad_gap": leaf_gap(g_prog, g_ref, skip),
            "change_gap": leaf_gap(d_prog, d_ref, skip)}


def leaf_gap(prog: dict, ref: dict, skip: set) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    keep = [k for k in ref if k not in skip]
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)
