"""OTM training at scale: batches of ``OTMTrainer``'s one-batch step (the
frozen trajectory and pseudo targets through K1, then a level step a level,
K2 committing each in the pmv route), their losses read 8 batches late as
``OTMTrainer.train`` reads them.

``OTMTrainer.train`` runs whole epochs and an evaluation at each epoch's
end, so the window calls the batch step it runs, ``_train_batch``.  Set-up
draws the item-to-leaf mapping (random leaves) and a pool of training
windows from the seed, builds the trainer with the benchmark's weights
copied in (``_adopt_mirrors`` puts them into the packed state, as
``train`` does on entry), and drives the first batches that the check
follows, recording the frozen part, each level step and the optimizer's
state after the first level step by wrapping the instance's methods.

The check (``reference/otm.py``, ``reference/train.py``) follows those
batches from the seed's weights in plain f32: each batch's frozen part is
held level by level to what the reference makes of the program's own
previous level, and the level steps' losses, the first gradient and each
leaf's change are compared.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

import flops
import inputs
from drivers import common
from drivers.tdm_train import TOWER_NAMES, compare, pmv_lanes, tower_params
from reference import otm as ref_otm
from reference import precision
from reference import train as ref_train


class Driver:
    METRIC = "otm_train_samples_per_s"
    PEAK_FLOPS = flops.F32_FLOP_PER_S  # K1 and the steps compute in f32

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        from dismember_tpu_torch.ops import din_kernel, row_writer
        from dismember_tpu_torch.train.otm import OTMTrainer

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.k1, self.k2 = din_kernel, row_writer.launches
        data = self._data()
        t = self.trainer = OTMTrainer(
            data, model_type="din", embed_size=cfg["embed_size"],
            learning_rate=cfg["learning_rate"], total_train_batch_size=cfg["train_batch_size"],
            total_eval_batch_size=cfg["eval_batch_size"], beam_size=cfg["beam_size"],
            topk=cfg["topk_number"], seq_len=cfg["seq_len"], target_mode=cfg["target_mode"],
            seed=seed, device=dev)
        if not (t._sparse and t._pmv):
            raise RuntimeError("the cell's route is pmv; the trainer chose another")
        common.load_into(t.model, common.weights(cfg, seed, t.model.embedding.shape[0], dev))
        t._adopt_mirrors()
        self.b = t.train_batch_size
        n = len(data.train_seqs) // self.b
        self.seqs = torch.as_tensor(data.train_seqs[: n * self.b], device=dev).view(n, self.b, -1)
        self.targets = torch.as_tensor(data.train_labels[: n * self.b], device=dev).view(
            n, self.b, -1)
        self.inflight: collections.deque = collections.deque()
        self.next = 0
        self.batches = self._capture(mix["check"]["batches"])
        with torch.no_grad():
            codes = torch.unique(torch.cat([ref_otm.frozen_codes(r) for r in self.batches]))
            codes = codes[codes >= 0]
            self.kept_codes = codes
            self.after = {"embedding": pmv_lanes(t, codes, 0).clone(), **{
                k: p.detach().clone() for k, p in tower_params(t.model).items()}}

    def _data(self):
        """The trainer's data: the mapping of items to random leaves of the
        complete tree and a pool of training windows in leaf codes."""
        from dismember_tpu_torch.data.otm_dataset import OTMData, all_nodes_bitmap, upper_log2

        c, m, dev = self.cfg, self.mix, self.dev
        n_items, level = c["items"], upper_log2(c["items"])
        g = inputs.generator(self.seed, inputs.MAPPING, dev)
        leaves = torch.randperm(1 << level, generator=g, device=dev)[:n_items].sort().values
        leaves += (1 << level) - 1
        order = torch.randperm(n_items, generator=g, device=dev)
        code_of = torch.full((n_items + 1,), -1, dtype=torch.long, device=dev)
        code_of[order + 1] = leaves
        g = inputs.generator(self.seed, inputs.TRAFFIC, dev)
        pop = inputs.Popularity(n_items, m["popularity"], dev)
        n = m["pool_batches"] * max(1, c["train_batch_size"] // (2 * c["beam_size"]))
        seqs = inputs.windows(pop, g, n, c["seq_len"], c["min_seq_len"], m["short_share"])
        labels = pop.draw(g, (n, c["label_num"]))
        empty = np.zeros((0, c["seq_len"]), np.int64)
        return OTMData(
            item_to_code={}, code_to_item={}, leaf_level=level, num_items=n_items,
            all_nodes=all_nodes_bitmap(leaves.cpu().numpy(), level),
            train_seqs=code_of[seqs].cpu().numpy(), train_labels=code_of[labels].cpu().numpy(),
            train_users=np.zeros(n, np.int64), eval_seqs=empty,
            eval_labels=np.zeros((0, c["label_num"]), np.int64),
            eval_users=np.zeros(0, np.int64), user_consumed={}, label_num=c["label_num"])

    def _capture(self, n: int) -> list:
        """Run ``n`` batches with the frozen part and every level step
        recorded."""
        t = self.trainer
        frozen, step = t._targets_and_trajectory, t.step_from_samples
        out: list = []

        def rec_frozen(seqs, targets):
            t_ids, t_labels, nodes = frozen(seqs, targets)
            out.append({"seq": seqs, "targets": targets, "t_ids": t_ids, "t_labels": t_labels,
                        "nodes": nodes, "levels": []})
            return t_ids, t_labels, nodes

        def rec_step(seq_codes, codes, labels, weights):
            loss = step(seq_codes, codes, labels, weights)
            lv = {"codes": codes, "labels": labels, "weights": weights, "loss": loss}
            if len(out) == 1 and not out[0]["levels"]:
                flat = torch.cat([codes.reshape(-1), seq_codes.reshape(-1)])
                u = torch.unique(flat[flat >= 0])
                lv["m1"] = {"embedding": pmv_lanes(t, u, 1).clone(), **{
                    k: t.adam["mu"][name].detach().clone() for k, name in TOWER_NAMES.items()}}
            out[-1]["levels"].append(lv)
            return loss

        t._targets_and_trajectory, t.step_from_samples = rec_frozen, rec_step
        try:
            for _ in range(n):
                self._batch()
            self.drain()
        finally:
            del t._targets_and_trajectory, t.step_from_samples
        return out

    def _batch(self) -> None:
        j = self.next % len(self.seqs)
        self.next += 1
        self.inflight.append(self.trainer._train_batch(self.seqs[j], self.targets[j]))
        if len(self.inflight) >= 8:
            self.inflight.popleft().cpu()

    def warmup(self) -> None:
        for _ in range(self.mix["warmup_batches"]):
            self._batch()
        self.drain()
        self.k1_start, self.k2_start = self.k1.launches, self.k2["write_rows"]
        self.batches_run = 0

    def unit(self, spans: dict | None) -> int:
        self._batch()
        self.batches_run += 1
        return self.b

    def drain(self) -> None:
        while self.inflight:
            self.inflight.popleft().cpu()

    def layer_stretch(self, spans: dict) -> None:
        pass

    def profile_stretch(self) -> int:
        n = self.mix["profile_batches"]
        self.profiled = self._capture(n)
        self.batches_run += n
        return n

    def kernel_bounds(self) -> dict:
        """K1's least time a batch at its shapes (the trajectory's [B, 2 *
        beam] levels, the pseudo targets' [B, J] pairs), and K2's over the
        profiled level steps' distinct rows."""
        c, t = self.cfg, self.trainer
        l, e, j = c["seq_len"], c["embed_size"], c["label_num"]
        k1 = (t.n_levels * flops.k1_bound(self.b, 2 * c["beam_size"], l, e)[0]
              + 2 * (t.n_levels - 1) * flops.k1_bound(self.b, j, l, e)[0])
        k2 = sum(common.k2_commit_bound(torch.cat([lv["codes"].reshape(-1),
                                                   rec["seq"].reshape(-1)]), e)
                 for rec in self.profiled for lv in rec["levels"])
        return {"k1": k1 * len(self.profiled), "k2": k2}

    def model_flops(self, win: dict) -> float:
        """A batch: the frozen trajectory (n_levels levels of 2 * beam
        candidates) and pseudo targets (2 (n_levels - 1) sets of J) forward,
        and every level step's 2 * beam candidates forward and backward."""
        c, t = self.cfg, self.trainer
        l, e = c["seq_len"], c["embed_size"]
        frozen = self.b * (t.n_levels * 2 * c["beam_size"]
                           + 2 * (t.n_levels - 1) * c["label_num"])
        steps = 3 * self.b * t.n_levels * 2 * c["beam_size"]
        return flops.din_model_flops(frozen + steps, l, e) * win["units"]

    def release(self) -> None:
        t = self.trainer
        self.n_levels, self.start_level = t.n_levels, t.start_level
        self.k1_launches = self.k1.launches - self.k1_start
        self.k2_launches = self.k2["write_rows"] - self.k2_start
        self.trainer = None

    def check(self, limits: dict) -> dict:
        c, dev = self.cfg, self.dev
        w = common.weights(c, self.seed, (1 << (self.n_levels + self.start_level + 1)) - 1, dev)
        numbers = judge(self.batches, w, self.kept_codes, c["learning_rate"], self.start_level,
                        c["beam_size"], self.after)
        if dev.type == "cuda":
            per = 1 + (self.n_levels - 1) + 2 * (self.n_levels - 1)
            numbers["k1_launches_off"] = abs(self.k1_launches - per * self.batches_run)
            numbers["k2_launches_off"] = abs(self.k2_launches - self.n_levels * self.batches_run)
        return {n: {"value": common.finite(v), "limit": limits[n]} for n, v in numbers.items()}

    def calibrate(self) -> dict:
        """The control (TF32 operands where the steps compute in float32)
        and the fault (half of the batch left out, the mean over the rest):
        the reference's own batches (``reference/otm.run_batch``) in the
        program's place, judged as ``check`` judges the program's."""
        c, dev = self.cfg, self.dev
        num_index = (1 << (self.n_levels + self.start_level + 1)) - 1
        w = common.weights(c, self.seed, num_index, dev)
        every = torch.arange(num_index, device=dev)
        out = {}
        for name, kw in (("control", {"rnd": precision.tf32}),
                         ("fault_half_batch", {"keep": self.b // 2})):
            f = ref_train.Follower(w["table"], common.tower(w), every, c["learning_rate"], **kw)
            recs = [ref_otm.run_batch(f, r["seq"], r["targets"], self.n_levels,
                                      self.start_level, c["beam_size"]) for r in self.batches]
            recs[0]["levels"][0]["m1"] = f.m1
            codes = torch.unique(torch.cat([ref_otm.frozen_codes(r) for r in recs]))
            codes = codes[codes >= 0]
            after = {"embedding": f.rows_of(codes), **{k: f.t[k] for k in ref_train.TOWERS}}
            out[name] = judge(recs, w, codes, c["learning_rate"], self.start_level,
                              c["beam_size"], after)
            del f
        return out


def judge(batches: list, w: dict, codes: torch.Tensor, lr: float, start_level: int, beam: int,
          after: dict, **follower) -> dict:
    """The OTM numbers of recorded batches against the reference from the
    weights ``w``: each batch's frozen part judged before its level steps
    are followed."""
    f = ref_train.Follower(w["table"], common.tower(w), codes, lr, **follower)
    worst = {"traj_gap": 0.0, "pseudo_gap": 0.0, "structure_faults": 0}
    steps, ref_losses = [], []
    for rec in batches:
        got = ref_otm.judge_batch(f, rec, start_level, beam)
        worst = {k: max(worst[k], got[k]) if k != "structure_faults" else worst[k] + got[k]
                 for k in worst}
        for lv in rec["levels"]:
            ref_losses.append(f.step(rec["seq"], lv["codes"], lv["labels"], lv["weights"]))
            steps.append(lv)
    return {**worst, **compare(steps, ref_losses, f, after, w)}
