"""TDM serving in a closed loop: one client sends a batch of behaviour
windows to ``TDMServing.recommend_batch`` and sends the next when the top-k
lists are back on the host.

Set-up builds the category-sorted tree of the catalog, the program's DIN
around the benchmark's weights, the serving facade, and a pool of traffic
batches; the warm-up call builds the pair table.  With spans on, a unit runs
``recommend_batch``'s steps one by one (``TDMServing._codes`` and
``_beam_fn``, which the facade has no public split of) so that the beam
loop, ended by a synchronize, and the download with the host filter are
timed apart.

The check takes a sample, drawn from the seed, of the windows served in the
window and judges each served list with the plain reference
(``reference/beam.py``): the reference's own tree, its f32 DIN, its beam.
"""

from __future__ import annotations

import numpy as np
import torch

import flops
import inputs
from drivers import common
from reference import beam as ref_beam
from reference import precision
from reference import tree as ref_tree


class LevelCapture:
    """Records the packed beam's levels for some rows of each call: the
    frontier, the scores and the kept parents that
    ``retrieval/packed_beam.py`` hands to ``select_top`` at every level
    (the module's global is wrapped), and the last level's scores and item
    ids (the facade's beam function is wrapped on the instance).  The
    program's files are untouched; ``close`` puts both back."""

    def __init__(self, serv):
        from dismember_tpu_torch.retrieval import packed_beam

        self.module, self.serv = packed_beam, serv
        self.rows: torch.Tensor | None = None
        self.calls: list[list[dict]] = []
        self._select, self._beam_fn = packed_beam.select_top, serv._beam_fn
        packed_beam.select_top = self.select_top
        serv._beam_fn = self.beam_fn

    def select_top(self, frontier, scores, beam):
        top, alive = self._select(frontier, scores, beam)
        r = self.rows
        self.calls[-1].append({"frontier": frontier[r].clone(), "scores": scores[r].clone(),
                               "top": top[r].clone(), "alive": alive[r].clone()})
        return top, alive

    def beam_fn(self, cn: int):
        fn = self._beam_fn(cn)

        def run(params, seq_codes):
            self.calls.append([])
            ids, scores = fn(params, seq_codes)
            last = self.calls[-1][-1]
            self.calls[-1].append({
                "frontier": torch.cat([2 * last["top"] + 1, 2 * last["top"] + 2], dim=1),
                "scores": scores[self.rows].clone(), "ids": ids[self.rows].clone()})
            return ids, scores

        return run

    def close(self) -> None:
        self.module.select_top = self._select
        del self.serv._beam_fn


class Driver:
    METRIC = "serve_qps"
    PEAK_FLOPS = flops.BF16_MMA_FLOP_PER_S  # K3's products are bf16

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        from dismember_tpu_torch.models.din import DIN
        from dismember_tpu_torch.ops import packed_level_kernel
        from dismember_tpu_torch.serving import TDMServing
        from dismember_tpu_torch.train.tdm import packed_fns, serving_fns

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.k3 = packed_level_kernel
        tree = common.program_tree(cfg)
        self.levels = tree.max_level - int(np.floor(np.log2(cfg["beam_size"])))
        num_index = (1 << (tree.max_level + 1)) - 1
        model = common.din_module(common.weights(cfg, seed, num_index, dev), dev)
        pre, app = serving_fns("din")
        _, app_emb = packed_fns("din")
        self.serv = TDMServing(model, DIN.forward, tree, precompute=pre, apply=app,
                               apply_emb=app_emb, model_type="din", topk=cfg["topk_number"],
                               candidate_num=cfg["beam_size"])
        self.batch = cfg["total_eval_batch_size"]
        self.pool = self._traffic()
        self.consumed = [[row[row > 0] for row in b] for b in self.pool]
        rng = np.random.default_rng(inputs.stream_seed(seed, inputs.SAMPLE))
        per = mix["check"]["requests"] // len(self.pool)
        self.sample_rows = [np.sort(rng.choice(self.batch, per, replace=False))
                            for _ in self.pool]
        n_warm = mix["warmup_batches"]
        per = mix["check"]["level_requests"] // n_warm
        self.level_rows = [np.sort(rng.choice(self.batch, per, replace=False))
                           for _ in range(n_warm)]
        self.served: list = [None] * len(self.pool)  # the first served lists of sampled rows
        self.changed = 0  # sampled lists that differed on a later serving
        self.next = 0
        self.units = 0

    def _traffic(self) -> np.ndarray:
        m, c = self.mix, self.cfg
        g = inputs.generator(self.seed, inputs.TRAFFIC, self.dev)
        pop = inputs.Popularity(c["items"], m["popularity"], self.dev)
        seqs = inputs.windows(pop, g, m["pool_batches"] * self.batch, c["seq_len"],
                              c["min_seq_len"], m["short_share"])
        return seqs.cpu().numpy().reshape(m["pool_batches"], self.batch, c["seq_len"])

    def warmup(self) -> None:
        """The warm-up batches (the first builds the pair table), with the
        beam's levels recorded for the check's level sample of each."""
        cap = LevelCapture(self.serv)
        try:
            for j in range(self.mix["warmup_batches"]):
                cap.rows = torch.as_tensor(self.level_rows[j], device=self.dev)
                self.serv.recommend_batch(self.pool[j], consumed=self.consumed[j])
        finally:
            cap.close()
        self.level_calls = cap.calls
        self.k3_start = self.k3.launches

    def unit(self, spans: dict | None) -> int:
        j = self.next % len(self.pool)
        self.next += 1
        seqs, cons = self.pool[j], self.consumed[j]
        if spans is None:
            lists = self.serv.recommend_batch(seqs, consumed=cons)
        else:
            lists = self._split(seqs, cons, spans)
        kept = [lists[r] for r in self.sample_rows[j]]
        if self.served[j] is None:
            self.served[j] = kept
        else:
            self.changed += sum(not np.array_equal(a, b) for a, b in zip(kept, self.served[j]))
        self.units += 1
        return len(seqs)

    def _split(self, seqs, cons, spans: dict) -> list:
        from dismember_tpu_torch.retrieval.tree_beam import filter_topk

        s = self.serv
        t0 = common.now()
        with torch.profiler.record_function("serve.beam"):
            ids, scores = s._beam_fn(s.candidate_num)(s.params, s._codes(seqs))
            common.sync(self.dev)
        t1 = common.now()
        with torch.profiler.record_function("serve.filter"):
            lists = filter_topk(ids.cpu().numpy(), scores.cpu().numpy(), s.topk, cons)
        t2 = common.now()
        for name, v in (("beam", t1 - t0), ("serve.filter", t2 - t1), ("serve.batch", t2 - t0)):
            spans.setdefault(name, []).append(v)
        return lists

    def drain(self) -> None:
        pass

    def layer_stretch(self, spans: dict) -> None:
        pass

    def profile_stretch(self) -> int:
        n = self.mix["profile_batches"]
        for _ in range(n):
            self.unit({})
        return n

    def kernel_bounds(self) -> dict:
        """Least seconds of the kernels the profiled stretch launches: K3
        once a level of every batch."""
        c = self.cfg
        k3, _ = flops.k3_bound(self.batch, c["beam_size"], c["seq_len"], c["embed_size"], 4)
        return {"k3": k3 * self.levels * self.mix["profile_batches"]}

    def model_flops(self, win: dict) -> float:
        c = self.cfg
        cands = self.batch * 2 * c["beam_size"] * self.levels
        return flops.din_model_flops(cands, c["seq_len"], c["embed_size"]) * win["units"]

    def release(self) -> None:
        self.k3_launches = self.k3.launches - self.k3_start
        del self.serv
        self.serv = None

    def sampled(self) -> tuple[np.ndarray, list]:
        """(windows [N, L], their served lists) of the check's sample."""
        rows = [(j, self.sample_rows[j], lists) for j, lists in enumerate(self.served)
                if lists is not None]
        return (np.concatenate([self.pool[j][r] for j, r, _ in rows]),
                [x for _, _, lists in rows for x in lists])

    def level_sample(self) -> np.ndarray:
        """The windows [N, L] whose beam levels the warm-up recorded."""
        return np.concatenate([self.pool[j][r] for j, r in enumerate(self.level_rows)])

    def check(self, limits: dict) -> dict:
        numbers = judge_served(self.cfg, self.seed, *self.sampled(), self.dev)
        numbers.update(judge_levels(self.cfg, self.seed, self.level_sample(), self.level_calls,
                                    self.dev))
        numbers["served_changed"] = self.changed
        if self.dev.type == "cuda":  # the CPU scores through K3's plain version
            numbers["k3_launches_off"] = abs(self.k3_launches - self.levels * self.units)
        return {n: {"value": common.finite(v), "limit": limits[n]} for n, v in numbers.items()}

    def calibrate(self) -> dict:
        """The control (the reference's own beam on float8 e4m3 operands
        where K3 takes bf16) and the fault (an answer altered where it is
        produced: the first item of every sampled list replaced by another
        catalog item), judged as ``check`` judges the served lists."""
        c = self.cfg
        seqs, served = self.sampled()
        rng = np.random.default_rng(inputs.stream_seed(self.seed, 99))
        altered = [np.concatenate([[rng.integers(1, c["items"] + 1)], s[1:]]) for s in served]
        control = judge_served(c, self.seed, seqs, served, self.dev, stand_in=precision.fp8)
        control.update(judge_levels(c, self.seed, self.level_sample(), None, self.dev,
                                    stand_in=precision.fp8))
        return {"control": control,
                "fault_altered_answer": judge_served(c, self.seed, seqs, altered, self.dev)}


def judge_served(cfg: dict, seed: int, seqs: np.ndarray, served: list, dev,
                 stand_in=None) -> dict:
    """The serving numbers of lists ``served`` for windows ``seqs`` against
    the reference (``reference/beam.py``) on the seed's weights.  With a
    rounding ``stand_in`` the lists judged are the reference's own beam
    search at that rounding (a control put in the program's place)."""
    tree = ref_tree.category_tree(*inputs.catalog(cfg))
    w = common.weights(cfg, seed, (1 << (tree.max_level + 1)) - 1, dev)
    k, beam = cfg["topk_number"], cfg["beam_size"]
    seq_codes = torch.as_tensor(tree.codes(seqs), device=dev)
    cons = torch.where(seq_codes >= 0, seq_codes, -1)
    exists = torch.as_tensor(tree.exists, device=dev)
    scorer = ref_beam.Scorer(w["table"], common.tower(w), seq_codes)
    ref_codes, ref_scores = ref_beam.beam_search(scorer, exists, tree.max_level, beam, k, cons)
    if stand_in is not None:
        alt = ref_beam.Scorer(w["table"], common.tower(w), seq_codes, stand_in)
        got, _ = ref_beam.beam_search(alt, exists, tree.max_level, beam, k, cons)
    else:
        got = torch.as_tensor(ref_beam.codes_of(tree, served, k), device=dev)
    return ref_beam.judge(scorer, exists, got, cons, ref_codes, ref_scores)


def judge_levels(cfg: dict, seed: int, seqs: np.ndarray, calls: list | None, dev,
                 stand_in=None) -> dict:
    """The numbers of the beam's recorded levels (``calls``: one list of
    levels a recorded call, rows of ``seqs`` in order) against the
    reference, on the seed's weights.  With a rounding ``stand_in`` the
    levels judged are the reference's own beam search at that rounding."""
    tree = ref_tree.category_tree(*inputs.catalog(cfg))
    w = common.weights(cfg, seed, (1 << (tree.max_level + 1)) - 1, dev)
    beam = cfg["beam_size"]
    seq_codes = torch.as_tensor(tree.codes(seqs), device=dev)
    exists = torch.as_tensor(tree.exists, device=dev)
    scorer = ref_beam.Scorer(w["table"], common.tower(w), seq_codes)
    if stand_in is not None:
        levels: list = []
        alt = ref_beam.Scorer(w["table"], common.tower(w), seq_codes, stand_in)
        none = torch.full((len(seqs), 1), -1, dtype=torch.long, device=dev)
        ref_beam.beam_search(alt, exists, tree.max_level, beam, cfg["topk_number"], none,
                             levels)
    else:
        levels = [{k: torch.cat([c[i][k] for c in calls]) for k in calls[0][i]}
                  for i in range(len(calls[0]))]
        ids = levels[-1].pop("ids").cpu().numpy()
        levels[-1]["id_codes"] = torch.as_tensor(tree.codes(ids), device=dev)
    return ref_beam.judge_levels(scorer, exists, levels, beam)
