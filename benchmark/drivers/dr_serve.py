"""Deep Retrieval serving in a closed loop: one client sends a batch of
behaviour windows to ``DRServing.recommend_batch_device``, each window its
own consumed list, and sends the next when the top-k ids are on the host.

Set-up draws the catalog's path mapping (J x D uniform nodes an item from
the seed's MAPPING stream; the same array is given to the program and to
the reference), builds the program's ``DRTrainer`` around the
benchmark's weights, the serving facade and a pool of traffic batches.  The
warm-up's first call builds the path map and the block table; the warm-up
runs with the port's recording on, for its ``dr_serve.truncated_paths``
counter, and records the beam's paths of the check's path sample (the
module's ``path_beam_search`` wrapped for the warm-up only).  With spans on,
``layer_stretch`` serves ``layer_batches`` batches with the port's
recording on and hands its ``snapshot()`` to the readers as
``spans["program"]``.

The check judges, with the plain reference (``reference/dr.py``: its own
path map, beam and rerank in f32 on the seed's weights), a sample drawn from
the seed of the lists served in the window, and the warm-up's path sample:
its served lists (the window's for the same rows must equal them) and its
beams.
"""

from __future__ import annotations

import numpy as np
import torch

import flops
import flops_dr
import inputs
from drivers import common
from reference import dr as ref_dr
from reference import precision


def dr_weights(cfg: dict, seed: int, dev) -> tuple[dict, dict]:
    """(layer, rerank) parameters, float32 on ``dev``, drawn from the seed's
    WEIGHTS stream at the configuration's standard deviations, keyed as the
    program's checkpoints."""
    s = cfg["assumed"]["weights"]
    n, k, depth = cfg["items"], cfg["num_node"], cfg["num_layer"]
    l, e = cfg["seq_len"], cfg["embed_size"]
    g = inputs.generator(seed, inputs.WEIGHTS, dev)

    def draw(std, *shape):
        return torch.randn(shape, generator=g, device=dev).mul_(std)

    layer = {"embedding": draw(s["embedding_std"], n + k * (depth - 1), e),
             "heads": [{"weight": draw(s["head_std"], k, (l + d) * e),
                        "bias": draw(s["bias_std"], k)} for d in range(depth)]}
    rerank = {"embedding": draw(s["embedding_std"], n, e),
              "linear": {"weight": draw(s["linear_std"], e, l * e),
                         "bias": draw(s["bias_std"], e)},
              "softmax_w": draw(s["softmax_std"], n, e), "softmax_b": draw(s["bias_std"], n)}
    return layer, rerank


def item_paths(cfg: dict, seed: int) -> np.ndarray:
    """[items, J, D] int32 node indices, uniform over the K nodes, from the
    seed's MAPPING stream (``initialize_mapping``)."""
    rng = np.random.default_rng(inputs.stream_seed(seed, inputs.MAPPING))
    shape = (cfg["items"], cfg["num_path_per_item"], cfg["num_layer"])
    return rng.integers(0, cfg["num_node"], shape).astype(np.int32)


class PathCapture:
    """Records the paths of some rows of each beam the serving closures
    search: ``retrieval/dr_serve.py``'s global ``path_beam_search`` wrapped.
    The program's files are untouched; ``close`` puts it back."""

    def __init__(self):
        from dismember_tpu_torch.retrieval import dr_serve

        self.module, self.real = dr_serve, dr_serve.path_beam_search
        self.rows: torch.Tensor | None = None
        self.paths: list = []
        dr_serve.path_beam_search = self.search

    def search(self, *args, **kwargs):
        paths, probs = self.real(*args, **kwargs)
        self.paths.append(paths[self.rows].clone())
        return paths, probs

    def close(self) -> None:
        self.module.path_beam_search = self.real


class Driver:
    METRIC = "serve_qps"
    PEAK_FLOPS = flops.F32_FLOP_PER_S  # the beam's and the rerank's products sum in f32

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        from dismember_tpu_torch.data.dr_dataset import DRData
        from dismember_tpu_torch.index.paths import PathIndex
        from dismember_tpu_torch.serving import DRServing
        from dismember_tpu_torch.train.dr import DRTrainer

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        c = cfg
        n, l = c["items"], c["seq_len"]
        self.item_paths = item_paths(c, seed)
        index = PathIndex(item_paths=self.item_paths, num_nodes=c["num_node"])
        empty = np.empty((0, l), np.int64)
        data = DRData(item_to_id={}, id_to_item={}, num_items=n, train_seqs=empty,
                      train_targets=np.empty(0, np.int64), eval_seqs=empty,
                      eval_labels=np.empty((0, 1), np.int64), eval_users=np.empty(0, np.int64),
                      user_consumed={})
        trainer = DRTrainer(data, num_layers=c["num_layer"], num_nodes=c["num_node"],
                            num_paths_per_item=c["num_path_per_item"],
                            embed_size=c["embed_size"], learning_rate=c["learning_rate"],
                            train_batch_size=c["train_batch_size"],
                            eval_batch_size=c["eval_batch_size"], num_sampled=c["num_sampled"],
                            topk=c["topk_number"], beam_size=c["beam_size"], seq_len=l,
                            seed=seed, path_index=index, device=dev)
        trainer.load_params(*dr_weights(c, seed, dev))
        self.serv = DRServing(trainer)
        self.k = c["topk_number"]
        self.batch = c["eval_batch_size"]
        self.pool = self._traffic()
        rng = np.random.default_rng(inputs.stream_seed(seed, inputs.SAMPLE))
        per = mix["check"]["requests"] // len(self.pool)
        self.sample_rows = [np.sort(rng.choice(self.batch, per, replace=False))
                            for _ in self.pool]
        n_warm = mix["warmup_batches"]
        per = mix["check"]["path_requests"] // n_warm
        self.path_rows = [np.sort(rng.choice(self.batch, per, replace=False))
                          for _ in range(n_warm)]
        self.served: list = [None] * len(self.pool)  # the first served lists of sampled rows
        self.changed = 0  # sampled lists that differed on a later serving
        self.next = 0
        self.units = 0

    def _traffic(self) -> np.ndarray:
        """[pool, batch, L] windows of dense ids (-1 pads)."""
        m, c = self.mix, self.cfg
        g = inputs.generator(self.seed, inputs.TRAFFIC, self.dev)
        pop = inputs.Popularity(c["items"], m["popularity"], self.dev)
        seqs = inputs.windows(pop, g, m["pool_batches"] * self.batch, c["seq_len"],
                              c["min_seq_len"], m["short_share"]) - 1
        return seqs.cpu().numpy().reshape(m["pool_batches"], self.batch, c["seq_len"])

    def _serve(self, j: int) -> np.ndarray:
        return self.serv.recommend_batch_device(self.pool[j], self.k, consumed=self.pool[j])

    def warmup(self) -> None:
        """The warm-up batches (the first builds the path map and the block
        table), the port's recording on for its counters, the beam's paths
        recorded for the check's path sample."""
        from dismember_tpu_torch.core import profiling

        cap = PathCapture()
        profiling.reset()
        was = profiling.enable(True)
        self.warm_lists = []
        try:
            for j, rows in enumerate(self.path_rows):
                cap.rows = torch.as_tensor(rows, device=self.dev)
                self.warm_lists.append(self._serve(j)[rows])
            self.counters = profiling.snapshot()["counters"]
        finally:
            profiling.enable(was)
            profiling.reset()
            cap.close()
        self.warm_paths = cap.paths
        self.warm_seen = [False] * len(self.path_rows)

    def unit(self, spans: dict | None) -> int:
        j = self.next % len(self.pool)
        self.next += 1
        lists = self._serve(j)
        kept = lists[self.sample_rows[j]]
        if self.served[j] is None:
            self.served[j] = kept
        else:
            self.changed += int((kept != self.served[j]).any(1).sum())
        if j < len(self.path_rows) and not self.warm_seen[j]:
            self.changed += int((lists[self.path_rows[j]] != self.warm_lists[j]).any(1).sum())
            self.warm_seen[j] = True
        self.units += 1
        return len(self.pool[j])

    def drain(self) -> None:
        pass

    def layer_stretch(self, spans: dict) -> None:
        """``layer_batches`` units with the port's spans and counters on."""
        from dismember_tpu_torch.core import profiling

        profiling.reset()
        was = profiling.enable(True)
        try:
            for _ in range(self.mix["layer_batches"]):
                self.unit(None)
            spans["program"] = profiling.snapshot()
        finally:
            profiling.enable(was)
            profiling.reset()

    def profile_stretch(self) -> int:
        n = self.mix["profile_batches"]
        for _ in range(n):
            self.unit(None)
        return n

    def kernel_bounds(self) -> dict:
        """The least seconds of the profiled batches (``flops_dr``)."""
        s = flops_dr.shape(self.cfg)
        bound = flops_dr.serve_bound(s, self.batch, self.cfg["seq_len"])
        return {"dr_serve": bound * self.mix["profile_batches"]}

    def model_flops(self, win: dict) -> float:
        return flops_dr.model_flops(flops_dr.shape(self.cfg)) * self.batch * win["units"]

    def release(self) -> None:
        self.serv = None

    # -- the check ---------------------------------------------------------
    def _samples(self) -> tuple[np.ndarray, np.ndarray]:
        """(windows [N, L], their lists served in the window [N, k])."""
        kept = [(j, lists) for j, lists in enumerate(self.served) if lists is not None]
        return (np.concatenate([self.pool[j][self.sample_rows[j]] for j, _ in kept]),
                np.concatenate([lists for _, lists in kept]))

    def _path_sample(self) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
        """(windows [N, L], their warm-up lists [N, k], beams [N, W, D])."""
        return (np.concatenate([self.pool[j][r] for j, r in enumerate(self.path_rows)]),
                np.concatenate(self.warm_lists), torch.cat(self.warm_paths))

    def check(self, limits: dict) -> dict:
        judge = Judge(self.cfg, self.seed, self.item_paths, self.dev)
        numbers = judge.numbers(self._samples(), self._path_sample())
        numbers["served_changed"] = self.changed
        # the reference caps no path; no count means the program did not say
        numbers["truncated_paths"] = self.counters.get("dr_serve.truncated_paths", 1)
        return {n: {"value": common.finite(v), "limit": limits[n]} for n, v in numbers.items()}

    def calibrate(self) -> dict:
        """The control (the reference's own serving on float8 e4m3 operands
        where the block route takes bf16) and the faults (an answer altered
        where it is produced: the first item of every sampled list replaced
        by another catalog item; a beam with one path dropped: the last of
        each recorded beam replaced by its first), judged as ``check``
        judges the program's."""
        judge = Judge(self.cfg, self.seed, self.item_paths, self.dev)
        samples, paths = self._samples(), self._path_sample()
        rng = np.random.default_rng(inputs.stream_seed(self.seed, 99))

        def altered(lists):
            out = lists.copy()
            out[:, 0] = rng.integers(0, self.cfg["items"], len(out))
            return out

        dropped = paths[2].clone()
        dropped[:, -1] = dropped[:, 0]
        control = judge.numbers(judge.stand_in(samples[0], precision.fp8)[:2],
                                judge.stand_in(paths[0], precision.fp8))
        return {"control": control,
                "fault_altered_answer": judge.numbers((samples[0], altered(samples[1])),
                                                      (paths[0], altered(paths[1]), paths[2])),
                "fault_dropped_path": judge.numbers(samples, (paths[0], paths[1], dropped))}


class Judge:
    """The reference's parts for one run: the seed's weights, the path map
    built from the mapping, and the numbers of ``reference/dr.judge``."""

    def __init__(self, cfg: dict, seed: int, item_paths: np.ndarray, dev):
        self.cfg, self.dev = cfg, dev
        self.layer, self.rerank = dr_weights(cfg, seed, dev)
        self.pmap = ref_dr.PathMap(torch.as_tensor(item_paths, device=dev), cfg["num_node"])

    def _serve(self, seqs: np.ndarray, rnd=None) -> tuple[torch.Tensor, dict]:
        c = self.cfg
        s = torch.as_tensor(seqs, device=self.dev)
        kw = {"rnd": rnd} if rnd is not None else {}
        return s, ref_dr.serve(self.layer, self.rerank, self.pmap, s, s, c["beam_size"],
                               c["topk_number"], c["items"], **kw)

    def stand_in(self, seqs: np.ndarray, rnd) -> tuple:
        """(windows, lists, beams) of the reference's serving at rounding
        ``rnd``, in the program's place."""
        _, out = self._serve(seqs, rnd)
        return seqs, out["ids"].cpu().numpy(), out["paths"]

    def numbers(self, samples: tuple, path_sample: tuple) -> dict:
        """The check's numbers: ``samples`` (windows, lists) served in the
        window; ``path_sample`` (windows, lists, beams) of the warm-up.
        Each window is its own consumed list."""
        n_items = self.cfg["items"]
        seqs, lists = samples
        s, ref = self._serve(seqs)
        a = ref_dr.judge(self.rerank, self.pmap, s, s, torch.as_tensor(lists, device=self.dev),
                         ref, n_items)
        seqs, lists, paths = path_sample
        s, ref = self._serve(seqs)
        b = ref_dr.judge(self.rerank, self.pmap, s, s, torch.as_tensor(lists, device=self.dev),
                         ref, n_items, served_paths=paths.to(self.dev))
        na, nb = len(samples[0]), len(seqs)
        return {"bad_items": a["bad_items"] + b["bad_items"],
                "order_gap": max(a["order_gap"], b["order_gap"]),
                "list_miss": (a["list_miss"] * na + b["list_miss"] * nb) / max(na + nb, 1),
                "path_miss": b["path_miss"]}
