"""TDM training: level-sampled BCE over the tree, and the scorer functions
serving needs.

Port of ``dismember_tpu/train/tdm.py``, for the DIN and DeepFM scorers:
``build_model``, ``serving_fns``, ``packed_fns``, ``MATMUL_FIRST_SCORERS``,
``ResidentWindows`` and ``TDMTrainer``.  A train step samples negatives on
the device (``train/sampler.py``) and takes one step of
``train/row_step.py`` on the sampled codes: the touched rows gathered once,
the scorer's forward and BCE differentiated w.r.t. them, dense or lazy sparse
Adam (mv or pmv, whose packed formats commit through K2).  Two loops run
the steps: :meth:`TDMTrainer.train`, a host loop that uploads each batch
and can snapshot its state for a bit-exact resume
(``train/step_resume.py``), and :meth:`TDMTrainer.train_resident`, which
uploads the dataset once and gathers every batch on the device.  The
embedding table of either scorer may be stored in bf16 (``embed_dtype``):
rows are upcast to f32 after every gather, so the scorer (K1 for DIN, plain
ops for DeepFM) and the step compute in f32, and the updates round to bf16
as the JAX package's do on the CPU.

Batch accounting parity: ``total_batch_size`` counts *expanded* rows, so
the number of targets per step is ``max(1, total_batch // unit)`` with
``unit`` the per-target sampled-node count (tdm MiniBatch.scala:19).  Each
step is split into :meth:`TDMTrainer.sample` and
:meth:`TDMTrainer.step_from_samples`, so one sampled batch can be fed to
several trainers, or to this package and the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque

import numpy as np
import torch

from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.core.mesh import with_whole_table
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.core.io import open_file
from dismember_tpu_torch.core.metrics import EvalResult, compute_metrics_batch
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.models.deepfm import DeepFM
from dismember_tpu_torch.models.din import DIN
from dismember_tpu_torch.models.losses import bce_with_logits
from dismember_tpu_torch.models.scorer import TreeScorer
from dismember_tpu_torch.ops.din_kernel import check_kernel_width
from dismember_tpu_torch.retrieval.tree_beam import filter_topk, make_beam_fn
from dismember_tpu_torch.train import sparse_adam, spmd, spmd_sparse, step_resume
from dismember_tpu_torch.train.row_step import RowStepTrainer
from dismember_tpu_torch.train.sampler import TreeSampler

logger = logging.getLogger("dismember_tpu_torch.tdm")

def scorer_class(model_type: str) -> type[TreeScorer]:
    """The scorer module of a ``model.deep_model`` name ("din", "deepfm")."""
    scorers = {"din": DIN, "deepfm": DeepFM}
    if model_type not in scorers:
        raise ValueError(f"unknown deep model: {model_type}")
    return scorers[model_type]


def build_model(model_type: str, tree_max_level: int, embed_size: int,
                seq_len: int, generator: torch.Generator | None = None,
                device="cuda", num_index: int | None = None) -> TreeScorer:
    """The scorer over tree-node codes, num_index = 2^(max_level+1) - 1
    (DIN.buildModel) unless given (a mesh's padded row count); ``seq_len``
    sizes DeepFM's DNN."""
    if num_index is None:
        num_index = (1 << (tree_max_level + 1)) - 1
    if model_type == "deepfm":
        return DeepFM(num_index, embed_size, seq_len, device=device, generator=generator)
    return scorer_class(model_type)(num_index, embed_size, device=device, generator=generator)


def serving_fns(model_type: str):
    """(precompute, apply) pair with the level-invariant sequence side hoisted
    out of the beam-search level loop."""
    cls = scorer_class(model_type)
    return cls.precompute_seq, cls.apply_with_ctx


def packed_fns(model_type: str):
    """(precompute, apply_from_emb) pair for the packed pair-table loop."""
    cls = scorer_class(model_type)
    return cls.precompute_seq, cls.apply_from_emb


# Scorers whose every use of the candidate embedding flows through a matmul,
# so bf16 pair-table lanes cannot change their scores.  DeepFM's FM term is
# elementwise f32 math on the embedding, so its pair table stays f32.
MATMUL_FIRST_SCORERS = frozenset({"din"})


def _stream_seed(seed: int, stream: int, counter: int) -> int:
    """A 64-bit generator seed derived from (seed, stream, counter): the
    resident loop's counter-derived random streams."""
    return int(np.random.SeedSequence([seed, stream, counter]).generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class ResidentWindows:
    """Compact sliding-window training set for ``train_resident``: the
    [U, S] per-user item-code matrix uploads once and every batch's windows
    are gathered on the device.  Logical row ``r`` of the
    [U * (t_hi - t_lo)] dataset is user ``r // n_win`` at target position
    ``t = t_lo + r % n_win``: sequence ``items[u, t-L:t]``, target
    ``items[u, t]`` (the reference's TreeInit windowing, evaluated lazily)."""

    item_codes: np.ndarray  # [U, S] tree codes (int32)
    seq_len: int
    t_lo: int
    t_hi: int

    @classmethod
    def from_items(cls, tree: ArrayTree, items: np.ndarray, seq_len: int,
                   t_lo: int, t_hi: int) -> "ResidentWindows":
        return cls(item_codes=tree.ids_to_codes(items).astype(np.int32),
                   seq_len=seq_len, t_lo=t_lo, t_hi=t_hi)

    @property
    def n_win(self) -> int:
        return self.t_hi - self.t_lo

    def __len__(self) -> int:
        return len(self.item_codes) * self.n_win


def window_rows(items: torch.Tensor, idx: torch.Tensor, seq_len: int, t_lo: int,
                n_win: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(target codes [B], sequence codes [B, L]) of logical rows ``idx`` of
    the on-device [U, S] code matrix, as int64 (ResidentWindows' rows)."""
    u = idx // n_win
    t = t_lo + idx % n_win
    cols = t[:, None] + torch.arange(-seq_len, 0, device=idx.device)[None, :]
    return items[u, t].long(), items[u[:, None], cols].long()


@dataclasses.dataclass
class TDMTrainer(RowStepTrainer):
    tree: ArrayTree
    model_type: str = "din"
    embed_size: int = 16
    learning_rate: float = 1e-4
    total_batch_size: int = 8192
    total_eval_batch_size: int = 8192
    seq_len: int = 10
    layer_neg_counts: str = "0,1,2,3,4"
    sample_with_prob: bool = False
    sample_tolerance: int = 20
    start_sample_level: int = 1
    topk: int = 10
    beam_size: int = 20
    seed: int = 0
    mesh: object = None  # a ("data", "model") DeviceMesh (core/mesh.py):
    # targets split on "data", the table and its Adam state row-sharded on
    # "model" (train/spmd.py dense, train/spmd_sparse.py sparse mv)
    embed_dtype: object = None  # torch.bfloat16 stores the table in bf16
    # (either scorer): half the memory of a deep catalog's table; compute
    # stays f32 and the Adam moments are optax's (mu f32; dense nu bf16)
    sparse_embed_update: bool | None = None  # lazy row-sparse Adam on the
    # embedding table (train/sparse_adam.py).  None = auto
    # (sparse_adam.sparse_worthwhile): sparse at deep catalogs, dense
    # otherwise.
    sparse_format: str = "auto"  # packed-state format of the sparse step:
    # "pmv" packs params+moments into one 128-lane row (one K2 write a step;
    # the model's embedding becomes a MIRROR synced at eval/train
    # boundaries); "mv" keeps the table addressable (m|v packed when the
    # width divides 128, split otherwise); "auto" = pmv when the width packs.
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.embed_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"embed_dtype must be float32 or bfloat16, got {self.embed_dtype!r}")
        self.device = meshlib.trainer_device(self.mesh, resolve_device(self.device))
        n_data = meshlib.data_size(self.mesh)
        check_kernel_width(self.model_type, self.embed_size, self.device)
        self.sampler = TreeSampler.build(
            self.tree, self.layer_neg_counts, start_level=self.start_sample_level,
            with_prob=self.sample_with_prob, tolerance=self.sample_tolerance,
            device=self.device,
        )
        self.num_targets_per_batch = max(1, self.total_batch_size // self.sampler.unit)
        # on a mesh the targets of a batch split over "data"
        self.num_targets_per_batch = max(n_data, self.num_targets_per_batch // n_data * n_data)
        base_num_index = (1 << (self.tree.max_level + 1)) - 1
        if self.sparse_embed_update is not None:
            sparse = self.sparse_embed_update
        else:
            touched = self.num_targets_per_batch * (self.sampler.unit + self.seq_len)
            sparse = sparse_adam.sparse_worthwhile(
                base_num_index, touched, embed_dim=self.embed_size)
        num_index = None
        if self.mesh is not None:
            # the table pads to split over "model" (and, for the sharded
            # sparse step, so that each shard's rows slot-pack); the JAX
            # package draws its mesh init at the padded count too
            num_index = (spmd_sparse.sparse_padded_rows(base_num_index, self.mesh,
                                                        self.embed_size)
                         if sparse else spmd.padded_num_index(base_num_index, self.mesh))
        self.model = build_model(
            self.model_type, self.tree.max_level, self.embed_size, self.seq_len,
            generator=torch.Generator().manual_seed(self.seed), device=self.device,
            num_index=num_index,
        )
        if self.embed_dtype == torch.bfloat16:
            self.model.embedding.data = self.model.embedding.data.to(torch.bfloat16)
        # pmv mode: the embedding is a MIRROR of the packed p|m|v state,
        # re-materialized by _sync_mirrors at eval/train boundaries
        self._init_optimizer(sparse, self.sparse_format, logical_rows=base_num_index)
        self._gen = torch.Generator(device=self.device)
        self._mesh_steps = 0
        self._beam_fn = None
        self._beam_fn_width = None

    # ------------------------------------------------------------------
    def sample(self, target_codes: torch.Tensor):
        """(codes [B, U], labels, weights) for a batch of target leaf codes,
        from the trainer's generator."""
        return self.sampler.sample(self._gen, target_codes)

    def _train_step(self, target_codes: torch.Tensor, seq_codes: torch.Tensor) -> torch.Tensor:
        """One step on a global batch.  On a mesh each rank keeps its "data"
        rows: the dense step samples the global batch from the trainer's
        generator (the single-device draws) and keeps its rows, the sparse
        step samples its rows from the (seed, step, data index) stream
        (``spmd_sparse.shard_generator``)."""
        with profiling.span("tdm.step"):
            profiling.count("tdm.steps")
            step = self._mesh_steps
            self._mesh_steps += 1
            if self.mesh is None:
                return self.step_from_samples(seq_codes, *self.sample(target_codes))
            rows = lambda t: meshlib.data_rows(t, self.mesh)  # noqa: E731
            if self._sparse:
                gen = spmd_sparse.shard_generator(
                    self.seed, step, meshlib.axis_index(self.mesh, meshlib.DATA_AXIS), self.device)
                samples = self.sampler.sample(gen, rows(target_codes))
            else:
                samples = [rows(t) for t in self.sample(target_codes)]
            return self.step_from_samples(rows(seq_codes), *samples)

    @torch.inference_mode()
    def _eval_loss_step(self, gen: torch.Generator, target_codes: torch.Tensor,
                        seq_codes: torch.Tensor) -> torch.Tensor:
        codes, labels, weights = self.sampler.sample(gen, target_codes)
        return bce_with_logits(self.model(codes, seq_codes), labels, weights)

    # ------------------------------------------------------------------
    def train(
        self,
        train_seqs: np.ndarray,  # [N, L] raw item ids
        train_targets: np.ndarray,  # [N] raw item ids
        iterations: int,
        eval_data: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
        user_consumed: dict[int, np.ndarray] | None = None,
        progress_interval: int = 100,
        shuffle: bool = True,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
    ) -> list[dict]:
        """Run the training loop; returns per-progress-point logs.  The batch
        order is ``np.random.default_rng(seed).permutation``, as in the JAX
        package; the sampler's generator restarts from ``seed + 1``.

        ``checkpoint_path`` + ``checkpoint_every`` snapshot the loop state
        every N iterations (``train/step_resume.py``): params, Adam and
        sparse state, the generator, and the numpy permutation stream's
        state before the current epoch's draw with the position in it.  A
        restarted call with the same arguments resumes from the snapshot
        and ends bit for bit where an uninterrupted run ends."""
        self._adopt_mirrors()
        seq_codes_all = self.tree.ids_to_codes(train_seqs)
        target_codes_all = self.tree.ids_to_codes(train_targets)
        n = len(target_codes_all)
        bsz = self.num_targets_per_batch
        rng = np.random.default_rng(self.seed)
        rng_before_perm = step_resume.rng_state_to_json(rng)
        perm = rng.permutation(n) if shuffle else np.arange(n)
        self._gen.manual_seed(self.seed + 1)
        self._mesh_steps = 0
        start_it, pos = 1, 0
        if checkpoint_path:
            loaded = step_resume.load_step_state(checkpoint_path, self._local_step_state())
            if loaded is not None:
                st, meta = loaded
                self._restore_step_state(st)
                step_resume.rng_state_from_json(rng, meta["rng_before_perm"])
                rng_before_perm = step_resume.rng_state_to_json(rng)
                perm = rng.permutation(n) if shuffle else np.arange(n)
                pos = int(meta["pos"])
                start_it = int(meta["iteration"]) + 1
                self._mesh_steps = step_resume.saved_steps(meta, self.mesh)
                logger.info(f"resumed step checkpoint {checkpoint_path} at iteration "
                            f"{meta['iteration']} (pos {pos})")
        logs: list[dict] = []
        t_epoch = time.perf_counter()
        for it in range(start_it, iterations + 1):
            if pos + bsz > n:
                rng_before_perm = step_resume.rng_state_to_json(rng)
                perm = rng.permutation(n) if shuffle else np.arange(n)
                pos = 0
            idx = perm[pos : pos + bsz]
            pos += bsz
            t0 = time.perf_counter()
            loss = self._train_step(self._codes(target_codes_all[idx]),
                                    self._codes(seq_codes_all[idx]))
            if it % progress_interval == 0 or it == iterations:
                loss_val = float(loss)
                iter_time = time.perf_counter() - t0
                elapsed = time.perf_counter() - t_epoch
                rows_s = (it - start_it + 1) * bsz * self.sampler.unit / max(elapsed, 1e-9)
                entry = {"iteration": it, "train_loss": loss_val, "iter_time": iter_time,
                         "elapsed": elapsed, "expanded_rows_per_s": rows_s}
                msg = (f"Iteration {it} time: {iter_time:.4f}s, "
                       f"Train loss: {loss_val:.4f}, {rows_s:,.0f} expanded rows/s")
                if eval_data is not None:
                    ev = self.evaluate(eval_data, user_consumed)
                    c = max(ev.count, 1)
                    entry.update({"eval_loss": ev.loss / c, "precision": ev.precision / c,
                                  "recall": ev.recall / c, "ndcg": ev.ndcg / c})
                    msg += f"\n\tMetrics: {ev}"
                logger.info(msg)
                logs.append(entry)
            if checkpoint_path and checkpoint_every > 0 and it % checkpoint_every == 0 \
                    and it < iterations:
                step_resume.save_step_state(
                    checkpoint_path, self._step_state(),
                    {"iteration": it, "pos": pos, "rng_before_perm": rng_before_perm,
                     "steps": self._mesh_steps}, self.mesh)
                logger.info(f"step checkpoint saved at iteration {it}")
        self._sync_mirrors()
        return logs

    def train_resident(
        self,
        data,  # ResidentWindows | (train_seqs [N, L], train_targets [N]) raw item ids
        iterations: int,
        chunk: int = 64,
        progress_interval: int = 1000,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
    ) -> list[dict]:
        """Device-resident training loop: the dataset goes to the device
        once and every step's windows are gathered there; the loop runs in
        ``chunk``-step chunks whose only host synchronization is one read
        of the chunk's losses, drained through a FIFO so the device runs
        chunk i+1 while the host reads chunk i.

        The same step as :meth:`train`, but its random streams are
        counter-derived: step g's negatives come from the trainer's
        generator seeded from (seed, g), and epoch k's permutation (of
        ``steps_per_epoch * batch`` rows) is drawn on the device from a
        generator seeded from (seed, k).  So the choice of ``chunk`` is bit
        for bit invariant, the two loops match in distribution and not in
        bits (as in the JAX package), and a snapshot (``checkpoint_every``
        steps, at chunk boundaries) needs only params, optimizer state and
        the global step to resume exactly."""
        if self.mesh is not None:
            raise ValueError("train_resident is single-chip; use train()")
        self._adopt_mirrors()
        b, dev = self.num_targets_per_batch, self.device
        if isinstance(data, ResidentWindows):
            n = len(data)
            items = torch.as_tensor(data.item_codes, dtype=torch.int32, device=dev)
            gather = lambda idx: window_rows(  # noqa: E731
                items, idx, data.seq_len, data.t_lo, data.n_win)
        else:
            train_seqs, train_targets = data
            n = len(train_targets)
            tc_all = torch.as_tensor(self.tree.ids_to_codes(train_targets), dtype=torch.int32,
                                     device=dev)
            sc_all = torch.as_tensor(self.tree.ids_to_codes(train_seqs), dtype=torch.int32,
                                     device=dev)
            gather = lambda idx: (tc_all[idx].long(), sc_all[idx].long())  # noqa: E731
        steps_per_epoch = n // b
        if steps_per_epoch < 1:
            raise ValueError(f"dataset ({n} rows) smaller than one batch ({b})")
        gs = 0
        if checkpoint_path:
            loaded = step_resume.load_step_state(checkpoint_path, self._resident_state())
            if loaded is not None:
                st, meta = loaded
                self._restore_step_state(st)
                gs = int(meta["global_step"])
                logger.info(f"resumed resident checkpoint {checkpoint_path} at global step {gs}")
        perm_gen = torch.Generator(device=dev)
        fifo: deque = deque()
        logs: list[dict] = []
        cur_epoch, perm = -1, None
        next_ckpt = ((gs // checkpoint_every + 1) * checkpoint_every
                     if checkpoint_path and checkpoint_every > 0 else None)
        next_log = (gs // progress_interval + 1) * progress_interval
        t0 = time.perf_counter()
        gs_start = gs

        def drain() -> None:
            nonlocal next_log
            g0, k, losses = fifo.popleft()
            with profiling.span("tdm.drain"):
                losses = losses.cpu().numpy()  # the chunk's one host synchronization
            if g0 + k >= next_log:
                elapsed = time.perf_counter() - t0
                rows_s = (g0 + k - gs_start) * b * self.sampler.unit / max(elapsed, 1e-9)
                entry = {"iteration": g0 + k, "train_loss": float(losses[-1]),
                         "elapsed": elapsed, "expanded_rows_per_s": rows_s}
                logger.info(f"Iteration {g0 + k} Train loss: {entry['train_loss']:.4f}, "
                            f"{rows_s:,.0f} expanded rows/s (resident)")
                logs.append(entry)
                next_log = ((g0 + k) // progress_interval + 1) * progress_interval

        while gs < iterations:
            epoch = gs // steps_per_epoch
            if epoch != cur_epoch:
                perm_gen.manual_seed(_stream_seed(self.seed, 3, epoch))
                perm = torch.randperm(steps_per_epoch * b, generator=perm_gen, device=dev)
                cur_epoch = epoch
            pos0 = gs % steps_per_epoch
            k = min(chunk, steps_per_epoch - pos0, iterations - gs)
            if next_ckpt is not None:
                k = min(k, next_ckpt - gs)
            losses = torch.empty(k, device=dev)
            for i in range(k):
                tc, sc = gather(perm[(pos0 + i) * b : (pos0 + i + 1) * b])
                self._gen.manual_seed(_stream_seed(self.seed, 1, gs + i))
                losses[i] = self._train_step(tc, sc)
            gs += k
            fifo.append((gs - k, k, losses))
            if len(fifo) >= 4:
                drain()
            if next_ckpt is not None and gs == next_ckpt:
                while fifo:
                    drain()
                if gs < iterations:
                    step_resume.save_step_state(checkpoint_path, self._resident_state(),
                                                {"global_step": gs})
                    logger.info(f"resident checkpoint saved at step {gs}")
                next_ckpt += checkpoint_every
        while fifo:
            drain()
        self._sync_mirrors()
        return logs

    def _resident_state(self) -> dict:
        """train_resident's snapshot: its streams are counter-derived, so
        the generator's state is not part of it."""
        st = self._step_state()
        st.pop("gen", None)
        return st

    # ------------------------------------------------------------------
    @with_whole_table
    def evaluate(
        self,
        eval_data: tuple[np.ndarray, np.ndarray, np.ndarray],
        user_consumed: dict[int, np.ndarray] | None = None,
        candidate_num: int | None = None,
    ) -> EvalResult:
        """Eval loss (the training sampler, target = first label, scored by
        K1) + beam-search metrics per user (Evaluator.scala:14-74)."""
        eval_seqs, eval_labels, eval_users = eval_data
        seq_codes = self.tree.ids_to_codes(eval_seqs)
        target_codes = self.tree.ids_to_codes(eval_labels[:, 0])
        result = EvalResult()
        m = len(target_codes)
        ebsz = max(1, self.total_eval_batch_size // self.sampler.unit)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        for s in range(0, m, ebsz):
            e = min(s + ebsz, m)
            loss = self._eval_loss_step(gen, self._codes(target_codes[s:e]),
                                        self._codes(seq_codes[s:e]))
            result.loss += float(loss) * (e - s)
            result.count += e - s
        # the reference widens the beam for heavy users
        # ((consumed + topk)/2, Recommender.scala:29-33): use the batch max
        cn = candidate_num if candidate_num is not None else self.beam_size
        if user_consumed:
            max_consumed = max(
                (len(user_consumed.get(int(u), ())) for u in eval_users), default=0)
            cn = max((max_consumed + self.topk) // 2, cn)
        rec_lists = self.recommend_batch(
            eval_seqs, candidate_num=cn, consumed=[
                user_consumed.get(int(u), np.empty(0, np.int64)) for u in eval_users
            ] if user_consumed else None,
        )
        rec_padded = np.full((len(rec_lists), self.topk), -1, dtype=np.int64)
        for i, rec in enumerate(rec_lists):
            rec_padded[i, : len(rec)] = rec
        p, r, nd = compute_metrics_batch(rec_padded, eval_labels)
        result.precision += float(p.sum())
        result.recall += float(r.sum())
        result.ndcg += float(nd.sum())
        return result

    @with_whole_table
    def recommend_batch(
        self,
        seqs: np.ndarray,  # [B, L] raw item ids
        candidate_num: int | None = None,
        topk: int | None = None,
        consumed: list[np.ndarray] | None = None,
        batch_size: int = 4096,
    ) -> list[np.ndarray]:
        """Classic beam search (K1 per level) over ``batch_size`` chunks."""
        cn = candidate_num or self.beam_size
        k = topk or self.topk
        if self._beam_fn is None or self._beam_fn_width != cn:
            pre, app = serving_fns(self.model_type)
            self._beam_fn = make_beam_fn(type(self.model).forward, self.tree, cn,
                                         precompute=pre, apply=app, device=self.device)
            self._beam_fn_width = cn
        seq_codes = self.tree.ids_to_codes(seqs)
        out: list[np.ndarray] = []
        for s in range(0, len(seq_codes), batch_size):
            e = min(s + batch_size, len(seq_codes))
            ids, scores = self._beam_fn(self.model, self._codes(seq_codes[s:e]))
            out.extend(filter_topk(ids.cpu().numpy(), scores.cpu().numpy(), k,
                                   consumed[s:e] if consumed is not None else None))
        return out

    def recommend(
        self,
        sequence: np.ndarray,
        topk: int | None = None,
        candidate_num: int | None = None,
        consumed: np.ndarray | None = None,
    ) -> np.ndarray:
        """Single-query recommend (TDM.recommend parity incl. the per-user
        candidate-num widening, Recommender.scala:29-33)."""
        k = topk or self.topk
        cn = candidate_num or self.beam_size
        if consumed is not None and len(consumed) > 0:
            cn = max((len(consumed) + k) // 2, cn)
        return self.recommend_batch(
            sequence[None, :], candidate_num=cn, topk=k,
            consumed=[consumed] if consumed is not None else None,
        )[0]

    # ------------------------------------------------------------------
    @with_whole_table
    def export_embeddings(self, path: str) -> None:
        """Leaf-item embeddings CSV: ``id, e1, ..., ed`` keyed by item id,
        rows read from the shared embedding table at each item's leaf code
        (tdm/.../utils/Serialization.scala:15-58)."""
        table = self.model.embedding.detach().float().cpu().numpy()
        with open_file(path, "w", encoding="utf-8") as f:
            for iid, code in zip(self.tree.item_ids, self.tree.item_codes):
                f.write(str(int(iid)))
                for v in table[code]:
                    f.write(f", {float(v):.12g}")
                f.write("\n")
