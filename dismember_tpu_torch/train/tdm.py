"""TDM training: level-sampled BCE over the tree, and the scorer functions
serving needs.

Port of ``dismember_tpu/train/tdm.py``, DIN only: ``build_model``,
``serving_fns``, ``packed_fns``, ``MATMUL_FIRST_SCORERS`` and
``TDMTrainer``.  A train step samples negatives on the device
(``train/sampler.py``) and takes one step of ``train/row_step.py`` on the
sampled codes: the touched rows gathered once, the DIN forward and BCE
differentiated w.r.t. them, dense or lazy sparse Adam (mv or pmv, whose
packed formats commit through K2).

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

import numpy as np
import torch

from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.core.io import open_file
from dismember_tpu_torch.core.metrics import EvalResult, compute_metrics_batch
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.models.din import DIN
from dismember_tpu_torch.models.losses import bce_with_logits
from dismember_tpu_torch.ops.din_kernel import check_kernel_width
from dismember_tpu_torch.retrieval.tree_beam import filter_topk, make_beam_fn
from dismember_tpu_torch.train import sparse_adam
from dismember_tpu_torch.train.row_step import RowStepTrainer
from dismember_tpu_torch.train.sampler import TreeSampler

logger = logging.getLogger("dismember_tpu_torch.tdm")

_DEEPFM_TODO = (
    "the DeepFM scorer is not ported yet (ROADMAP queue 1 item 9: "
    "models/deepfm.py)"
)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 {item})")


def build_model(model_type: str, tree_max_level: int, embed_size: int,
                seq_len: int, generator: torch.Generator | None = None,
                device="cuda") -> DIN:
    """The scorer over tree-node codes, num_index = 2^(max_level+1) - 1
    (DIN.buildModel).  ``seq_len`` sizes DeepFM, which is not ported."""
    num_index = (1 << (tree_max_level + 1)) - 1
    if model_type == "din":
        return DIN(num_index, embed_size, device=device, generator=generator)
    if model_type == "deepfm":
        raise NotImplementedError(_DEEPFM_TODO)
    raise ValueError(f"unknown deep model: {model_type}")


def _din_only(model_type: str) -> None:
    if model_type == "deepfm":
        raise NotImplementedError(_DEEPFM_TODO)
    if model_type != "din":
        raise ValueError(f"unknown deep model: {model_type}")


def serving_fns(model_type: str):
    """(precompute, apply) pair with the level-invariant sequence side hoisted
    out of the beam-search level loop."""
    _din_only(model_type)
    return DIN.precompute_seq, DIN.apply_with_ctx


def packed_fns(model_type: str):
    """(precompute, apply_from_emb) pair for the packed pair-table loop."""
    _din_only(model_type)
    return DIN.precompute_seq, DIN.apply_from_emb


# Scorers whose every use of the candidate embedding flows through a matmul,
# so bf16 pair-table lanes cannot change their scores.
MATMUL_FIRST_SCORERS = frozenset({"din"})


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
    mesh: object = None  # not ported (ROADMAP queue 1 item 13)
    embed_dtype: object = None  # not ported (ROADMAP queue 1 item 7)
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
        if self.mesh is not None:
            raise _not_ported("mesh training", "item 13: multi-device")
        if self.embed_dtype is not None:
            raise _not_ported("embed_dtype", "item 7: bf16 embedding tables")
        self.device = resolve_device(self.device)
        check_kernel_width(self.embed_size, self.device)
        self.sampler = TreeSampler.build(
            self.tree, self.layer_neg_counts, start_level=self.start_sample_level,
            with_prob=self.sample_with_prob, tolerance=self.sample_tolerance,
            device=self.device,
        )
        self.num_targets_per_batch = max(1, self.total_batch_size // self.sampler.unit)
        base_num_index = (1 << (self.tree.max_level + 1)) - 1
        if self.sparse_embed_update is not None:
            sparse = self.sparse_embed_update
        else:
            touched = self.num_targets_per_batch * (self.sampler.unit + self.seq_len)
            sparse = sparse_adam.sparse_worthwhile(
                base_num_index, touched, embed_dim=self.embed_size)
        self.model = build_model(
            self.model_type, self.tree.max_level, self.embed_size, self.seq_len,
            generator=torch.Generator().manual_seed(self.seed), device=self.device,
        )
        # pmv mode: the embedding is a MIRROR of the packed p|m|v state,
        # re-materialized by _sync_mirrors at eval/train boundaries
        self._init_optimizer(sparse, self.sparse_format)
        self._gen = torch.Generator(device=self.device)
        self._beam_fn = None
        self._beam_fn_width = None

    # ------------------------------------------------------------------
    def sample(self, target_codes: torch.Tensor):
        """(codes [B, U], labels, weights) for a batch of target leaf codes,
        from the trainer's generator."""
        return self.sampler.sample(self._gen, target_codes)

    def _train_step(self, target_codes: torch.Tensor, seq_codes: torch.Tensor) -> torch.Tensor:
        return self.step_from_samples(seq_codes, *self.sample(target_codes))

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
        package; the sampler's generator restarts from ``seed + 1``."""
        if checkpoint_path:
            raise _not_ported("checkpoint_path", "item 7: step_resume")
        self._adopt_mirrors()
        seq_codes_all = self.tree.ids_to_codes(train_seqs)
        target_codes_all = self.tree.ids_to_codes(train_targets)
        n = len(target_codes_all)
        bsz = self.num_targets_per_batch
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n) if shuffle else np.arange(n)
        self._gen.manual_seed(self.seed + 1)
        pos = 0
        logs: list[dict] = []
        t_epoch = time.perf_counter()
        for it in range(1, iterations + 1):
            if pos + bsz > n:
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
                rows_s = it * bsz * self.sampler.unit / max(elapsed, 1e-9)
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
        self._sync_mirrors()
        return logs

    def train_resident(self, *args, **kwargs):
        raise _not_ported("train_resident (ResidentWindows)",
                          "item 7: the device-resident loop")

    # ------------------------------------------------------------------
    def evaluate(
        self,
        eval_data: tuple[np.ndarray, np.ndarray, np.ndarray],
        user_consumed: dict[int, np.ndarray] | None = None,
        candidate_num: int | None = None,
    ) -> EvalResult:
        """Eval loss (the training sampler, target = first label, scored by
        K1) + beam-search metrics per user (Evaluator.scala:14-74)."""
        self._sync_mirrors()
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

    def recommend_batch(
        self,
        seqs: np.ndarray,  # [B, L] raw item ids
        candidate_num: int | None = None,
        topk: int | None = None,
        consumed: list[np.ndarray] | None = None,
        batch_size: int = 4096,
    ) -> list[np.ndarray]:
        """Classic beam search (K1 per level) over ``batch_size`` chunks."""
        self._sync_mirrors()
        cn = candidate_num or self.beam_size
        k = topk or self.topk
        if self._beam_fn is None or self._beam_fn_width != cn:
            pre, app = serving_fns(self.model_type)
            self._beam_fn = make_beam_fn(DIN.forward, self.tree, cn, precompute=pre,
                                         apply=app, device=self.device)
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
    def export_embeddings(self, path: str) -> None:
        """Leaf-item embeddings CSV: ``id, e1, ..., ed`` keyed by item id,
        rows read from the shared embedding table at each item's leaf code
        (tdm/.../utils/Serialization.scala:15-58)."""
        self._sync_mirrors()
        table = self.model.embedding.detach().cpu().numpy()
        with open_file(path, "w", encoding="utf-8") as f:
            for iid, code in zip(self.tree.item_ids, self.tree.item_codes):
                f.write(str(int(iid)))
                for v in table[code]:
                    f.write(f", {float(v):.12g}")
                f.write("\n")
