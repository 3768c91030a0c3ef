"""OTM training: beam-search-aware optimal pseudo-targets, per-level BCE.

Port of ``dismember_tpu/train/otm.py`` for the DIN and DeepFM scorers
(otm/.../optim/LocalOptimizer.scala:18-274, tree/OTMTree.scala in the
reference).  Per
batch, with *frozen* parameters, compute (a) the per-level target node sets,
either bottom-up optimal pseudo-targets (Algorithm 1 of arXiv 2006.15408) or
plain ancestor targets, and (b) the per-level beam-search trajectories;
then, level by level (top-down), take one BCE-with-logits step of
``train/row_step.py`` on (beam nodes, level targets).

Layout: beam trajectories [n_levels, B, 2*beam], target sets [n_levels, B,
J] (-1 padded).  The bottom-up parent reduction (group-by-parent + label
sum + clip, OTMTree.computeTargets:104-129) is a stable row sort and an
equality-matrix segment sum; J = label_num is tiny.  Selection is
``torch.topk`` + ``gather`` (the JAX package's one-hot select is a TPU
workaround); ``torch.topk`` orders equal scores differently from
``lax.top_k``, so trajectories agree as sets per row and level.

Kernels on this path: every frozen forward (trajectory, pseudo targets)
scores under ``torch.no_grad()`` through the scorer's ``apply_from_emb``,
so K1 on CUDA for DIN (DeepFM scores in plain ops); in the pmv format each
level commits its rows through K2 (n_levels launches a batch); serving and
evaluation run the packed pair-table loop over the complete tree, K3 per
level for DIN.  The level steps differentiate the plain scorer
(``train_apply_from_emb``), as the JAX package differentiates outside its
kernel.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from collections import deque

import numpy as np
import torch

from dismember_tpu_torch.constants import PADDING_IDX
from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.core.mesh import with_whole_table
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.core.metrics import compute_metrics_batch
from dismember_tpu_torch.data.otm_dataset import OTMData, lower_log2, upper_log2
from dismember_tpu_torch.ops.din_kernel import check_kernel_width
from dismember_tpu_torch.retrieval.packed_beam import (
    PackedTree,
    build_pair_table,
    make_packed_beam_fn,
)
from dismember_tpu_torch.retrieval.tree_beam import NEG_INF, TreeBeamConfig
from dismember_tpu_torch.train import sparse_adam, spmd, spmd_sparse, step_resume
from dismember_tpu_torch.train.row_step import RowStepTrainer
from dismember_tpu_torch.train.tdm import build_model

logger = logging.getLogger("dismember_tpu_torch.otm")

_INT_MAX = 2**31 - 1


@dataclasses.dataclass
class OTMEvalResult:
    loss: float = 0.0
    precision: float = 0.0
    recall: float = 0.0
    ndcg: float = 0.0

    def __str__(self) -> str:
        return (
            f"{{precision: {self.precision:.6f}, recall: {self.recall:.6f}, "
            f"ndcg: {self.ndcg:.6f}}}"
        )


def level_labels(nodes: torch.Tensor, t_ids: torch.Tensor, t_labels: torch.Tensor,
                 dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-level BCE labels and the valid-node mask from the (beam nodes,
    target set) match (otm LocalOptimizer.scala:96-117): label = clipped sum
    of target labels whose id equals the node; -1 beam pads are invalid."""
    valid = nodes >= 0
    eq = nodes[:, :, None] == torch.where(t_ids >= 0, t_ids, -2)[:, None, :]
    labels = torch.einsum("bwj,bj->bw", eq.to(dtype), t_labels.to(dtype)).clamp(0.0, 1.0)
    return labels, valid


def _row_group_parents(parents: torch.Tensor, values: torch.Tensor):
    """Group duplicate parent ids within each row, summing their labels.

    parents/values: [B, J]; invalid ids < 0.  Returns (ids [B, J], labels
    [B, J]) where each distinct parent appears once (label clipped to [0,1],
    mirroring ``clipValue``) and remaining slots are -1."""
    key = torch.where(parents < 0, _INT_MAX, parents)
    ps, order = torch.sort(key, dim=1, stable=True)
    vs = torch.gather(values, 1, order)
    eq = ps[:, :, None] == ps[:, None, :]
    sums = torch.einsum("bjk,bk->bj", eq.to(vs.dtype), vs)
    first = torch.ones_like(ps, dtype=torch.bool)
    first[:, 1:] = ps[:, 1:] != ps[:, :-1]
    keep = first & (ps != _INT_MAX)
    new_ids = torch.where(keep, ps, -1)
    new_labels = torch.where(keep, sums.clamp(0.0, 1.0), 0.0)
    return new_ids, new_labels


class OTMTrainer(RowStepTrainer):
    _table_caches = ("_packed_cache",)  # the packed loop's pair table

    def __init__(
        self,
        data: OTMData,
        model_type: str = "din",
        embed_size: int = 16,
        learning_rate: float = 3e-3,
        total_train_batch_size: int = 8192,
        total_eval_batch_size: int = 8192,
        beam_size: int = 20,
        topk: int = 10,
        seq_len: int = 10,
        target_mode: str = "pseudo",
        seed: int = 42,
        precision: str = "f32",
        sparse_embed_update: bool | None = None,
        sparse_format: str = "auto",
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        """The JAX package's ``OTMTrainer`` on ``device`` (CUDA by default).

        ``precision="f64"`` is the reference's Double-precision OTM
        (LocalOptimizer.scala:18): params, pseudo-target scores, losses and
        Adam state in float64.  The JAX package takes it as a precision
        parity mode outside any kernel, and so does the port: every score
        of this mode, frozen ones included, goes through float64 plain ops
        on any device, never through K1 (f32) or K3 (bf16).

        ``sparse_embed_update``: lazy row-sparse Adam on the node table
        (None = auto by ``sparse_adam.sparse_worthwhile`` on train_batch *
        (2*beam + seq_len) touched rows); not available with f64.
        ``sparse_format``: "pmv" packs params and moments into one 128-lane
        row and each level commits through K2, the embedding becoming a
        mirror synced at train/eval boundaries; "mv" keeps the table
        addressable; "auto" = pmv when the width packs (3E <= 128).

        Initial weights come from ``torch.Generator().manual_seed(seed)``,
        not from JAX's draws (``load_numpy`` carries a JAX trainer's
        params and state); on CUDA a DIN at a width K1 and K3 are not built
        for is refused here.

        ``mesh``: a ("data", "model") DeviceMesh (``core/mesh.py``): each
        batch splits on "data" (its size rounded to a multiple of it, a
        ragged epoch tail cut to one), the node table zero-padded and
        row-sharded on "model" with its dense moments or sharded mv state
        (``train/spmd.make_sharded_otm_train_batch``); f32 only, and pmv
        is refused."""
        if precision not in ("f32", "f64"):
            raise ValueError(f"precision must be f32 or f64, got {precision!r}")
        if sparse_format not in ("auto", "mv", "pmv"):
            raise ValueError(f"unknown sparse_format {sparse_format!r}")
        self._x64 = precision == "f64"
        self.dtype = torch.float64 if self._x64 else torch.float32
        self.mesh = mesh
        self.device = meshlib.trainer_device(mesh, resolve_device(device))
        if mesh is not None and self._x64:
            raise ValueError("mesh mode is f32-only (no f64 SPMD path)")
        if mesh is not None and sparse_format == "pmv":
            raise ValueError("pmv is single-device; meshes use the sharded mv state")
        n_data = meshlib.data_size(mesh)
        check_kernel_width(model_type, embed_size, self.device)
        self.data = data
        self.model_type = model_type
        self.embed_size = embed_size
        self.learning_rate = learning_rate
        self.beam = beam_size
        self.topk = topk
        self.seq_len = seq_len
        self.target_mode = target_mode
        self.seed = seed
        self.start_level = lower_log2(beam_size)
        self.leaf_level = upper_log2(data.num_items)
        self.n_levels = self.leaf_level - self.start_level
        self.label_num = data.label_num or data.train_labels.shape[1]
        self.train_batch_size = max(1, total_train_batch_size // (beam_size * 2))
        self.train_batch_size = max(n_data, self.train_batch_size // n_data * n_data)
        self.eval_batch_size = max(1, total_eval_batch_size // (beam_size * 2))

        num_index = data.num_tree_nodes
        # drawn in f32 and upcast, so f32 and f64 start from the same weights
        self.model = build_model(model_type, data.leaf_level, embed_size, seq_len,
                                 generator=torch.Generator().manual_seed(seed),
                                 device=self.device).to(self.dtype)
        if sparse_embed_update and self._x64:
            raise ValueError(
                "sparse_embed_update keeps f32 moments; it is not available "
                "in the f64 parity mode"
            )
        if sparse_embed_update is not None:
            sparse = sparse_embed_update
        else:
            touched = self.train_batch_size * (2 * beam_size + seq_len)
            sparse = not self._x64 and sparse_adam.sparse_worthwhile(
                num_index, touched, embed_dim=embed_size)
        if mesh is not None:
            # zero rows pad the table to split over "model" (and to slot-pack
            # each shard's rows in the sparse mode); they are never addressed
            rows = (spmd_sparse.sparse_padded_rows(num_index, mesh, embed_size) if sparse
                    else spmd.padded_num_index(num_index, mesh))
            self.model.embedding = torch.nn.Parameter(
                spmd.pad_embedding_rows(self.model.embedding.detach(), rows))
        self._init_optimizer(sparse, sparse_format, logical_rows=num_index)
        self._batch_fn = (self._train_batch if mesh is None
                          else spmd.make_sharded_otm_train_batch(self))
        self._packed_cache = None

    # -- frozen scoring -------------------------------------------------
    def _frozen_rows(self, codes: torch.Tensor) -> torch.Tensor:
        """Embedding rows [..., E] of ``codes`` (-1 -> zero rows), from the
        packed state in pmv mode (the mirror may be stale there)."""
        valid = codes != PADDING_IDX
        safe = torch.where(valid, codes, 0)
        if self._shard is not None:
            rows = spmd_sparse.gather_rows_sharded(self._shard, safe.reshape(-1),
                                                   valid.reshape(-1), self.mesh)
            return rows.view(*codes.shape, -1)
        if self._pmv:
            rows = sparse_adam.pmv_gather(self.emb_state["pmv"], safe.reshape(-1),
                                          self.embed_size).view(*codes.shape, -1)
        else:
            rows = self.model.embedding.detach()[safe]
        return rows * valid[..., None].to(rows.dtype)

    def _frozen_scorer(self, seqs: torch.Tensor):
        """``logits_fn(nodes [B, W], -1 pads) -> logits [B, W]`` with the
        current parameters and ``seqs``' context computed once: the scorer's
        ``apply_from_emb`` (K1 for DIN on CUDA), or in the f64 mode its
        plain twin ``train_apply_from_emb`` in float64 (K1 is f32)."""
        m = self.model
        ctx = m.ctx_from_seq_emb(self._frozen_rows(seqs), (seqs == PADDING_IDX).to(torch.float32))
        score = m.train_apply_from_emb if self._x64 else m.apply_from_emb
        return lambda nodes: score(self._frozen_rows(nodes), ctx)

    # ------------------------------------------------------------------
    def _beam_trajectory_from(self, logits_fn, b: int):
        """Frozen-model beam trajectories (OTMTree.beamSearchNodes):
        (nodes [n_levels, B, 2*beam], scores [...]), -1 / NEG_INF pads."""
        width = 2 * self.beam
        s = self.start_level
        init = torch.arange((1 << s) - 1, (1 << (s + 1)) - 1, device=self.device)
        first = torch.full((width,), -1, dtype=torch.long, device=self.device)
        first[: 2 * len(init)] = torch.stack([2 * init + 1, 2 * init + 2], -1).reshape(-1)
        nodes = first.expand(b, width)
        scores = torch.where(nodes >= 0, logits_fn(nodes), NEG_INF)
        all_nodes, all_scores = [nodes], [scores]
        for _ in range(1, self.n_levels):
            top_idx = torch.topk(scores, self.beam, dim=1).indices
            top_codes = torch.gather(nodes, 1, top_idx)
            nodes = torch.stack([2 * top_codes + 1, 2 * top_codes + 2], -1).reshape(b, width)
            scores = logits_fn(nodes)
            all_nodes.append(nodes)
            all_scores.append(scores)
        return torch.stack(all_nodes), torch.stack(all_scores)

    def _pseudo_targets_from(self, logits_fn, target_items: torch.Tensor):
        """Bottom-up optimal pseudo targets (OTMTree.optimalPseudoTargets).
        ``target_items`` [B, J] leaf codes (-1 pad).  Returns (ids, labels),
        each [n_levels, B, J]; index i <-> tree level start_level+1+i."""
        ids = target_items.long()
        labels = (ids >= 0).to(self.dtype)
        out_ids, out_labels = [ids], [labels]
        for _ in range(self.n_levels - 1):
            valid = ids >= 0
            sib = torch.where(valid, torch.where(ids % 2 == 1, ids + 1, ids - 1), -1)
            # sibling's current label when the sibling is also a target node
            eq = ids[:, None, :] == torch.where(valid, sib, -2)[:, :, None]
            sib_label = torch.einsum("bjk,bk->bj", eq.to(labels.dtype), labels)
            pos_pred = logits_fn(ids)
            neg_pred = logits_fn(sib)
            contrib = torch.where(pos_pred >= neg_pred, labels, sib_label)
            contrib = torch.where(valid, contrib, 0.0)
            parents = torch.where(valid, (ids - 1) >> 1, -1)
            ids, labels = _row_group_parents(parents, contrib)
            out_ids.append(ids)
            out_labels.append(labels)
        # built bottom-up: reverse so index 0 = level start_level+1
        return torch.stack(out_ids[::-1]), torch.stack(out_labels[::-1])

    def _normal_targets(self, target_items: torch.Tensor):
        """Plain ancestor targets (OTMTree.normalTargets): the ancestor of
        each target at every level, label 1."""
        ids_levels, labels_levels = [], []
        cur = target_items.long()
        for _ in range(self.n_levels):
            ids_levels.append(cur)
            labels_levels.append((cur >= 0).to(self.dtype))
            cur = torch.where(cur >= 0, (cur - 1) >> 1, -1)
        return torch.stack(ids_levels[::-1]), torch.stack(labels_levels[::-1])

    @torch.no_grad()
    def _targets_and_trajectory(self, seqs: torch.Tensor, targets: torch.Tensor):
        """One batch's frozen part: (t_ids, t_labels, nodes), all from the
        parameters before the batch's first level step."""
        with profiling.span("otm.frozen"):
            logits_fn = self._frozen_scorer(seqs)
            if self.target_mode == "pseudo":
                t_ids, t_labels = self._pseudo_targets_from(logits_fn, targets)
            else:
                t_ids, t_labels = self._normal_targets(targets)
            nodes, _ = self._beam_trajectory_from(logits_fn, seqs.shape[0])
            return t_ids, t_labels, nodes

    def _train_batch(self, seqs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """One whole OTM batch: pseudo/normal targets and the frozen-model
        beam trajectory, then the sequential per-level BCE + Adam steps.
        Returns the per-level losses [n_levels] on the device."""
        with profiling.span("otm.batch"):
            profiling.count("otm.batches")
            t_ids, t_labels, nodes = self._targets_and_trajectory(seqs, targets)
            losses = []
            for lvl in range(self.n_levels):
                labels, valid = level_labels(nodes[lvl], t_ids[lvl], t_labels[lvl], self.dtype)
                losses.append(self.step_from_samples(
                    seqs, torch.where(valid, nodes[lvl], -1), labels, valid.to(self.dtype)))
            return torch.stack(losses)

    # ------------------------------------------------------------------
    def train(
        self,
        num_epochs: int,
        progress_interval: int = 0,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
    ) -> list[dict]:
        """Epochs over the train windows in ``np.random.default_rng(seed)``
        order; per-epoch logs with the JAX package's keys.  Leaves the pmv
        mirror synced.  ``checkpoint_path``/``checkpoint_every`` (in
        batches) snapshot the loop state for a bit-exact resume
        (``train/step_resume.py``); the epoch a kill lands in resumes mid-
        epoch, and that epoch's log lacks the skipped batches' losses."""
        d = self.data
        n = len(d.train_seqs)
        rng = np.random.default_rng(self.seed)
        logs: list[dict] = []
        self._adopt_mirrors()
        start_epoch, start_bi = 1, 0
        if checkpoint_path:
            loaded = step_resume.load_step_state(checkpoint_path, self._local_step_state())
            if loaded is not None:
                st, meta = loaded
                self._restore_step_state(st)
                step_resume.rng_state_from_json(rng, meta["rng_before_perm"])
                start_epoch, start_bi = int(meta["epoch"]), int(meta["batch"]) + 1
                logger.info(f"resumed step checkpoint {checkpoint_path} at epoch "
                            f"{start_epoch} batch {meta['batch']}")
        n_data = meshlib.data_size(self.mesh)
        for epoch in range(start_epoch, num_epochs + 1):
            rng_before_perm = step_resume.rng_state_to_json(rng)
            perm = rng.permutation(n)
            epoch_losses: list[list[float]] = []
            t0 = time.perf_counter()
            num_batches = math.ceil(n / self.train_batch_size)
            # a window of in-flight level losses, fetched 8 batches late, so
            # the host enqueues ahead of the device
            inflight: deque = deque()

            def drain() -> None:
                epoch_losses.append(inflight.popleft().cpu().double().tolist())

            bi0, start_bi = start_bi, 0  # a resume lands mid-epoch once
            for bi in range(bi0, num_batches):
                idx = perm[bi * self.train_batch_size : (bi + 1) * self.train_batch_size]
                # ragged epoch tail: a mesh batch must split over "data"
                idx = idx[: len(idx) // n_data * n_data]
                if len(idx) == 0:
                    continue
                targets_np = d.train_labels[idx]
                if targets_np.shape[1] > self.label_num:
                    # ragged one_user_sample labels: pad each batch only to
                    # its own max (power-of-2 bucketed), as the JAX package
                    jmax = int((targets_np >= 0).sum(axis=1).max(initial=0))
                    width = max(self.label_num, 1 << max(jmax - 1, 0).bit_length())
                    targets_np = targets_np[:, : min(width, targets_np.shape[1])]
                inflight.append(self._batch_fn(self._codes(d.train_seqs[idx]),
                                               self._codes(targets_np)))
                if len(inflight) >= 8:
                    drain()
                if checkpoint_path and checkpoint_every > 0 \
                        and (bi + 1) % checkpoint_every == 0 and bi + 1 < num_batches:
                    step_resume.save_step_state(
                        checkpoint_path, self._step_state(),
                        {"epoch": epoch, "batch": bi, "rng_before_perm": rng_before_perm},
                        self.mesh)
                if progress_interval > 0 and (bi + 1) % progress_interval == 0:
                    if not epoch_losses:
                        drain()
                    logger.info(
                        f"Epoch {epoch} iter {bi + 1}/{num_batches} "
                        f"loss(last level, batch {len(epoch_losses)}): "
                        f"{epoch_losses[-1][-1]:.4f}"
                    )
            while inflight:
                drain()
            ev = self.evaluate()
            logs.append({
                "epoch": epoch,
                "time": time.perf_counter() - t0,
                "level_losses": [float(np.mean([lo[i] for lo in epoch_losses]))
                                 for i in range(self.n_levels)],
                "eval_loss": ev.loss,
                "precision": ev.precision,
                "recall": ev.recall,
                "ndcg": ev.ndcg,
            })
            logger.info(
                f"Epoch {epoch} time {logs[-1]['time']:.1f}s "
                f"losses {['%.4f' % x for x in logs[-1]['level_losses']]} "
                f"eval loss {ev.loss:.4f} metrics {ev}"
            )
        self._sync_mirrors()
        return logs

    # ------------------------------------------------------------------
    def _packed_search(self):
        """The packed pair-table loop (K3 per level for DIN) over the OTM
        complete tree, on an f32 table: every heap slot exists and the id
        lanes carry the leaf code
        itself; validity and consumed filtering stay in recommend_batch.
        Rebuilt when the embedding's identity or in-place version changes.
        The JAX package's contraction levels (ROADMAP item f) give the same
        results and are not ported."""
        emb = self.model.embedding
        key = (id(emb), emb._version)
        if self._packed_cache is not None and self._packed_cache[0] == key:
            return self._packed_cache[1]
        total = self.data.num_tree_nodes
        s = self.start_level
        start = np.arange((1 << s) - 1, (1 << (s + 1)) - 1, dtype=np.int64)
        padded = np.concatenate([start, np.full(2 * self.beam - len(start), -1)])
        cfg = TreeBeamConfig(beam=self.beam, max_level=self.leaf_level, start_level=s,
                             start_codes_padded=tuple(int(c) for c in padded))
        table = build_pair_table(emb.detach(), np.ones(total, dtype=bool),
                                 np.arange(total, dtype=np.int64), total)
        fn = make_packed_beam_fn(PackedTree(pair_table=table, embed_size=self.embed_size,
                                            cfg=cfg), type(self.model).precompute_seq)
        self._packed_cache = (key, fn)
        return fn

    @with_whole_table
    def batch_beam_search(self, seqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Final-level candidates [B, 2*beam] (codes) and their scores: the
        packed loop in f32, the frozen trajectory's last level in the f64
        mode (float64 plain ops, as the JAX package keeps f64 off its packed
        path)."""
        codes = self._codes(seqs)
        if self._x64 or self.n_levels < 1:
            with torch.no_grad():
                nodes, scores = self._beam_trajectory_from(self._frozen_scorer(codes),
                                                           len(codes))
            return nodes[-1].cpu().numpy(), scores[-1].cpu().numpy()
        ids, scores = self._packed_search()(self.model, codes)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def recommend_batch(
        self,
        seqs: np.ndarray,
        topk: int | None = None,
        consumed: list[np.ndarray] | None = None,
        return_codes: bool = False,
        with_scores: bool = False,
    ):
        """Top-k per row; candidates filtered to existing leaves (allNodes)
        and non-consumed (otm Evaluator.scala:58-66)."""
        k = topk or self.topk
        nodes, scores = self.batch_beam_search(seqs)
        out = []
        all_nodes = self.data.all_nodes
        for i in range(len(nodes)):
            ids, sc = nodes[i], scores[i].copy()
            ok = (ids >= 0) & (ids < len(all_nodes))
            ok &= np.where(ok, all_nodes[np.clip(ids, 0, len(all_nodes) - 1)], False)
            if consumed is not None and len(consumed[i]) > 0:
                ok &= ~np.isin(ids, consumed[i])
            idx = np.flatnonzero(ok)
            order = idx[np.argsort(-sc[idx], kind="stable")][:k]
            codes = ids[order]
            if return_codes:
                out.append((codes, sc[order]) if with_scores else codes)
            else:
                items = np.asarray([self.data.code_to_item[int(c)] for c in codes],
                                   dtype=np.int64)
                out.append((items, sc[order]) if with_scores else items)
        return out

    @with_whole_table
    def evaluate(self) -> OTMEvalResult:
        """Eval parity with otm Evaluator.evaluate: beam search per eval
        sample, consumed + validity filter, top-k; loss = summed BCE of the
        top-k scores against membership labels / eval size; metrics averaged,
        vectorized over each batch."""
        d = self.data
        m = len(d.eval_seqs)
        if m == 0:
            return OTMEvalResult()
        all_nodes = d.all_nodes
        max_consumed = max(
            (len(d.user_consumed.get(int(u), ())) for u in d.eval_users), default=0
        )
        total_loss = 0.0
        prec = rec = ndcg = 0.0
        k = self.topk
        for s in range(0, m, self.eval_batch_size):
            e = min(s + self.eval_batch_size, m)
            b = e - s
            ids, scores = self.batch_beam_search(d.eval_seqs[s:e])
            ok = (ids >= 0) & (ids < len(all_nodes))
            ok &= np.where(ok, all_nodes[np.clip(ids, 0, len(all_nodes) - 1)], False)
            if max_consumed > 0:
                cons = np.full((b, max_consumed), -1, dtype=np.int64)
                for i, u in enumerate(d.eval_users[s:e]):
                    c = d.user_consumed.get(int(u), ())
                    cons[i, : len(c)] = c
                ok &= ~(ids[:, :, None] == cons[:, None, :]).any(-1)
            masked = np.where(ok, scores.astype(np.float64), -np.inf)
            order = np.argsort(-masked, axis=1, kind="stable")[:, :k]
            codes = np.take_along_axis(ids, order, axis=1)
            sc = np.take_along_axis(masked, order, axis=1)
            sel = np.isfinite(sc)
            codes = np.where(sel, codes, -1)

            labels = d.eval_labels[s:e]
            is_pos = (
                (codes[:, :, None] == labels[:, None, :]) & (labels >= 0)[:, None, :]
            ).any(-1)
            x = np.where(sel, sc, 0.0)
            total_loss += float(np.sum(np.where(
                sel, np.maximum(x, 0) - x * is_pos + np.log1p(np.exp(-np.abs(x))), 0.0)))
            p, r, nd = compute_metrics_batch(codes, labels)
            prec += float(p.sum())
            rec += float(r.sum())
            ndcg += float(nd.sum())
        return OTMEvalResult(
            loss=total_loss / m, precision=prec / m, recall=rec / m, ndcg=ndcg / m
        )
