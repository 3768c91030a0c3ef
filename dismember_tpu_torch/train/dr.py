"""Deep Retrieval E-step training, evaluation and serving.

Port of ``dismember_tpu/train/dr.py`` (deep-retrieval's
LocalOptimizer.scala:19-269).  Per batch, (a) the layer model trains on
(sample x path) rows with the sum of its D softmax cross-entropies (the
reference's per-head backward accumulation gives the same gradient) and
(b) the rerank model trains with the sampled softmax, its softmax
projection treated as ordinary parameters under the same Adam.  Every step
gathers the touched embedding rows once and differentiates w.r.t. them and
the dense weights (plain PyTorch under autograd; no kernel differentiates).

Three routes for the item-scaled tables (layer embedding, rerank
embedding, softmax w and b), chosen as the JAX package chooses them:
- dense: optax's Adam over every parameter (duplicate-row gradients summed
  by ``sparse_adam.dedup_rows``, in a fixed order);
- split sparse: lazy row-sparse Adam (``sparse_adam.apply_rows``) on the
  embeddings and softmax weights, dense Adam on the rest;
- pmv (auto at deep catalogs): the layer embedding, the rerank embedding
  and the [V, E+1] softmax ``w|b`` table each live in packed p|m|v rows,
  and every step commits each of the three through K2
  (``ops/row_writer.write_rows``): three K2 launches an E-step.  The [V, E]
  params are then MIRRORS, re-read from the packed state by
  ``_sync_mirrors`` at epoch, eval and train-end boundaries; a mirror
  replaced from outside (a checkpoint load) is detected by tensor identity
  and in-place version and pushed back into the p lanes at ``train``
  entry and before a sync.  As in the JAX package, the folded bias gets lazy Adam, not the
  dense route's.

On a mesh (``train/spmd_dr.py``) a rank holds only its "model" slice of
each packed table, and the four mirrors are empty placeholders between
boundaries: ``evaluate`` and the recommend calls run inside
:meth:`DRTrainer.whole_table`, which all-gathers the tables for the call
and drops them afterwards.

Negatives are drawn from the trainer's ``torch.Generator`` (seeded
``seed + 1`` at ``train`` entry), not JAX's PRNG; the steps take them as
given, so one draw can feed this package and the JAX package.  Batches come
in ``np.random.default_rng(seed).permutation`` order, as in the JAX package.
Serving (evaluate's recommend leg) is ``retrieval/dr_serve.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import numpy as np
import torch

from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.core.checkpoint import flatten
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.core.mesh import with_whole_table
from dismember_tpu_torch.core.metrics import compute_metrics, compute_metrics_batch
from dismember_tpu_torch.data.dr_dataset import DRData
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.models import dr_models
from dismember_tpu_torch.models.losses import cross_entropy
from dismember_tpu_torch.retrieval.path_beam import path_beam_search
from dismember_tpu_torch.train import sparse_adam, spmd_dr, spmd_sparse, step_resume

logger = logging.getLogger("dismember_tpu_torch.dr")

_MIRRORS = ("layer_embedding", "rerank_embedding", "softmax_w", "softmax_b")


@dataclasses.dataclass
class DREvalResult:
    layer_loss: list[float]
    rerank_loss: float
    precision: float
    recall: float
    ndcg: float

    def __str__(self) -> str:
        ll = ", ".join(f"{x:.4f}" for x in self.layer_loss)
        return (
            f"{{layer loss: [{ll}], rerank loss: {self.rerank_loss:.4f}, "
            f"precision: {self.precision:.6f}, recall: {self.recall:.6f}, "
            f"ndcg: {self.ndcg:.6f}}}"
        )


def _adam_init(tree) -> dict:
    """optax.adam's state for the leaves of ``tree``, keyed by their
    checkpoint paths."""
    named = flatten(tree)
    return {"count": 0, "mu": {n: torch.zeros_like(v) for n, v in named.items()},
            "nu": {n: torch.zeros_like(v) for n, v in named.items()}}


def _adam_apply(state: dict, params: dict, grads: dict, lr: float) -> None:
    """optax.adam(lr, 0.9, 0.999, 1e-8) on the named ``params`` (updated in
    place) with ``grads`` of the same names."""
    state["count"] += 1
    for n, g in grads.items():
        state["mu"][n], state["nu"][n], upd = sparse_adam.adam_update(
            state["mu"][n], state["nu"][n], g, state["count"], lr)
        params[n].add_(upd)


def _dense_grad(table: torch.Tensor, codes: torch.Tensor, g_rows: torch.Tensor) -> torch.Tensor:
    """The table's gradient from per-occurrence row gradients ([R] codes,
    -1 dropped): duplicates summed in a fixed order, zeros elsewhere."""
    codes_u, g_sum, live = sparse_adam.dedup_rows(codes, g_rows.reshape(len(codes), -1))
    grad = torch.zeros_like(table).reshape(table.shape[0], -1)
    grad[codes_u[live]] = g_sum[live]
    return grad.reshape(table.shape)


def _leaves(tree) -> dict:
    """{name: detached leaf that requires grad} for differentiating ``tree``."""
    return {n: v.detach().requires_grad_() for n, v in flatten(tree).items()}


def _heads_of(named: dict, num_layers: int) -> list:
    return [{"weight": named[f"heads/{d}/weight"], "bias": named[f"heads/{d}/bias"]}
            for d in range(num_layers)]


class DRTrainer:
    def __init__(
        self,
        data: DRData,
        num_layers: int = 3,
        num_nodes: int = 100,
        num_paths_per_item: int = 2,
        embed_size: int = 16,
        learning_rate: float = 3e-3,
        train_batch_size: int = 8192,
        eval_batch_size: int = 8192,
        num_sampled: int = 1,
        topk: int = 10,
        beam_size: int = 20,
        seq_len: int = 10,
        seed: int = 0,
        path_index: PathIndex | None = None,
        sparse_embed_update: bool | None = None,
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        """The JAX package's ``DRTrainer`` on ``device`` (CUDA by default).

        ``sparse_embed_update``: None = auto (``sparse_adam.sparse_worthwhile``
        on the layer step's B*(L + J*(D-1)) touched rows of the
        num_items + K*(D-1)-row table); True takes pmv when E and E+1 both
        pack (3*(E+1) <= 128), the split format otherwise.  Initial weights
        come from a ``torch.Generator`` on ``device`` seeded ``seed``; the
        path index from ``PathIndex.random_init(..., seed)``, the JAX
        package's draws.

        ``mesh``: a ("data", "model") DeviceMesh (``core/mesh.py``): the
        three item-scaled tables row-shard on "model" in the pmv format
        (``train/spmd_dr.py``) and their mirrors are dropped
        (:meth:`whole_table`), batches split on "data" (their sizes
        rounded to a multiple of it, a ragged epoch tail cut to one), each
        data shard draws its negatives from its own (seed, step, data
        index) stream, and ``evaluate`` serves through the sharded block
        route.  Only widths whose E and E+1 pack p|m|v (3(E+1) <= 128)."""
        self.mesh = mesh
        self.device = meshlib.trainer_device(mesh, resolve_device(device))
        if mesh is not None and not (sparse_adam.pmv_slots(embed_size)
                                     and sparse_adam.pmv_slots(embed_size + 1)):
            raise ValueError(
                f"mesh mode needs p|m|v-packable widths; E={embed_size} does not pack "
                "(3*E and 3*(E+1) must fit 128 lanes)")
        n_data = meshlib.data_size(mesh)
        self.data = data
        self.num_layers = num_layers
        self.num_nodes = num_nodes
        self.num_paths = num_paths_per_item
        self.embed_size = embed_size
        self.seq_len = seq_len
        self.topk = topk
        self.beam = beam_size
        self.num_sampled = num_sampled
        self.seed = seed
        self.learning_rate = learning_rate
        self.num_targets_per_batch = max(1, train_batch_size // num_paths_per_item)
        self.num_targets_per_batch = max(n_data, self.num_targets_per_batch // n_data * n_data)
        self.eval_targets_per_batch = max(1, eval_batch_size // num_paths_per_item)
        self.eval_targets_per_batch = max(n_data, self.eval_targets_per_batch // n_data * n_data)
        self.path_index = path_index or PathIndex.random_init(
            data.num_items, num_layers, num_nodes, num_paths_per_item, seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.layer_params = dr_models.init_layer_params(
            gen, data.num_items, num_nodes, num_layers, seq_len, embed_size, self.device)
        self.rerank_params = dr_models.init_rerank_params(
            gen, data.num_items, seq_len, embed_size, self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        if sparse_embed_update is not None:
            self._sparse = sparse_embed_update
        else:
            touched = self.num_targets_per_batch * (
                seq_len + num_paths_per_item * (num_layers - 1))
            self._sparse = sparse_adam.sparse_worthwhile(
                data.num_items + num_nodes * (num_layers - 1), touched, embed_dim=embed_size)
        if mesh is not None:
            self._sparse = True
        self._pmv = (self._sparse and sparse_adam.pmv_slots(embed_size) > 0
                     and sparse_adam.pmv_slots(embed_size + 1) > 0)
        self._mirrors_stale = False
        self._mesh_steps = 0
        lp, rp = self.layer_params, self.rerank_params
        if mesh is not None:
            (self._layer_step, self._rerank_step, self.layer_opt_state,
             self.rerank_opt_state) = spmd_dr.make_sharded_dr_steps(self, mesh)
            self._drop_tables()
        elif self._pmv:
            self.layer_opt_state = (_adam_init({"heads": lp["heads"]}),
                                    sparse_adam.pmv_init(lp["embedding"]))
            # softmax weights and bias train as ONE [V, E+1] packed table
            self.rerank_opt_state = (_adam_init({"linear": rp["linear"]}),
                                     sparse_adam.pmv_init(rp["embedding"]),
                                     sparse_adam.pmv_init(self._wb_mirror()))
            self._record_mirror_ids()
        elif self._sparse:
            self.layer_opt_state = (_adam_init({"heads": lp["heads"]}),
                                    sparse_adam.init_state(lp["embedding"]))
            self.rerank_opt_state = (
                _adam_init({"linear": rp["linear"], "softmax_b": rp["softmax_b"]}),
                sparse_adam.init_state(rp["embedding"]),
                sparse_adam.init_state(rp["softmax_w"]))
        else:
            self.layer_opt_state = _adam_init(lp)
            self.rerank_opt_state = _adam_init(rp)

    # ------------------------------------------------------------------
    def _ids(self, a) -> torch.Tensor:
        """Ids, windows or paths as an int64 tensor on the trainer's device."""
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    def sample_negatives(self, labels: torch.Tensor) -> torch.Tensor:
        """[B] labels -> [B, num_sampled] negatives from the trainer's
        generator; on a mesh, this rank's labels from its data shard's
        stream at the current step."""
        gen = self._gen
        if self.mesh is not None:
            gen = spmd_sparse.shard_generator(
                self.seed, self._mesh_steps, meshlib.axis_index(self.mesh, meshlib.DATA_AXIS),
                self.device)
        return dr_models.sample_negatives(gen, labels, self.data.num_items, self.num_sampled)

    def _layer_codes(self, seqs: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
        """[B*L + B*J*(D-1)] rows the layer step touches (-1 = padding):
        the sequence items, then path node i at ``num_items + i*K + node``."""
        prefix = dr_models.prefix_rows(paths, self.data.num_items, self.num_nodes,
                                       self.num_layers - 1)
        return torch.cat([seqs.reshape(-1).long(), prefix.reshape(-1)])

    def _layer_losses_from_rows(self, rows, heads, paths) -> torch.Tensor:
        b, j = paths.shape[:2]
        nb = b * self.seq_len
        e = self.embed_size
        logits = dr_models.layer_logits_from_emb(
            heads, rows[:nb].view(b, self.seq_len, e),
            rows[nb:].view(b, j, self.num_layers - 1, e), self.num_nodes)
        return torch.stack([cross_entropy(lg.reshape(-1, self.num_nodes),
                                          paths[:, :, d].reshape(-1))
                            for d, lg in enumerate(logits)])

    @torch.no_grad()
    def _layer_losses(self, seqs: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
        logits = dr_models.layer_forward_training(self.layer_params, seqs, paths,
                                                  self.data.num_items, self.num_nodes)
        return torch.stack([cross_entropy(lg.reshape(-1, self.num_nodes),
                                          paths[:, :, d].reshape(-1))
                            for d, lg in enumerate(logits)])

    def _layer_step(self, seqs: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
        """One layer-model step on sequences [B, L] and paths [B, J, D];
        returns the D losses (before the update)."""
        lp, e = self.layer_params, self.embed_size
        flat = self._layer_codes(seqs, paths)
        valid = flat >= 0
        safe = torch.where(valid, flat, 0)
        if self._pmv:
            rows = sparse_adam.pmv_gather(self.layer_opt_state[1]["pmv"], safe, e)
        else:
            rows = lp["embedding"][safe]
        rows = (rows * valid[:, None]).requires_grad_()
        heads = _leaves({"heads": lp["heads"]})
        with torch.enable_grad():
            losses = self._layer_losses_from_rows(rows, _heads_of(heads, self.num_layers), paths)
            g_rows, *g_heads = torch.autograd.grad(losses.sum(), [rows, *heads.values()])
        g_rows = g_rows * valid[:, None]
        grads = dict(zip(heads, g_heads))
        with torch.no_grad():
            lr = self.learning_rate
            if not self._sparse:
                grads["embedding"] = _dense_grad(lp["embedding"], flat, g_rows)
                _adam_apply(self.layer_opt_state, flatten(lp), grads, lr)
                return losses.detach()
            heads_opt, emb_state = self.layer_opt_state
            _adam_apply(heads_opt, flatten({"heads": lp["heads"]}), grads, lr)
            if self._pmv:
                sparse_adam.pmv_apply_rows(emb_state, flat, g_rows, lr)
                self._mirrors_stale = True
            else:
                sparse_adam.apply_rows(lp["embedding"], emb_state, flat, g_rows, lr)
        return losses.detach()

    def _rerank_step(self, seqs: torch.Tensor, labels: torch.Tensor,
                     negs: torch.Tensor) -> torch.Tensor:
        """One rerank step: the sampled softmax of ``labels`` [B] against
        the negatives [B, S]; returns the loss (before the update)."""
        rp, e = self.rerank_params, self.embed_size
        b = seqs.shape[0]
        cand = torch.cat([labels.long()[:, None], negs.long()], 1)  # [B, 1+S]
        c = cand.shape[1]
        seq_flat = seqs.reshape(-1).long()
        seq_valid = seq_flat >= 0
        safe = torch.where(seq_valid, seq_flat, 0)
        if self._pmv:
            _, emb_state, wb_state = self.rerank_opt_state
            erows = sparse_adam.pmv_gather(emb_state["pmv"], safe, e)
            wb = sparse_adam.pmv_gather(wb_state["pmv"], cand.reshape(-1), e + 1)
        else:
            erows = rp["embedding"][safe]
            wb = torch.cat([rp["softmax_w"][cand], rp["softmax_b"][cand][..., None]], -1)
        erows = (erows * seq_valid[:, None]).requires_grad_()
        wb = wb.reshape(b, c, e + 1).requires_grad_()
        linear = _leaves({"linear": rp["linear"]})
        with torch.enable_grad():
            vec = dr_models.user_vector_from_emb(
                {"weight": linear["linear/weight"], "bias": linear["linear/bias"]},
                erows.view(b, -1, e))
            logits = dr_models.sampled_logits(vec, wb[..., :e], wb[..., e])
            loss = -torch.log_softmax(logits, dim=-1)[:, 0].mean()
            g_e, g_wb, *g_lin = torch.autograd.grad(loss, [erows, wb, *linear.values()])
        g_e = g_e * seq_valid[:, None]
        grads = dict(zip(linear, g_lin))
        cflat = cand.reshape(-1)
        g_wb = g_wb.reshape(-1, e + 1)
        with torch.no_grad():
            lr = self.learning_rate
            if not self._sparse:
                grads["embedding"] = _dense_grad(rp["embedding"], seq_flat, g_e)
                grads["softmax_w"] = _dense_grad(rp["softmax_w"], cflat, g_wb[:, :e])
                grads["softmax_b"] = _dense_grad(rp["softmax_b"], cflat, g_wb[:, e])
                _adam_apply(self.rerank_opt_state, flatten(rp), grads, lr)
            elif self._pmv:
                rest_opt, emb_state, wb_state = self.rerank_opt_state
                _adam_apply(rest_opt, flatten({"linear": rp["linear"]}), grads, lr)
                sparse_adam.pmv_apply_rows(emb_state, seq_flat, g_e, lr)
                sparse_adam.pmv_apply_rows(wb_state, cflat, g_wb, lr)
                self._mirrors_stale = True
            else:
                rest_opt, emb_opt, w_opt = self.rerank_opt_state
                grads["softmax_b"] = _dense_grad(rp["softmax_b"], cflat, g_wb[:, e])
                _adam_apply(rest_opt, flatten({"linear": rp["linear"],
                                               "softmax_b": rp["softmax_b"]}), grads, lr)
                sparse_adam.apply_rows(rp["embedding"], emb_opt, seq_flat, g_e, lr)
                sparse_adam.apply_rows(rp["softmax_w"], w_opt, cflat, g_wb[:, :e].contiguous(),
                                       lr)
        return loss.detach()

    def _estep_fused(self, seqs, paths, labels, negs):
        """The E-step of the pmv route: the layer step, then the rerank step,
        with the same state updates as calling them apart (the JAX package
        fuses them into one dispatch; PyTorch runs eagerly).  Returns
        (layer losses, rerank loss)."""
        return self._layer_step(seqs, paths), self._rerank_step(seqs, labels, negs)

    def _serve_sharded(self, serve, seqs: torch.Tensor, consumed: torch.Tensor) -> torch.Tensor:
        """A mesh's sharded serving of a global eval batch: padded with
        copies of its first row to a "data" multiple, each rank serving its
        rows, the items all-gathered back in row order."""
        b = seqs.shape[0]
        pad = (-b) % meshlib.data_size(self.mesh)
        if pad:
            seqs = torch.cat([seqs, seqs[:1].expand(pad, -1)])
            consumed = torch.cat([consumed, consumed[:1].expand(pad, -1)])
        items, _ = serve(self.layer_params, self.rerank_params,
                         meshlib.data_rows(seqs, self.mesh), meshlib.data_rows(consumed, self.mesh))
        return meshlib.all_gather_rows(items, self.mesh, meshlib.DATA_AXIS)[:b]

    # -- pmv mirrors --------------------------------------------------------
    def _wb_mirror(self) -> torch.Tensor:
        """[V, E+1] softmax projection: weights with the bias as last lane."""
        rp = self.rerank_params
        return torch.cat([rp["softmax_w"], rp["softmax_b"][:, None]], 1)

    def _mirror_tensors(self) -> dict:
        lp, rp = self.layer_params, self.rerank_params
        return dict(zip(_MIRRORS, (lp["embedding"], rp["embedding"], rp["softmax_w"],
                                   rp["softmax_b"])))

    def _record_mirror_ids(self) -> None:
        """Remember the mirror tensors handed out (identity and in-place
        version), so _adopt_mirrors can tell an external assignment or copy
        (a checkpoint load) from the mirrors the trainer made itself."""
        self._mirror_ids = {k: (t, t._version) for k, t in self._mirror_tensors().items()}

    def _replaced_mirrors(self) -> set[str]:
        return {k for k, t in self._mirror_tensors().items()
                if t is not self._mirror_ids[k][0] or t._version != self._mirror_ids[k][1]}

    def _sync_mirrors(self) -> None:
        """Re-materialize the [V, E] param mirrors from the packed p|m|v
        state (no-op outside pmv mode, on a mesh, or when already in sync).
        A mirror replaced from outside since the last sync is adopted
        first, so a checkpoint load is never overwritten by older packed
        rows."""
        if not self._pmv or self.mesh is not None or not self._mirrors_stale:
            return
        self._adopt_mirrors()
        e, n = self.embed_size, self.data.num_items
        _, layer_emb = self.layer_opt_state
        _, rerank_emb, wb_state = self.rerank_opt_state
        self.layer_params["embedding"] = sparse_adam.pmv_unpack(
            layer_emb, n + self.num_nodes * (self.num_layers - 1), e)
        self.rerank_params["embedding"] = sparse_adam.pmv_unpack(rerank_emb, n, e)
        self._set_wb(sparse_adam.pmv_unpack(wb_state, n, e + 1))
        self._mirrors_stale = False
        self._record_mirror_ids()

    def _set_wb(self, wb: torch.Tensor) -> None:
        e = self.embed_size
        self.rerank_params["softmax_w"] = wb[:, :e].contiguous()
        self.rerank_params["softmax_b"] = wb[:, e].contiguous()

    @contextlib.contextmanager
    def whole_table(self):
        """The four item-scaled params (layer and rerank embeddings, softmax
        w and b) hold their whole tables inside the block.  Off a mesh they
        always do (re-read from the packed states in pmv mode).  On a mesh a
        rank holds only its slices between blocks: the tables are
        all-gathered over "model" on entry, so every rank enters together,
        and dropped on exit; blocks nest."""
        if self.mesh is None or self.rerank_params["embedding"].shape[0]:
            self._sync_mirrors()
            yield self
            return
        _, layer_emb = self.layer_opt_state
        _, rerank_emb, wb_state = self.rerank_opt_state
        self.layer_params["embedding"] = layer_emb.unpack()
        self.rerank_params["embedding"] = rerank_emb.unpack()
        self._set_wb(wb_state.unpack())
        try:
            yield self
        finally:
            self._drop_tables()

    def _drop_tables(self) -> None:
        """On a mesh: the four item-scaled params back to empty
        placeholders."""
        lp, rp = self.layer_params, self.rerank_params
        lp["embedding"] = lp["embedding"].new_empty(0, self.embed_size)
        rp["embedding"] = rp["embedding"].new_empty(0, self.embed_size)
        rp["softmax_w"] = rp["softmax_w"].new_empty(0, self.embed_size)
        rp["softmax_b"] = rp["softmax_b"].new_empty(0)

    def _adopt_mirrors(self) -> None:
        """Push externally assigned param mirrors into the packed state's p
        lanes (moments kept).  Called at train() entry and by
        _sync_mirrors.  When the packed state is newer (steps driven without
        _sync_mirrors) the external values still win, with a warning, and
        the mirrors stay marked stale: the next sync re-reads every table,
        the adopted ones included.  On a mesh the whole tables found in the
        params (a load) go into the rank's slices and are dropped."""
        if self.mesh is not None:
            lp, rp = self.layer_params, self.rerank_params
            _, layer_emb = self.layer_opt_state
            _, rerank_emb, wb_state = self.rerank_opt_state
            if lp["embedding"].shape[0]:
                layer_emb.refresh(lp["embedding"])
            if rp["embedding"].shape[0]:
                rerank_emb.refresh(rp["embedding"])
            if rp["softmax_w"].shape[0]:
                wb_state.refresh(self._wb_mirror())
            self._drop_tables()
            return
        if not self._pmv:
            return
        replaced = self._replaced_mirrors()
        if not replaced:
            return
        if self._mirrors_stale:
            logger.warning(
                "param mirrors %s were externally replaced while the packed p|m|v "
                "state was newer; adopting the external values into the packed "
                "state (moments kept). softmax w/b adopt jointly.", sorted(replaced))
        _, layer_emb = self.layer_opt_state
        _, rerank_emb, wb_state = self.rerank_opt_state
        if "layer_embedding" in replaced:
            sparse_adam.pmv_refresh(layer_emb, self.layer_params["embedding"])
        if "rerank_embedding" in replaced:
            sparse_adam.pmv_refresh(rerank_emb, self.rerank_params["embedding"])
        if replaced & {"softmax_w", "softmax_b"}:
            sparse_adam.pmv_refresh(wb_state, self._wb_mirror())
        self._record_mirror_ids()

    def load_params(self, layer: dict, rerank: dict) -> None:
        """Take layer and rerank param pytrees of arrays (either package's
        checkpoints through ``load_pytree``); in pmv mode the next train()
        adopts them into the packed state, on a mesh this call does (each
        rank keeps its rows; every rank loads the same arrays)."""
        self.layer_params, self.rerank_params = dr_models.dr_params_from_numpy(
            layer, rerank, self.device)
        if self.mesh is not None:
            self._adopt_mirrors()

    # -- step-level snapshots (train/step_resume.py) ----------------------
    _MIRROR_KEYS = ("embedding", "softmax_w", "softmax_b")

    _OPT_KEYS = ("layer_opt_state", "rerank_opt_state")

    def _local_step_state(self) -> dict:
        """The loop state a within-stage snapshot holds, as this rank holds
        it.  In pmv mode the packed p|m|v states own the item tables, so the
        [V, E] mirrors (layer and rerank embeddings, softmax w and b) are
        left out; on a mesh each packed state is the rank's slice."""
        lp, rp = self.layer_params, self.rerank_params
        if self._pmv:
            lp = {k: v for k, v in lp.items() if k != "embedding"}
            rp = {k: v for k, v in rp.items() if k not in self._MIRROR_KEYS}
        local = lambda opt: opt if self.mesh is None else tuple(  # noqa: E731
            x.state if isinstance(x, spmd_dr.ShardedPmv) else x for x in opt)
        return {"layer_params": lp, "layer_opt_state": local(self.layer_opt_state),
                "rerank_params": rp, "rerank_opt_state": local(self.rerank_opt_state),
                "gen": step_resume.generator_state(self._gen)}

    def _step_state(self) -> dict:
        """:meth:`_local_step_state`; on a mesh with each row-sharded packed
        state gathered over "model" into the layout of a single-device
        trainer's (a collective: every rank calls it)."""
        st = self._local_step_state()
        if self.mesh is not None:
            for k in self._OPT_KEYS:
                st[k] = tuple(
                    spmd_sparse.whole_state(x.state, x.v_rows, x.e, self.mesh)
                    if isinstance(x, spmd_dr.ShardedPmv) else part
                    for x, part in zip(getattr(self, k), st[k]))
        return st

    def _restore_step_state(self, loaded: dict) -> None:
        """Take a snapshot's state (numpy leaves in the layout of
        :meth:`_step_state`); on a mesh each rank takes its rows of the
        packed states."""
        like = self._local_step_state()
        st = {k: step_resume.to_torch(loaded[k], v) for k, v in like.items()
              if k not in self._OPT_KEYS or self.mesh is None}
        for k in self._OPT_KEYS if self.mesh is not None else ():
            parts = []
            for x, part, got in zip(getattr(self, k), like[k], loaded[k]):
                if isinstance(x, spmd_dr.ShardedPmv):
                    spmd_sparse.restore_state(x.state, got, self.mesh)
                    parts.append(x)
                else:
                    parts.append(step_resume.to_torch(got, part))
            st[k] = type(like[k])(parts)
        self.layer_opt_state = st["layer_opt_state"]
        self.rerank_opt_state = st["rerank_opt_state"]
        step_resume.set_generator_state(self._gen, st["gen"])
        if self._pmv:
            self.layer_params = dict(st["layer_params"],
                                     embedding=self.layer_params["embedding"])
            self.rerank_params = dict(st["rerank_params"],
                                      **{k: self.rerank_params[k] for k in self._MIRROR_KEYS})
            self._mirrors_stale = True
            self._record_mirror_ids()
        else:
            self.layer_params, self.rerank_params = st["layer_params"], st["rerank_params"]

    # ------------------------------------------------------------------
    def train(self, num_epochs: int, progress_interval: int = 0,
              rerank_epochs: int | None = None, checkpoint_path: str | None = None,
              checkpoint_every: int = 0) -> list[DREvalResult]:
        """``rerank_epochs`` mirrors the reference's ``reRankStoppingEpoch``
        (dr LocalOptimizer.scala:35-38,88-96): rerank training stops after
        that many epochs while the layer model keeps training.

        ``checkpoint_path``/``checkpoint_every`` (in batches) snapshot the
        loop state for a bit-exact resume (``train/step_resume.py``)."""
        self._adopt_mirrors()
        d = self.data
        n = len(d.train_seqs)
        rng = np.random.default_rng(self.seed)
        self._gen.manual_seed(self.seed + 1)
        self._mesh_steps = 0
        results: list[DREvalResult] = []
        self.train_loss_log: list[dict] = []
        bsz = self.num_targets_per_batch
        n_data = meshlib.data_size(self.mesh)
        rerank_stop = rerank_epochs if rerank_epochs is not None else num_epochs
        start_epoch, start_s = 1, 0
        if checkpoint_path:
            loaded = step_resume.load_step_state(checkpoint_path, self._local_step_state())
            if loaded is not None:
                st, meta = loaded
                self._restore_step_state(st)
                step_resume.rng_state_from_json(rng, meta["rng_before_perm"])
                start_epoch, start_s = int(meta["epoch"]), int(meta["s"]) + bsz
                self._mesh_steps = step_resume.saved_steps(meta, self.mesh)
                logger.info(f"resumed step checkpoint {checkpoint_path} at epoch "
                            f"{start_epoch} offset {meta['s']}")
        for epoch in range(start_epoch, num_epochs + 1):
            rng_before_perm = step_resume.rng_state_to_json(rng)
            perm = rng.permutation(n)
            t0 = time.perf_counter()
            it = 0
            layer_sum = torch.zeros(self.num_layers, device=self.device)
            rerank_sum = torch.zeros((), device=self.device)
            s0, start_s = start_s, 0  # a resume lands mid-epoch once
            rows = lambda a: meshlib.data_rows(self._ids(a), self.mesh)  # noqa: E731
            for s in range(s0, n, bsz):
                # ragged epoch tail: a mesh batch must split over "data"
                idx = perm[s : s + bsz]
                idx = idx[: len(idx) // n_data * n_data]
                if len(idx) == 0:
                    continue
                seqs = rows(d.train_seqs[idx])
                targets = d.train_targets[idx]
                paths = rows(self.path_index.item_paths[targets])
                if epoch <= rerank_stop:
                    labels = rows(targets)
                    losses, rloss = self._estep_fused(seqs, paths, labels,
                                                      self.sample_negatives(labels))
                    rerank_sum += rloss
                else:
                    losses, rloss = self._layer_step(seqs, paths), float("nan")
                self._mesh_steps += 1
                layer_sum += losses
                it += 1
                if checkpoint_path and checkpoint_every > 0 and it % checkpoint_every == 0 \
                        and s + bsz < n:
                    step_resume.save_step_state(
                        checkpoint_path, self._step_state(),
                        {"epoch": epoch, "s": s, "rng_before_perm": rng_before_perm,
                         "steps": self._mesh_steps}, self.mesh)
                    logger.info(f"step checkpoint saved at epoch {epoch} offset {s}")
                if progress_interval > 0 and it % progress_interval == 0:
                    ll = ", ".join(f"{float(x):.4f}" for x in losses)
                    logger.info(f"Epoch {epoch} iter {it}: layer loss [{ll}], "
                                f"rerank loss {float(rloss):.4f}")
            self.train_loss_log.append({
                "layer_loss": (layer_sum / max(it, 1)).tolist(),
                "rerank_loss": (float(rerank_sum) if epoch <= rerank_stop else float("nan"))
                / max(it, 1)})
            ev = self.evaluate()
            logger.info(f"Epoch {epoch} time {time.perf_counter() - t0:.1f}s metrics {ev}")
            results.append(ev)
        self._sync_mirrors()
        return results

    # ------------------------------------------------------------------
    @with_whole_table
    def beam_search_paths_async(self, seqs: np.ndarray):
        """One beam-search batch as device tensors (paths [B, beam, D],
        probs [B, beam]), without waiting for the device."""
        return path_beam_search(self.layer_params, self._ids(seqs), self.beam,
                                self.data.num_items, self.num_nodes, self.num_layers)

    def beam_search_paths(self, seqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        paths, probs = self.beam_search_paths_async(seqs)
        return paths.cpu().numpy(), probs.cpu().numpy()

    @torch.no_grad()
    @with_whole_table
    def recommend_batch(self, seqs: np.ndarray, topk: int | None = None,
                        consumed: list[np.ndarray] | None = None,
                        path_to_items: dict[tuple, list[int]] | None = None) -> list[np.ndarray]:
        """The host route: beam search on the device, then each query's
        items through the ``path_to_items`` dict, deduplicated in path
        order, reranked and cut to top-k on the host."""
        k = topk or self.topk
        p2i = path_to_items if path_to_items is not None else self.path_index.path_to_items()
        paths, _probs = self.beam_search_paths(seqs)
        user_vecs = dr_models.rerank_user_vector(self.rerank_params, self._ids(seqs)).cpu().numpy()
        sw = self.rerank_params["softmax_w"].cpu().numpy()
        sb = self.rerank_params["softmax_b"].cpu().numpy()
        out: list[np.ndarray] = []
        for i in range(len(seqs)):
            cands: list[int] = []
            seen: set[int] = set()
            for path in paths[i]:
                for item in p2i.get(tuple(int(x) for x in path), ()):
                    if item not in seen:
                        seen.add(item)
                        cands.append(item)
            if consumed is not None and len(consumed[i]) > 0:
                cset = set(int(x) for x in consumed[i])
                cands = [c for c in cands if c not in cset]
            if not cands:
                out.append(np.empty(0, np.int64))
                continue
            carr = np.asarray(cands, dtype=np.int64)
            scores = sw[carr] @ user_vecs[i] + sb[carr]
            out.append(carr[np.argsort(-scores, kind="stable")[:k]])
        return out

    @torch.no_grad()
    @with_whole_table
    def evaluate(self) -> DREvalResult:
        """Eval parity with dr Evaluator.evaluate: per-batch layer CE vector,
        the exact-softmax rerank loss and recall/precision/nDCG of the
        device serving function with the consumed filter (the host route
        when the dense path table does not fit)."""
        from dismember_tpu_torch.retrieval.dr_serve import make_dr_serving_fn

        d = self.data
        m = len(d.eval_seqs)
        if m == 0:
            return DREvalResult([0.0] * self.num_layers, 0.0, 0.0, 0.0, 0.0)
        if self.mesh is not None:
            serve = spmd_dr.make_sharded_dr_serving_fn(self, self.mesh, topk=self.topk)
        else:
            serve = make_dr_serving_fn(self, topk=self.topk)
        p2i = None if serve is not None else self.path_index.path_to_items()
        max_consumed = max((len(d.user_consumed.get(int(u), ())) for u in d.eval_users),
                           default=0)
        layer_loss = np.zeros(self.num_layers)
        rerank_loss = prec = rec = ndcg = 0.0
        bsz = self.eval_targets_per_batch
        for s in range(0, m, bsz):
            e = min(s + bsz, m)
            seqs_np = d.eval_seqs[s:e]
            seqs = self._ids(seqs_np)
            targets = self._ids(d.eval_labels[s:e, 0])
            paths = self._ids(self.path_index.item_paths[d.eval_labels[s:e, 0]])
            layer_loss += self._layer_losses(seqs, paths).cpu().numpy() * (e - s)
            rp = self.rerank_params
            rerank_loss += float(dr_models.full_softmax_loss(
                rp, dr_models.rerank_user_vector(rp, seqs), targets)) * (e - s)
            if serve is not None:
                cons = np.full((e - s, max(max_consumed, 1)), -1, dtype=np.int64)
                for i, u in enumerate(d.eval_users[s:e]):
                    c = d.user_consumed.get(int(u), ())
                    cons[i, : len(c)] = c
                if self.mesh is not None:
                    items = self._serve_sharded(serve, seqs, self._ids(cons))
                else:
                    items, _sc = serve(self.layer_params, rp, seqs, self._ids(cons))
                p, r, nd = compute_metrics_batch(items.cpu().numpy(), d.eval_labels[s:e])
                prec += float(p.sum())
                rec += float(r.sum())
                ndcg += float(nd.sum())
            else:
                consumed = [d.user_consumed.get(int(u), np.empty(0, np.int64))
                            for u in d.eval_users[s:e]]
                recs = self.recommend_batch(seqs_np, topk=self.topk, consumed=consumed,
                                            path_to_items=p2i)
                for i, r in enumerate(recs):
                    labels = d.eval_labels[s + i]
                    p, rcl, nd = compute_metrics(r, labels[labels >= 0])
                    prec += p
                    rec += rcl
                    ndcg += nd
        return DREvalResult(layer_loss=(layer_loss / m).tolist(), rerank_loss=rerank_loss / m,
                            precision=prec / m, recall=rec / m, ndcg=ndcg / m)
