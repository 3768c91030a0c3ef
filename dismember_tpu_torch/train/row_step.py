"""The train step on gathered embedding rows, its Adam state and the pmv
mirror: what the TDM and OTM trainers share.

A step takes a batch of candidate codes [B, U] (-1 invalid) with BCE labels
and weights, and the query sequences [B, L]:

    gather the touched embedding rows once (table, or packed p|m|v state)
    -> the scorer's forward [B, U] through its ``train_apply_from_emb``
       (DIN or DeepFM, the sequence side from its ``ctx_from_seq_emb``) and
       BCE-with-logits, differentiated w.r.t. the gathered rows and the
       scorer weights
    -> Adam: dense over the whole table (duplicate-row gradients summed by
       ``sparse_adam.dedup_rows``, so the step has no float atomics), or
       lazy row-sparse Adam on the touched rows (``train/sparse_adam.py``),
       whose packed formats commit through K2.

A bf16 table (``TDMTrainer(embed_dtype=torch.bfloat16)``) has its rows
upcast to f32 after the gather; its dense gradient and Adam step, and its
mv row updates, round as the JAX package's compiled CPU step does
(``train/sparse_adam.py``); pmv needs an f32 table.

In pmv mode the packed state owns the table and ``model.embedding`` is a
MIRROR: ``_sync_mirrors`` re-materializes it at eval/train boundaries and
``_adopt_mirrors`` pushes an external assignment (detected by the
Parameter's identity and in-place version) back into the p lanes, the JAX
package's contract.  The Adam state is optax's, so the JAX trainers' states
load as they are (:meth:`RowStepTrainer.load_numpy`).

On a mesh each rank keeps only its "model" block of the table (``_shard``)
with its moments or m|v state; ``model.embedding`` is an empty [0, E]
placeholder between boundaries.  ``evaluate``, ``recommend*`` and
``export_embeddings`` run inside :meth:`RowStepTrainer.whole_table`, which
all-gathers the table over "model" into the model for the call and drops
it afterwards; ``params`` hands out a gathered copy.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from dismember_tpu_torch.constants import PADDING_IDX
from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.core.checkpoint import flatten, to_numpy, to_tensor
from dismember_tpu_torch.models.losses import bce_with_logits
from dismember_tpu_torch.models.scorer import TreeScorer
from dismember_tpu_torch.train import sparse_adam, spmd, spmd_sparse, step_resume

logger = logging.getLogger("dismember_tpu_torch.train")


def _find_adam(state):
    """(count, mu, nu) of optax's ``ScaleByAdamState``, given as it is or
    inside a tuple (optax's chain state); None if there is none."""
    if all(hasattr(state, a) for a in ("count", "mu", "nu")):
        return state.count, state.mu, state.nu
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


class RowStepTrainer:
    """Mixin of the trainers: needs ``model`` (DIN or DeepFM),
    ``learning_rate``, ``embed_size`` and ``device``;
    :meth:`_init_optimizer` sets the rest."""

    model: TreeScorer
    # attributes holding something built from the whole table (dropped
    # with it on a mesh)
    _table_caches: tuple[str, ...] = ()

    def _init_optimizer(self, sparse: bool, sparse_format: str,
                        logical_rows: int | None = None) -> None:
        """Dense Adam, or lazy sparse Adam on the embedding in the mv or pmv
        format ("auto": pmv when the width packs, 3E <= 128, and the table
        is f32; mv for a bf16 table).  On a mesh the table is row-sharded:
        the rank keeps its rows in ``_shard`` and the model's embedding is
        dropped (:meth:`whole_table`); the sparse mode takes the sharded mv
        state, never pmv.  ``logical_rows``: the table's rows before a
        mesh's padding (snapshots hold those)."""
        self._sparse = sparse
        self._pmv = False
        self._mirrors_stale = False
        self.emb_state = None
        self._shard = None
        if sparse:
            if sparse_format not in ("auto", "mv", "pmv"):
                raise ValueError(f"unknown sparse_format {sparse_format!r}")
            packable = sparse_adam.pmv_slots(self.embed_size) > 0
            f32_table = self.model.embedding.dtype == torch.float32
            self._pmv = (packable and f32_table if sparse_format == "auto"
                         else sparse_format == "pmv") and self.mesh is None
            if self._pmv and not (packable and f32_table):
                raise ValueError(
                    f"pmv needs a packable width (3*E <= 128; E={self.embed_size}) "
                    "and an f32 table")
        table = self.model.embedding.detach()
        self._logical_rows = logical_rows or table.shape[0]
        if self.mesh is not None:
            self._shard = meshlib.local_rows(table, self.mesh).clone()
            self._table_rows = table.shape[0]
            self._drop_table()
            if sparse:
                n_model = meshlib.axis_size(self.mesh, meshlib.MODEL_AXIS)
                self.emb_state = spmd_sparse.sharded_state_zeros(
                    table.shape[0], self.embed_size, n_model, device=table.device)
                self._mesh_step = spmd_sparse.make_sharded_sparse_train_step(self)
            else:
                self._mesh_step = spmd.make_sharded_train_step(self)
        elif self._pmv:
            self.emb_state = sparse_adam.pmv_init(table)
            self._record_mirror_id()
        elif sparse:
            self.emb_state = sparse_adam.init_state(table)
        self.adam = self._adam_init()

    # ------------------------------------------------------------------
    def _named_params(self) -> dict[str, torch.nn.Parameter]:
        return flatten(self.model.param_tree())

    def _adam_names(self) -> list[str]:
        """Parameters the trainer's Adam state covers (all but the
        embedding in the sparse modes, whose rows have their own state)."""
        return [n for n in self._named_params() if not (self._sparse and n == "embedding")]

    def _shard_params(self) -> dict:
        """The parameters a step updates: the named parameters with the
        embedding replaced by this rank's table shard on a mesh."""
        p = self._named_params()
        if self._shard is not None:
            p["embedding"] = self._shard
        return p

    def _adam_init(self) -> dict:
        """optax.adam(mu_dtype=float32)'s state: moments in each parameter's
        dtype, but a bf16 table's mu in f32 (its nu stays bf16); on a mesh
        the table's moments cover its shard (they follow its rows)."""
        p = self._shard_params()
        names = self._adam_names()
        mu_dtype = lambda t: torch.float32 if t.dtype == torch.bfloat16 else t.dtype  # noqa: E731
        return {"count": 0,
                "mu": {n: torch.zeros_like(p[n], dtype=mu_dtype(p[n])) for n in names},
                "nu": {n: torch.zeros_like(p[n]) for n in names}}

    @property
    def params(self) -> dict:
        """The params pytree (the embedding is the mirror in pmv mode).  On
        a mesh the embedding is the whole table all-gathered over "model"
        for the caller: every rank reads ``params`` together."""
        tree = self.model.param_tree()
        if self._shard is not None and not self.model.embedding.shape[0]:
            tree = dict(tree, embedding=meshlib.full_rows(self._shard, self.mesh))
        return tree

    @contextlib.contextmanager
    def whole_table(self):
        """``model.embedding`` holds the whole [V, E] table inside the
        block.  Off a mesh it always does (re-read from the packed state in
        pmv mode).  On a mesh a rank holds only its shard between blocks:
        the table is all-gathered over "model" on entry, so every rank
        enters together, and dropped on exit with what was built from it;
        blocks nest."""
        if self._shard is None or self.model.embedding.shape[0]:
            self._sync_mirrors()
            yield self.model
            return
        self.model.embedding.data = meshlib.full_rows(self._shard, self.mesh)
        try:
            yield self.model
        finally:
            self._drop_table()

    def _drop_table(self) -> None:
        """On a mesh: the model's embedding back to its [0, E] placeholder,
        and the caches built from the whole table cleared."""
        emb = self.model.embedding
        emb.data = emb.data.new_empty(0, emb.shape[1])
        for name in self._table_caches:
            setattr(self, name, None)

    def _adopt_table(self) -> None:
        """On a mesh: take this rank's rows of a whole table found in the
        model's embedding (a load, or an assignment from outside) into the
        shard, and drop the table."""
        with torch.no_grad():
            self._shard.copy_(meshlib.local_rows(self.model.embedding.detach(), self.mesh))
        self._drop_table()

    def load_numpy(self, params: dict, opt_state=None) -> None:
        """Take a params pytree and, optionally, an optimizer state, as
        arrays: the JAX package's trainers' ``.params`` and ``.opt_state``
        load as they are (``jax.tree.map(np.asarray, ...)``).  The state is
        optax's Adam chain state (a tuple holding a ``ScaleByAdamState``) in
        the dense mode, and ``(that, {"pmv" | "mv" | "m", "v", "count"})`` in
        the sparse modes.  In pmv mode the packed state owns the table, and
        the embedding is re-read from it.  Arrays take each parameter's
        dtype.  On a mesh the arrays are whole (padded rows included) and
        each rank keeps its rows."""
        if self._shard is not None:
            emb = self.model.embedding
            emb.data = emb.data.new_empty(self._table_rows, emb.shape[1])
        self.model.load_numpy(params)
        if self._shard is not None:
            self._adopt_table()
        if opt_state is None:
            return  # pmv mode adopts the new mirror at the next train()
        rest = opt_state
        if self._sparse:
            rest, emb = opt_state
            want = {"pmv"} if self._pmv else set(self.emb_state) - {"count"}
            if set(emb) - {"count"} != want:
                raise ValueError(f"embedding state has {sorted(emb)}, expected {sorted(want)}")
            self.emb_state = {
                k: int(np.asarray(v)) if k == "count" else
                self._rows_of(torch.tensor(np.asarray(v, np.float32), device=self.device))
                for k, v in emb.items()
            }
        found = _find_adam(rest)
        if found is None:
            raise ValueError("no Adam state (count, mu, nu) in opt_state")
        count, mu, nu = found
        names = self._adam_names()
        like = self._adam_init()
        mu, nu = flatten(mu), flatten(nu)
        def conv(n, a, t):
            a = to_tensor(a, t.dtype, self.device)
            return (self._rows_of(a) if n == "embedding" else a).reshape(t.shape)

        self.adam = {"count": int(np.asarray(count)),
                     "mu": {n: conv(n, mu[n], like["mu"][n]) for n in names},
                     "nu": {n: conv(n, nu[n], like["nu"][n]) for n in names}}
        if self._pmv:
            self._mirrors_stale = True
            self._sync_mirrors()

    def _rows_of(self, t: torch.Tensor) -> torch.Tensor:
        """On a mesh, this rank's row block of a loaded row-sharded array
        (the JAX package's global arrays: every shard's rows in "model"
        order, the per-shard m|v tables stacked); off a mesh, ``t``."""
        return t if self._shard is None else meshlib.local_rows(t, self.mesh).clone()

    # -- step-level snapshots (train/step_resume.py) ----------------------
    def _local_step_state(self) -> dict:
        """The loop state a within-stage snapshot holds, as this rank holds
        it: the parameters (in pmv mode without the [V, E] mirror, which the
        packed state owns and which would double a deep catalog's snapshot;
        on a mesh the embedding is the rank's table shard), the Adam state,
        the embedding's sparse state and the trainer's generator, if any."""
        st = {"params": {n: p.detach() for n, p in self._shard_params().items()
                         if not (self._pmv and n == "embedding")},
              "adam": self.adam}
        if self.emb_state is not None:
            st["emb_state"] = self.emb_state
        if getattr(self, "_gen", None) is not None:
            st["gen"] = step_resume.generator_state(self._gen)
        return st

    def _step_state(self) -> dict:
        """:meth:`_local_step_state`; on a mesh with the table's row blocks
        (the shard, its moments or sparse state) gathered over "model" and
        cut to the table's logical rows, the layout a single-device trainer
        saves (a collective: every rank calls it)."""
        st = self._local_step_state()
        if self._shard is None:
            return st
        n = self._logical_rows
        st["params"]["embedding"] = meshlib.full_rows(self._shard, self.mesh)[:n]
        if "embedding" in self.adam["mu"]:
            st["adam"] = dict(self.adam, **{
                k: dict(self.adam[k], embedding=meshlib.full_rows(
                    self.adam[k]["embedding"], self.mesh)[:n]) for k in ("mu", "nu")})
        if self.emb_state is not None:
            st["emb_state"] = spmd_sparse.whole_state(self.emb_state, n, self.embed_size,
                                                      self.mesh)
        return st

    @torch.no_grad()
    def _restore_step_state(self, loaded: dict) -> None:
        """Take a snapshot's state (numpy leaves in the layout of
        :meth:`_step_state`); in pmv mode the mirror is marked stale and
        re-read from the packed state at the next sync."""
        if self._shard is not None:
            loaded = self._local_rows_of(loaded)
        like = {k: v for k, v in self._local_step_state().items() if k in loaded}
        st = step_resume.to_torch(loaded, like)
        named = self._shard_params()
        for n, t in st["params"].items():
            named[n].copy_(t)
        self.adam = st["adam"]
        if "emb_state" in st:
            self.emb_state = st["emb_state"]
        if "gen" in st:
            step_resume.set_generator_state(self._gen, st["gen"])
        if self._pmv:
            self._mirrors_stale = True
            self._record_mirror_id()

    def _local_rows_of(self, loaded: dict) -> dict:
        """On a mesh: a whole snapshot's table, its moments and its sparse
        state cut to this rank's rows (numpy leaves); the padding rows past
        the logical ones keep the trainer's values."""
        def local(cur: torch.Tensor, whole) -> np.ndarray:
            out = cur.detach().clone()
            meshlib.set_local_rows(out, to_tensor(whole), self.mesh)
            return to_numpy(out)

        out = dict(loaded, params=dict(loaded["params"], embedding=local(
            self._shard, loaded["params"]["embedding"])))
        if "embedding" in self.adam["mu"]:
            out["adam"] = dict(loaded["adam"], **{
                k: dict(loaded["adam"][k], embedding=local(
                    self.adam[k]["embedding"], loaded["adam"][k]["embedding"]))
                for k in ("mu", "nu")})
        if "emb_state" in loaded:
            state = {k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in self.emb_state.items()}
            spmd_sparse.restore_state(state, loaded["emb_state"], self.mesh)
            out["emb_state"] = {k: to_numpy(v) for k, v in state.items()}
        return out

    def _codes(self, codes: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(codes, dtype=torch.long, device=self.device)

    # ------------------------------------------------------------------
    def step_from_samples(self, seq_codes: torch.Tensor, codes: torch.Tensor,
                          labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """One train step on a batch of candidates; returns the loss (a 0-d
        tensor on the device, before the update).  On a mesh the batch is
        this rank's data rows and the loss the global one."""
        with profiling.span("row_step.step"):
            if self.mesh is not None:
                return self._mesh_step(seq_codes, codes, labels, weights)
            b, u = codes.shape
            e = self.embed_size
            flat = torch.cat([codes.reshape(-1), seq_codes.reshape(-1)])
            valid = flat != PADDING_IDX
            safe = torch.where(valid, flat, 0)
            if self._pmv:
                rows = sparse_adam.pmv_gather(self.emb_state["pmv"], safe, e)
            else:
                rows = self.model.embedding.detach()[safe]
                if rows.dtype == torch.bfloat16:
                    rows = rows.float()  # a bf16 table's rows compute in f32
            rows = rows * valid[:, None].to(rows.dtype)
            loss, g_rows, grads = self._row_loss_grads(rows, seq_codes, labels, weights, b, u)
            g_rows = g_rows * valid[:, None].to(g_rows.dtype)
            params = self._named_params()
            with torch.no_grad():
                if not self._sparse:
                    grads["embedding"] = self._dense_table_grad(flat, g_rows, b * u)
                self._adam_step(params, grads)
                lr = self.learning_rate
                if self._pmv:
                    sparse_adam.pmv_apply_rows(self.emb_state, flat, g_rows, lr)
                    self._mirrors_stale = True
                elif self._sparse:
                    sparse_adam.apply_rows(self.model.embedding.detach(), self.emb_state,
                                           flat, g_rows, lr)
            return loss.detach()

    def _row_loss_grads(self, rows: torch.Tensor, seq_codes: torch.Tensor, labels: torch.Tensor,
                        weights: torch.Tensor, b: int, u: int, denom=None):
        """The scorer's forward on gathered rows ([B*U candidate rows |
        B*L sequence rows]) and the BCE, differentiated: (loss, row grads
        [R, E], tower grads by name).  ``denom``: the BCE's normaliser when
        it is not this batch's own weight sum (a mesh's global one)."""
        l, e = seq_codes.shape[1], self.embed_size
        rows = rows.detach().requires_grad_()
        params = self._named_params()
        rest_names = [n for n in params if n != "embedding"]
        with torch.enable_grad():
            ctx = self.model.ctx_from_seq_emb(rows[b * u :].view(b, l, e),
                                              (seq_codes == PADDING_IDX).float())
            logits = self.model.train_apply_from_emb(rows[: b * u].view(b, u, e), ctx)
            loss = bce_with_logits(logits, labels, weights, denom=denom)
            g_rows, *g_rest = torch.autograd.grad(loss, [rows, *(params[n] for n in rest_names)])
        return loss.detach(), g_rows, dict(zip(rest_names, g_rest))

    def _dense_table_grad(self, flat: torch.Tensor, g_rows: torch.Tensor,
                          n_items: int, table: torch.Tensor | None = None) -> torch.Tensor:
        """The [V, E] gradient of ``table`` (the embedding by default; a
        mesh's table shard, with shard-local codes): per-occurrence row
        gradients summed per code in a fixed order (no float atomics), zeros
        elsewhere.  A bf16 table takes the JAX package's bf16 sums: the
        candidates' and the sequences' gathers each summed serially in bf16,
        then added."""
        table = self.model.embedding if table is None else table
        v_rows = table.shape[0]
        if table.dtype == torch.bfloat16:
            parts = [sparse_adam.serial_bf16_sums(flat[sl], g_rows[sl], v_rows)
                     for sl in (slice(0, n_items), slice(n_items, None))]
            return sparse_adam._bf16(parts[0] + parts[1])
        codes_u, g_sum, live = sparse_adam.dedup_rows(flat, g_rows)
        # dead slots go to a sink row past the table: no boolean mask, so
        # the step never waits for the card
        grad = torch.zeros(v_rows + 1, table.shape[1], device=table.device, dtype=table.dtype)
        grad[torch.where(live, codes_u, v_rows)] = g_sum
        return grad[:v_rows]

    def _adam_step(self, params: dict, grads: dict) -> None:
        """optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8) on ``grads``, in place."""
        st = self.adam
        st["count"] += 1
        for n, g in grads.items():
            if params[n].dtype == torch.bfloat16:
                p_new, st["mu"][n], st["nu"][n] = sparse_adam.adam_update_bf16(
                    params[n], st["mu"][n], st["nu"][n], g, st["count"], self.learning_rate)
                params[n].copy_(p_new)
                continue
            st["mu"][n], st["nu"][n], upd = sparse_adam.adam_update(
                st["mu"][n], st["nu"][n], g, st["count"], self.learning_rate)
            params[n].add_(upd)

    # -- pmv mirror management (the JAX package's contract) ---------------
    def _mirror_key(self) -> tuple[int, int]:
        # identity and in-place version: a replaced Parameter or a copy into
        # it (load_numpy) both count as an external assignment
        emb = self.model.embedding
        return id(emb), emb._version

    def _record_mirror_id(self) -> None:
        self._mirror_id = self._mirror_key()

    def _sync_mirrors(self) -> None:
        """Re-materialize the [V, E] embedding mirror from the packed p|m|v
        state; a no-op when already in sync (and on a mesh, which holds no
        mirror)."""
        if not self._mirrors_stale:
            return
        v_rows, e = self.model.embedding.shape
        with torch.no_grad():
            self.model.embedding.copy_(sparse_adam.pmv_unpack(self.emb_state, v_rows, e))
        self._mirrors_stale = False
        self._record_mirror_id()

    def _adopt_mirrors(self) -> None:
        """Push an externally assigned embedding into the packed state's p
        lanes (moments kept), or on a mesh a whole table assigned to the
        model into this rank's shard.  Called at train() entry.  If the
        packed state was newer (steps driven without _sync_mirrors), the
        external values win with a warning."""
        if self._shard is not None:
            if self.model.embedding.shape[0]:
                self._adopt_table()
            return
        if not self._pmv or self._mirror_key() == self._mirror_id:
            return
        if self._mirrors_stale:
            logger.warning(
                "embedding mirror was externally replaced while the packed "
                "p|m|v state was newer; adopting the external values (moments kept).")
        sparse_adam.pmv_refresh(self.emb_state, self.model.embedding.detach().float())
        self._mirrors_stale = False
        self._record_mirror_id()
