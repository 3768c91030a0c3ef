"""Serving facades: load persisted artifacts, score and recommend.

Port of ``TDMServing`` and ``OTMServing`` from ``dismember_tpu/serving.py``.
TDM (TDM.scala's ``predict`` = sigmoid scores, ``recommend`` = beam search +
consumed filter + top-k): trees with ``max_level >= 8`` serve through the
packed pair-table loop (K3 per level), smaller ones through the classic
loop (K1 per level); ``predict`` scores through K1.  A DeepFM checkpoint
serves on the same routes with its levels scored in plain ops (it has no
kernel).  The pair table is f32, or bf16 where the f32 table would pass
``TDMServing._BF16_TABLE_BYTES`` (4 GB: a 10M-item catalog's 8.6 GB table
becomes 4.3 GB) and the scorer is matmul-first (DIN), the JAX facade's
rule; K3 reads either.  OTM (OTM.scala) serves through its trainer's
packed loop over the complete tree (K3 per level for DIN), in raw item-id
space.
"""

from __future__ import annotations

import numpy as np
import torch

from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.core.checkpoint import load_meta, load_pytree
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.data.dr_dataset import build_dr_data
from dismember_tpu_torch.data.otm_dataset import build_otm_data, load_mapping
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.ops.din_kernel import check_kernel_width
from dismember_tpu_torch.retrieval.dr_serve import make_dr_serving_fn
from dismember_tpu_torch.retrieval.packed_beam import (
    PackedTree,
    build_pair_table,
    make_packed_beam_fn,
    pair_row_width,
)
from dismember_tpu_torch.retrieval.tree_beam import (
    filter_topk,
    is_deep_catalog,
    make_beam_fn,
    make_config,
)
from dismember_tpu_torch.train.dr import DRTrainer
from dismember_tpu_torch.train.otm import OTMTrainer
from dismember_tpu_torch.train.tdm import (
    MATMUL_FIRST_SCORERS,
    build_model,
    packed_fns,
    serving_fns,
)


class TDMServing:
    def __init__(self, params, forward, tree: ArrayTree, precompute=None,
                 apply=None, apply_emb=None, packed: bool | None = None,
                 packed_dtype: str | None = None, model_type: str | None = None,
                 topk: int = 10, candidate_num: int = 20):
        self.params = params  # the scorer module (DIN or DeepFM), on its device
        self.forward = forward
        self.tree = tree
        self.precompute = precompute
        self.apply = apply
        self.apply_emb = apply_emb
        # packed pair-table beam: None = auto (on for deep trees)
        self.packed = packed
        # pair-table lane dtype: "float32" | "bfloat16" | None = auto (bf16
        # when the f32 table would pass _BF16_TABLE_BYTES and the scorer is
        # matmul-first: its scores are the f32 table's)
        if packed_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"packed_dtype must be None, 'float32' or 'bfloat16', "
                             f"got {packed_dtype!r}")
        self.packed_dtype = packed_dtype
        # the model's name when known; None (direct construction) counts as
        # matmul-first, as in the JAX facade
        self.model_type = model_type
        self.topk = topk
        self.candidate_num = candidate_num
        self.device = params.embedding.device
        check_kernel_width(params.model_type, params.embed_size, self.device)
        self._beam_fns: dict[int, object] = {}
        self._pair_table = None

    _BF16_TABLE_BYTES = 4 << 30  # the auto rule's threshold for the f32 table

    @classmethod
    def load(cls, model_path: str, tree_path: str, device="cuda",
             **kwargs) -> "TDMServing":
        """Load a checkpoint (either package's) and a tree file onto
        ``device``; raises if ``device`` is CUDA and there is none.
        ``kwargs`` (``packed``, ``packed_dtype``, ``topk``, ...) go to the
        constructor."""
        dev = resolve_device(device)
        tree = ArrayTree.from_file(tree_path)
        meta = load_meta(model_path)
        model = build_model(meta["model"], tree.max_level, meta["embed_size"],
                            meta["seq_len"], device=dev)
        model.load_numpy(load_pytree(model_path, model.param_tree()))
        pre, app = serving_fns(meta["model"])
        _, app_emb = packed_fns(meta["model"])
        kwargs.setdefault("model_type", meta["model"])
        return cls(model, type(model).forward, tree, precompute=pre, apply=app,
                   apply_emb=app_emb, **kwargs)

    @torch.inference_mode()
    def predict(self, sequence: np.ndarray, items: np.ndarray) -> np.ndarray:
        """Sigmoid scores of candidate items given a sequence (TDM.predict)."""
        seq_codes = self._codes(sequence[None, :])
        item_codes = self._codes(items[None, :])
        logits = self.forward(self.params, item_codes, seq_codes)
        return torch.sigmoid(logits[0]).cpu().numpy()

    def _codes(self, ids: np.ndarray) -> torch.Tensor:
        with profiling.span("serving.codes"):
            return torch.as_tensor(
                self.tree.ids_to_codes(ids), dtype=torch.long, device=self.device
            )

    def _use_packed(self, cn: int) -> bool:
        if self.apply_emb is None or self.precompute is None:
            return False
        if self.packed is not None:
            return self.packed
        return is_deep_catalog(self.tree, cn)

    def _matmul_first(self) -> bool:
        return self.model_type is None or self.model_type in MATMUL_FIRST_SCORERS

    def pair_table_dtype(self) -> torch.dtype:
        """The pair table's lane dtype: ``packed_dtype``, or the auto rule."""
        if self.packed_dtype is not None:
            return getattr(torch, self.packed_dtype)
        n_pairs = (self.tree.total_codes - 1) // 2
        f32_bytes = n_pairs * pair_row_width(self.params.embed_size) * 4
        if f32_bytes > self._BF16_TABLE_BYTES and self._matmul_first():
            return torch.bfloat16
        return torch.float32

    def _beam_fn(self, cn: int):
        if cn not in self._beam_fns:
            if self._use_packed(cn):
                if self._pair_table is None:
                    self._pair_table = build_pair_table(
                        self.params.embedding, self.tree.node_exists,
                        self.tree.node_id, self.tree.total_codes,
                        dtype=self.pair_table_dtype(),
                    )
                packed = PackedTree(
                    pair_table=self._pair_table,
                    embed_size=self.params.embed_size,
                    cfg=make_config(self.tree, cn),
                )
                self._beam_fns[cn] = make_packed_beam_fn(packed, self.precompute)
            else:
                self._beam_fns[cn] = make_beam_fn(
                    self.forward, self.tree, cn, precompute=self.precompute,
                    apply=self.apply, device=self.device,
                )
        return self._beam_fns[cn]

    def recommend(
        self,
        sequence: np.ndarray,
        topk: int | None = None,
        candidate_num: int | None = None,
        consumed: np.ndarray | None = None,
    ) -> np.ndarray:
        k = topk or self.topk
        cn = candidate_num or self.candidate_num
        if consumed is not None and len(consumed) > 0:
            cn = max((len(consumed) + k) // 2, cn)
        return self.recommend_batch(
            sequence[None, :], topk=k, candidate_num=cn,
            consumed=[consumed] if consumed is not None else None,
        )[0]

    def recommend_batch(
        self,
        seqs: np.ndarray,
        topk: int | None = None,
        candidate_num: int | None = None,
        consumed: list[np.ndarray] | None = None,
    ) -> list[np.ndarray]:
        with profiling.span("serving.recommend_batch"):
            profiling.count("serving.batches")
            k = topk or self.topk
            cn = candidate_num or self.candidate_num
            ids, scores = self._beam_fn(cn)(self.params, self._codes(seqs))
            with profiling.span("serving.download"):  # waits for the beam's last kernels
                ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
            return filter_topk(ids, scores, k, consumed)


class OTMServing:
    """OTM facade (otm/.../model/OTM.scala): load model + item<->leaf-code
    mapping, serve beam-search recommendations in raw item-id space."""

    def __init__(self, trainer: OTMTrainer):
        self._trainer = trainer

    @classmethod
    def load(
        cls, model_path: str, mapping_path: str, data_path: str,
        seq_len: int = 10, min_seq_len: int = 2, split_ratio: float = 0.8,
        label_num: int = 5, beam_size: int = 20, topk: int = 10, device="cuda",
    ) -> "OTMServing":
        """Load a checkpoint (either package's) and a mapping file onto
        ``device``; raises if ``device`` is CUDA and there is none."""
        dev = resolve_device(device)
        mapping = load_mapping(mapping_path)
        data = build_otm_data(
            data_path, seq_len, min_seq_len, split_ratio,
            label_num=label_num, mapping=mapping,
        )
        meta = load_meta(model_path)
        trainer = OTMTrainer(
            data, model_type=meta["model"], embed_size=meta["embed_size"],
            beam_size=beam_size, topk=topk, seq_len=meta["seq_len"], device=dev,
        )
        trainer.load_numpy(load_pytree(model_path, trainer.params))
        return cls(trainer)

    def recommend(
        self, sequence_items: np.ndarray, topk: int | None = None,
        consumed_items: np.ndarray | None = None,
    ) -> np.ndarray:
        """sequence/result in raw item-id space (codes mapped internally)."""
        t = self._trainer
        seq_codes = np.asarray(
            [t.data.item_to_code.get(int(i), -1) for i in sequence_items],
            dtype=np.int64,
        )
        consumed_codes = None
        if consumed_items is not None:
            consumed_codes = [np.asarray(
                [t.data.item_to_code[int(i)] for i in consumed_items
                 if int(i) in t.data.item_to_code], dtype=np.int64,
            )]
        return t.recommend_batch(
            seq_codes[None, :], topk=topk, consumed=consumed_codes
        )[0]


class DRServing:
    """Deep Retrieval facade (DeepRetrieval.scala): load the layer and
    rerank checkpoints and the ItemSet mapping, serve on the device or
    through the host dict route.

    The device closures are cached per (topk, beam), and each freezes the
    bf16 tables of its route (block table, seq pack, packed rows) when it is
    built while reading the heads and the f32 tables live, as the JAX
    package's ``DRServing`` does: a facade serves a loaded model, which
    nothing changes afterwards.  A caller that changes the trainer's
    embeddings or softmax rows drops ``_device_fns`` to serve them.
    The host route's path->items dict (a Python loop over every (item,
    path) pair) is built on that route's first call; the device route never
    reads it.

    Spans and counters (``core/profiling.py``, off by default): a device
    batch is ``dr_serving.recommend_batch`` (counter ``dr_serving.batches``)
    around ``dr_serving.upload`` (windows and consumed lists to the device),
    the closure's spans and ``dr_serving.download`` (the wait for the device
    and the copy); while recording, ``dr_serving.short_lists`` counts the
    rows served fewer than ``topk`` items."""

    def __init__(self, trainer: DRTrainer):
        self._trainer = trainer
        self._p2i: dict[tuple, list[int]] | None = None
        self._device_fns: dict[tuple, object] = {}

    def path_to_items(self) -> dict[tuple, list[int]]:
        """The host route's inverted map, built on its first use."""
        if self._p2i is None:
            self._p2i = self._trainer.path_index.path_to_items()
        return self._p2i

    def device_serving_fn(self, topk: int = 10, beam: int | None = None):
        """The device serving closure (``retrieval.dr_serve``); None when
        the dense path table is too big.  Cached per (topk, beam)."""
        key = (topk, beam)
        if key not in self._device_fns:
            self._device_fns[key] = make_dr_serving_fn(self._trainer, beam=beam, topk=topk)
        return self._device_fns[key]

    def recommend_batch_device(self, seqs: np.ndarray, topk: int = 10,
                               consumed=None) -> np.ndarray:
        """[B, L] dense-id windows -> [B, topk] dense item ids, -1 where a
        row has fewer items.  ``consumed``: the dense ids each row leaves
        out, a [B, C] array padded with -1 or a list of B arrays.  Where the
        dense path table does not fit, the rows go through the host route."""
        with profiling.span("dr_serving.recommend_batch"):
            profiling.count("dr_serving.batches")
            cons = _consumed_matrix(consumed)
            fn = self.device_serving_fn(topk=topk)
            if fn is None:
                ids = np.full((len(seqs), topk), -1, np.int64)
                for i, s in enumerate(seqs):
                    got = self.recommend(s, topk=topk,
                                         consumed=None if cons is None else cons[i][cons[i] >= 0])
                    ids[i, : len(got)] = got
            else:
                t = self._trainer
                with profiling.span("dr_serving.upload"):
                    seqs_t = t._ids(seqs)
                    cons_t = None if cons is None else t._ids(cons)
                ids, _scores = fn(t.layer_params, t.rerank_params, seqs_t, cons_t)
                with profiling.span("dr_serving.download"):  # waits for the device
                    ids = ids.cpu().numpy()
                if ids.shape[1] < topk:  # fewer candidate slots than topk
                    ids = np.pad(ids, ((0, 0), (0, topk - ids.shape[1])), constant_values=-1)
            if profiling.enabled():
                profiling.count("dr_serving.short_lists", int((ids[:, -1] < 0).sum()))
            return ids

    @classmethod
    def load(cls, model_path: str, mapping_path: str, data_path: str,
             seq_len: int = 10, min_seq_len: int = 2, split_ratio: float = 0.8,
             num_nodes: int = 100, device="cuda", **trainer_kwargs) -> "DRServing":
        """Load checkpoints (either package's) and a mapping onto
        ``device``; raises if ``device`` is CUDA and there is none."""
        dev = resolve_device(device)
        path_index, item_to_id = PathIndex.read(mapping_path, num_nodes)
        data = build_dr_data(data_path, seq_len, min_seq_len, split_ratio, item_to_id)
        meta = load_meta(model_path + ".layer")
        trainer = DRTrainer(
            data, num_layers=meta["num_layer"], num_nodes=meta["num_node"],
            num_paths_per_item=path_index.num_paths_per_item,
            embed_size=meta["embed_size"], seq_len=meta["seq_len"],
            path_index=path_index, device=dev, **trainer_kwargs)
        trainer.load_params(load_pytree(model_path + ".layer", trainer.layer_params),
                            load_pytree(model_path + ".rerank", trainer.rerank_params))
        return cls(trainer)

    def recommend(self, sequence: np.ndarray, topk: int = 10, beam_size: int | None = None,
                  consumed: np.ndarray | None = None) -> np.ndarray:
        """sequence/result in dense item-id space (map via data.item_to_id)."""
        if beam_size is not None:
            self._trainer.beam = beam_size
        return self._trainer.recommend_batch(
            sequence[None, :], topk=topk,
            consumed=[consumed] if consumed is not None else None,
            path_to_items=self.path_to_items(),
        )[0]


def _consumed_matrix(consumed) -> np.ndarray | None:
    """Consumed dense ids as a [B, C] array padded with -1, from such an
    array or a list of B arrays; None stays None."""
    if consumed is None or (isinstance(consumed, np.ndarray) and consumed.ndim == 2):
        return consumed
    rows = [np.asarray(c, np.int64).reshape(-1) for c in consumed]
    out = np.full((len(rows), max((len(r) for r in rows), default=0)), -1, np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out
