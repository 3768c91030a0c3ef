"""Flat config-file loading with the reference's key namespace.

Copy of the TDM, JTM, OTM and Deep Retrieval part of ``dismember_tpu/core/config.py``.  The reference
reads flat ``prefix.key value`` files (configs/*.conf) through
``Property.readConf`` (scalann utils/Property.scala:12-48) and converts them to
per-stage case classes (examples/.../tdm/package.scala:8-113); reference conf
files work verbatim, and each stage gets a typed dataclass.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Mapping

from dismember_tpu_torch.core.io import open_file


def read_conf(path: str, prefix: str) -> dict[str, str]:
    """Parse a flat conf file and return the keys under ``prefix``.

    Mirrors Property.readConf: lines are ``prefix.key<whitespace>value``; blank
    lines and lines starting with ``#`` are ignored.  Keys are returned without
    the prefix.
    """
    out: dict[str, str] = {}
    with open_file(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"^(\S+)\s+(.*)$", line)
            if not m:
                continue
            key, value = m.group(1), m.group(2).strip()
            if key.startswith(prefix + "."):
                out[key[len(prefix) + 1 :]] = value
    return out


def _get(conf: Mapping[str, str], key: str) -> str:
    """Required-key lookup, mirroring ``getOrStop``."""
    if key not in conf:
        raise KeyError(f"missing required config key: {key}")
    return conf[key]


def _bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes")


def _resolve(base_dir: str, p: str) -> str:
    """Paths in reference confs are relative to the project root."""
    if os.path.isabs(p):
        return p
    return os.path.join(base_dir, p)


@dataclasses.dataclass
class TreeInitParams:
    """``init.*`` keys (TDM/JTM initialize-tree stage)."""

    seq_len: int
    min_seq_len: int
    split_for_eval: bool
    split_ratio: float
    data_path: str
    train_path: str
    eval_path: str
    stat_path: str
    leaf_id_path: str
    tree_pb_path: str
    user_consumed_path: str

    @classmethod
    def from_conf(cls, conf: Mapping[str, str], base_dir: str = "") -> "TreeInitParams":
        return cls(
            seq_len=int(_get(conf, "seq_len")),
            min_seq_len=int(_get(conf, "min_seq_len")),
            split_for_eval=_bool(_get(conf, "split_for_eval")),
            split_ratio=float(_get(conf, "split_ratio")),
            data_path=_resolve(base_dir, _get(conf, "data_path")),
            train_path=_resolve(base_dir, _get(conf, "train_path")),
            eval_path=_resolve(base_dir, _get(conf, "eval_path")),
            stat_path=_resolve(base_dir, _get(conf, "stat_path")),
            leaf_id_path=_resolve(base_dir, _get(conf, "leaf_id_path")),
            tree_pb_path=_resolve(base_dir, _get(conf, "tree_protobuf_path")),
            user_consumed_path=_resolve(base_dir, _get(conf, "user_consumed_path")),
        )


@dataclasses.dataclass
class TDMModelParams:
    """``model.*`` keys for TDM/JTM deep-model training."""

    deep_model: str
    train_path: str
    eval_path: str
    tree_pb_path: str
    user_consumed_path: str
    evaluate_during_training: bool
    thread_number: int
    total_batch_size: int
    total_eval_batch_size: int
    seq_len: int
    layer_negative_counts: str
    sample_with_probability: bool
    start_sample_level: int
    sample_tolerance: int
    parallel_sample: bool
    embed_size: int
    learning_rate: float
    iteration_number: int
    show_progress_interval: int
    topk_number: int
    beam_size: int
    model_path: str
    embed_path: str

    @classmethod
    def from_conf(cls, conf: Mapping[str, str], base_dir: str = "") -> "TDMModelParams":
        return cls(
            deep_model=_get(conf, "deep_model").lower(),
            train_path=_resolve(base_dir, _get(conf, "train_path")),
            eval_path=_resolve(base_dir, _get(conf, "eval_path")),
            tree_pb_path=_resolve(base_dir, _get(conf, "tree_protobuf_path")),
            user_consumed_path=_resolve(base_dir, _get(conf, "user_consumed_path")),
            evaluate_during_training=_bool(_get(conf, "evaluate_during_training")),
            thread_number=int(conf.get("thread_number", "0")),
            total_batch_size=int(_get(conf, "total_batch_size")),
            total_eval_batch_size=int(_get(conf, "total_eval_batch_size")),
            seq_len=int(_get(conf, "seq_len")),
            layer_negative_counts=_get(conf, "layer_negative_counts"),
            sample_with_probability=_bool(_get(conf, "sample_with_probability")),
            start_sample_level=int(_get(conf, "start_sample_level")),
            sample_tolerance=int(conf.get("sample_tolerance", "20")),
            parallel_sample=_bool(conf.get("parallel_sample", "true")),
            embed_size=int(_get(conf, "embed_size")),
            learning_rate=float(_get(conf, "learning_rate")),
            iteration_number=int(_get(conf, "iteration_number")),
            show_progress_interval=int(_get(conf, "show_progress_interval")),
            topk_number=int(_get(conf, "topk_number")),
            beam_size=int(_get(conf, "beam_size")),
            model_path=_resolve(base_dir, _get(conf, "model_path")),
            embed_path=_resolve(base_dir, _get(conf, "embed_path")),
        )


@dataclasses.dataclass
class ClusterParams:
    """``cluster.*`` keys (TDM cluster-tree stage)."""

    embed_path: str
    tree_pb_path: str
    cluster_type: str  # "kmeans" | "spectral"
    cluster_iter: int
    parallel: bool
    thread_number: int

    @classmethod
    def from_conf(cls, conf: Mapping[str, str], base_dir: str = "") -> "ClusterParams":
        return cls(
            embed_path=_resolve(base_dir, _get(conf, "embed_path")),
            tree_pb_path=_resolve(base_dir, _get(conf, "tree_protobuf_path")),
            cluster_type=_get(conf, "cluster_type").lower(),
            cluster_iter=int(conf.get("cluster_iter", "10")),
            parallel=_bool(conf.get("parallel", "false")),
            thread_number=int(conf.get("thread_number", "0")),
        )


@dataclasses.dataclass
class JTMTreeParams:
    """``tree.*`` keys (JTM tree-learning stage)."""

    data_path: str
    model_path: str
    tree_pb_path: str
    deep_model: str
    gap: int
    seq_len: int
    hierarchical_preference: bool
    min_level: int
    thread_number: int

    @classmethod
    def from_conf(cls, conf: Mapping[str, str], base_dir: str = "") -> "JTMTreeParams":
        return cls(
            data_path=_resolve(base_dir, _get(conf, "data_path")),
            model_path=_resolve(base_dir, _get(conf, "model_path")),
            tree_pb_path=_resolve(base_dir, _get(conf, "tree_protobuf_path")),
            deep_model=_get(conf, "deep_model").lower(),
            gap=int(_get(conf, "gap")),
            seq_len=int(_get(conf, "seq_len")),
            hierarchical_preference=_bool(conf.get("hierarchical_preference", "false")),
            min_level=int(conf.get("min_level", "0")),
            thread_number=int(conf.get("thread_number", "0")),
        )


@dataclasses.dataclass
class OTMModelParams:
    """``model.*`` keys (OTM train stage)."""

    data_path: str
    model_path: str
    deep_model: str
    thread_number: int
    train_batch_size: int
    eval_batch_size: int
    embed_size: int
    learning_rate: float
    epoch_num: int
    topk_number: int
    beam_size: int
    show_progress_interval: int
    seq_len: int
    min_seq_len: int
    split_ratio: float
    leaf_init_mode: str
    initialize_mapping: bool
    mapping_path: str
    label_num: int
    target_mode: str
    seed: int

    @classmethod
    def from_conf(cls, conf: Mapping[str, str], base_dir: str = "") -> "OTMModelParams":
        return cls(
            data_path=_resolve(base_dir, _get(conf, "data_path")),
            model_path=_resolve(base_dir, _get(conf, "model_path")),
            deep_model=_get(conf, "deep_model").lower(),
            thread_number=int(conf.get("thread_number", "0")),
            train_batch_size=int(_get(conf, "train_batch_size")),
            eval_batch_size=int(_get(conf, "eval_batch_size")),
            embed_size=int(_get(conf, "embed_size")),
            learning_rate=float(_get(conf, "learning_rate")),
            epoch_num=int(_get(conf, "epoch_num")),
            topk_number=int(_get(conf, "topk_number")),
            beam_size=int(_get(conf, "beam_size")),
            show_progress_interval=int(_get(conf, "show_progress_interval")),
            seq_len=int(_get(conf, "seq_len")),
            min_seq_len=int(_get(conf, "min_seq_len")),
            split_ratio=float(_get(conf, "split_ratio")),
            leaf_init_mode=_get(conf, "leaf_init_mode").lower(),
            initialize_mapping=_bool(_get(conf, "initialize_mapping")),
            mapping_path=_resolve(base_dir, _get(conf, "mapping_path")),
            label_num=int(_get(conf, "label_num")),
            target_mode=_get(conf, "target_mode").lower(),
            seed=int(conf.get("seed", "42")),
        )


@dataclasses.dataclass
class OTMTreeParams:
    """``tree.*`` keys (OTM tree-construction stage)."""

    data_path: str
    model_path: str
    mapping_path: str
    deep_model: str
    gap: int
    label_num: int
    seq_len: int
    min_seq_len: int
    split_ratio: float
    thread_number: int

    @classmethod
    def from_conf(cls, conf: Mapping[str, str], base_dir: str = "") -> "OTMTreeParams":
        return cls(
            data_path=_resolve(base_dir, _get(conf, "data_path")),
            model_path=_resolve(base_dir, _get(conf, "model_path")),
            mapping_path=_resolve(base_dir, _get(conf, "mapping_path")),
            deep_model=_get(conf, "deep_model").lower(),
            gap=int(_get(conf, "gap")),
            label_num=int(_get(conf, "label_num")),
            seq_len=int(_get(conf, "seq_len")),
            min_seq_len=int(_get(conf, "min_seq_len")),
            split_ratio=float(_get(conf, "split_ratio")),
            thread_number=int(conf.get("thread_number", "0")),
        )


@dataclasses.dataclass
class DRModelParams:
    """``model.*`` keys (Deep Retrieval train stage)."""

    data_path: str
    model_path: str
    mapping_path: str
    thread_number: int
    train_batch_size: int
    eval_batch_size: int
    num_layer: int
    num_node: int
    num_path_per_item: int
    embed_size: int
    learning_rate: float
    epoch_num: int
    num_sampled: int
    topk_number: int
    beam_size: int
    show_progress_interval: int
    seq_len: int
    min_seq_len: int
    split_ratio: float
    initialize_mapping: bool

    @classmethod
    def from_conf(cls, conf: Mapping[str, str], base_dir: str = "") -> "DRModelParams":
        return cls(
            data_path=_resolve(base_dir, _get(conf, "data_path")),
            model_path=_resolve(base_dir, _get(conf, "model_path")),
            mapping_path=_resolve(base_dir, _get(conf, "mapping_path")),
            thread_number=int(conf.get("thread_number", "0")),
            train_batch_size=int(_get(conf, "train_batch_size")),
            eval_batch_size=int(_get(conf, "eval_batch_size")),
            num_layer=int(_get(conf, "num_layer")),
            num_node=int(_get(conf, "num_node")),
            num_path_per_item=int(_get(conf, "num_path_per_item")),
            embed_size=int(_get(conf, "embed_size")),
            learning_rate=float(_get(conf, "learning_rate")),
            epoch_num=int(_get(conf, "epoch_num")),
            num_sampled=int(_get(conf, "num_sampled")),
            topk_number=int(_get(conf, "topk_number")),
            beam_size=int(_get(conf, "beam_size")),
            show_progress_interval=int(_get(conf, "show_progress_interval")),
            seq_len=int(_get(conf, "seq_len")),
            min_seq_len=int(_get(conf, "min_seq_len")),
            split_ratio=float(_get(conf, "split_ratio")),
            initialize_mapping=_bool(_get(conf, "initialize_mapping")),
        )


@dataclasses.dataclass
class DRCoordinateParams:
    """``cd.*`` keys (Deep Retrieval coordinate-descent stage)."""

    data_path: str
    model_path: str
    mapping_path: str
    thread_number: int
    train_batch_size: int
    eval_batch_size: int
    num_layer: int
    num_node: int
    num_path_per_item: int
    seq_len: int
    min_seq_len: int
    split_ratio: float
    initialize_mapping: bool
    candidate_path_num: int
    iteration_num: int
    decay_factor: float
    penalty_factor: float
    penalty_poly_order: int
    train_mode: str

    @classmethod
    def from_conf(cls, conf: Mapping[str, str], base_dir: str = "") -> "DRCoordinateParams":
        return cls(
            data_path=_resolve(base_dir, _get(conf, "data_path")),
            model_path=_resolve(base_dir, _get(conf, "model_path")),
            mapping_path=_resolve(base_dir, _get(conf, "mapping_path")),
            thread_number=int(conf.get("thread_number", "0")),
            train_batch_size=int(_get(conf, "train_batch_size")),
            eval_batch_size=int(_get(conf, "eval_batch_size")),
            num_layer=int(_get(conf, "num_layer")),
            num_node=int(_get(conf, "num_node")),
            num_path_per_item=int(_get(conf, "num_path_per_item")),
            seq_len=int(_get(conf, "seq_len")),
            min_seq_len=int(_get(conf, "min_seq_len")),
            split_ratio=float(_get(conf, "split_ratio")),
            initialize_mapping=_bool(_get(conf, "initialize_mapping")),
            candidate_path_num=int(_get(conf, "candidate_path_num")),
            iteration_num=int(_get(conf, "iteration_num")),
            decay_factor=float(conf.get("decay_factor", "0.999")),
            penalty_factor=float(conf.get("penalty_factor", "3e-6")),
            penalty_poly_order=int(conf.get("penalty_poly_order", "4")),
            train_mode=conf.get("train_mode", "streaming").lower(),
        )
