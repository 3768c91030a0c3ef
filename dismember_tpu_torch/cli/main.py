"""CLI entry points: the reference's TDM, JTM, OTM and Deep Retrieval commands.

Port of the ``tdm-*``, ``jtm-*``, ``otm-*`` and ``dr-*`` commands of
``dismember_tpu/cli/main.py``
(examples/ in the reference, SURVEY.md §2.6): same command names, same conf
keys (``--conf``; the reference's ``--tdmConfFile``/``--jtmConfFile``/
``--otmConfFile``/``--drConfFile`` are also accepted), same stage files, and the post-train recommend smoke test +
latency loop (examples/.../tdm/package.scala:115-126).  Conf paths resolve
against the working directory, as the reference's project-root-relative
``data/...`` paths expect.  Every command runs on ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).

Usage:  python -m dismember_tpu_torch.cli <command> --conf <file> [--device cpu] [--quiet]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

from dismember_tpu_torch.core import config as cfg
from dismember_tpu_torch.core.checkpoint import load_meta, load_pytree, save_pytree
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.core.io import open_file
from dismember_tpu_torch.data import tdm_dataset as tds
from dismember_tpu_torch.data.dr_dataset import build_dr_data
from dismember_tpu_torch.data.ingest import unique_items_with_category
from dismember_tpu_torch.data.otm_dataset import build_otm_data, load_mapping, save_mapping
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.cluster import cluster_tree_from_embeddings
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu_torch.train.dr import DRTrainer
from dismember_tpu_torch.train.dr_coordinate import coordinate_descent
from dismember_tpu_torch.train.jtm import TreeLearner, otm_tree_learner, write_projection_tree
from dismember_tpu_torch.train.otm import OTMTrainer
from dismember_tpu_torch.train.tdm import TDMTrainer, build_model

logger = logging.getLogger("dismember_tpu_torch.cli")

COMMANDS = {}


def command(name):
    def deco(fn):
        COMMANDS[name] = fn
        return fn

    return deco


def _conf_base(conf_path: str) -> str:
    """Reference confs use project-root-relative paths like data/xxx."""
    return os.getcwd()


# ---------------------------------------------------------------------------
# TDM / JTM shared stages
# ---------------------------------------------------------------------------


def _initialize_tree(conf_path: str) -> None:
    p = cfg.TreeInitParams.from_conf(cfg.read_conf(conf_path, "init"), _conf_base(conf_path))
    samples, raw = tds.generate_all(
        p.data_path, p.seq_len, p.min_seq_len, p.split_for_eval, p.split_ratio
    )
    tds.write_train_file(p.train_path, samples, split_mode=p.split_for_eval)
    if p.split_for_eval:
        tds.write_eval_file(p.eval_path, samples)
    tds.write_stat_file(p.stat_path, samples.stat)
    tds.write_user_consumed_file(p.user_consumed_path, samples.user_consumed)
    ids, cats = unique_items_with_category(raw)
    sorted_ids, codes = category_sorted_codes(ids, cats)
    with open_file(p.leaf_id_path, "w", encoding="utf-8") as f:
        for i in ids:
            f.write(f"{int(i)}\n")
    write_tree(p.tree_pb_path, sorted_ids, codes, stat=samples.stat)
    logger.info(
        f"tree initialized: {len(sorted_ids)} items -> {p.tree_pb_path}; "
        f"{len(samples.train_targets)} train / {len(samples.eval_users)} eval samples"
    )


def _train_deep_model(conf_path: str, device) -> None:
    p = cfg.TDMModelParams.from_conf(cfg.read_conf(conf_path, "model"), _conf_base(conf_path))
    tree = ArrayTree.from_file(p.tree_pb_path)
    train_seqs, train_targets = tds.read_train_file(p.train_path)
    eval_data = tds.read_eval_file(p.eval_path, p.seq_len)
    consumed = tds.read_user_consumed_file(p.user_consumed_path)
    trainer = TDMTrainer(
        tree=tree,
        model_type=p.deep_model,
        embed_size=p.embed_size,
        learning_rate=p.learning_rate,
        total_batch_size=p.total_batch_size,
        total_eval_batch_size=p.total_eval_batch_size,
        seq_len=p.seq_len,
        layer_neg_counts=p.layer_negative_counts,
        sample_with_prob=p.sample_with_probability,
        sample_tolerance=p.sample_tolerance,
        start_sample_level=p.start_sample_level,
        topk=p.topk_number,
        beam_size=p.beam_size,
        device=device,
    )
    trainer.train(
        train_seqs,
        train_targets,
        iterations=p.iteration_number,
        eval_data=eval_data if p.evaluate_during_training else None,
        user_consumed=consumed if p.evaluate_during_training else None,
        progress_interval=p.show_progress_interval,
    )
    save_pytree(
        p.model_path,
        trainer.params,
        meta={
            "model": p.deep_model,
            "embed_size": p.embed_size,
            "seq_len": p.seq_len,
            "tree_pb_path": p.tree_pb_path,
        },
    )
    trainer.export_embeddings(p.embed_path)
    _recommend_smoke(trainer, eval_data[0])


def _recommend_smoke(trainer: TDMTrainer, eval_seqs: np.ndarray) -> None:
    """Post-train smoke + latency loop (examples/.../tdm/package.scala:115)."""
    if len(eval_seqs) == 0:
        return
    seq = eval_seqs[0]
    rec = trainer.recommend(seq)
    logger.info(f"Recommendation result: {rec.tolist()}")
    n = 100
    start = time.perf_counter()
    for _ in range(n):
        trainer.recommend(seq)
    avg_ms = (time.perf_counter() - start) / n * 1e3
    logger.info(f"Average recommend time: {avg_ms:.4f}ms")


@command("tdm-initialize-tree")
def tdm_init_tree(args):
    _initialize_tree(args.conf)


@command("tdm-train-deep-model")
def tdm_train(args):
    _train_deep_model(args.conf, args.device)


@command("tdm-cluster-tree")
def tdm_cluster(args):
    p = cfg.ClusterParams.from_conf(cfg.read_conf(args.conf, "cluster"), _conf_base(args.conf))
    t0 = time.perf_counter()
    ids, _codes = cluster_tree_from_embeddings(
        p.embed_path, p.tree_pb_path, p.cluster_iter, p.cluster_type, device=args.device
    )
    logger.info(
        f"clustered {len(ids)} items ({p.cluster_type}) in "
        f"{time.perf_counter() - t0:.2f}s -> {p.tree_pb_path}"
    )


@command("jtm-initialize-tree")
def jtm_init_tree(args):
    _initialize_tree(args.conf)


@command("jtm-train-deep-model")
def jtm_train(args):
    _train_deep_model(args.conf, args.device)


@command("jtm-tree-learning")
def jtm_tree_learning(args):
    p = cfg.JTMTreeParams.from_conf(cfg.read_conf(args.conf, "tree"), _conf_base(args.conf))
    tree = ArrayTree.from_file(p.tree_pb_path)
    meta = load_meta(p.model_path)
    model = build_model(meta["model"], tree.max_level, meta["embed_size"], meta["seq_len"],
                        device=args.device)
    model.load_numpy(load_pytree(p.model_path, model.param_tree()))
    train_seqs, train_targets = tds.read_train_file(p.data_path)
    learner = TreeLearner(
        tree=tree,
        model=model,
        train_seqs=train_seqs,
        train_targets=train_targets,
        gap=p.gap,
        hierarchical=p.hierarchical_preference,
        min_level=p.min_level,
        device=args.device,
    )
    t0 = time.perf_counter()
    projection = learner.optimize()
    logger.info(f"total tree learning time: {time.perf_counter() - t0:.2f}s")
    write_projection_tree(tree, projection, p.tree_pb_path)


# ---------------------------------------------------------------------------
# OTM
# ---------------------------------------------------------------------------


@command("otm-train-deep-model")
def otm_train(args):
    p = cfg.OTMModelParams.from_conf(cfg.read_conf(args.conf, "model"), _conf_base(args.conf))
    mapping = None if p.initialize_mapping else load_mapping(p.mapping_path)
    data = build_otm_data(
        p.data_path,
        p.seq_len,
        p.min_seq_len,
        p.split_ratio,
        leaf_init_mode=p.leaf_init_mode,
        label_num=p.label_num,
        seed=p.seed,
        mapping=mapping,
    )
    trainer = OTMTrainer(
        data,
        model_type=p.deep_model,
        embed_size=p.embed_size,
        learning_rate=p.learning_rate,
        total_train_batch_size=p.train_batch_size,
        total_eval_batch_size=p.eval_batch_size,
        beam_size=p.beam_size,
        topk=p.topk_number,
        seq_len=p.seq_len,
        target_mode=p.target_mode,
        seed=p.seed,
        device=args.device,
    )
    trainer.train(p.epoch_num, progress_interval=p.show_progress_interval)
    save_pytree(
        p.model_path,
        trainer.params,
        meta={
            "model": p.deep_model,
            "embed_size": p.embed_size,
            "seq_len": p.seq_len,
            "num_items": data.num_items,
        },
    )
    save_mapping(p.mapping_path, data.item_to_code)


@command("otm-construct-tree")
def otm_construct(args):
    p = cfg.OTMTreeParams.from_conf(cfg.read_conf(args.conf, "tree"), _conf_base(args.conf))
    data = build_otm_data(
        p.data_path,
        p.seq_len,
        p.min_seq_len,
        p.split_ratio,
        label_num=p.label_num,
        mapping=load_mapping(p.mapping_path),
    )
    meta = load_meta(p.model_path)
    # the scorer over the complete tree's 2^(leaf_level+1) - 1 codes
    model = build_model(meta["model"], data.leaf_level, meta["embed_size"], meta["seq_len"],
                        device=args.device)
    model.load_numpy(load_pytree(p.model_path, model.param_tree()))
    learner = otm_tree_learner(
        model,
        data.item_to_code,
        data.train_seqs,
        data.train_labels,
        gap=p.gap,
        device=args.device,
    )
    t0 = time.perf_counter()
    projection = learner.optimize()
    logger.info(f"total tree construction time: {time.perf_counter() - t0:.2f}s")
    save_mapping(p.mapping_path, projection)


# ---------------------------------------------------------------------------
# Deep Retrieval
# ---------------------------------------------------------------------------


@command("dr-train-deep-model")
def dr_train(args):
    p = cfg.DRModelParams.from_conf(cfg.read_conf(args.conf, "model"), _conf_base(args.conf))
    if p.initialize_mapping:
        data = build_dr_data(p.data_path, p.seq_len, p.min_seq_len, p.split_ratio)
        path_index = None
    else:
        path_index, item_to_id = PathIndex.read(p.mapping_path, p.num_node)
        data = build_dr_data(p.data_path, p.seq_len, p.min_seq_len, p.split_ratio, item_to_id)
    trainer = DRTrainer(
        data,
        num_layers=p.num_layer,
        num_nodes=p.num_node,
        num_paths_per_item=p.num_path_per_item,
        embed_size=p.embed_size,
        learning_rate=p.learning_rate,
        train_batch_size=p.train_batch_size,
        eval_batch_size=p.eval_batch_size,
        num_sampled=p.num_sampled,
        topk=p.topk_number,
        beam_size=p.beam_size,
        seq_len=p.seq_len,
        path_index=path_index,
        device=args.device,
    )
    trainer.train(p.epoch_num, progress_interval=p.show_progress_interval)
    save_pytree(
        p.model_path + ".layer",
        trainer.layer_params,
        meta={
            "num_layer": p.num_layer,
            "num_node": p.num_node,
            "embed_size": p.embed_size,
            "seq_len": p.seq_len,
            "num_items": data.num_items,
        },
    )
    save_pytree(p.model_path + ".rerank", trainer.rerank_params)
    if p.initialize_mapping:
        trainer.path_index.write(p.mapping_path, data.item_to_id)


@command("dr-coordinate-descent")
def dr_cd(args):
    p = cfg.DRCoordinateParams.from_conf(cfg.read_conf(args.conf, "cd"), _conf_base(args.conf))
    path_index, item_to_id = PathIndex.read(p.mapping_path, p.num_node)
    data = build_dr_data(p.data_path, p.seq_len, p.min_seq_len, p.split_ratio, item_to_id)
    meta = load_meta(p.model_path + ".layer")
    trainer = DRTrainer(
        data,
        num_layers=p.num_layer,
        num_nodes=p.num_node,
        num_paths_per_item=p.num_path_per_item,
        embed_size=meta["embed_size"],
        train_batch_size=p.train_batch_size,
        eval_batch_size=p.eval_batch_size,
        seq_len=p.seq_len,
        path_index=path_index,
        device=args.device,
    )
    trainer.load_params(load_pytree(p.model_path + ".layer", trainer.layer_params),
                        load_pytree(p.model_path + ".rerank", trainer.rerank_params))
    new_index = coordinate_descent(
        trainer,
        data.train_seqs,
        data.train_targets,
        num_iteration=p.iteration_num,
        num_candidate_path=p.candidate_path_num,
        batch_size=max(1, p.train_batch_size // p.num_path_per_item),
        mode=p.train_mode,
        decay_factor=p.decay_factor,
        penalty_factor=p.penalty_factor,
        penalty_poly_order=p.penalty_poly_order,
    )
    new_index.write(p.mapping_path, data.item_to_id)
    logger.info(f"coordinate descent done -> {p.mapping_path}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dismember-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("command", choices=sorted(COMMANDS))
    parser.add_argument(
        "--conf",
        "--tdmConfFile",
        "--jtmConfFile",
        "--otmConfFile",
        "--drConfFile",
        dest="conf",
        required=True,
        help="path to the flat conf file (reference format)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of every stage (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.ERROR if args.quiet else logging.INFO, format="%(message)s"
    )
    args.device = resolve_device(args.device)
    COMMANDS[args.command](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
