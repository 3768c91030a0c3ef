"""Alternating train → index → retrain drivers with stage checkpoint/resume.

Port of the TDM, JTM, OTM and Deep Retrieval drivers of
``dismember_tpu/train/pipeline.py``.  The reference's alternation protocol
is human-driven: re-run the CLIs stage by stage, persisting each stage's
output (model blob, tree pb, mapping).  Here the loop is one program; after every stage a state file records (round, stage tag,
artifact paths), in the JAX package's format, so a killed run resumes at the
stage boundary, whichever package wrote the state.  Every stage runs on
``device`` (CUDA by default).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

from dismember_tpu_torch.core.checkpoint import load_pytree, save_pytree
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.core.io import exists as path_exists
from dismember_tpu_torch.core.io import open_file
from dismember_tpu_torch.data.otm_dataset import build_otm_data, load_mapping, save_mapping
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.cluster import cluster_tree_from_embeddings
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.train.dr import DRTrainer
from dismember_tpu_torch.train.dr_coordinate import coordinate_descent
from dismember_tpu_torch.train.jtm import TreeLearner, otm_tree_learner, write_projection_tree
from dismember_tpu_torch.train.otm import OTMTrainer
from dismember_tpu_torch.train.tdm import TDMTrainer

logger = logging.getLogger("dismember_tpu_torch.pipeline")


@dataclasses.dataclass
class StageState:
    """Persisted progress marker."""

    round: int  # completed alternation rounds
    stage: str  # last completed stage
    artifacts: dict  # stage -> artifact path

    def save(self, path: str) -> None:
        with open_file(path, "w", encoding="utf-8") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "StageState | None":
        if not path_exists(path):
            return None
        with open_file(path, "r", encoding="utf-8") as f:
            return cls(**json.load(f))


def _train_round(trainer: TDMTrainer, samples, state: StageState, state_path: str,
                 model_ckpt: str, rnd: int, iterations: int, tag: str) -> None:
    """Train a round's scorer, or load it when the state says this round
    already trained; checkpoint it and mark the state ``trained``."""
    if state.stage == "trained" and path_exists(model_ckpt + ".npz"):
        trainer.load_numpy(load_pytree(model_ckpt, trainer.params))
        return
    t0 = time.perf_counter()
    trainer.train(samples.train_seqs, samples.train_targets, iterations=iterations,
                  progress_interval=max(1, iterations // 4))
    logger.info(f"{tag}round {rnd} train: {time.perf_counter() - t0:.1f}s")
    save_pytree(model_ckpt, trainer.params, meta={"round": rnd})
    state.stage = "trained"
    state.artifacts[f"model_round{rnd}"] = model_ckpt
    state.save(state_path)


def run_tdm_alternation(
    workdir: str,
    samples,  # TDMSamples
    initial_tree_path: str,
    rounds: int = 2,
    iterations_per_round: int = 2000,
    cluster_type: str = "kmeans",
    cluster_iter: int = 10,
    trainer_kwargs: dict | None = None,
    eval_every_round: bool = True,
    device: str = "cuda",
):
    """TDM loop: train scorer -> export embeddings -> re-cluster tree ->
    retrain.  Returns (final trainer, per-round eval results)."""
    dev = resolve_device(device)
    if "://" not in workdir:
        os.makedirs(workdir, exist_ok=True)
    state_path = os.path.join(workdir, "pipeline_state.json")
    state = StageState.load(state_path) or StageState(
        round=0, stage="init", artifacts={"tree": initial_tree_path}
    )
    results = []
    trainer = None
    eval_data = (samples.eval_seqs, samples.eval_labels, samples.eval_users)
    while state.round < rounds:
        rnd = state.round + 1
        tree = ArrayTree.from_file(state.artifacts["tree"])
        trainer = TDMTrainer(tree=tree, device=dev, **(trainer_kwargs or {}))
        _train_round(trainer, samples, state, state_path,
                     os.path.join(workdir, f"model_round{rnd}"), rnd,
                     iterations_per_round, "")

        if eval_every_round and len(samples.eval_users):
            ev = trainer.evaluate(eval_data, samples.user_consumed)
            logger.info(f"round {rnd} eval: {ev}")
            results.append(ev)

        if rnd < rounds:
            # index stage: export embeddings, re-cluster
            embed_path = os.path.join(workdir, f"embed_round{rnd}.csv")
            new_tree = os.path.join(workdir, f"tree_round{rnd + 1}.bin")
            trainer.export_embeddings(embed_path)
            t0 = time.perf_counter()
            cluster_tree_from_embeddings(embed_path, new_tree, cluster_iter, cluster_type,
                                         device=dev)
            logger.info(f"round {rnd} cluster: {time.perf_counter() - t0:.1f}s")
            state.artifacts["tree"] = new_tree
        state.round = rnd
        state.stage = "indexed"
        state.save(state_path)
    return trainer, results


def run_jtm_alternation(
    workdir: str,
    samples,  # TDMSamples
    initial_tree_path: str,
    rounds: int = 2,
    iterations_per_round: int = 2000,
    gap: int = 2,
    hierarchical: bool = False,
    min_level: int = 0,
    trainer_kwargs: dict | None = None,
    eval_every_round: bool = True,
    device: str = "cuda",
):
    """JTM loop: train scorer -> tree learning (greedy weighted re-assignment)
    -> retrain, with the same stage checkpoint/resume as the TDM driver.

    Mirrors the reference's human-driven jtm-train-deep-model /
    jtm-tree-learning CLI alternation (jtm/.../optim/JTM.scala).  Returns
    (final trainer, per-round eval results).
    """
    dev = resolve_device(device)
    if "://" not in workdir:
        os.makedirs(workdir, exist_ok=True)
    state_path = os.path.join(workdir, "jtm_pipeline_state.json")
    state = StageState.load(state_path) or StageState(
        round=0, stage="init", artifacts={"tree": initial_tree_path}
    )
    results = []
    trainer = None
    eval_data = (samples.eval_seqs, samples.eval_labels, samples.eval_users)

    while state.round < rounds:
        rnd = state.round + 1
        tree = ArrayTree.from_file(state.artifacts["tree"])
        trainer = TDMTrainer(tree=tree, device=dev, **(trainer_kwargs or {}))
        _train_round(trainer, samples, state, state_path,
                     os.path.join(workdir, f"jtm_model_round{rnd}"), rnd,
                     iterations_per_round, "jtm ")

        if eval_every_round and len(samples.eval_users):
            ev = trainer.evaluate(eval_data, samples.user_consumed)
            logger.info(f"jtm round {rnd} eval: {ev}")
            results.append(ev)

        if rnd < rounds:
            t0 = time.perf_counter()
            # the learner scores with the model's embedding: in pmv mode a
            # mirror of the packed state, re-read here if steps left it stale
            trainer._sync_mirrors()
            learner = TreeLearner(
                tree=trainer.tree,
                model=trainer.model,
                train_seqs=samples.train_seqs,
                train_targets=samples.train_targets,
                gap=gap,
                hierarchical=hierarchical,
                min_level=min_level,
                device=dev,
            )
            projection = learner.optimize()
            new_tree = os.path.join(workdir, f"jtm_tree_round{rnd + 1}.bin")
            write_projection_tree(trainer.tree, projection, new_tree)
            logger.info(f"jtm round {rnd} tree learning: {time.perf_counter() - t0:.1f}s")
            state.artifacts["tree"] = new_tree
        state.round = rnd
        state.stage = "indexed"
        state.save(state_path)
    return trainer, results


def run_otm_alternation(
    workdir: str,
    data_path: str,
    rounds: int = 2,
    epochs_per_round: int = 5,
    seq_len: int = 10,
    min_seq_len: int = 2,
    split_ratio: float = 0.8,
    label_num: int = 5,
    leaf_init_mode: str = "random",
    data_mode: str = "default",
    gap: int = 2,
    seed: int = 42,
    trainer_kwargs: dict | None = None,
    device: str = "cuda",
):
    """OTM loop: train (per-level pseudo-target steps) -> tree construction
    (item->leaf re-assignment) -> rebuild dataset under the new mapping ->
    retrain, with stage checkpoint/resume.

    The dataset is rebuilt each round because sequences/labels live in
    mapped-code space (otm LocalDataSet.scala:15-44 reloads the mapping the
    same way).  Returns (final trainer, per-round last-epoch eval dicts).
    """
    dev = resolve_device(device)
    if "://" not in workdir:
        os.makedirs(workdir, exist_ok=True)
    state_path = os.path.join(workdir, "otm_pipeline_state.json")
    state = StageState.load(state_path) or StageState(round=0, stage="init", artifacts={})
    results = []
    trainer = None
    while state.round < rounds:
        rnd = state.round + 1
        mapping_path = state.artifacts.get("mapping")
        mapping = (load_mapping(mapping_path)
                   if mapping_path and path_exists(mapping_path) else None)
        data = build_otm_data(
            data_path, seq_len, min_seq_len, split_ratio,
            leaf_init_mode=leaf_init_mode, label_num=label_num, seed=seed,
            mapping=mapping, data_mode=data_mode,
        )
        trainer = OTMTrainer(data, device=dev, **(trainer_kwargs or {}))
        model_ckpt = os.path.join(workdir, f"otm_model_round{rnd}")
        if state.stage == "trained" and path_exists(model_ckpt + ".npz"):
            trainer.load_numpy(load_pytree(model_ckpt, trainer.params))
            ev = trainer.evaluate()
            results.append({"round": rnd, "recall": ev.recall, "ndcg": ev.ndcg,
                            "precision": ev.precision, "loss": ev.loss})
        else:
            t0 = time.perf_counter()
            logs = trainer.train(num_epochs=epochs_per_round)
            logger.info(f"otm round {rnd} train: {time.perf_counter() - t0:.1f}s")
            save_pytree(model_ckpt, trainer.params, meta={"round": rnd})
            state.stage = "trained"
            state.artifacts[f"model_round{rnd}"] = model_ckpt
            state.save(state_path)
            last = logs[-1]
            results.append({"round": rnd, "recall": last["recall"], "ndcg": last["ndcg"],
                            "precision": last["precision"], "loss": last["eval_loss"]})

        if rnd < rounds:
            t0 = time.perf_counter()
            learner = otm_tree_learner(trainer.model, data.item_to_code, data.train_seqs,
                                       data.train_labels, gap=gap, device=dev)
            projection = learner.optimize()
            new_mapping = os.path.join(workdir, f"otm_mapping_round{rnd + 1}.txt")
            save_mapping(new_mapping, projection)
            logger.info(f"otm round {rnd} tree construction: {time.perf_counter() - t0:.1f}s")
            state.artifacts["mapping"] = new_mapping
        state.round = rnd
        state.stage = "indexed"
        state.save(state_path)
    return trainer, results


def run_dr_alternation(
    workdir: str,
    data,  # DRData
    rounds: int = 2,
    epochs_per_round: int = 2,
    cd_kwargs: dict | None = None,
    trainer_kwargs: dict | None = None,
    device: str = "cuda",
):
    """Deep Retrieval EM loop: E-step training -> M-step coordinate descent,
    with the JAX package's stage state (``dr_pipeline_state.json``): a
    resumed run reloads the last mapping and checkpoints and goes on from
    the next round.  Returns (trainer, per-epoch eval results)."""
    dev = resolve_device(device)
    if "://" not in workdir:
        os.makedirs(workdir, exist_ok=True)
    state_path = os.path.join(workdir, "dr_pipeline_state.json")
    state = StageState.load(state_path) or StageState(round=0, stage="init", artifacts={})
    trainer = DRTrainer(data, device=dev, **(trainer_kwargs or {}))
    mapping_path = state.artifacts.get("mapping")
    if mapping_path and path_exists(mapping_path):
        trainer.path_index, _ = PathIndex.read(mapping_path, trainer.num_nodes)
    layer_ckpt = state.artifacts.get("layer_params")
    if layer_ckpt and path_exists(layer_ckpt + ".npz"):
        trainer.load_params(load_pytree(layer_ckpt, trainer.layer_params),
                            load_pytree(state.artifacts["rerank_params"],
                                        trainer.rerank_params))

    results = []
    while state.round < rounds:
        rnd = state.round + 1
        results.extend(trainer.train(num_epochs=epochs_per_round))
        layer_ckpt = os.path.join(workdir, f"dr_layer_round{rnd}")
        rerank_ckpt = os.path.join(workdir, f"dr_rerank_round{rnd}")
        save_pytree(layer_ckpt, trainer.layer_params, meta={"round": rnd})
        save_pytree(rerank_ckpt, trainer.rerank_params)
        state.artifacts.update(layer_params=layer_ckpt, rerank_params=rerank_ckpt)
        state.stage = "trained"
        state.save(state_path)

        if rnd < rounds:
            trainer.path_index = coordinate_descent(
                trainer, data.train_seqs, data.train_targets, **(cd_kwargs or {}))
            mapping_path = os.path.join(workdir, f"dr_mapping_round{rnd + 1}.bin")
            trainer.path_index.write(mapping_path, data.item_to_id)
            state.artifacts["mapping"] = mapping_path
        state.round = rnd
        state.stage = "indexed"
        state.save(state_path)
    return trainer, results
