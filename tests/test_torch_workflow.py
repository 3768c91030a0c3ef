"""The port's TDM/JTM workflow against the JAX package's, on the CPU: conf
parsing, the stage files of ``*-initialize-tree``, the alternation drivers
with resume (also from a state the JAX driver left), the six CLI commands in
process, and checkpoints that feed either package's stages.  The JAX side
runs in process too."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from dismember_tpu.cli.main import main as jax_cli
from dismember_tpu.core import config as jcfg
from dismember_tpu.core.checkpoint import load_meta as jax_load_meta
from dismember_tpu.core.checkpoint import load_pytree as jax_load_pytree
from dismember_tpu.data.ingest import read_csv, unique_items_with_category, user_interactions
from dismember_tpu.data.tdm_dataset import generate_split_samples
from dismember_tpu.index.tree_io import category_sorted_codes, write_tree
from dismember_tpu.models import din as jdin
from dismember_tpu.train.pipeline import run_tdm_alternation as jax_run_tdm_alternation
from dismember_tpu_torch.cli.main import main as cli
from dismember_tpu_torch.core import config as cfg
from dismember_tpu_torch.core.checkpoint import flatten, load_pytree
from dismember_tpu_torch.core.io import read_bytes
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.ops.din_kernel import KERNEL_WIDTHS, check_kernel_width
from dismember_tpu_torch.train.pipeline import (
    StageState,
    run_jtm_alternation,
    run_tdm_alternation,
)
from dismember_tpu_torch.train.sampler import pack_exists_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,17,19,22,25,30,76,200"
STAGE_FILES = ["train.csv", "eval.csv", "stat.txt", "leaf.txt", "tree.bin", "consumed.txt"]

# one conf for every stage, E=8, as tests/test_cli.py's
CONF = f"""
init.seq_len             10
init.min_seq_len         2
init.split_for_eval      true
init.split_ratio         0.8
init.data_path           data/example.csv
init.train_path          data/train.csv
init.eval_path           data/eval.csv
init.stat_path           data/stat.txt
init.leaf_id_path        data/leaf.txt
init.tree_protobuf_path  data/tree.bin
init.user_consumed_path  data/consumed.txt

model.deep_model         DIN
model.train_path         data/train.csv
model.eval_path          data/eval.csv
model.tree_protobuf_path data/tree.bin
model.user_consumed_path data/consumed.txt
model.evaluate_during_training false
model.total_batch_size   2048
model.total_eval_batch_size 2048
model.seq_len            10
model.layer_negative_counts {NEG}
model.sample_with_probability false
model.start_sample_level 1
model.embed_size         8
model.learning_rate      3e-3
model.iteration_number   10
model.show_progress_interval 10
model.topk_number        10
model.beam_size          20
model.model_path         data/model.bin
model.embed_path         data/embed.csv

cluster.embed_path          data/embed.csv
cluster.tree_protobuf_path  data/tree.bin
cluster.cluster_type        kmeans
cluster.cluster_iter        3

tree.data_path            data/train.csv
tree.model_path           data/model.bin
tree.tree_protobuf_path   data/tree.bin
tree.deep_model           DIN
tree.gap                  2
tree.seq_len              10
tree.hierarchical_preference false
tree.min_level            0
"""

TRAINER_KW = dict(model_type="din", embed_size=8, learning_rate=3e-3, total_batch_size=1024,
                  layer_neg_counts=NEG, topk=5, beam_size=10)


def make_workdir(path, small_csv) -> str:
    os.makedirs(path / "data", exist_ok=True)
    shutil.copy(small_csv, path / "data" / "example.csv")
    (path / "workflow.conf").write_text(CONF)
    return str(path / "workflow.conf")


@pytest.fixture(scope="module")
def samples_tree(small_csv, tmp_path_factory):
    raw = read_csv(small_csv)
    samples = generate_split_samples(user_interactions(raw), 10, 2, 0.8)
    ids, cats = unique_items_with_category(raw)
    sid, codes = category_sorted_codes(ids, cats)
    path = str(tmp_path_factory.mktemp("wf") / "tree.bin")
    write_tree(path, sid, codes, stat=samples.stat)
    return samples, path


# ---------------------------------------------------------------- conf
@pytest.mark.parametrize("fname,prefix,name", [
    ("tdm.conf", "init", "TreeInitParams"), ("tdm.conf", "model", "TDMModelParams"),
    ("tdm.conf", "cluster", "ClusterParams"), ("jtm.conf", "init", "TreeInitParams"),
    ("jtm.conf", "model", "TDMModelParams"), ("jtm.conf", "tree", "JTMTreeParams"),
    ("deep-retrieval.conf", "model", "DRModelParams"),
    ("deep-retrieval.conf", "cd", "DRCoordinateParams"),
])
def test_conf_params_match_jax(fname, prefix, name):
    path = os.path.join(REPO, "configs", fname)
    conf = cfg.read_conf(path, prefix)
    assert conf == jcfg.read_conf(path, prefix) and conf
    got = getattr(cfg, name).from_conf(conf, "/base")
    assert vars(got) == vars(getattr(jcfg, name).from_conf(conf, "/base"))
    with pytest.raises(KeyError, match="missing required"):
        getattr(cfg, name).from_conf({}, "/base")


# ---------------------------------------------------------------- CLI
def test_initialize_tree_files_are_byte_identical(small_csv, tmp_path, monkeypatch):
    for pkg, run in (("jax", jax_cli), ("port", cli)):
        conf = make_workdir(tmp_path / pkg, small_csv)
        monkeypatch.chdir(tmp_path / pkg)
        args = ["tdm-initialize-tree", "--conf", conf, "--quiet"]
        run(args + (["--device", "cpu"] if pkg == "port" else []))
    for f in STAGE_FILES:
        got = read_bytes(str(tmp_path / "port" / "data" / f))
        assert got == read_bytes(str(tmp_path / "jax" / "data" / f)), f
        assert got


def test_six_commands_in_process(small_csv, tmp_path, monkeypatch):
    """tdm-initialize-tree -> tdm-train-deep-model -> tdm-cluster-tree, then
    jtm-initialize-tree -> jtm-train-deep-model -> jtm-tree-learning, with
    the reference's flag aliases; each stage's tree holds the same items at
    distinct leaf codes."""
    conf = make_workdir(tmp_path, small_csv)
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "data"
    items = None
    for command, flag in (("tdm-initialize-tree", "--tdmConfFile"),
                          ("tdm-train-deep-model", "--tdmConfFile"),
                          ("tdm-cluster-tree", "--conf"),
                          ("jtm-initialize-tree", "--jtmConfFile"),
                          ("jtm-train-deep-model", "--jtmConfFile"),
                          ("jtm-tree-learning", "--conf")):
        assert cli([command, flag, conf, "--device", "cpu", "--quiet"]) == 0
        tree = ArrayTree.from_file(str(data / "tree.bin"))
        items = items or set(tree.item_ids.tolist())
        assert set(tree.item_ids.tolist()) == items, command
        assert len(np.unique(tree.item_codes)) == tree.num_items, command
    assert (data / "model.bin.npz").exists()
    lines = (data / "embed.csv").read_text().splitlines()
    assert len(lines) == len(items) and len(lines[0].split(",")) == 1 + 8


def test_checkpoints_feed_either_package(small_csv, tmp_path, monkeypatch):
    """A JAX-trained model (the JAX CLI's tdm-train-deep-model) feeds the
    port's jtm-tree-learning; the port's checkpoint loads with the JAX
    package's load_pytree."""
    conf = make_workdir(tmp_path / "jax", small_csv)
    monkeypatch.chdir(tmp_path / "jax")
    jax_cli(["tdm-initialize-tree", "--conf", conf, "--quiet"])
    jax_cli(["tdm-train-deep-model", "--conf", conf, "--quiet"])
    data = tmp_path / "jax" / "data"
    old = ArrayTree.from_file(str(data / "tree.bin"))
    assert cli(["jtm-tree-learning", "--conf", conf, "--device", "cpu", "--quiet"]) == 0
    learned = ArrayTree.from_file(str(data / "tree.bin"))
    assert set(learned.item_ids.tolist()) == set(old.item_ids.tolist())
    assert len(np.unique(learned.item_codes)) == learned.num_items

    conf = make_workdir(tmp_path / "port", small_csv)
    monkeypatch.chdir(tmp_path / "port")
    for command in ("tdm-initialize-tree", "tdm-train-deep-model"):
        cli([command, "--conf", conf, "--device", "cpu", "--quiet"])
    path = str(tmp_path / "port" / "data" / "model.bin")
    tree = ArrayTree.from_file(str(tmp_path / "port" / "data" / "tree.bin"))
    like = jdin.init_params(jax.random.PRNGKey(0), tree.total_codes, 8)
    got, ref = flatten(jax_load_pytree(path, like)), flatten(load_pytree(path, like))
    assert set(got) == set(ref) == {"embedding", "att_linear/weight", "mlp1/weight",
                                    "mlp1/bias", "mlp2/weight", "mlp2/bias"}
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k])
    assert jax_load_meta(path) == {"model": "din", "embed_size": 8, "seq_len": 10,
                                   "tree_pb_path": str(tmp_path / "port" / "data" / "tree.bin")}


def test_cli_needs_cuda_unless_cpu_is_asked(small_csv, tmp_path, monkeypatch):
    conf = make_workdir(tmp_path, small_csv)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli(["tdm-initialize-tree", "--conf", conf])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli(["dr-train-deep-model", "--conf", conf])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli(["otm-train-deep-model", "--conf", conf])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_exists_rows(np.ones(5, bool))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_tdm_alternation(str(tmp_path / "alt"), None, "unused.bin")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_jtm_alternation(str(tmp_path / "alt"), None, "unused.bin")


# ---------------------------------------------------------------- drivers
def test_tdm_alternation_with_resume(samples_tree, tmp_path):
    samples, tree_path = samples_tree
    wd = str(tmp_path / "alt")
    kw = dict(iterations_per_round=20, cluster_iter=2, trainer_kwargs=TRAINER_KW,
              eval_every_round=False, device="cpu")
    run_tdm_alternation(wd, samples, tree_path, rounds=2, **kw)
    state = StageState.load(os.path.join(wd, "pipeline_state.json"))
    assert state.round == 2 and state.stage == "indexed"
    assert os.path.exists(os.path.join(wd, "model_round2.npz"))
    t2 = ArrayTree.from_file(os.path.join(wd, "tree_round2.bin"))
    assert set(t2.item_ids.tolist()) == set(ArrayTree.from_file(tree_path).item_ids.tolist())
    trainer, results = run_tdm_alternation(wd, samples, tree_path, rounds=3,
                                           **{**kw, "eval_every_round": True})
    assert StageState.load(os.path.join(wd, "pipeline_state.json")).round == 3
    assert len(results) == 1 and results[0].count == len(samples.eval_users)
    assert len(trainer.recommend(samples.eval_seqs[0], topk=5)) == 5


def test_jtm_alternation_with_resume(samples_tree, tmp_path):
    samples, tree_path = samples_tree
    wd = str(tmp_path / "jtm_alt")
    kw = dict(iterations_per_round=20, gap=2, trainer_kwargs=TRAINER_KW,
              eval_every_round=False, device="cpu")
    trainer, _ = run_jtm_alternation(wd, samples, tree_path, rounds=2, **kw)
    state = StageState.load(os.path.join(wd, "jtm_pipeline_state.json"))
    assert state.round == 2
    assert os.path.exists(os.path.join(wd, "jtm_model_round2.npz"))
    t2 = ArrayTree.from_file(os.path.join(wd, "jtm_tree_round2.bin"))
    assert set(t2.item_ids.tolist()) == set(trainer.tree.item_ids.tolist())
    assert len(np.unique(t2.item_codes)) == t2.num_items
    trainer2, _ = run_jtm_alternation(wd, samples, tree_path, rounds=3, **kw)
    assert StageState.load(os.path.join(wd, "jtm_pipeline_state.json")).round == 3
    assert len(trainer2.recommend(samples.eval_seqs[0], topk=5)) == 5


def test_state_left_by_the_jax_driver_resumes(samples_tree, tmp_path):
    """The JAX driver's round 1 (train, checkpoint, state file), then the
    port's driver takes round 2 from that state and checkpoints in the same
    format."""
    samples, tree_path = samples_tree
    wd = str(tmp_path / "mixed")
    jax_run_tdm_alternation(wd, samples, tree_path, rounds=1, iterations_per_round=5,
                            trainer_kwargs=TRAINER_KW, eval_every_round=False)
    state = StageState.load(os.path.join(wd, "pipeline_state.json"))
    assert (state.round, state.stage) == (1, "indexed")
    # the JAX round's model loads into the port's trainer
    trainer, _ = run_tdm_alternation(wd, samples, tree_path, rounds=2, iterations_per_round=5,
                                     trainer_kwargs=TRAINER_KW, eval_every_round=False,
                                     device="cpu")
    state = StageState.load(os.path.join(wd, "pipeline_state.json"))
    assert state.round == 2 and "model_round1" in state.artifacts
    like = trainer.model.params_numpy()
    round1 = load_pytree(os.path.join(wd, "model_round1"), like)
    assert round1["embedding"].shape == like["embedding"].shape
    round2 = jax_load_pytree(os.path.join(wd, "model_round2"), like)
    np.testing.assert_array_equal(np.asarray(round2["embedding"]), like["embedding"])


# ---------------------------------------------------------------- repairs
@pytest.mark.parametrize("e", [24, 48])
def test_kernel_width_check_refuses_other_widths_on_cuda(e):
    with pytest.raises(ValueError, match=r"E in \[8, 16, 32, 64, 96, 128\] only"):
        check_kernel_width("din", e, torch.device("cuda"))


@pytest.mark.parametrize("e", [8, 16, 32])
def test_kernel_width_check_passes_e16_and_the_cpu(e):
    """The built widths pass on CUDA, any width on the CPU, and DeepFM
    (no kernel) at any width."""
    assert e in KERNEL_WIDTHS
    check_kernel_width("din", e, torch.device("cpu"))
    check_kernel_width("din", e + 8, torch.device("cpu"))
    check_kernel_width("din", e, torch.device("cuda"))
    check_kernel_width("deepfm", e + 8, torch.device("cuda"))


def test_width_check_runs_where_trainers_servers_and_learners_are_built(samples_tree,
                                                                       monkeypatch):
    """Construction on CUDA with E=24 (a width not built) raises from the
    check, before anything is allocated there (CUDA faked as present)."""
    import types

    from dismember_tpu_torch.models.din import DIN
    from dismember_tpu_torch.serving import TDMServing
    from dismember_tpu_torch.train.jtm import TreeLearner
    from dismember_tpu_torch.train.tdm import TDMTrainer

    samples, tree_path = samples_tree
    tree = ArrayTree.from_file(tree_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="built for E in"):
        TDMTrainer(tree=tree, embed_size=24, layer_neg_counts=NEG, device="cuda")
    with pytest.raises(ValueError, match="built for E in"):
        TreeLearner(tree=tree, model=DIN(tree.total_codes, 24, device="cpu"),
                    train_seqs=samples.train_seqs[:4], train_targets=samples.train_targets[:4],
                    device="cuda")
    on_cuda = types.SimpleNamespace(embedding=types.SimpleNamespace(device=torch.device("cuda")),
                                    embed_size=24, model_type="din")
    with pytest.raises(ValueError, match="built for E in"):
        TDMServing(on_cuda, DIN.forward, tree)
