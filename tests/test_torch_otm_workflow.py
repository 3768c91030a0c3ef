"""The port's OTM workflow against the JAX package, on the CPU: the
``otm-train-deep-model`` and ``otm-construct-tree`` commands, checkpoints
that serve the same lists in either package's ``OTMServing``, the learned
mapping against the JAX package's ``otm_tree_learner``, and
``run_otm_alternation``'s resume from its state file."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core.checkpoint import load_pytree as j_load_pytree
from dismember_tpu.core.checkpoint import save_pytree as j_save_pytree
from dismember_tpu.data import otm_dataset as jds
from dismember_tpu.models import din as jdin
from dismember_tpu.retrieval.packed_beam import PackedTree as JPackedTree
from dismember_tpu.retrieval.packed_beam import build_pair_table as j_build_pair_table
from dismember_tpu.retrieval.packed_beam import make_packed_beam_fn_pallas
from dismember_tpu.retrieval.tree_beam import TreeBeamConfig as JTreeBeamConfig
from dismember_tpu.serving import OTMServing as JOTMServing
from dismember_tpu.train.jtm import otm_tree_learner as j_otm_tree_learner
from dismember_tpu_torch.cli.main import main as cli_main
from dismember_tpu_torch.core.checkpoint import load_meta
from dismember_tpu_torch.data import otm_dataset as ds
from dismember_tpu_torch.serving import OTMServing
from dismember_tpu_torch.train.pipeline import run_otm_alternation

REPO_CONF = "configs/otm.conf"
# the cut of configs/otm.conf for the CPU: one epoch (5 in the file)
EPOCHS = 1


@pytest.fixture(scope="module")
def workdir(small_csv, tmp_path_factory):
    """otm.conf as it is but for the epoch cut and its data path, which
    points at the first 8000 rows of the example data; paths resolve
    against this directory."""
    wd = tmp_path_factory.mktemp("otm")
    (wd / "data").mkdir()
    shutil.copy(small_csv, wd / "data" / "example_data.csv")
    import pathlib

    lines = (pathlib.Path(__file__).resolve().parent.parent / REPO_CONF).read_text().splitlines()
    lines = [f"model.epoch_num {EPOCHS}" if ln.startswith("model.epoch_num") else ln
             for ln in lines]
    (wd / "otm.conf").write_text("\n".join(lines) + "\n")
    return wd


def _cli(wd, monkeypatch, command):
    monkeypatch.chdir(wd)
    assert cli_main([command, "--conf", "otm.conf", "--device", "cpu", "--quiet"]) == 0


def _jax_serving_on_pallas(serv: JOTMServing) -> JOTMServing:
    """The JAX facade served through the Pallas level body (interpret mode),
    whose bf16 operand rounding the port's CPU level shares."""
    t = serv._trainer
    total, s = t.data.num_tree_nodes, t.start_level
    start = np.arange((1 << s) - 1, (1 << (s + 1)) - 1)
    cfg = JTreeBeamConfig(beam=t.beam, max_level=t.leaf_level, start_level=s,
                          start_codes_padded=tuple(int(c) for c in np.concatenate(
                              [start, np.full(2 * t.beam - len(start), -1)])))
    table = j_build_pair_table(t.params["embedding"], np.ones(total, bool),
                               np.arange(total), total)
    t._packed_cache = (t.params, make_packed_beam_fn_pallas(
        JPackedTree(pair_table=table, embed_size=t.embed_size, cfg=cfg), tile_b=8,
        interpret=True))
    return serv


def _same_lists(port: OTMServing, jax_serv: JOTMServing, data):
    for u in data.eval_users[:6]:
        seq = [data.code_to_item[c] for c in data.user_consumed[int(u)][-10:]]
        consumed = np.asarray(seq[:4])
        np.testing.assert_array_equal(port.recommend(np.asarray(seq), consumed_items=consumed),
                                      jax_serv.recommend(np.asarray(seq),
                                                         consumed_items=consumed))


def test_otm_cli_round_serves_in_both_packages(workdir, monkeypatch):
    """otm-train-deep-model -> otm-construct-tree -> otm-train-deep-model
    with initialize_mapping false, on the CPU; the port's checkpoint serves
    the same lists in the JAX facade, and a JAX checkpoint in the port's."""
    wd = workdir
    _cli(wd, monkeypatch, "otm-train-deep-model")
    meta = load_meta(str(wd / "data" / "otm_model.bin"))
    first = ds.load_mapping(str(wd / "data" / "otm_mapping.txt"))[0]
    assert set(meta) == {"model", "embed_size", "seq_len", "num_items"}
    assert (meta["model"], meta["embed_size"], meta["num_items"]) == ("din", 16, len(first))
    # the mapping the construction starts from, and the model it scores with
    shutil.copy(wd / "data" / "otm_mapping.txt", wd / "data" / "mapping_round1.txt")
    _cli(wd, monkeypatch, "otm-construct-tree")
    learned = ds.load_mapping(str(wd / "data" / "otm_mapping.txt"))[0]
    assert learned.keys() == first.keys()
    codes = np.asarray(list(learned.values()))
    leaf_level = ds.upper_log2(len(learned))
    assert len(np.unique(codes)) == len(codes)
    assert ((codes >= (1 << leaf_level) - 1) & (codes < (1 << (leaf_level + 1)) - 1)).all()
    assert learned != first

    # the JAX package's tree construction from the same model and mapping
    jdata = jds.build_otm_data(str(wd / "data" / "example_data.csv"), 10, 2, 0.8, label_num=5,
                               mapping=jds.load_mapping(str(wd / "data" / "mapping_round1.txt")))
    like = jdin.init_params(jax.random.PRNGKey(0), jdata.num_tree_nodes, 16)
    jparams = j_load_pytree(str(wd / "data" / "otm_model.bin"), like)
    ref = j_otm_tree_learner(jparams, jdin.forward, jdata.item_to_code, jdata.train_seqs,
                             jdata.train_labels, gap=2).optimize()
    moved = sum(learned[k] != ref[k] for k in ref)
    assert moved <= max(2, len(ref) // 50), f"{moved} of {len(ref)} items moved"

    # retrain under the learned mapping, then serve in both packages
    conf = (wd / "otm.conf").read_text().replace("model.initialize_mapping        true",
                                                 "model.initialize_mapping        false")
    (wd / "otm.conf").write_text(conf)
    _cli(wd, monkeypatch, "otm-train-deep-model")
    assert ds.load_mapping(str(wd / "data" / "otm_mapping.txt"))[0] == learned
    paths = (str(wd / "data" / "otm_model.bin"), str(wd / "data" / "otm_mapping.txt"),
             str(wd / "data" / "example_data.csv"))
    port = OTMServing.load(*paths, device="cpu")
    data = port._trainer.data
    _same_lists(port, _jax_serving_on_pallas(JOTMServing.load(*paths)), data)

    # a checkpoint written by the JAX package serves the same in the port
    rng = np.random.default_rng(11)
    jp = jax.tree.map(lambda a: np.asarray(rng.standard_normal(a.shape) * 0.5, np.float32),
                      like)
    j_save_pytree(str(wd / "jax_model"), jax.tree.map(jnp.asarray, jp),
                  meta={"model": "din", "embed_size": 16, "seq_len": 10,
                        "num_items": len(learned)})
    paths = (str(wd / "jax_model"),) + paths[1:]
    _same_lists(OTMServing.load(*paths, device="cpu"),
                _jax_serving_on_pallas(JOTMServing.load(*paths)), data)


def test_otm_commands_need_cuda_unless_cpu_is_asked(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for command in ("otm-train-deep-model", "otm-construct-tree"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main([command, "--conf", "otm.conf", "--quiet"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_otm_alternation(str(workdir / "never"), "data/example_data.csv")


def test_run_otm_alternation_resumes_from_its_state_file(small_csv, tmp_path):
    kw = dict(data_path=small_csv, epochs_per_round=1, label_num=3, seed=5, device="cpu",
              trainer_kwargs=dict(embed_size=8, beam_size=4, topk=5,
                                  total_train_batch_size=512, total_eval_batch_size=512))
    whole, whole_res = run_otm_alternation(str(tmp_path / "a"), rounds=2, **kw)
    part, part_res = run_otm_alternation(str(tmp_path / "b"), rounds=1, **kw)
    state = json.loads((tmp_path / "b" / "otm_pipeline_state.json").read_text())
    assert (state["round"], state["stage"]) == (1, "indexed") and "mapping" not in state[
        "artifacts"]
    # a killed second round: its state file marks round 1 done and points
    # at the mapping round 1 learned
    state_a = json.loads((tmp_path / "a" / "otm_pipeline_state.json").read_text())
    assert (state_a["round"], state_a["stage"]) == (2, "indexed")
    shutil.copy(tmp_path / "a" / "otm_mapping_round2.txt", tmp_path / "b")
    state["artifacts"]["mapping"] = str(tmp_path / "b" / "otm_mapping_round2.txt")
    (tmp_path / "b" / "otm_pipeline_state.json").write_text(json.dumps(state))
    resumed, res = run_otm_alternation(str(tmp_path / "b"), rounds=2, **kw)
    assert part_res == whole_res[:1] and res == whole_res[1:]
    for a, b in zip(whole.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    # a state file at "trained" loads the round's checkpoint instead of training
    state_a["round"], state_a["stage"] = 1, "trained"
    (tmp_path / "a" / "otm_pipeline_state.json").write_text(json.dumps(state_a))
    again, res2 = run_otm_alternation(str(tmp_path / "a"), rounds=2, **kw)
    assert res2[0]["recall"] == whole_res[1]["recall"]
    for a, b in zip(whole.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
