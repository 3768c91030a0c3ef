"""The port's Deep Retrieval workflow on the CPU: the ``dr-train-deep-model``
and ``dr-coordinate-descent`` commands on a cut configs/deep-retrieval.conf,
a JAX-written model and mapping served by the port's ``DRServing`` with the
JAX facade's lists, ``run_dr_alternation``'s resume, and the commands'
refusal to run without CUDA unless the CPU is asked for."""

import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core.checkpoint import save_pytree as j_save_pytree
from dismember_tpu.index.paths import PathIndex as JPathIndex
from dismember_tpu.serving import DRServing as JDRServing
from dismember_tpu_torch.cli.main import main as cli_main
from dismember_tpu_torch.core.checkpoint import load_meta, load_pytree
from dismember_tpu_torch.data.dr_dataset import build_dr_data
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.serving import DRServing
from dismember_tpu_torch.train.dr import DRTrainer
from dismember_tpu_torch.train.pipeline import run_dr_alternation

REPO = pathlib.Path(__file__).resolve().parent.parent
# the cut of configs/deep-retrieval.conf for the CPU: one epoch (5 in the file)
EPOCHS = 1


@pytest.fixture(scope="module")
def workdir(small_csv, tmp_path_factory):
    """deep-retrieval.conf as it is but for the epoch cut; its data path
    resolves to the first 8000 rows of the example data."""
    wd = tmp_path_factory.mktemp("dr")
    (wd / "data").mkdir()
    shutil.copy(small_csv, wd / "data" / "example_data.csv")
    lines = (REPO / "configs" / "deep-retrieval.conf").read_text().splitlines()
    lines = [f"model.epoch_num {EPOCHS}" if ln.startswith("model.epoch_num") else ln
             for ln in lines]
    (wd / "dr.conf").write_text("\n".join(lines) + "\n")
    return wd


def _cli(wd, monkeypatch, command):
    monkeypatch.chdir(wd)
    assert cli_main([command, "--drConfFile", "dr.conf", "--device", "cpu", "--quiet"]) == 0


def test_dr_commands_on_the_cpu(workdir, monkeypatch):
    """dr-train-deep-model (initialize mapping) -> dr-coordinate-descent ->
    dr-train-deep-model under the learned mapping, and the stage files
    serve in both packages' facades."""
    wd = workdir
    data_dir = wd / "data"
    _cli(wd, monkeypatch, "dr-train-deep-model")
    model = str(data_dir / "dr_model.bin")
    meta = load_meta(model + ".layer")
    assert meta == {"num_layer": 3, "num_node": 100, "embed_size": 16, "seq_len": 10,
                    "num_items": meta["num_items"]}
    first, ids = PathIndex.read(str(data_dir / "dr_mapping.bin"), 100)
    assert first.item_paths.shape == (meta["num_items"], 2, 3) and len(ids) == meta["num_items"]
    _cli(wd, monkeypatch, "dr-coordinate-descent")
    learned, ids2 = PathIndex.read(str(data_dir / "dr_mapping.bin"), 100)
    assert ids2 == ids and not np.array_equal(learned.item_paths, first.item_paths)
    conf = (wd / "dr.conf").read_text().replace("model.initialize_mapping        true",
                                                "model.initialize_mapping        false")
    (wd / "dr.conf").write_text(conf)
    _cli(wd, monkeypatch, "dr-train-deep-model")
    again, _ = PathIndex.read(str(data_dir / "dr_mapping.bin"), 100)
    np.testing.assert_array_equal(again.item_paths, learned.item_paths)
    paths = (model, str(data_dir / "dr_mapping.bin"), str(data_dir / "example_data.csv"))
    port, ref = DRServing.load(*paths, device="cpu"), JDRServing.load(*paths)
    seqs = port._trainer.data.eval_seqs[:16]
    lists = port.recommend_batch_device(seqs)
    assert lists.shape == (16, 10)
    for i, s in enumerate(seqs[:4]):
        np.testing.assert_array_equal(port.recommend(s), ref.recommend(s))
        assert set(port.recommend(s)) == set(lists[i][lists[i] >= 0])


def test_jax_written_model_serves_the_same_in_the_port(small_csv, tmp_path):
    data = build_dr_data(small_csv, 10, 2, 0.8)
    idx = JPathIndex.random_init(data.num_items, 3, 100, 2, seed=4)
    mapping = str(tmp_path / "mapping.bin")
    idx.write(mapping, data.item_to_id)
    rng = np.random.default_rng(9)
    f = lambda *s: jnp.asarray(rng.standard_normal(s) * 0.5, jnp.float32)  # noqa: E731
    n, e = data.num_items, 16
    layer = {"embedding": f(n + 200, e),
             "heads": [{"weight": f(100, (10 + d) * e), "bias": f(100)} for d in range(3)]}
    rerank = {"embedding": f(n, e), "linear": {"weight": f(e, 10 * e), "bias": f(e)},
              "softmax_w": f(n, e), "softmax_b": f(n)}
    model = str(tmp_path / "jax_model")
    j_save_pytree(model + ".layer", layer, meta={"num_layer": 3, "num_node": 100,
                                                  "embed_size": e, "seq_len": 10,
                                                  "num_items": n})
    j_save_pytree(model + ".rerank", rerank)
    port = DRServing.load(model, mapping, small_csv, device="cpu")
    ref = JDRServing.load(model, mapping, small_csv)
    seqs = data.eval_seqs[:32]
    np.testing.assert_array_equal(port.recommend_batch_device(seqs, topk=10),
                                  ref.recommend_batch_device(seqs, topk=10))
    for s in seqs[:3]:
        np.testing.assert_array_equal(port.recommend(s, consumed=s[-2:]),
                                      ref.recommend(s, consumed=s[-2:]))
    for a, b in zip(jax.tree.leaves(rerank),
                    jax.tree.leaves(port._trainer.rerank_params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_run_dr_alternation_resumes_from_its_state_file(small_csv, tmp_path, monkeypatch):
    """Two rounds, the run killed in round 2's training; the rerun takes
    round 1's checkpoints and the M-step's mapping from the state file."""
    data = build_dr_data(small_csv, 10, 2, 0.8)
    kw = dict(rounds=2, epochs_per_round=1, device="cpu",
              cd_kwargs=dict(num_candidate_path=10, batch_size=512, mode="streaming"),
              trainer_kwargs=dict(num_nodes=20, embed_size=8, train_batch_size=2048,
                                  beam_size=10, topk=5))
    wd = tmp_path / "alt"
    train = DRTrainer.train
    entries = []

    def killed_in_round_2(self, *a, **k):
        entries.append(self.layer_params["embedding"].clone())
        if len(entries) == 2:
            raise KeyboardInterrupt
        return train(self, *a, **k)

    monkeypatch.setattr(DRTrainer, "train", killed_in_round_2)
    with pytest.raises(KeyboardInterrupt):
        run_dr_alternation(str(wd), data, **kw)
    state = json.loads((wd / "dr_pipeline_state.json").read_text())
    assert (state["round"], state["stage"]) == (1, "indexed")
    mapping = state["artifacts"]["mapping"]
    assert mapping.endswith("dr_mapping_round2.bin")
    entries.clear()
    trainer, res = run_dr_alternation(str(wd), data, **kw)
    state = json.loads((wd / "dr_pipeline_state.json").read_text())
    assert (state["round"], state["stage"]) == (2, "indexed") and len(res) == 1
    assert state["artifacts"]["layer_params"].endswith("dr_layer_round2")
    np.testing.assert_array_equal(PathIndex.read(mapping, 20)[0].item_paths,
                                  trainer.path_index.item_paths)
    round1 = load_pytree(str(wd / "dr_layer_round1"), trainer.layer_params)
    np.testing.assert_array_equal(entries[0].numpy(), round1["embedding"])
    done, rest = run_dr_alternation(str(wd), data, **kw)  # nothing left to do
    assert rest == []
    saved = load_pytree(state["artifacts"]["layer_params"], trainer.layer_params)
    np.testing.assert_array_equal(done.layer_params["embedding"].numpy(), saved["embedding"])


def test_dr_commands_need_cuda_unless_cpu_is_asked(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for command in ("dr-train-deep-model", "dr-coordinate-descent"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main([command, "--conf", "dr.conf", "--quiet"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_dr_alternation(str(workdir / "never"), None)
