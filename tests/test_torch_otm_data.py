"""The port's OTM dataset and conf classes against the JAX package:
``build_otm_data`` array for array in both leaf-init modes and both data
modes, mapping files that cross-load, and ``configs/otm.conf`` read into
equal ``OTMModelParams``/``OTMTreeParams``."""

import dataclasses
import pathlib

import numpy as np
import pytest

from dismember_tpu.core import config as jcfg
from dismember_tpu.data import otm_dataset as jds
from dismember_tpu_torch.core import config as cfg
from dismember_tpu_torch.data import otm_dataset as ds

REPO = pathlib.Path(__file__).resolve().parent.parent


def _assert_same_data(got, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "user_consumed":
            assert a.keys() == b.keys()
            for u in b:
                np.testing.assert_array_equal(a[u], b[u], err_msg=f"user_consumed[{u}]")
        else:
            assert a == b, f.name
    assert got.num_tree_nodes == ref.num_tree_nodes


@pytest.mark.parametrize("leaf_init_mode", ["random", "category"])
@pytest.mark.parametrize("data_mode", ["default", "one_user_sample"])
def test_build_otm_data_matches_jax(small_csv, leaf_init_mode, data_mode):
    kw = dict(seq_len=10, min_seq_len=2, split_ratio=0.8, leaf_init_mode=leaf_init_mode,
              label_num=5, seed=7, data_mode=data_mode)
    _assert_same_data(ds.build_otm_data(small_csv, **kw), jds.build_otm_data(small_csv, **kw))


def test_mapping_files_cross_load_and_rebuild_the_same_data(small_csv, tmp_path):
    ref = jds.build_otm_data(small_csv, 10, 2, 0.8, label_num=5, seed=3)
    jds.save_mapping(str(tmp_path / "j.txt"), ref.item_to_code)
    ds.save_mapping(str(tmp_path / "t.txt"), ref.item_to_code)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    fwd, rev = ds.load_mapping(str(tmp_path / "j.txt"))
    assert fwd == ref.item_to_code and rev == ref.code_to_item
    assert jds.load_mapping(str(tmp_path / "t.txt"))[0] == ref.item_to_code
    _assert_same_data(ds.build_otm_data(small_csv, 10, 2, 0.8, label_num=5, mapping=(fwd, rev)),
                      jds.build_otm_data(small_csv, 10, 2, 0.8, label_num=5,
                                         mapping=jds.load_mapping(str(tmp_path / "t.txt"))))


def test_tree_helpers_match_jax():
    for n in (1, 2, 3, 20, 1024, 1025, 3325):
        assert (ds.upper_log2(n), ds.lower_log2(n)) == (jds.upper_log2(n), jds.lower_log2(n))
    codes = np.array([7, 8, 10, 14])
    np.testing.assert_array_equal(ds.all_nodes_bitmap(codes, 3), jds.all_nodes_bitmap(codes, 3))


def test_otm_conf_reads_the_same_params():
    conf = str(REPO / "configs" / "otm.conf")
    base = str(REPO)
    for name in ("OTMModelParams", "OTMTreeParams"):
        prefix = "model" if name == "OTMModelParams" else "tree"
        got = getattr(cfg, name).from_conf(cfg.read_conf(conf, prefix), base)
        ref = getattr(jcfg, name).from_conf(jcfg.read_conf(conf, prefix), base)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    p = cfg.OTMModelParams.from_conf(cfg.read_conf(conf, "model"), base)
    assert (p.deep_model, p.embed_size, p.beam_size, p.seq_len, p.epoch_num) == ("din", 16, 20,
                                                                               10, 5)
