"""The port's ``core/compress.py``, ``core/profiling.py``,
``index/tree_io.ancestors_of`` and ``examples/recommend_demo_torch.py``
against the JAX package's: the codec bit for bit on the CPU, a trace
written, the step timer's counters and log lines, the ancestors, and the
demo's recommendation."""

import importlib.util
import json
import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dismember_tpu.core import compress as jcompress
from dismember_tpu.core import profiling as jprofiling
from dismember_tpu.index import tree_io as jtree_io
from dismember_tpu.models import din as jdin
from dismember_tpu.serving import TDMServing as JTDMServing
from dismember_tpu_torch.core import compress, profiling
from dismember_tpu_torch.core.checkpoint import save_pytree
from dismember_tpu_torch.index import tree_io

REPO = pathlib.Path(__file__).resolve().parent.parent
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp16": (torch.float16, jnp.float16)}


def _tree(seed):
    """Nested dicts and lists of f32 arrays at scales where rounding shows:
    values between representable bf16/fp16 numbers, ties and subnormals."""
    rng = np.random.default_rng(seed)
    ties = (np.arange(64, dtype=np.float32) + 0.5) * np.float32(2.0**-7) + 1.0
    return {"w": (rng.standard_normal((5, 7)) * 10).astype(np.float32),
            "layers": [rng.standard_normal(33).astype(np.float32) * 1e-6,
                       {"b": ties, "c": rng.standard_normal((2, 3)).astype(np.float32) * 300}]}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(tree)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.element_size() == 2 else torch.int32).numpy()
    else:
        x = np.asarray(x)
        x = x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)
    return x


def _assert_same(got, want):
    gl, gs = jax.tree.flatten(got)
    wl, ws = jax.tree.flatten(want)
    assert gs == ws
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_codec_bit_equal_to_jax(name):
    tdt, jdt = DTYPES[name]
    a, b = _tree(0), _tree(1)
    ca, cb = compress.compress(_torch(a), tdt), compress.compress(_torch(b), tdt)
    ja, jb = jcompress.compress(jax.tree.map(jnp.asarray, a), jdt), \
        jcompress.compress(jax.tree.map(jnp.asarray, b), jdt)
    _assert_same(ca, ja)
    assert ca["w"].dtype == tdt
    _assert_same(compress.decompress(ca), jcompress.decompress(ja))
    summed = compress.compressed_add(ca, cb)
    assert summed["layers"][1]["b"].dtype == tdt
    _assert_same(summed, jcompress.compressed_add(ja, jb))


def test_default_dtypes_are_bf16_and_f32():
    c = compress.compress({"x": torch.ones(2)})
    assert c["x"].dtype == torch.bfloat16
    assert compress.decompress(c)["x"].dtype == torch.float32


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert prof is not None
    (path,) = (tmp_path / "tr").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names
    with pytest.raises(ValueError, match="inside"):
        with profiling.trace(str(tmp_path / "raised")):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert len(list((tmp_path / "raised").glob("trace_*.json"))) == 1


def test_step_timer_counts_and_logs_as_jax(caplog):
    with caplog.at_level(logging.INFO):
        t, jt = profiling.StepTimer("serve", log_every=2), jprofiling.StepTimer("serve", 2)
        for n in (5, 7, 9):
            t.step(n)
            jt.step(n)
    assert (t.count, t.items) == (jt.count, jt.items) == (3, 21)
    assert t.rate > 0
    port = [r.getMessage() for r in caplog.records if r.name == "dismember_tpu_torch.profiling"]
    jax_ = [r.getMessage() for r in caplog.records if r.name == "dismember_tpu.profiling"]
    assert len(port) == len(jax_) == 1
    assert port[0].split(",")[0] == jax_[0].split(",")[0] == "serve: step 2"


@pytest.mark.parametrize("max_level", [1, 5, 12])
def test_ancestors_of_equals_jax(max_level):
    first_leaf = (1 << max_level) - 1
    for code in range(first_leaf, 2 * first_leaf + 1):
        assert tree_io.ancestors_of(code, max_level) == jtree_io.ancestors_of(code, max_level)
    assert tree_io.ancestors_of(first_leaf, max_level)[-1] == 0


def test_recommend_demo_on_the_cpu(tmp_path, capsys):
    ids = np.arange(1, 101)  # 7 levels: both facades take the classic loop
    sorted_ids, codes = tree_io.category_sorted_codes(ids, ids // 10)
    tree_path = str(tmp_path / "tree.bin")
    tree_io.write_tree(tree_path, sorted_ids, codes)
    n_codes = 2 ** (int(np.log2(codes.max() + 1)) + 1) - 1
    params = jax.tree.map(np.asarray, jdin.init_params(jax.random.PRNGKey(2), n_codes, 16))
    ckpt = str(tmp_path / "din")
    save_pytree(ckpt, params, meta={"model": "din", "embed_size": 16, "seq_len": 10})
    spec = importlib.util.spec_from_file_location(
        "recommend_demo_torch", REPO / "examples" / "recommend_demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    demo.main(ckpt, tree_path, device="cpu")
    out = capsys.readouterr().out.splitlines()
    jserv = JTDMServing.load(ckpt, tree_path, topk=10, candidate_num=20)
    want = jserv.recommend(np.asarray(jserv.tree.item_ids[:10]), topk=10)
    assert out[0] == f"Recommendation result: {want.tolist()}"
    assert out[2].startswith("Batched throughput:") and out[2].endswith("on cpu")
