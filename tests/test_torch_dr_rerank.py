"""DR serving's block rerank kernel (``ops/dr_rerank.py``,
``csrc/dr_rerank.cu``).

On the CPU: the wrapper's plain branch is the plain chain
(``block_rerank_topk_plain``: path keys and first copies, the path-table
lookup, the block read, score, filter, dedup and top-k), and the chain
reading its rows through ``blocks_of`` as the mesh's masked gather does
(zeros where a path has no row) gives the same bits; the kernel's contract
(the top k distinct items by score descending, id ascending, written here
in numpy) is that chain's result up to the order of equal scores; the CUDA branch,
reached with a fake library, launches once a call with the geometry it was
given and raises on what the kernel does not take; ``profiling.snapshot()``
reports the launches.  On the card (``card`` tests, which import no JAX;
``tests/conftest.py`` does, so skip it there: ``python -m pytest
--noconftest tests/test_torch_dr_rerank.py -m card``): the kernel
against the plain chain and the contract at the serving cell's geometry,
at E = 8, 32 and 64, at beam 110, with 4-byte slot loads and with more
consumed ids than shared memory stages."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.ops import _cuda, dr_rerank
from dismember_tpu_torch.retrieval import dr_serve

CSRC = Path(dr_rerank.__file__).resolve().parent.parent / "csrc" / "dr_rerank.cu"
NEG_INF = np.float32(-3.4e38)

# name -> (E, J, k, beam, rows, K, D, items a path on average, consumed
# width (None: no list), options); the card cases at the serving cell's
# geometry and beside it
CPU_CASES = {
    "e16_j2_consumed": (16, 2, 10, 20, 48, 6, 3, 8.3, 10, {}),
    "e16_j2_no_consumed": (16, 2, 10, 20, 48, 6, 3, 8.3, None, {}),
    "e8_j1_consumed": (8, 1, 10, 20, 48, 6, 3, 8.3, 10, {}),
    "e8_j2_no_consumed": (8, 2, 10, 12, 48, 6, 3, 8.3, None, {}),
    "padded_beam": (16, 2, 10, 20, 48, 4, 2, 8.3, 10, {"padded_beam": True}),
    "empty_paths": (16, 2, 10, 20, 48, 6, 3, 8.3, 10, {"empty_share": 0.5}),
    "short_rows": (8, 2, 10, 4, 48, 6, 3, 0.8, 6, {}),
    "j1_k_over_pool": (16, 1, 40, 3, 32, 6, 3, 3.0, 10, {"empty_share": 0.3}),
}
CARD_CASES = {
    "cell": (16, 2, 10, 20, 2048, 30, 3, 8.33, 10, {"geometry": (24, 32)}),
    "e8": (8, 2, 10, 20, 1024, 30, 3, 8.33, 10, {}),
    "e32": (32, 2, 10, 20, 1024, 30, 3, 8.33, 10, {}),
    "e64": (64, 2, 10, 20, 1024, 30, 3, 8.33, 10, {}),
    "beam110": (16, 2, 10, 110, 1024, 30, 3, 8.33, 10, {"padded_beam": True}),
    "e16_4byte_loads": (16, 2, 10, 20, 1024, 10, 3, 36.0, 10, {"geometry": (22, 64)}),
    "e8_4byte_loads": (8, 2, 10, 20, 1024, 10, 3, 36.0, 10, {"geometry": (14, 64)}),
    "consumed_past_shared": (16, 2, 10, 20, 1024, 30, 3, 8.33, 100, {"empty_share": 0.2}),
    "k256": (16, 2, 256, 40, 512, 30, 3, 8.33, 10, {}),
}


def make_case(spec: tuple, seed: int = 0) -> dict:
    """The kernel's inputs on the CPU: a DevicePathMap and block table from
    a J-path mapping of uniform nodes (``empty_share`` of the first layer's
    nodes hold no item, so their paths have no row), beams of uniform
    paths (``padded_beam``: the back half repeats the front's, as a beam
    padded past K does), N(0, 1) weights and user vectors, biases N(0,
    0.5), and consumed lists mixing ids the row would serve, other catalog
    ids and -1 pads."""
    e, j, k, beam, b, kn, depth, per_path, cw, opts = spec
    rng = np.random.default_rng(seed)
    n_keys = kn**depth
    items = max(1, int(round(n_keys * per_path / j)))
    item_paths = rng.integers(0, kn, (items, j, depth)).astype(np.int32)
    share = opts.get("empty_share", 0.0)
    if share:
        item_paths[..., 0] %= max(1, int(round(kn * (1 - share))))
    dmap = dr_serve.DevicePathMap.build(PathIndex(item_paths=item_paths, num_nodes=kn),
                                        device="cpu")
    m = dmap.path_items.shape[1]
    planes, m_pad = dr_rerank.block_geometry(e, m)
    if "geometry" in opts:
        assert (planes, m_pad) == opts["geometry"], (m, planes, m_pad)
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(items, e, generator=g)
    bias = torch.randn(items, generator=g) * 0.5
    block_tab = dr_rerank.build_block_table(w, bias, dmap.path_items.long(), planes, m_pad)
    paths = rng.integers(0, kn, (b, beam, depth))
    if opts.get("padded_beam"):
        h = beam // 2
        pick = rng.integers(0, h, (b, beam - h))
        paths[:, h:] = np.take_along_axis(paths[:, :h], pick[..., None], 1)
    case = {"paths": torch.as_tensor(paths, dtype=torch.long), "path_table": dmap.path_table,
            "block_tab": block_tab, "user_vec": torch.randn(b, e, generator=g),
            "consumed": None, "num_nodes": kn, "e": e, "k": min(k, beam * m_pad),
            "j_paths": j}
    if cw is not None:
        served, _ = dr_rerank.block_rerank_topk_plain(**case)
        cons = rng.integers(0, items, (b, cw))
        hits = min(cw // 3, served.shape[1])
        cons[:, :hits] = served[:, :hits].numpy()  # hits (or -1 on short rows)
        cons[:, cw - cw // 4 :] = -1
        case["consumed"] = torch.as_tensor(cons, dtype=torch.long)
    return case


def masked_gather(block_tab):
    """``blocks_of`` as the mesh's masked gather reads rows: zeros where a
    path has no row."""
    return lambda rows: torch.where((rows >= 0)[..., None, None], block_tab[rows.clamp_min(0)],
                                    0)


def contract(paths, path_table, block_tab, user_vec, consumed, num_nodes, e, k, j_paths):
    """The kernel's contract in numpy: each live first-copy path's valid
    slots scored in f32 (bf16 user vector, products and sums over the planes
    in order, then the bias), consumed ids dropped, the top k distinct items
    by (score descending, id ascending); -1 and -3.4e38 past the items."""
    p = paths.cpu().numpy()
    b, beam, depth = p.shape
    keys = np.zeros((b, beam), np.int64)
    for d in range(depth):
        keys = keys * num_nodes + p[:, :, d]
    rows = path_table.cpu().numpy()[keys]
    blk = block_tab.cpu().float().numpy()
    ub = user_vec.cpu().to(torch.bfloat16).float().numpy()
    sl = blk[np.maximum(rows, 0)]  # [B, beam, m_pad, planes]
    s = sl[..., 0] * ub[:, None, None, 0]
    for l in range(1, e):
        s = s + sl[..., l] * ub[:, None, None, l]
    s = s + sl[..., e]
    ids = np.zeros(s.shape, np.int64)
    for d in range(4):
        ids = ids * 256 + sl[..., e + 1 + d].astype(np.int64)
    ok = sl[..., e + 5] > 0
    cons = None if consumed is None else consumed.cpu().numpy()
    out_ids = np.full((b, k), -1, np.int64)
    out_s = np.full((b, k), NEG_INF, np.float32)
    for i in range(b):
        live = np.zeros(beam, bool)
        seen = set()
        for q in range(beam):
            if rows[i, q] >= 0 and rows[i, q] not in seen:
                live[q] = True
                seen.add(rows[i, q])
        keep = ok[i] & live[:, None]
        if cons is not None:
            keep &= ~np.isin(ids[i], cons[i])
        cs, ci = s[i][keep], ids[i][keep]
        order = np.lexsort((ci, -cs))
        cs, ci = cs[order], ci[order]
        _, first = np.unique(ci, return_index=True)
        first = np.sort(first)[:k]
        out_ids[i, : len(first)] = ci[first]
        out_s[i, : len(first)] = cs[first]
    return torch.as_tensor(out_ids), torch.as_tensor(out_s)


def _plain_wider(case: dict) -> torch.Tensor:
    """The (k+1)-th distinct score of each row by the plain chain (-3.4e38
    where a row has no more than k items)."""
    wide = dict(case, k=case["k"] + 1)
    if wide["k"] > wide["paths"].shape[1] * wide["block_tab"].shape[1]:
        return torch.full((case["paths"].shape[0],), float(NEG_INF))
    return dr_rerank.block_rerank_topk_plain(**wide)[1][:, -1].cpu()


def agree_up_to_ties(ids, scores, ref_ids, ref_scores, kth1) -> None:
    """Scores equal bit for bit; ids equal, in (score descending, id
    ascending) order, on every row whose k-th and (k+1)-th distinct scores
    differ."""
    ids, scores, ref_ids, ref_scores = (t.cpu() for t in (ids, scores, ref_ids, ref_scores))
    assert torch.equal(scores.view(torch.int32), ref_scores.view(torch.int32))

    def canon(i, s):
        i, s = i.numpy(), s.numpy()
        order = np.lexsort((i, -s), axis=1) if i.size else np.zeros_like(i)
        return np.take_along_axis(i, order, 1)

    clear = ((scores[:, -1] != kth1) | (scores[:, -1] == NEG_INF)).numpy()
    assert clear.mean() > 0.9  # the comparison is not vacuous
    np.testing.assert_array_equal(canon(ids, scores)[clear], canon(ref_ids, ref_scores)[clear])


@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_plain_branch_is_the_former_chain_and_the_kernels_contract(name):
    case = make_case(CPU_CASES[name])
    ids, scores = dr_rerank.block_rerank_topk(**case)
    ref_ids, ref_scores = dr_rerank.block_rerank_topk_plain(
        **{**case, "block_tab": None}, blocks_of=masked_gather(case["block_tab"]))
    assert torch.equal(ids, ref_ids)
    assert torch.equal(scores.view(torch.int32), ref_scores.view(torch.int32))
    got_ids, got_scores = contract(**case)
    agree_up_to_ties(got_ids, got_scores, ids, scores, _plain_wider(case))
    if name == "short_rows":
        assert (ids[:, -1] == -1).any() and (scores[ids == -1] == NEG_INF).all()
    if name == "padded_beam":
        _, first = dr_rerank.path_keys_and_dedup(case["paths"], case["num_nodes"])
        assert not first.all()
    if name == "empty_paths":
        keys, _ = dr_rerank.path_keys_and_dedup(case["paths"], case["num_nodes"])
        assert (case["path_table"][keys] < 0).any()


# ---------------------------------------------------------------- CUDA branch
class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrapper's CUDA
    path on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda")


class _Lib:
    def __init__(self, code: int = 0):
        self.calls, self.code = [], code

    def dr_block_rerank_topk(self, *args):
        self.calls.append(args)
        return self.code

    def dismember_error_string(self, code):
        return b"an error"


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda dev: 0)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    return lib


def _on_fake_card(case: dict) -> dict:
    return {n: v.as_subclass(_FakeCuda) if isinstance(v, torch.Tensor) else v
            for n, v in case.items()}


def test_cuda_branch_launches_once_a_call_with_its_geometry(fake_lib):
    case = make_case(CPU_CASES["e16_j2_consumed"])
    b, beam, depth = case["paths"].shape
    n_paths, m_pad, planes = case["block_tab"].shape
    profiling.reset()
    n0 = dr_rerank.launches
    for call in range(3):
        ids, scores = dr_rerank.block_rerank_topk(**_on_fake_card(case))
        assert len(fake_lib.calls) == call + 1 and dr_rerank.launches == n0 + call + 1
        assert ids.shape == (b, case["k"]) and ids.dtype == torch.int64
        assert scores.shape == (b, case["k"]) and scores.dtype == torch.float32
    args = fake_lib.calls[-1]
    assert args[2] == case["path_table"].numel() and args[4] == n_paths
    assert args[6] == case["consumed"].data_ptr()
    assert args[9:18] == (b, beam, depth, case["num_nodes"], case["e"], planes, m_pad,
                          case["consumed"].shape[1], case["k"])
    assert args[18] == 0  # the stream
    no_cons = dict(case, consumed=None)
    dr_rerank.block_rerank_topk(**_on_fake_card(no_cons))
    assert fake_lib.calls[-1][6] is None and fake_lib.calls[-1][16] == 0
    # the snapshot counts the launches since the reset
    assert profiling.snapshot()["counters"]["dr_rerank.launches"] == dr_rerank.launches - n0 == 4


def _bad(case: dict, what: str) -> dict:
    c = dict(case)
    if what == "paths_int32":
        c["paths"] = c["paths"].int()
    elif what == "block_tab_f32":
        c["block_tab"] = c["block_tab"].float()
    elif what == "user_vec_f64":
        c["user_vec"] = c["user_vec"].double()
    elif what == "consumed_int32":
        c["consumed"] = c["consumed"].int()
    elif what == "path_table_int64":
        c["path_table"] = c["path_table"].long()
    elif what == "user_vec_shape":
        c["user_vec"] = torch.zeros(c["user_vec"].shape[0], c["e"] + 1)
    elif what == "path_table_shape":
        c["path_table"] = c["path_table"][:-1].clone()
    elif what == "consumed_rows":
        c["consumed"] = c["consumed"][1:].clone()
    elif what == "user_vec_strided":
        c["user_vec"] = torch.zeros(c["e"], c["user_vec"].shape[0]).T
    elif what == "block_tab_strided":
        c["block_tab"] = c["block_tab"].transpose(1, 2)
    elif what == "width_12":
        c["e"], c["user_vec"] = 12, torch.zeros(c["user_vec"].shape[0], 12)
    elif what == "planes_short":
        c["block_tab"] = c["block_tab"][..., :20].contiguous()
    elif what == "k_past_limit":
        c["k"] = dr_rerank.MAX_K + 1
        c["block_tab"] = torch.zeros(2, 16, 24, dtype=torch.bfloat16)
    elif what == "beam_past_limit":
        b = c["paths"].shape[0]
        c["paths"] = torch.zeros(b, dr_rerank.MAX_BEAM + 1, 3, dtype=torch.long)
    return c


BAD = ("paths_int32", "block_tab_f32", "user_vec_f64", "consumed_int32", "path_table_int64",
       "user_vec_shape", "path_table_shape", "consumed_rows", "user_vec_strided",
       "block_tab_strided", "width_12", "planes_short", "k_past_limit", "beam_past_limit")


@pytest.mark.parametrize("what", BAD)
def test_cuda_branch_raises_on_what_the_kernel_does_not_take(fake_lib, what):
    case = _bad(make_case(CPU_CASES["e16_j2_consumed"]), what)
    n0 = dr_rerank.launches
    with pytest.raises(ValueError, match="block_rerank_topk"):
        dr_rerank.block_rerank_topk(**_on_fake_card(case))
    assert not fake_lib.calls and dr_rerank.launches == n0


def test_cuda_branch_raises_on_a_failed_launch(fake_lib):
    fake_lib.code = 1
    n0 = dr_rerank.launches
    with pytest.raises(RuntimeError, match="block_rerank_topk launch failed"):
        dr_rerank.block_rerank_topk(**_on_fake_card(make_case(CPU_CASES["e8_j1_consumed"])))
    assert dr_rerank.launches == n0


def test_the_kernel_takes_every_block_geometry_and_mirrors_its_limits():
    """The wrapper's limits are the source's, and it takes every geometry
    ``block_geometry`` gives at the built widths (slots of 4-byte-aligned
    planes, rows of 16-byte vectors)."""
    src = CSRC.read_text()
    assert int(re.search(r"constexpr int kMaxBeam = (\d+);", src)[1]) == dr_rerank.MAX_BEAM
    assert int(re.search(r"constexpr int kMaxK = (\d+);", src)[1]) == dr_rerank.MAX_K
    built = tuple(int(w) for w in re.findall(r"DR_RERANK_CASE\((\d+)\)", src))
    assert built == dr_rerank.KERNEL_WIDTHS
    for e in dr_rerank.KERNEL_WIDTHS:
        for m in range(1, 129):
            planes, m_pad = dr_rerank.block_geometry(e, m)
            assert planes % 2 == 0 and planes >= e + 6 and planes * m_pad % 8 == 0
            dr_rerank._check(torch.zeros(2, 20, 3, dtype=torch.long),
                             torch.zeros(4**3, dtype=torch.int32),
                             torch.zeros(1, m_pad, planes, dtype=torch.bfloat16),
                             torch.zeros(2, e), None, 4, e, min(10, 20 * m_pad))
    assert dr_rerank.block_geometry(128, 1) is None  # no block route past the widths


@pytest.mark.parametrize("e,beam,k,taken", [(16, 20, 10, True), (96, 256, 256, True),
                                            (12, 20, 10, False), (16, 257, 10, False),
                                            (16, 20, 257, False)])
def test_the_block_route_goes_packed_on_the_card_past_the_kernels_limits(monkeypatch, e, beam,
                                                                         k, taken):
    """On a CUDA device ``make_dr_serving_fn`` serves a block route that the
    kernel does not take (width, beam or k) packed; on the CPU the plain
    chain takes it."""
    cuda = torch.device("cuda", 0)
    assert dr_rerank.takes(cuda, e, beam, k) is taken
    assert dr_rerank.takes(torch.device("cpu"), e, beam, k)
    tr = _tiny_dr_trainer()
    assert dr_serve.make_dr_serving_fn(tr, rerank_table="block").route == "block"
    seen = []

    def on_card(device, e_, beam_, k_):
        seen.append((e_, beam_, k_))
        return taken
    monkeypatch.setattr(dr_rerank, "takes", on_card)
    fn = dr_serve.make_dr_serving_fn(tr, rerank_table="block")
    assert fn.route == ("block" if taken else "packed") and seen == [(8, 6, 5)]


def _tiny_dr_trainer(n: int = 400, l: int = 5):
    """A 400-item DR trainer on the CPU: 2 layers of 8 nodes, E = 8, beam 6,
    top 5."""
    from dismember_tpu_torch.data.dr_dataset import DRData
    from dismember_tpu_torch.train.dr import DRTrainer

    empty = np.empty((0, l), np.int64)
    data = DRData(item_to_id={}, id_to_item={}, num_items=n, train_seqs=empty,
                  train_targets=np.empty(0, np.int64), eval_seqs=empty,
                  eval_labels=np.empty((0, 1), np.int64), eval_users=np.empty(0, np.int64),
                  user_consumed={})
    return DRTrainer(data, num_layers=2, num_nodes=8, num_paths_per_item=2, embed_size=8,
                     beam_size=6, seq_len=l, topk=5, device="cpu")


def test_the_block_closure_reranks_through_the_wrapper_inside_its_span(monkeypatch):
    rng = np.random.default_rng(3)
    n, l = 400, 5
    tr = _tiny_dr_trainer(n, l)
    fn = dr_serve.make_dr_serving_fn(tr, rerank_table="block")
    calls = []
    real = dr_rerank.block_rerank_topk

    def counted(*args, **kwargs):
        stack = profiling._stack()
        calls.append(stack[-1].name if stack else None)
        return real(*args, **kwargs)

    monkeypatch.setattr(dr_rerank, "block_rerank_topk", counted)
    seqs = torch.as_tensor(rng.integers(-1, n, (7, l)))
    cons = torch.as_tensor(rng.integers(-1, n, (7, 4)))
    profiling.enable(True)
    try:
        for _ in range(2):
            ids, scores = fn(tr.layer_params, tr.rerank_params, seqs, cons)
    finally:
        profiling.enable(False)
        profiling.reset()
    assert calls == ["dr_serve.rerank"] * 2
    assert ids.shape == (7, 5) and not np.isin(ids.numpy(), cons.numpy()[cons.numpy() >= 0]).any()


# ---------------------------------------------------------------- on the card
@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_against_the_plain_chain_on_the_card(card, name):
    case = make_case(CARD_CASES[name], seed=11)
    on = {n: v.to(card) if isinstance(v, torch.Tensor) else v for n, v in case.items()}
    n0 = dr_rerank.launches
    ids, scores = dr_rerank.block_rerank_topk(**on)
    again = dr_rerank.block_rerank_topk(**on)
    torch.cuda.synchronize()
    assert dr_rerank.launches == n0 + 2
    assert torch.equal(ids, again[0]) and torch.equal(scores.view(torch.int32),
                                                      again[1].view(torch.int32))
    plain_ids, plain_scores = dr_rerank.block_rerank_topk_plain(**on)
    agree_up_to_ties(ids, scores, plain_ids, plain_scores, _plain_wider(on))
    ref_ids, ref_scores = contract(**case)
    assert torch.equal(ids.cpu(), ref_ids)
    assert torch.equal(scores.cpu().view(torch.int32), ref_scores.view(torch.int32))
