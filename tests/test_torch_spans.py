"""The port's span and counter recorder (``core/profiling.py``): nothing is
recorded while it is off, and while it is on each span keeps its parent, its
top-level span's id and its self time, counters add up, ``reset`` and the
raw-record cap bound what is kept, threads keep their own nesting, and the
spans show as ``user_annotation`` events around their operations in a
``profiling.trace`` Chrome trace."""

import json
import os
import pathlib
import re
import sys
import threading

import pytest
import torch

from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.ops import din_kernel, dr_rerank, packed_level_kernel, row_writer

REPO = pathlib.Path(__file__).resolve().parent.parent
# the port's spans and counters, each named in PERF.md section 3 with the
# per-layer metric it feeds
PORT_NAMES = {"serving.recommend_batch", "serving.batches", "serving.codes",
              "serving.download", "packed_beam.search", "tree_beam.filter_topk",
              "tree_beam.filter_native", "tdm.step",
              "tdm.steps", "sampler.sample", "row_step.step", "tdm.drain", "otm.batch",
              "otm.batches", "otm.frozen", "dr_serving.recommend_batch", "dr_serving.batches",
              "dr_serving.upload", "dr_serving.download", "dr_serving.short_lists",
              "path_beam.search", "dr_serve.rerank", "dr_serve.truncated_paths"}
LAUNCH_KEYS = {"k1.launches", "k3.launches", "k3.launches_bf16_rows", "k2.write_rows",
               "k2.add_rows", "k2.add_rows_bf16", "dr_rerank.launches"}


@pytest.fixture(autouse=True)
def _off_and_empty():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture
def clock(monkeypatch):
    """``perf_counter_ns`` as a clock that moves only when told to."""
    now = [1000]
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: now[0])

    def tick(ns):
        now[0] += ns

    return tick


def _raw(tmp_path):
    path = tmp_path / "spans.json"
    profiling.write(str(path))
    return json.loads(path.read_text())


def test_off_records_nothing_and_returns_the_shared_no_op_context(tmp_path):
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c", 3)
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["records"] == snap["dropped"] == 0
    assert set(snap["counters"]) == LAUNCH_KEYS
    assert _raw(tmp_path)["raw"] == []


def test_nesting_self_time_and_shared_top_ids(clock, tmp_path):
    assert profiling.enable(True) is False
    for outer in (10, 30):
        with profiling.span("call"):
            clock(outer)
            with profiling.span("inner"):
                clock(5)
                with profiling.span("leaf"):
                    clock(2)
            with profiling.span("leaf"):
                clock(3)
    with profiling.span("alone"):
        clock(7)
    raw = _raw(tmp_path)["raw"]
    assert [(r["name"], r["parent"], r["top"]) for r in raw] == [
        ("call", -1, 1), ("inner", 0, 1), ("leaf", 1, 1), ("leaf", 0, 1),
        ("call", -1, 2), ("inner", 4, 2), ("leaf", 5, 2), ("leaf", 4, 2), ("alone", -1, 3)]
    assert [r["end_ns"] - r["start_ns"] for r in raw] == [20, 7, 2, 3, 40, 7, 2, 3, 7]
    s = profiling.snapshot()["spans"]
    assert s["call"]["calls"] == 2
    assert s["call"]["total_s"] == pytest.approx(60e-9)
    assert s["call"]["self_s"] == pytest.approx(40e-9)  # less inner and the second leaf
    assert s["inner"]["self_s"] == pytest.approx(10e-9) and s["leaf"]["calls"] == 4
    assert s["call"]["mean_s"] == pytest.approx(30e-9)
    assert s["call"]["p50_s"] == pytest.approx(30e-9)
    assert s["call"]["p95_s"] == pytest.approx(39e-9)


def test_counters_add_and_reset_clears_spans_and_counters_but_not_launches(monkeypatch):
    monkeypatch.setattr(din_kernel, "launches", 7)
    monkeypatch.setattr(packed_level_kernel, "launches", 18)
    monkeypatch.setitem(row_writer.launches, "write_rows", 3)
    profiling.enable(True)
    profiling.count("serving.batches")
    profiling.count("serving.batches", 2)
    with profiling.span("a"):
        pass
    snap = profiling.snapshot()
    assert snap["counters"]["serving.batches"] == 3
    assert (snap["counters"]["k1.launches"], snap["counters"]["k3.launches"],
            snap["counters"]["k2.write_rows"]) == (7, 18, 3)
    profiling.reset()
    snap = profiling.snapshot()
    assert snap["spans"] == {} and "serving.batches" not in snap["counters"]
    # the modules keep their counts; the snapshot counts launches from the
    # reset on, as it counts the spans and counters of the same stretch
    assert (din_kernel.launches, packed_level_kernel.launches) == (7, 18)
    assert snap["counters"]["k1.launches"] == snap["counters"]["dr_rerank.launches"] == 0
    monkeypatch.setattr(din_kernel, "launches", 9)
    monkeypatch.setattr(dr_rerank, "launches", dr_rerank.launches + 4)
    snap = profiling.snapshot()
    assert (snap["counters"]["k1.launches"], snap["counters"]["k3.launches"],
            snap["counters"]["dr_rerank.launches"]) == (2, 0, 4)


def test_raw_records_stop_at_the_cap_and_aggregates_go_on(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "RAW_CAP", 5)
    monkeypatch.setattr(profiling, "TAIL", 4)
    profiling.reset()
    profiling.enable(True)
    for _ in range(4):
        with profiling.span("top"):
            with profiling.span("child"):
                pass
    snap = profiling.snapshot()
    assert (snap["records"], snap["dropped"]) == (5, 3)
    assert snap["spans"]["top"]["calls"] == snap["spans"]["child"]["calls"] == 4
    raw = _raw(tmp_path)["raw"]
    assert len(raw) == 5 and [r["top"] for r in raw] == [1, 1, 2, 2, 3]


def test_a_span_open_across_a_reset_lands_in_the_old_records():
    profiling.enable(True)
    with profiling.span("before"):
        profiling.reset()
        with profiling.span("after"):
            pass
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {"after"} and snap["records"] == 1


def test_threads_keep_their_own_nesting_and_lose_no_update():
    """More threads than cores, switching every microsecond: every span and
    count lands, and each child's parent is its own thread's span."""
    n_threads = (os.cpu_count() or 1) + 1
    per = min(200, profiling.RAW_CAP // (4 * n_threads))  # every record kept
    profiling.enable(True)
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait()
        for _ in range(per):
            with profiling.span(f"t{i}"):
                profiling.count("n")
                with profiling.span(f"t{i}.child"):
                    profiling.count("n")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.snapshot()
    assert snap["counters"]["n"] == 2 * per * n_threads
    assert all(snap["spans"][f"t{i}"]["calls"] == per for i in range(n_threads))
    raw = profiling._rec.raw
    for r in raw:
        if r[0].endswith(".child"):
            assert raw[r[3]][0] == r[0][: -len(".child")]
    assert len({r[4] for r in raw}) == per * n_threads


def test_spans_are_user_annotations_around_their_ops_in_a_trace(tmp_path):
    assert not profiling.enabled()
    with profiling.trace(str(tmp_path / "tr")):
        assert profiling.enabled()
        with profiling.span("outer.step"):
            with profiling.span("inner.mm"):
                torch.mm(torch.ones(16, 16), torch.ones(16, 16))
            torch.ones(4).sum()
    assert not profiling.enabled()
    (path,) = (tmp_path / "tr").glob("trace_*.json")
    xs = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def first(name, cat):
        e = min((e for e in xs if e["name"] == name and e.get("cat") == cat),
                key=lambda e: float(e["ts"]))
        return float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]

    o0, o1, otid = first("outer.step", "user_annotation")
    i0, i1, itid = first("inner.mm", "user_annotation")
    m0, m1, mtid = first("aten::mm", "cpu_op")
    s0, s1, _ = first("aten::sum", "cpu_op")
    assert otid == itid == mtid
    assert o0 <= i0 <= m0 <= m1 <= i1 <= o1
    assert i1 <= s0 and s1 <= o1
    assert profiling.snapshot()["spans"]["inner.mm"]["calls"] == 1


def test_trace_restores_recording_that_was_on(tmp_path):
    profiling.enable(True)
    with profiling.trace(str(tmp_path / "tr")):
        pass
    assert profiling.enabled()


def test_the_port_opens_the_documented_spans_and_counters():
    found = set()
    for f in (REPO / "dismember_tpu_torch").rglob("*.py"):
        found |= set(re.findall(r'profiling\.(?:span|count)\("([^"]+)"', f.read_text()))
    assert found == PORT_NAMES
    perf = (REPO / "PERF.md").read_text()
    assert not [n for n in sorted(PORT_NAMES) if f"`{n}`" not in perf]
