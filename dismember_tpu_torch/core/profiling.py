"""Profiling and observability helpers.

Port of ``dismember_tpu/core/profiling.py``.  The reference times everything
with nanoTime logs (SURVEY.md §5); here the same structured counters exist,
plus traces through ``torch.profiler`` (host operations, and the card's
kernels when CUDA is available) in place of ``jax.profiler``: open the
Chrome trace in ``chrome://tracing`` or Perfetto.

Spans and counters.  The port's layers open named spans
(``span("serving.recommend_batch")``, ``span("row_step.step")``, ...) and
bump counters (``count("serving.batches")``).  Recording is off by default:
a span is then one flag test returning a shared no-op context, and a count
one flag test.  ``enable(True)`` turns it on for the process; each span then
records its name, its start and end on ``time.perf_counter_ns``, its parent
(the span open on the same thread when it opened) and the id of the
top-level span it belongs to, and, while a ``torch.profiler`` is
recording, is also a ``record_function`` of its name, so that the
profiler's trace shows the span on its own clock, on the thread that issued
the work.  ``snapshot()`` aggregates the spans by name and returns the
counters, with the kernel modules' launch counters read beside them;
``write(path)`` dumps both and the raw records as JSON; ``reset()`` clears
them.  ``trace()`` records for its block.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time

import numpy as np
import torch

logger = logging.getLogger("dismember_tpu_torch.profiling")

# raw span records kept after a reset; past the cap only the aggregates grow
RAW_CAP = 1 << 16
# the most recent durations kept a span name, for its p50 and p95
TAIL = 4096

_on = False
_profiler_on = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open spans, innermost last
_OFF = contextlib.nullcontext()  # the context every span returns while recording is off


class _Records:
    """What the recorder holds between two resets."""

    def __init__(self):
        self.raw: list[list] = []  # [name, start_ns, end_ns, parent index, top id]
        self.dropped = 0  # spans past RAW_CAP, in the aggregates only
        self.tops = 0  # top-level spans opened
        # name -> [calls, total ns, self ns, recent durations (ns)]
        self.agg: dict[str, list] = {}
        self.counters: dict[str, int] = {}


_rec = _Records()
_launch_base: dict = {}  # _launch_totals() at the last reset()


class _Span:
    __slots__ = ("name", "rec", "index", "top", "child_ns", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        # a profiler's own range of the span, where one is recording
        self.rf = torch.profiler.record_function(self.name) if _profiler_on() else None
        if self.rf is not None:
            self.rf.__enter__()
        with _lock:
            rec = self.rec = _rec
            if parent is None or parent.rec is not rec:
                rec.tops += 1
                self.top, up = rec.tops, -1
            else:
                self.top, up = parent.top, parent.index
            if len(rec.raw) < RAW_CAP:
                self.index = len(rec.raw)
                rec.raw.append([self.name, 0, 0, up, self.top])
            else:
                self.index = -1
                rec.dropped += 1
        self.child_ns = 0
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        dur = end - self.start
        if stack:
            stack[-1].child_ns += dur
        rec = self.rec
        with _lock:
            if self.index >= 0:
                rec.raw[self.index][1:3] = self.start, end
            a = rec.agg.get(self.name)
            if a is None:
                a = rec.agg[self.name] = [0, 0, 0, collections.deque(maxlen=TAIL)]
            a[0] += 1
            a[1] += dur
            a[2] += dur - self.child_ns
            a[3].append(dur)
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def enabled() -> bool:
    """Whether spans and counters are being recorded."""
    return _on


def enable(on: bool = True) -> bool:
    """Turn recording on or off for the process; returns the previous
    state."""
    global _on
    prev, _on = _on, bool(on)
    return prev


def span(name: str):
    """Context manager timing the enclosed block as span ``name`` while
    recording is on; a shared no-op context while it is off."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording is on."""
    if not _on:
        return
    with _lock:
        _rec.counters[name] = _rec.counters.get(name, 0) + n


def reset() -> None:
    """Drop every span record, aggregate and counter; the kernel modules'
    launch counters are theirs and stay, and ``snapshot()`` counts their
    launches from here on."""
    global _rec, _launch_base
    with _lock:
        _rec = _Records()
        _launch_base = _launch_totals()


def _launch_totals() -> dict:
    """The kernel modules' own launch counters on CUDA tensors, since the
    process started or the module's user zeroed them."""
    from dismember_tpu_torch.ops import din_kernel, dr_rerank, packed_level_kernel, row_writer

    out = {"k1.launches": din_kernel.launches,
           "k3.launches": packed_level_kernel.launches,
           "k3.launches_bf16_rows": packed_level_kernel.launches_bf16_rows,
           "dr_rerank.launches": dr_rerank.launches}
    out.update({f"k2.{k}": v for k, v in row_writer.launches.items()})
    return out


def _launch_counters() -> dict:
    """The kernel modules' launches since the last ``reset()``, comparable
    with the span counters of the same stretch."""
    with _lock:
        base = _launch_base
    return {k: v - base.get(k, 0) for k, v in _launch_totals().items()}


def snapshot() -> dict:
    """``{"spans": {name: {calls, total_s, self_s, mean_s, p50_s, p95_s}},
    "counters": {name: n}, "records": kept, "dropped": past the cap}``.
    Self time is a span's duration less what its child spans cover; p50 and
    p95 are over the name's last ``TAIL`` calls."""
    with _lock:
        rec = _rec
        aggs = {k: (a[0], a[1], a[2], list(a[3])) for k, a in rec.agg.items()}
        counters = dict(rec.counters)
        kept, dropped = len(rec.raw), rec.dropped
    spans = {}
    for name, (calls, total, self_ns, tail) in aggs.items():
        p50, p95 = np.percentile(np.asarray(tail, np.float64), [50, 95]) * 1e-9
        spans[name] = {"calls": calls, "total_s": total * 1e-9, "self_s": self_ns * 1e-9,
                       "mean_s": total * 1e-9 / calls, "p50_s": float(p50),
                       "p95_s": float(p95)}
    return {"spans": spans, "counters": {**counters, **_launch_counters()},
            "records": kept, "dropped": dropped}


def write(path: str) -> None:
    """Write ``snapshot()`` and the raw span records (name, start and end
    in ``perf_counter`` ns, the parent's record index or -1, the top-level
    span's id) to ``path`` as JSON."""
    snap = snapshot()
    with _lock:
        raw = [list(r) for r in _rec.raw]
    snap["raw"] = [dict(zip(("name", "start_ns", "end_ns", "parent", "top"), r)) for r in raw]
    with open(path, "w") as f:
        json.dump(snap, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` and export it, also
    when the block raises, as ``trace_<pid>_<ns>.json`` (Chrome trace
    format) into ``log_dir``; yields the profiler.  Spans are recorded in
    the block (the previous state comes back after it), so the trace shows
    the port's layers as ``user_annotation`` events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    was_on = enable(True)
    try:
        with prof:
            try:
                yield prof
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()  # the block's kernels end inside the trace
    finally:
        enable(was_on)
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info(f"trace written to {path}")


class StepTimer:
    """Throughput counter: examples/s and queries/s with periodic logs.

    Mirrors the reference's progress strings (epoch time, count/total,
    iteration time — tdm LocalOptimizer.scala:210-227) in a reusable form.
    """

    def __init__(self, name: str, log_every: int = 100):
        self.name = name
        self.log_every = log_every
        self.count = 0
        self.items = 0
        self.t0 = time.perf_counter()
        self.last = self.t0

    def step(self, n_items: int) -> None:
        self.count += 1
        self.items += n_items
        if self.log_every and self.count % self.log_every == 0:
            now = time.perf_counter()
            rate = self.items / (now - self.t0)
            logger.info(
                f"{self.name}: step {self.count}, {rate:,.0f} items/s "
                f"(last {self.log_every}: "
                f"{self.log_every * n_items / (now - self.last):,.0f}/s)"
            )
            self.last = now

    @property
    def rate(self) -> float:
        return self.items / max(time.perf_counter() - self.t0, 1e-9)
