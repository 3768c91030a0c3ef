"""The device trace of a short stretch of a cell's work, taken with
``torch.profiler`` itself (no wrapper of the program's), reduced to what the
per-layer readers need: each device operation's name and interval, the
union of those intervals (busy), the traced window, and the idle gaps
labelled by what the host was doing.

The profiler is opened only after every host-clock measurement of the run:
once it has traced, the host's launches stay slower for the rest of the
process.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    ops: list  # (name, start_us, dur_us) of device operations in the window
    window_s: float
    busy_s: float
    gaps: list  # (host label, seconds) of each idle gap
    units: int  # units of work the stretch ran

    def device_s(self, names: tuple[str, ...]) -> float:
        """Device seconds of the operations whose name holds one of ``names``."""
        return sum(d for n, _, d in self.ops if any(s in n for s in names)) * 1e-6

    def count(self, names: tuple[str, ...] | None = None) -> int:
        return sum(1 for n, _, _ in self.ops if names is None or any(s in n for s in names))

    def top_ops(self, k: int = 10) -> list:
        acc = collections.Counter()
        for n, _, d in self.ops:
            acc[n[:120]] += d * 1e-6
        return [[n, s] for n, s in acc.most_common(k)]

    def top_gaps(self, k: int = 10) -> list:
        acc = collections.Counter()
        for n, s in self.gaps:
            acc[n[:120]] += s
        return [[n, s] for n, s in acc.most_common(k)]


@contextlib.contextmanager
def profiled(out_json: Path, cuda: bool = True):
    """Profile the block (host, and the device where ``cuda``); the block's
    own region is the ``bench.window`` annotation.  The Chrome trace goes to
    ``out_json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize()
    out_json.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_json))


def _union(intervals: list) -> tuple[float, list]:
    """(covered length, merged intervals) of [start, end) intervals."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def read(out_json: Path, units: int) -> Trace:
    events = json.loads(out_json.read_text())["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("profiler trace holds no bench.window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = [(e["name"], float(e["ts"]), float(e["dur"])) for e in xs
           if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1]
    busy_us, merged = _union([(s, min(s + d, w1)) for _, s, d in ops])
    tid = win[0].get("tid")
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid and e.get("name") != WINDOW),
                  key=lambda h: (h[0], -h[1]))
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    spans = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    labels = _innermost(host, [(s + e) / 2 for s, e in spans])
    gaps = [(label, (e - s) * 1e-6) for label, (s, e) in zip(labels, spans)]
    return Trace(ops=ops, window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, gaps=gaps,
                 units=units)


def _innermost(host: list, points: list) -> list:
    """For each point (ascending), the name of the innermost host event that
    covers it.  Events of one thread nest, so a stack swept over the events
    in order of start (the outer first at equal starts) holds the open
    ones, the innermost on top."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            s, e, name = host[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append(stack[-1][2] if stack else "host: untraced")
    return out
