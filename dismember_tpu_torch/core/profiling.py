"""Profiling and observability helpers.

Port of ``dismember_tpu/core/profiling.py``.  The reference times everything
with nanoTime logs (SURVEY.md §5); here the same structured counters exist,
plus traces through ``torch.profiler`` (host operations, and the card's
kernels when CUDA is available) in place of ``jax.profiler``: open the
Chrome trace in ``chrome://tracing`` or Perfetto.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("dismember_tpu_torch.profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` and export it, also
    when the block raises, as ``trace_<pid>_<ns>.json`` (Chrome trace
    format) into ``log_dir``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            try:
                yield prof
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()  # the block's kernels end inside the trace
    finally:
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
