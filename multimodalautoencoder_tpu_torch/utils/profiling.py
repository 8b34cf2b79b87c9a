"""Tracing and timing helpers.

Counterpart of ``multimodalautoencoder_tpu/utils/profiling.py``.  The
reference has none: its only instrumentation is wall-clock per-setting
timing feeding an ETA printout (generic_wrapper.py:270-315), kept in
``sweep/engine.TimeEstimator``.  Here:

- :func:`trace`: a ``torch.profiler`` trace of the host and, where there
  is one, the CUDA device, written as a Chrome trace (chrome://tracing,
  Perfetto);
- :func:`annotate`: a named region on the trace's host timeline
  (``record_function``);
- :func:`materialize` / :func:`blocking_time`: wall-clock time that
  includes the devices finishing the work;
- :class:`PhaseTimer`: named wall-clock phase records a sweep can attach
  to its ledger rows.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into ``log_dir/trace.json`` (a Chrome trace):
    host operations, and CUDA kernels when CUDA is available."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region on the host timeline of a trace."""
    return torch.profiler.record_function(name)


def materialize(tree) -> None:
    """Wait until every CUDA device that holds a tensor of ``tree`` (a
    tensor, or nested lists, tuples and dicts of them) has finished its
    queued work.  CPU tensors are done when the call returns."""
    devices = set()

    def visit(node):
        if isinstance(node, torch.Tensor):
            if node.device.type == "cuda":
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


def blocking_time(fn: Callable[[], object]) -> float:
    """Wall-clock seconds of ``fn`` including the devices finishing its
    result's work."""
    t0 = time.perf_counter()
    out = fn()
    materialize(out)
    return time.perf_counter() - t0


class PhaseTimer:
    """Accumulates named phase durations; ``summary()`` yields a flat dict
    suitable for a results-ledger row or log line."""

    def __init__(self) -> None:
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(
                time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, vals in self.records.items():
            out[f"time_{name}_total_s"] = float(np.sum(vals))
            out[f"time_{name}_mean_s"] = float(np.mean(vals))
            out[f"time_{name}_count"] = len(vals)
        return out
