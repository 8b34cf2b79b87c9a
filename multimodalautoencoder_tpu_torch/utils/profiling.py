"""Tracing and timing helpers.

Counterpart of ``multimodalautoencoder_tpu/utils/profiling.py``.  The
reference has none: its only instrumentation is wall-clock per-setting
timing feeding an ETA printout (generic_wrapper.py:270-315), kept in
``sweep/engine.TimeEstimator``.  Here:

- :func:`trace`: a ``torch.profiler`` trace of the host and, where there
  is one, the CUDA device, written as a Chrome trace (chrome://tracing,
  Perfetto);
- :func:`span`: a named region of the program on the trace's host
  timeline (a ``record_function`` range), with counts, logged for
  :func:`take_spans`; without a running profiler it costs one flag read;
- :func:`materialize` / :func:`blocking_time`: wall-clock time that
  includes the devices finishing the work.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import time
from typing import Callable, List

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


_profiling = torch._C._autograd._profiler_enabled
# A span's region on the trace: a record_function range at operator scope
# (not a user annotation), so the profiler does not mirror it on the
# device's timeline and the device rows of a trace hold device operations
# only.
_region = torch._C._profiler._RecordFunctionFast

# records of the spans opened while a profiler ran, in the order they
# opened; drained by take_spans()
_LOG: List[dict] = []
_CALL_IDS = itertools.count(1)
# the innermost open span's record, per thread
_OPEN: contextvars.ContextVar = contextvars.ContextVar("span", default=None)


class _Off:
    """What :func:`span` gives with no profiler running: it records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("record", "_region", "_token")

    def __init__(self, name: str, counts: dict):
        parent = _OPEN.get()
        self.record = {
            "name": name, "parent": parent and parent["name"],
            "call": next(_CALL_IDS) if parent is None else parent["call"],
            "counts": counts}
        self._region = _region(name)

    def __enter__(self):
        _LOG.append(self.record)
        self._token = _OPEN.set(self.record)
        self._region.__enter__()
        return self

    def __exit__(self, *exc):
        _OPEN.reset(self._token)
        return self._region.__exit__(*exc)

    def count(self, **counts) -> None:
        """Adds ``counts`` to the span's record."""
        self.record["counts"].update(counts)


def span(name: str, **counts):
    """A named region of the program on the host timeline of a running
    ``torch.profiler`` (a ``record_function`` range, so its start and end
    share the clock of the device's operations), with integer ``counts``; the
    context manager's ``count(**counts)`` adds more inside it.  Each span
    is logged for :func:`take_spans` as its name, its parent span's name,
    its call id and its counts.  A span opened outside any other starts a
    new call id, which every span inside it shares: one id per trainer
    entry call.  With no profiler running on this thread (a profiler
    records the thread that started it) it reads one flag and records
    nothing."""
    if not _profiling():
        return _OFF
    return _Span(name, counts)


def take_spans() -> List[dict]:
    """The records of the spans opened since the last call, in the order
    they opened (so, name by name, in the order of the profiler's events
    of that name), and empties the log: each ``{"name", "parent", "call",
    "counts"}``."""
    out = _LOG[:]
    del _LOG[:len(out)]
    return out


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
