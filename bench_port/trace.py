"""The traced window: ``torch.profiler`` over the window, the harness's host
spans as profiler annotations, and the raw device events read back.

Events are read from the profiler's raw kineto results (building its
``FunctionEvent`` tables costs seconds per 10^5 events).  Host spans and
device operations share the profiler's clock.  Times in the context
handed to the metric readers are seconds from the window span's start.
"""

from __future__ import annotations

import functools
import re
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "window"
HOST_SPANS = ("call:", "read_results", WINDOW)


class Tracer:
    """Profiles CPU and CUDA activity while open; ``span(name)`` marks a
    host span."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    @staticmethod
    def span(name: str):
        from torch.profiler import record_function

        return record_function(name)

    def events(self) -> Tuple[List[tuple], List[tuple]]:
        """(device ops, host spans), each (name, start_ns, end_ns)."""
        from torch.autograd import DeviceType

        ops, spans = [], []
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                # the profiler mirrors each host annotation on the device's
                # timeline; it is no device operation
                if not (e.is_user_annotation()
                        or name.startswith(HOST_SPANS)):
                    ops.append((name, start, end))
            elif name.startswith(HOST_SPANS):
                spans.append((name, start, end))
        return ops, spans


def context(ops: List[tuple], spans: List[tuple]) -> dict:
    """The metric readers' view of a traced window: ``ops`` and ``spans``
    as (name, start_s, end_s) from the window span's start, sorted by
    start, ops clipped to the window; ``window_s``; ``busy_s``, the union
    of the device ops' intervals."""
    win = [s for s in spans if s[0] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0][1], win[0][2]

    def rel(items, clip):
        out = []
        for name, a, b in items:
            if clip:
                a, b = max(a, w0), min(b, w1)
                if b <= a:
                    continue
            out.append((name, (a - w0) * 1e-9, (b - w0) * 1e-9))
        return sorted(out, key=lambda t: t[1])

    dev = rel(ops, True)
    host = rel([s for s in spans if s[0] != WINDOW], False)
    return {"ops": dev, "spans": host, "window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(b - a for a, b in union(dev))}


def union(ops: List[tuple]) -> List[Tuple[float, float]]:
    """Merged busy intervals of (name, start, end) items sorted by start."""
    merged: List[List[float]] = []
    for _, a, b in ops:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@functools.lru_cache(maxsize=4096)
def short_name(name: str) -> str:
    """A device op's name without return type, template arguments and
    parameters."""
    n = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    n = "".join(out)
    return n.split("(")[0].strip() or name[:64]


def breakdown(ctx: dict, top: int = 10) -> Dict[str, list]:
    """The device ops that took most time, by short name, and the device's
    idle time by the host span it began in ("between_calls" outside any)."""
    by_op: Dict[str, float] = defaultdict(float)
    for name, a, b in ctx["ops"]:
        by_op[short_name(name)] += b - a
    busy = union(ctx["ops"])
    gaps = []
    edge = 0.0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if ctx["window_s"] > edge:
        gaps.append((edge, ctx["window_s"]))
    by_span: Dict[str, float] = defaultdict(float)
    spans = ctx["spans"]
    j = 0
    for a, b in gaps:
        while j + 1 < len(spans) and spans[j + 1][1] <= a:
            j += 1
        name = "between_calls"
        for k in (j, j - 1):
            if 0 <= k < len(spans) and spans[k][1] <= a < spans[k][2]:
                name = spans[k][0]
                break
        by_span[name] += b - a

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}
