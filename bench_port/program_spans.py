"""The program's own spans in a traced window, for the readers of the
metrics built on them.

The port marks its trainer path with spans (``utils/profiling.span``:
``mmae.entry`` around each trainer entry call, ``mmae.prepare``,
``mmae.init_params``, ``mmae.plan``, ``mmae.enqueue`` around the launch
loop's one call, ``mmae.evaluate``).  They are profiler events on the
clock of the device's operations, and the program logs each span's
parent, call id and counts; :func:`read_program` pairs that log with the
events name by name, in order, and finds each ``mmae.enqueue`` span's
loop ops: the device ops of the kernel launches the host made inside it,
by the launches' correlation ids.  A loop among whose ops another call's
op runs is left out, with a message on standard error.  A program without spans (an older commit)
gives none, and the readers find nothing to read.

The harness hands its readers a context without the profiler, so
:func:`view` finds the run's one open ``trace.Tracer`` among the live
objects, reads it once and keeps the result in the context (until
``trace.context`` carries the program's spans itself).

:func:`idle_split` splits the window's idle time by what the host was
doing: an idle interval between the first and last loop op of a call
belongs to that call's ``mmae.enqueue`` span, whatever the host was doing
then (the host runs up to a full launch queue ahead of the device); any
other idle instant belongs to the innermost span, the program's or the
harness's, open on the host at that instant, on the host's clock by the
offset that the nearest loop's launches show.
"""

from __future__ import annotations

import bisect
import gc
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from bench_port import trace

PROGRAM = "mmae."
ENTRY = PROGRAM + "entry"
ENQUEUE = PROGRAM + "enqueue"
OUTSIDE = "between_calls"


def _take_log() -> List[dict]:
    """The program's span log since the last take (empty for a program
    that keeps none)."""
    from multimodalautoencoder_tpu_torch.utils import profiling

    take = getattr(profiling, "take_spans", None)
    return take() if take is not None else []


def read_program(events, log: List[dict]) -> Tuple[Optional[int], list]:
    """(the window span's start in ns, the program's spans) of the
    profiler's raw ``events`` and the program's span ``log``.  Each span
    is its ``name``, ``start`` and ``end`` (ns) and its record's
    ``parent``, ``call`` and ``counts``; an ``mmae.enqueue`` span also
    ``kernels``, how many device ops the kernel launches made inside it
    ran (by correlation id), and, unless :func:`_foreign` finds another
    call's op among them, ``loop``, their sorted (start, end), and
    ``offset``, the host's clock less the device's there (ns).  No spans
    where the log does not pair one to one with the events, or where a
    span does not lie inside a span of its parent's name and call."""
    from torch.autograd import DeviceType

    w0 = None
    host: Dict[str, List[tuple]] = defaultdict(list)
    api, dev = [], defaultdict(list)
    for e in events:
        name = e.name()
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation()
                    or name.startswith(trace.HOST_SPANS + (PROGRAM,))):
                dev[e.correlation_id()].append(
                    (start, start + e.duration_ns()))
        elif name.startswith(PROGRAM):
            host[name].append((start, start + e.duration_ns()))
        elif name == trace.WINDOW:
            w0 = start if w0 is None else w0
        elif name.startswith("cu") and e.correlation_id():
            # a CUDA API call (cuda*, cu*); a launch if "Launch" is in it
            api.append((start, e.correlation_id(), "Launch" in name))
    by_name: Dict[str, List[dict]] = defaultdict(list)
    for rec in log:
        by_name[rec["name"]].append(rec)
    if sorted(by_name) != sorted(host) or any(
            len(by_name[n]) != len(host[n]) for n in host):
        if host or log:
            _refuse("the program's span log does not pair with the trace; "
                    "its spans are left out")
        return w0, []
    out = [{"name": name, "start": a, "end": b, "parent": rec["parent"],
            "call": rec["call"], "counts": dict(rec["counts"])}
           for name, spans in host.items()
           for (a, b), rec in zip(sorted(spans), by_name[name])]
    out.sort(key=lambda sp: sp["start"])
    if not _nested(out):
        _refuse("a program span lies outside its parent; the program's "
                "spans are left out")
        return w0, []
    api.sort()
    starts = [t for t, _, _ in api]
    ops = sorted((a, c) for c, ivs in dev.items() for a, _ in ivs)
    for sp in out:
        if sp["name"] != ENQUEUE:
            continue
        made = api[bisect.bisect_left(starts, sp["start"]):
                   bisect.bisect_right(starts, sp["end"])]
        runs = [(t, iv) for t, c, launch in made if launch
                for iv in dev.get(c, ())]
        loop = sorted(iv for _, iv in runs)
        sp["kernels"] = len(loop)
        if not loop:
            continue
        n = _foreign(loop, ops, {c for _, c, _ in made})
        if n:
            _refuse(f"call {sp['call']}: its loop is left out: {n} device "
                    "ops not launched in its enqueue span run inside it")
            continue
        sp["loop"] = loop
        sp["offset"] = max(t - iv[0] for t, iv in runs)
    return w0, out


def _refuse(msg: str) -> None:
    print("bench_port: " + msg, file=sys.stderr)


def _nested(spans: List[dict]) -> bool:
    """Whether each of ``spans`` (sorted by start) with a parent lies
    inside a span of its parent's name and call."""
    by = defaultdict(list)
    for sp in spans:
        by[sp["name"], sp["call"]].append(sp)
    return all(any(p["start"] <= sp["start"] and sp["end"] <= p["end"]
                   for p in by[sp["parent"], sp["call"]])
               for sp in spans if sp["parent"] is not None)


def _foreign(loop: List[tuple], ops: List[tuple], own: set) -> int:
    """How many of the device ``ops`` ((start, correlation id), sorted)
    that start between the first and last of ``loop`` were made by CUDA
    calls other than ``own``'s: another call's op there means the loop
    was not found right (one stream runs a call's loop alone).  Device
    times only, so the offset between the host's and the device's clocks
    in the trace does not enter."""
    end = max(b for _, b in loop)
    lo = bisect.bisect_left(ops, (loop[0][0],))
    hi = bisect.bisect_left(ops, (end,))
    return sum(c not in own for _, c in ops[lo:hi])


def attach(ctx: dict, program: List[dict], w0: int = 0) -> dict:
    """Puts the program's spans (:func:`read_program`'s, times in ns) into
    ``ctx`` (a ``trace.context``) under ``program``: ``spans`` with
    seconds from the window's start ``w0``, loop ops clipped to the
    window, offsets in seconds, and ``idle``, :func:`idle_split`."""
    spans = []
    for sp in program:
        sp = dict(sp, start=(sp["start"] - w0) * 1e-9,
                  end=(sp["end"] - w0) * 1e-9)
        if "loop" in sp:
            loop = [((a - w0) * 1e-9, (b - w0) * 1e-9) for a, b in sp["loop"]]
            sp["loop"] = [(max(a, 0.0), min(b, ctx["window_s"]))
                          for a, b in loop if b > 0 and a < ctx["window_s"]]
            sp["offset"] = sp["offset"] * 1e-9
        spans.append(sp)
    ctx["program"] = {"spans": spans}
    ctx["program"]["idle"] = idle_split(ctx)
    return ctx["program"]


def view(ctx: dict) -> dict:
    """The program's part of ``ctx``, read once from the run's open
    tracer: ``{"spans", "idle"}``, empty without program spans.  Raises
    unless exactly one ``trace.Tracer`` is alive."""
    if "program" not in ctx:
        gc.collect()
        tracers = [o for o in gc.get_objects() if type(o) is trace.Tracer]
        if len(tracers) != 1:
            raise RuntimeError(f"{len(tracers)} open trace.Tracer objects; "
                               "the program's spans need exactly one")
        w0, program = read_program(
            tracers[0].prof.profiler.kineto_results.events(), _take_log())
        attach(ctx, program if w0 is not None else [], w0 or 0)
    return ctx["program"]


# ------------------------------------------------------------ idle time

def idle_intervals(ops: List[tuple], window_s: float
                   ) -> List[Tuple[float, float]]:
    """The intervals of [0, ``window_s``] in which no device op ran."""
    gaps, edge = [], 0.0
    for a, b in trace.union(ops):
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if window_s > edge:
        gaps.append((edge, window_s))
    return gaps


def _innermost(spans: List[tuple], end: float) -> List[tuple]:
    """[0, ``end``] cut into (start, stop, key) pieces, key that of the
    innermost of ``spans`` ((start, stop, key), nested) open there, None
    outside all of them."""
    pieces, stack, t = [], [], 0.0

    def emit(stop, key):
        nonlocal t
        if stop > t:
            pieces.append((t, stop, key))
            t = stop

    for a, b, key in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            _, stop, inner = stack.pop()
            emit(stop, inner)
        emit(a, stack[-1][2] if stack else None)
        stack.append((a, b, key))
    while stack:
        _, stop, inner = stack.pop()
        emit(stop, inner)
    emit(end, None)
    return pieces


def _cut(intervals: List[tuple], cover: List[tuple]) -> List[tuple]:
    """Each of ``intervals`` ((start, stop)) cut by ``cover`` ((start,
    stop, key), sorted, disjoint) into (start, stop, key) pieces, key None
    outside the cover."""
    ends = [c[1] for c in cover]
    out = []
    for a, b in intervals:
        k, t = bisect.bisect_right(ends, a), a
        while t < b:
            if k < len(cover) and cover[k][0] <= t:
                hi = min(b, cover[k][1])
                out.append((t, hi, cover[k][2]))
                k += 1
            else:
                hi = min(b, cover[k][0]) if k < len(cover) else b
                out.append((t, hi, None))
            t = hi
    return out


def idle_split(ctx: dict) -> Dict[tuple, float]:
    """The window's idle seconds by (span name, call id, in loop): idle
    between the first and last loop op of an ``mmae.enqueue`` span is that
    span's, in loop; any other idle instant the innermost span's open on
    the host then (the program's, and the harness's ``call:`` and
    ``read_results`` with call id None; "between_calls" outside all).

    The trace's device clock can drift from its host clock by
    milliseconds within a window, so an idle instant is put on the host's
    clock by the offset of the next loop (of the last, after it): the
    host's time of a launch less the device's start of its kernel, the
    largest over the loop's launches, which a launch to an idle device
    attains up to its few-us latency."""
    prog = ctx["program"]["spans"]
    loops = sorted((sp["loop"][0][0], max(b for _, b in sp["loop"]),
                    (ENQUEUE, sp["call"], True), sp["offset"])
                   for sp in prog if sp.get("loop"))
    firsts = [lp[0] for lp in loops]
    host = [(a, b, (name, None, False)) for name, a, b in ctx["spans"]]
    host += [(sp["start"], sp["end"], (sp["name"], sp["call"], False))
             for sp in prog]
    out: Dict[tuple, float] = defaultdict(float)
    rest = []
    for a, b, key in _cut(idle_intervals(ctx["ops"], ctx["window_s"]),
                          [lp[:3] for lp in loops]):
        if key is not None:
            out[key] += b - a
            continue
        i = min(bisect.bisect_left(firsts, b), len(loops) - 1)
        shift = loops[i][3] if loops else 0.0
        rest.append((a + shift, b + shift))
    for a, b, key in _cut(rest, _innermost(host, ctx["window_s"])):
        out[key or (OUTSIDE, None, False)] += b - a
    return dict(out)


def entry_calls(ctx: dict) -> set:
    """The call ids of the program's trainer entry calls in the window."""
    return {sp["call"] for sp in view(ctx)["spans"] if sp["name"] == ENTRY}


def idle_per_call(ctx: dict, names) -> Optional[float]:
    """Mean idle seconds per entry call that :func:`idle_split` gives the
    program's spans ``names`` outside loops; None without entry calls."""
    calls = entry_calls(ctx)
    if not calls:
        return None
    return sum(sec for (name, call, loop), sec in view(ctx)["idle"].items()
               if name in names and call in calls and not loop) / len(calls)
