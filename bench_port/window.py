"""The measured window: whole passes over a cell's buckets.

Each pass calls the entry once per bucket, in the traffic file's order,
each call with a seed derived from the run's seed and the call's index.
Like the sweeps, the window reads a call's results only after the next
call is enqueued, and synchronises once at the end.  It ends at the first
pass boundary at or after ``seconds``, so every run does the same mix and
the rate is all instance-steps of all calls over the time from the first
enqueue to the final synchronise.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List

import numpy as np


class Seeds:
    """Seeds derived from the run's ``--seed``: one for each call (by its
    index in the window; pass 0's calls are also the check's) and one for
    each drawn parameter stack."""

    def __init__(self, seed: int):
        self.seed = int(seed) % 2 ** 64

    def _derive(self, *words: int) -> int:
        ss = np.random.SeedSequence([self.seed, *words])
        return int(ss.generate_state(1, dtype=np.uint64)[0] >> 33)

    def call(self, index: int) -> int:
        return self._derive(1, int(index))

    def params(self, index: int) -> int:
        return self._derive(2, int(index))


def run_window(session, seeds: Seeds, seconds: float,
               clock: Callable[[], float] = time.perf_counter,
               sync: Callable[[], None] = lambda: None,
               span=None) -> dict:
    """Drive whole passes of ``session`` (an entry adapter's session) for
    at least ``seconds``.  ``span(name)`` is a context manager that marks
    the host's spans for the trace.  Returns the calls made (bucket, work,
    whether the call raised), the passes, ``window_s`` and the
    instance-steps."""
    span = span or (lambda name: contextlib.nullcontext())
    n = len(session.buckets)
    calls: List[dict] = []
    pending = None
    index = 0
    passes = 0
    t0 = clock()
    while True:
        for bi in range(n):
            name = session.buckets[bi]["name"]
            record = {"bucket": name, **session.work(bi), "failed": False}
            with span(f"call:{name}"):
                try:
                    handle = session.call(bi, seeds.call(index))
                except RuntimeError as err:
                    record["failed"] = True
                    record["error"] = str(err)[:500]
                    handle = None
            if pending is not None:
                with span("read_results"):
                    session.read(pending)
            pending = handle
            calls.append(record)
            index += 1
        passes += 1
        if clock() - t0 >= seconds:
            break
    with span("read_results"):
        if pending is not None:
            session.read(pending)
        sync()
    t1 = clock()
    done = [c for c in calls if not c["failed"]]
    return {"calls": calls, "passes": passes, "window_s": t1 - t0,
            "inst_steps": sum(c["inst"] * c["steps"] for c in done),
            "failed": len(calls) - len(done)}
