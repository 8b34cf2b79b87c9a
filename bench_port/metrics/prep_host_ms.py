"""``prep_host_ms``: the mean host time per trainer entry call, in ms,
of the program's run preparation, its ``mmae.prepare`` and ``mmae.plan``
spans: the fold data and phase-1 rows moved or gathered onto the device,
initial parameters or heads drawn, the run's inputs built, the kernels'
plan, work list and workspace.  Nothing to read in a trace without the
program's spans."""

from bench_port.program_spans import PROGRAM, entry_calls, view

NAMES = (PROGRAM + "prepare", PROGRAM + "plan")


def read(ctx):
    calls = entry_calls(ctx)
    if not calls:
        return None
    return 1e3 * sum(sp["end"] - sp["start"] for sp in view(ctx)["spans"]
                     if sp["name"] in NAMES and sp["call"] in calls
                     ) / len(calls)
