"""``eval_idle_ms``: the mean device-idle time per trainer entry call, in
ms, while the host was in the program's evaluation, its
``mmae.evaluate`` span (the trained parameters reshaped, the noisy-val
objective or the val predictions enqueued), as ``program_spans.idle_split``
splits the window's idle.  Nothing to read in a trace without the
program's spans."""

from bench_port.program_spans import PROGRAM, idle_per_call


def read(ctx):
    sec = idle_per_call(ctx, (PROGRAM + "evaluate",))
    return None if sec is None else 1e3 * sec
