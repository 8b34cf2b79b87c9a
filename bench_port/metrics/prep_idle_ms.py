"""``prep_idle_ms``: the mean device-idle time per trainer entry call, in
ms, while the host was in the program's run preparation: its
``mmae.prepare``, ``mmae.init_params`` and ``mmae.plan`` spans, as
``program_spans.idle_split`` splits the window's idle.  Nothing to read in a
trace without the program's spans."""

from bench_port.program_spans import PROGRAM, idle_per_call

NAMES = (PROGRAM + "prepare", PROGRAM + "init_params", PROGRAM + "plan")


def read(ctx):
    sec = idle_per_call(ctx, NAMES)
    return None if sec is None else 1e3 * sec
