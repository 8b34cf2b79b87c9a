"""``init_idle_ms``: the mean device-idle time per trainer entry call, in
ms, while the host drew initial parameters or heads on the CPU, the
program's ``mmae.init_params`` span (``init_grid_params``,
``init_heads``), as ``program_spans.idle_split`` splits the window's
idle; a part of ``prep_idle_ms``.  Nothing to read in a trace without
the program's spans, or where no call draws in the window."""

from bench_port.program_spans import PROGRAM, idle_per_call, view

NAME = PROGRAM + "init_params"


def read(ctx):
    if not any(sp["name"] == NAME for sp in view(ctx)["spans"]):
        return None
    sec = idle_per_call(ctx, (NAME,))
    return None if sec is None else 1e3 * sec
