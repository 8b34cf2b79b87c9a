"""``setup_s``: from the start of the run's script to the window's first
enqueue, by the host's clock: imports, the CUDA context, the program's
libraries (built on a checkout's first run), the study, the initial
parameters and the warm-up calls that take the check's readings."""


def read(ctx):
    return ctx["setup_s"]
