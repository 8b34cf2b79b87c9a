"""``loop_idle_us_per_launch``: the device-idle time inside the
program's launch loops per launch, in us.  A call's loop ops are the
device ops launched by the CUDA calls its ``mmae.enqueue`` span made
(found by correlation id); its loop runs from the first to the last of
them.  The idle between them, summed over the calls, over the sum of the
spans' ``launches`` counters (the C loops' own count).  Nothing to read
in a trace without the program's spans, or where a span's kernels found
in the trace are not its counted launches."""

from bench_port.program_spans import ENQUEUE, view


def read(ctx):
    prog = view(ctx)
    spans = [sp for sp in prog["spans"]
             if sp["name"] == ENQUEUE and sp.get("loop")]
    if not spans or any(sp["kernels"] != sp["counts"].get("launches")
                        for sp in spans):
        return None
    idle = sum(sec for (_, _, loop), sec in prog["idle"].items() if loop)
    return 1e6 * idle / sum(sp["counts"]["launches"] for sp in spans)
