"""``phase2_step_roofline``: phase-2 steps (training kernel 4) against
``cls_step_bound``; see ``roofline_common.py``."""

from bench_port.metrics.roofline_common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "phase2_step")
