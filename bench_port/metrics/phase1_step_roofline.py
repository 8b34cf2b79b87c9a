"""``phase1_step_roofline``: phase-1 steps (training kernel 2) against
``step_bound``; see ``roofline_common.py``."""

from bench_port.metrics.roofline_common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "phase1_step")
