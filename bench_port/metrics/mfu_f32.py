"""``mfu_f32``: the products' FLOPs of every step of every call in the
traced window (the frozen ``yardstick/flops.py`` counts: forward,
backward data and weight gradients, nothing recomputed, no Adam) over the
window's time at the H100's f32 CUDA-core peak, in %."""

from bench_port.yardstick import peaks


def read(ctx):
    flop = sum(c["mxu_flop"] for c in ctx["calls"] if not c["failed"])
    if flop <= 0 or ctx["window_s"] <= 0 or not ctx["ops"]:
        return None
    return 100.0 * flop / (ctx["window_s"] * peaks.H100_F32_FLOP_PER_S)
