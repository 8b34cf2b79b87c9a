"""``call_gap_ms``: the mean device-idle time between one call's kernel
loop and the next's, in ms.

A call's device ops are those that start between its host span's start
and the next call's; its kernel loop runs from the first to the last of
them that is a training-loop kernel of the program (by name, the
kernels of ``csrc/train_kernel.cu``, ``cls_train_kernel.cu`` and
``train_common.cuh``).  The idle time between two loops is the part of
the interval from one's end to the next's start that no device op
covers: the run's preparation, the objective or predictions, and the
host's work between calls."""

import bisect

from bench_port.trace import short_name, union

LOOP_KERNELS = frozenset((
    "sample_corrupt_kernel", "cls_sample_kernel", "gemm_batch_kernel",
    "gemm_tile_kernel", "update_group_kernel", "vae_sample_kernel",
    "vae_grad_kernel", "cls_loss_grad_kernel", "cls_vae_sample_kernel",
    "cls_vae_grad_kernel"))


def _is_loop(name):
    return short_name(name).split("::")[-1] in LOOP_KERNELS


def read(ctx):
    starts = [s[1] for s in ctx["spans"] if s[0].startswith("call:")]
    if len(starts) < 2:
        return None
    bounds = starts[1:] + [float("inf")]
    loops, i = [], 0
    ops = ctx["ops"]
    for lo, hi in zip(starts, bounds):
        first = last = None
        while i < len(ops) and ops[i][1] < hi:
            if ops[i][1] >= lo and _is_loop(ops[i][0]):
                first = ops[i][1] if first is None else first
                last = ops[i][2] if last is None else max(last, ops[i][2])
            i += 1
        if first is not None:
            loops.append((first, last))
    if len(loops) < 2:
        return None
    busy = union(ops)
    ends = [b for _, b in busy]
    gaps = []
    for (_, end), (nxt, _) in zip(loops, loops[1:]):
        covered = 0.0
        j = bisect.bisect_right(ends, end)
        while j < len(busy) and busy[j][0] < nxt:
            covered += min(busy[j][1], nxt) - max(busy[j][0], end)
            j += 1
        gaps.append(max(nxt - end - covered, 0.0))
    return 1e3 * sum(gaps) / len(gaps)
