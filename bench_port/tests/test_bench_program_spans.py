"""The program's spans in a traced window (``program_spans.py``) and the
readers of the metrics built on them, on made-up traces."""

import importlib.util
import os

import pytest

from bench_port import program_spans as ps
from bench_port import trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000  # ns
NEW = ("prep_host_ms", "prep_idle_ms", "init_idle_ms", "eval_idle_ms",
       "loop_idle_us_per_launch")
HARNESS = [("window", 0, 100 * MS), ("call:a", 0, 40 * MS),
           ("read_results", 40 * MS, 41 * MS), ("call:b", 41 * MS, 90 * MS)]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(HERE, "metrics",
                                                    name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(name, a, b, call, parent=None, **extra):
    return {"name": "mmae." + name, "start": a * MS, "end": b * MS,
            "parent": parent and "mmae." + parent, "call": call,
            "counts": extra.pop("counts", {}), **extra}


OPS = [("Memcpy HtoD", 2.5 * MS, 3 * MS), ("Memcpy HtoD", 9.5 * MS, 10 * MS),
       ("gemm_batch_kernel", 11 * MS, 20 * MS),
       ("update_group_kernel", 22 * MS, 30 * MS),
       ("elementwise_kernel", 31 * MS, 33 * MS),
       ("gemm_batch_kernel", 55 * MS, 80 * MS),
       ("elementwise_kernel", 81 * MS, 84 * MS)]


def idle_by_name(ctx):
    """The window's idle ms by span name, from ``program_spans.idle_split``."""
    out = {}
    for (name, _, _), sec in ps.view(ctx)["idle"].items():
        out[name] = out.get(name, 0.0) + 1e3 * sec
    return out


def with_program(program=True, lag=0.0):
    """Window 0-100 ms; harness spans call:a 0-40, read_results 40-41,
    call:b 41-90.  Call 1: entry 1-39, prepare 2-8 (a copy 2.5-3), its
    init_params 3-7, plan 8-9, enqueue 9-12 (2 launches: a copy 9.5-10,
    kernels 11-20 and 22-30), evaluate 12-14 (an op 31-33).  Call 2:
    entry 42-88, prepare 43-50, plan 50-52, enqueue 52-53 (1 launch:
    55-80), evaluate 53-54 (an op 81-84).  Without ``program``, the trace
    of a program without spans; ``lag``, the device's clock that many ms
    behind the host's."""
    prog = [span("entry", 1, 39, 1),
            span("prepare", 2, 8, 1, "entry"),
            span("init_params", 3, 7, 1, "prepare"),
            span("plan", 8, 9, 1, "entry"),
            span("enqueue", 9, 12, 1, "entry",
                 counts={"launches": 2},
                 loop=[(11 * MS, 20 * MS), (22 * MS, 30 * MS)],
                 kernels=2, offset=lag * MS),
            span("evaluate", 12, 14, 1, "entry"),
            span("entry", 42, 88, 2), span("prepare", 43, 50, 2, "entry"),
            span("plan", 50, 52, 2, "entry"),
            span("enqueue", 52, 53, 2, "entry",
                 counts={"launches": 1},
                 loop=[(55 * MS, 80 * MS)], kernels=1, offset=lag * MS),
            span("evaluate", 53, 54, 2, "entry")]
    for sp in prog:
        if "loop" in sp:
            sp["loop"] = [(a - lag * MS, b - lag * MS) for a, b in sp["loop"]]
    ctx = trace.context([(n, a - lag * MS, b - lag * MS) for n, a, b in OPS],
                        HARNESS)
    ps.attach(ctx, prog if program else [])
    return ctx


def test_readers_find_nothing_without_program_spans():
    """A program without spans (a parent commit): the new readers find
    nothing, and the idle splits over the harness's spans alone."""
    ctx = with_program(False)
    for name in NEW:
        assert reader(name)(ctx) is None
    idle = idle_by_name(ctx)
    assert set(idle) == {"call:a", "call:b", "read_results",
                         "between_calls"}
    assert sum(idle.values()) == pytest.approx(1e3 * (0.1 - ctx["busy_s"]))


def test_idle_split_by_what_the_host_was_doing():
    """Idle inside a loop (20-22) is its enqueue's; any other idle
    instant the innermost span's open on the host then: 33-55 runs from
    call 1's entry through the harness's spans into call 2's
    preparation."""
    ctx = with_program()
    idle = idle_by_name(ctx)
    want = {"mmae.entry": 15, "mmae.prepare": 8.5, "mmae.init_params": 4,
            "mmae.plan": 3, "mmae.enqueue": 4.5, "mmae.evaluate": 1,
            "call:a": 2, "call:b": 3, "read_results": 1,
            "between_calls": 10}
    assert idle == pytest.approx(want)
    assert sum(want.values()) == pytest.approx(
        1e3 * (ctx["window_s"] - ctx["busy_s"]))
    assert ctx["program"]["idle"][("mmae.enqueue", 1, True)] == \
        pytest.approx(0.002)


def test_idle_split_on_the_hosts_clock():
    """With the device's clock 2 ms behind the host's, the loops'
    offsets put each idle instant back where the host was: the split
    inside the window is the same, and only its two ends move (the device
    runs its first op 2 ms earlier and its last 2 ms earlier)."""
    base, late = idle_by_name(with_program()), idle_by_name(
        with_program(lag=2.0))
    assert late == pytest.approx(dict(
        base, **{"mmae.entry": base["mmae.entry"] - 1,
                 "call:a": base["call:a"] - 1,
                 "between_calls": base["between_calls"] + 2}))


def test_program_readers():
    ctx = with_program()
    # prepare 6 + plan 1, prepare 7 + plan 2, over 2 calls
    assert reader("prep_host_ms")(ctx) == pytest.approx(8.0)
    # (1.5 + 4 + 1) + (7 + 2) over 2 calls
    assert reader("prep_idle_ms")(ctx) == pytest.approx(7.75)
    # 3-7 in call 1's init_params, over 2 calls
    assert reader("init_idle_ms")(ctx) == pytest.approx(2.0)
    assert reader("eval_idle_ms")(ctx) == pytest.approx(0.5)
    # 2 ms of idle inside the loops over 3 launches
    assert reader("loop_idle_us_per_launch")(ctx) == pytest.approx(2000 / 3)
    # the harness's readers read the same with the program's spans
    for name in ("device_idle_pct", "call_gap_ms"):
        assert reader(name)(ctx) == reader(name)(with_program(False))


def test_loop_reader_refuses_a_miscounted_loop():
    ctx = with_program()
    ctx["program"]["spans"][4]["kernels"] = 3
    assert reader("loop_idle_us_per_launch")(ctx) is None


class FakeEvent:
    def __init__(self, name, device, start, end, corr=0, kind=None,
                 annotation=False):
        self._v = (name, device, start, end, corr, kind, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[1] == "cuda" else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[6]


EVENTS = [
    FakeEvent("window", "cpu", 5, 100, kind="user_annotation",
              annotation=True),
    FakeEvent("window", "cuda", 12, 42, kind="gpu_user_annotation"),
    FakeEvent("mmae.entry", "cpu", 6, 60, 1, "cpu_op"),
    FakeEvent("mmae.enqueue", "cpu", 10, 20, 2, "cpu_op"),
    FakeEvent("cudaMemcpyAsync", "cpu", 11, 12, 7, "cuda_runtime"),
    FakeEvent("cudaLaunchKernel", "cpu", 13, 14, 8, "cuda_runtime"),
    FakeEvent("cudaLaunchKernel", "cpu", 15, 16, 9, "cuda_runtime"),
    FakeEvent("cudaLaunchKernel", "cpu", 25, 26, 10, "cuda_runtime"),
    FakeEvent("aten::add", "cpu", 13, 14, 9, "cpu_op"),
    FakeEvent("Memcpy HtoD", "cuda", 12, 13, 7, "gpu_memcpy"),
    FakeEvent("gemm_batch_kernel", "cuda", 14, 30, 8, "kernel"),
    FakeEvent("update_group_kernel", "cuda", 31, 40, 9, "kernel"),
    FakeEvent("elementwise_kernel", "cuda", 41, 42, 10, "kernel")]
LOG = [{"name": "mmae.entry", "parent": None, "call": 4, "counts": {}},
       {"name": "mmae.enqueue", "parent": "mmae.entry", "call": 4,
        "counts": {"launches": 2}}]


def test_program_pairs_the_log_and_finds_the_loop_by_correlation():
    """The program's host events pair with its log name by name; the
    enqueue span's loop ops are the device ops of the kernel launches made
    inside it (not a copy's, not the launch after it, nor an operator's
    own id)."""
    w0, (entry, enq) = ps.read_program(EVENTS, LOG)
    assert w0 == 5
    assert (entry["name"], entry["start"], entry["call"]) == (
        "mmae.entry", 6, 4)
    assert enq["loop"] == [(14, 30), (31, 40)]
    assert enq["kernels"] == 2 == enq["counts"]["launches"]
    # launched at 13 and 15, run from 14 and 31: the host's clock is at
    # most 1 ns behind the device's
    assert enq["offset"] == -1
    assert enq["parent"] == "mmae.entry"


def test_program_left_out_where_the_log_does_not_pair(capsys):
    assert ps.read_program(EVENTS, LOG[:1]) == (5, [])
    assert "does not pair" in capsys.readouterr().err
    # a program without spans: nothing, quietly
    assert ps.read_program(
        [e for e in EVENTS if not e.name().startswith("mmae.")], []) == (
        5, [])
    assert capsys.readouterr().err == ""


def test_view_reads_the_open_tracer_once(monkeypatch):
    """``view`` finds the run's tracer, drains the program's log, and
    keeps what it read in the context."""
    class Results:
        def events(self):
            return EVENTS

    tracer = trace.Tracer.__new__(trace.Tracer)
    tracer.prof = type("P", (), {"profiler": type(
        "K", (), {"kineto_results": Results()})()})()
    logs = [list(LOG)]
    monkeypatch.setattr(ps, "_take_log", lambda: logs.pop())
    ctx = trace.context([(n, a + 5, b + 5) for n, a, b in
                         [("Memcpy HtoD", 7, 8), ("k", 9, 25), ("k", 26, 35),
                          ("k", 36, 37)]], [("window", 5, 100)])
    got = ps.view(ctx)
    assert [sp["name"] for sp in got["spans"]] == ["mmae.entry",
                                                   "mmae.enqueue"]
    assert [t for iv in got["spans"][1]["loop"] for t in iv] == \
        pytest.approx([9e-9, 25e-9, 26e-9, 35e-9])
    assert ps.view(ctx) is got and not logs
    del tracer


def test_loop_left_out_where_another_calls_op_runs_inside(capsys):
    """A device op that no CUDA call of the enqueue span made, running
    between its loop's ops, leaves the loop out with a message; the spans
    stay, and a copy made inside the span may run there."""
    stray = EVENTS + [
        FakeEvent("cudaMemcpyAsync", "cpu", 22, 23, 12, "cuda_runtime"),
        FakeEvent("Memcpy HtoD", "cuda", 30, 31, 12, "gpu_memcpy")]
    _, (_, enq) = ps.read_program(stray, LOG)
    assert "loop" not in enq and enq["kernels"] == 2
    assert "call 4" in capsys.readouterr().err
    own = EVENTS + [
        FakeEvent("cudaMemcpyAsync", "cpu", 16, 17, 12, "cuda_runtime"),
        FakeEvent("Memcpy HtoD", "cuda", 30, 31, 12, "gpu_memcpy")]
    _, (_, enq) = ps.read_program(own, LOG)
    assert enq["loop"] == [(14, 30), (31, 40)]


def test_loop_kept_where_the_device_clock_lags():
    """Device times 5 units behind the host's (the first kernel seems to
    start before its launch): the loop stays, and its offset says so."""
    late = [FakeEvent(*(e._v[:2] + (e._v[2] - 5, e._v[3] - 5) + e._v[4:]))
            if e._v[1] == "cuda" else e for e in EVENTS]
    _, (_, enq) = ps.read_program(late, LOG)
    assert enq["loop"] == [(9, 25), (26, 35)] and enq["offset"] == 4


def test_launch_without_correlation_finds_nothing():
    """A launch event whose correlation id is 0 names no loop op (device
    events without a launch of their own carry 0 too)."""
    events = EVENTS + [
        FakeEvent("cudaLaunchKernel", "cpu", 17, 18, 0, "cuda_runtime"),
        FakeEvent("stray_kernel", "cuda", 90, 95, 0, "kernel")]
    _, (_, enq) = ps.read_program(events, LOG)
    assert enq["loop"] == [(14, 30), (31, 40)] and enq["kernels"] == 2


def test_program_left_out_where_a_span_leaves_its_parent(capsys):
    log = [dict(LOG[0]), dict(LOG[1], call=9)]
    assert ps.read_program(EVENTS, log) == (5, [])
    assert "outside its parent" in capsys.readouterr().err


@pytest.mark.parametrize("n", [0, 2])
def test_view_refuses_other_than_one_tracer(n):
    tracers = [trace.Tracer.__new__(trace.Tracer) for _ in range(n)]
    ctx = trace.context([], [("window", 0, 10)])
    with pytest.raises(RuntimeError, match=f"{n} open"):
        ps.view(ctx)
    del tracers


@pytest.mark.cuda
def test_cuda_program_loops_pair_with_launches():
    """On the card, under the benchmark's tracer, the reader of the
    program's spans finds each call's loop kernels by correlation, as many
    as its enqueue span's ``launches``, and no ``mmae.*`` device op."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from multimodalautoencoder_tpu_torch.config import (MMAEConfig,
                                                        TrainConfig)
    from multimodalautoencoder_tpu_torch.data.modalities import \
        ModalityTable
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.utils import profiling

    cfg = MMAEConfig(num_feats=30, layer_sizes=(16, 8)).validate()
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(
        5, 6, ("call", "location", "screen", "sms", "survey")))
    tcfg = TrainConfig(learning_rate=1e-3, batch_size=8, num_steps=3,
                       clip_gradients=False)
    rng = np.random.default_rng(0)
    folded = gt.FoldedData.from_ragged(
        [rng.random((40, 30)).astype(np.float32) for _ in range(2)],
        [rng.random((9, 30)).astype(np.float32) for _ in range(2)], "cuda")
    hyper = gt.HyperStack.from_settings(
        [{"dropout_prob": 1.0, "weight_penalty": 0.0,
          "activation_function": "relu"}], cfg, tcfg)

    def call():
        gt.train_grid_sharded("cuda", 3, cfg, tcfg, spec, hyper, folded,
                              num_steps=3, backend="pallas")

    call()
    torch.cuda.synchronize()
    profiling.take_spans()
    tracer = trace.Tracer()
    with tracer:
        with tracer.span(trace.WINDOW):
            call()
            call()
            torch.cuda.synchronize()
    ops, spans = tracer.events()
    assert ops and not [o for o in ops if o[0].startswith("mmae.")]
    prog = ps.view(trace.context(ops, spans))
    enq = [s for s in prog["spans"] if s["name"] == "mmae.enqueue"]
    assert [s["name"] for s in prog["spans"]].count("mmae.entry") == 2
    assert len(enq) == 2 and all(s.get("loop") for s in enq)
    assert all(s["kernels"] == s["counts"]["launches"] > 0 for s in enq)
    del tracer
