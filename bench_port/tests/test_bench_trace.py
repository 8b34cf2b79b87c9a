"""The traced window's reduction and the per-layer readers, on a made-up
trace."""

import importlib.util
import os

import pytest

from bench_port import trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(HERE, "metrics",
                                                    name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MS = 1_000_000  # ns


def made_up():
    # window 0-100 ms; call 0 span 0-40, loop 5-30, objective 32-35;
    # read 40-41; call 1 span 41-90, prep 45-46, loop 50-80, tail 82-84
    spans = [("window", 0, 100 * MS), ("call:a", 0, 40 * MS),
             ("read_results", 40 * MS, 41 * MS), ("call:b", 41 * MS, 90 * MS)]
    ops = [("Memcpy HtoD (Pageable -> Device)", 1 * MS, 2 * MS),
           ("void gemm_batch_kernel<2, 4>(Args)", 5 * MS, 20 * MS),
           ("void update_group_kernel<float>(Upd)", 20 * MS, 30 * MS),
           ("ampere_sgemm_128x64_nn", 32 * MS, 35 * MS),
           ("void at::native::fill_kernel<float>(X)", 45 * MS, 46 * MS),
           ("sample_corrupt_kernel(Args)", 50 * MS, 51 * MS),
           ("void gemm_batch_kernel<2, 4>(Args)", 51 * MS, 80 * MS),
           ("ampere_sgemm_128x64_nn", 82 * MS, 84 * MS)]
    ctx = trace.context(ops, spans)
    ctx["calls"] = [
        {"kind": "phase1_step", "failed": False, "bound_s": 0.010,
         "mxu_flop": 67e12 * 0.001, "inst": 1, "steps": 1},
        {"kind": "phase1_step", "failed": False, "bound_s": 0.005,
         "mxu_flop": 67e12 * 0.001, "inst": 1, "steps": 1}]
    return ctx


def test_context_and_busy_time():
    ctx = made_up()
    assert ctx["window_s"] == pytest.approx(0.1)
    # busy: 1 + 25 + 3 + 1 + 30 + 2 = 62 ms
    assert ctx["busy_s"] == pytest.approx(0.062)


def test_readers():
    ctx = made_up()
    assert reader("device_idle_pct")(ctx) == pytest.approx(38.0)
    assert reader("mfu_f32")(ctx) == pytest.approx(2.0)
    assert reader("phase1_step_roofline")(ctx) == pytest.approx(
        100 * 0.015 / 0.062)
    assert reader("phase2_step_roofline")(ctx) is None
    # loops 5-30 and 50-80: idle in 30-50 is 20 - 3 (objective) - 1 (fill)
    assert reader("call_gap_ms")(ctx) == pytest.approx(16.0)


def test_readers_find_nothing_without_device_ops():
    ctx = trace.context([], [("window", 0, 10 * MS), ("call:a", 0, 5 * MS),
                             ("call:b", 5 * MS, 9 * MS)])
    ctx["calls"] = []
    for name in ("device_idle_pct", "mfu_f32", "phase1_step_roofline",
                 "call_gap_ms"):
        assert reader(name)(ctx) is None


def test_breakdown_names_ops_and_idle_spans():
    b = trace.breakdown(made_up())
    ops = dict(b["device_ops"])
    assert ops["gemm_batch_kernel"] == pytest.approx(0.044)
    assert ops["at::native::fill_kernel"] == pytest.approx(0.001)
    idle = dict(b["idle_gaps"])
    # idle 0-1, 2-5, 30-32 and 35-45 begin in call:a (a gap goes to the
    # span it begins in), 46-50, 80-82 and 84-100 in call:b
    assert idle["call:a"] == pytest.approx(0.001 + 0.003 + 0.002 + 0.010)
    assert "read_results" not in idle
    assert idle["call:b"] == pytest.approx(0.004 + 0.002 + 0.016)
    assert "between_calls" not in idle
