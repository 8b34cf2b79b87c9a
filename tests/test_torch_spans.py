"""The program's spans and counters inside the trainer path
(``utils/profiling.span``): nothing logged and no ``record_function``
without a profiler; under one, each trainer entry call opens one tree of
spans with one call id, whose log pairs with the profiler's events.  The
``cuda`` cases check the C loops' launch counters and that no device-side
mirror of a span counts as a device operation."""

import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable
from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
from multimodalautoencoder_tpu_torch.utils import profiling

NAMES = ("call", "location", "screen", "sms", "survey")
SETTINGS = [{"dropout_prob": kp, "weight_penalty": 0.0,
             "activation_function": act}
            for kp in (1.0, 0.5) for act in ("softsign", "relu")][:3]
TCFG = TrainConfig(learning_rate=1e-3, batch_size=8, num_steps=3,
                   clip_gradients=False)
STEPS = 3

# (name, parent) of one twin call's spans, in the order they open (the
# twin has no launch loop, so no mmae.plan and no mmae.enqueue)
TREE = [("mmae.entry", None), ("mmae.prepare", "mmae.entry"),
        ("mmae.prepare", "mmae.entry"), ("mmae.init_params", "mmae.prepare"),
        ("mmae.evaluate", "mmae.entry")]


def bucket(layers=(16, 8), tied=True, vae=False, device="cpu", head=None):
    """A bucket of three settings on two folds: a phase-1 bucket, or with
    ``head`` a phase-2 one."""
    cfg = MMAEConfig(num_feats=30, layer_sizes=layers, tie_weights=tied,
                     variational=vae, num_labels=2,
                     classification_layer_sizes=head).validate()
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
    rng = np.random.default_rng(0)
    tr = [rng.random((40, 30)).astype(np.float32) for _ in range(2)]
    va = [rng.random((9, 30)).astype(np.float32) for _ in range(2)]
    ty = [rng.integers(0, 2, (40, 2)).astype(np.float32) for _ in range(2)]
    vy = [rng.integers(0, 2, (9, 2)).astype(np.float32) for _ in range(2)]
    unsup = gt.FoldedData.from_ragged(tr, va, device)
    sup = gt.FoldedData.from_ragged(tr, va, device, train_y_list=ty,
                                    val_y_list=vy)
    hyper = gt.HyperStack.from_settings(SETTINGS, cfg, TCFG)
    chyper = gt.ClassifierHyperStack.from_settings(SETTINGS, cfg)
    return cfg, spec, unsup, sup, hyper, chyper


def phase1(device="cpu", backend="pallas", **kw):
    cfg, spec, unsup, _, hyper, _ = bucket(**kw)
    return gt.train_grid_sharded(device, 3, cfg, TCFG, spec, hyper, unsup,
                                 num_steps=STEPS, backend=backend)


def phase2(device="cpu", **kw):
    """A phase-2 call on a drawn phase-1 stack of two settings, made ready
    before the call (so outside any trace): the call as a function."""
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as ck
    from multimodalautoencoder_tpu_torch.ops import train_kernels as tk

    cfg, spec, _, sup, hyper, chyper = bucket(head=(4,), **kw)
    params_u = tk.init_grid_params(torch.Generator().manual_seed(4),
                                   ck.phase1_cfg(cfg), 2, 2)
    return lambda: gt.train_phase2_shared_sharded(
        device, 5, cfg, TCFG, TCFG, spec, params_u, [0, 1, 0], hyper,
        chyper, sup, cls_num_steps=STEPS, backend="pallas")


def traced(fn, tmp_path):
    """``fn()``'s span log and the profiler's host events named
    ``mmae.*`` (name, start ns, end ns), by start."""
    profiling.take_spans()
    with profiling.trace(str(tmp_path / "prof")) as prof:
        fn()
    log = profiling.take_spans()
    events = sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith("mmae.")
         and str(e.device_type()).endswith("CPU")), key=lambda t: t[1])
    return log, events


def test_span_without_profiler_reads_one_flag(monkeypatch):
    """No profiler: ``span`` opens no ``record_function`` range and logs
    nothing, whatever is counted inside it."""
    def refuse(*a, **k):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(profiling, "_region", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.take_spans()
    with profiling.span("mmae.entry") as sp:
        sp.count(calls=1)
        with profiling.span("mmae.enqueue", launches=7):
            pass
    assert profiling.take_spans() == []


@pytest.mark.parametrize("phase", [1, 2])
def test_entries_log_nothing_without_profiler(phase):
    call = phase1 if phase == 1 else phase2()
    profiling.take_spans()
    call()
    assert profiling.take_spans() == []


@pytest.mark.parametrize("phase", [1, 2])
def test_twin_call_span_tree(phase, tmp_path):
    """One twin call: the tree in order (``mmae.plan`` and
    ``mmae.enqueue`` only on the card; phase 2's first ``mmae.prepare``
    gathers the phase-1 rows, its ``mmae.init_params`` draws the heads),
    one call id, and no counts outside the card's launch loop."""
    log, _ = traced(phase1 if phase == 1 else phase2(), tmp_path)
    assert [(r["name"], r["parent"]) for r in log] == TREE
    assert len({r["call"] for r in log}) == 1
    assert all(r["counts"] == {} for r in log)


def test_one_call_id_per_call(tmp_path):
    def two():
        phase1()
        phase1(vae=True, tied=False)

    log, _ = traced(two, tmp_path)
    ids = [r["call"] for r in log]
    half = len(TREE)
    assert len(log) == 2 * half
    assert len(set(ids[:half])) == 1 and len(set(ids[half:])) == 1
    assert ids[0] != ids[half]


def test_span_log_pairs_with_profiler_events(tmp_path):
    """Name by name, the log's records and the profiler's events pair one
    to one in order, and each record's parent's event holds its own."""
    log, events = traced(lambda: phase1(layers=(16, 10, 8), tied=False),
                         tmp_path)
    assert [r["name"] for r in log] == [e[0] for e in events]
    stack = []
    for rec, (name, a, b) in zip(log, events):
        while stack and stack[-1][2] <= a:
            stack.pop()
        assert (stack[-1][0] if stack else None) == rec["parent"]
        if stack:
            assert stack[-1][1] <= a and b <= stack[-1][2]
        stack.append((name, a, b))


def test_split_run_logs_the_callers_thread_only(tmp_path):
    """A run split over two CPU chunks, each stepped from a worker thread,
    logs the caller's tree alone, and the log still pairs with the
    profiler's events."""
    log, events = traced(lambda: phase1(device=["cpu", "cpu"]), tmp_path)
    assert [(r["name"], r["parent"]) for r in log] == TREE
    assert [r["name"] for r in log] == [e[0] for e in events]


def test_plain_backend_entry(tmp_path):
    """The plain backend's call: its entry, the fold data's move and the
    drawn parameters, and nothing of the kernels' path."""
    log, _ = traced(lambda: phase1(backend="xla"), tmp_path)
    assert [(r["name"], r["parent"]) for r in log] == TREE[:2] + [
        ("mmae.init_params", "mmae.entry")]


# ------------------------------------------------------------ on the card

def cuda_run(kernel):
    """A small run of ``kernel`` (2, 3 or 4) on the card: (run, its
    kernels' function, launches a step)."""
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as ck
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as dk
    from multimodalautoencoder_tpu_torch.ops import train_kernels as tk

    layers = (16, 10, 8) if kernel == 3 else (16, 8)
    cfg, spec, unsup, sup, hyper, chyper = bucket(
        layers, tied=False, vae=kernel != 3, device="cuda",
        head=(4,) if kernel == 4 else None)
    tcfg = TCFG.replace(batch_size=20)
    g = torch.Generator().manual_seed(0)
    if kernel == 4:
        run = ck.prepare_cls_run(
            g, cfg, tcfg, spec, hyper, chyper, sup,
            tk.init_grid_params(g, ck.phase1_cfg(cfg), 3, 2),
            ck.init_heads(g, cfg, 3, 2))
        return run, ck.train_cls_kernel, ck.launches_per_step(2, True)
    p0 = tk.init_grid_params(g, cfg, 3, 2)
    if kernel == 3:
        return (dk.prepare_deep_run(g, cfg, tcfg, spec, hyper, unsup, p0),
                dk.train_deep_kernel, dk.launches_per_step(3, False, False))
    return (tk.prepare_run(g, cfg, tcfg, spec, hyper, unsup, p0),
            tk.train_grid_kernel, tk.launches_per_step(False, True))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [2, 3, 4])
def test_cuda_enqueue_counts_the_loops_launches(kernel, tmp_path):
    """``mmae.enqueue``'s ``launches`` is the C loop's own count, steps x
    launches a step, and the run's plan is its own span before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    run, fn, per_step = cuda_run(kernel)
    log, events = traced(lambda: fn(run, 0, 5), tmp_path)
    torch.cuda.synchronize()
    assert [r["name"] for r in log] == ["mmae.plan", "mmae.enqueue"]
    assert log[1]["counts"]["launches"] == 5 * per_step
    assert [e[0] for e in events] == ["mmae.plan", "mmae.enqueue"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [2, 3, 4])
def test_cuda_enqueue_counts_the_update_ring_items(kernel, tmp_path):
    """``mmae.enqueue`` carries the grouped update's weight items by path,
    steps x the run plan's: ``upd_ring_items`` through the W, m, v ring
    and ``upd_fallback_items`` read in place (F = 30 and the 6- or
    2-column tensors take the second path, 16- and 8-column ones the
    first), and nothing else but ``launches``."""
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as ck
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as dk
    from multimodalautoencoder_tpu_torch.ops import train_kernels as tk

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    run, fn, per_step = cuda_run(kernel)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kernel == 2:
        ring = tk.run_plan(tuple(run.dims), bool(run.tied),
                           bool(run.variational), run.n_inst, run.batch,
                           sms, 2 if run.bf16_moments else 4)[4]
    elif kernel == 3:
        ring = dk._run_plan(tuple(run.sizes), bool(run.tied),
                            bool(run.variational), run.n_inst, run.batch,
                            sms, 2 if run.bf16_moments else 4)[4]
    else:
        F, H1 = (int(s) for s in run.params[0].shape[1:])
        ring = ck._run_plan(F, H1, tuple(run.dims), tuple(run.gates),
                            bool(run.variational), run.n_inst, run.batch,
                            sms, 2 if run.bf16_moments else 4)[5]
    assert ring.ring_items > 0 and ring.fallback_items > 0
    log, _ = traced(lambda: fn(run, 0, 5), tmp_path)
    torch.cuda.synchronize()
    assert log[1]["name"] == "mmae.enqueue"
    assert log[1]["counts"] == {
        "launches": 5 * per_step, "upd_ring_items": 5 * ring.ring_items,
        "upd_fallback_items": 5 * ring.fallback_items}


@pytest.mark.cuda
def test_cuda_span_mirrors_are_no_device_ops(tmp_path):
    """The program's spans leave no mirror on the device's timeline: every
    device event of a traced call is a device operation, none named
    ``mmae.*``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, spec, unsup, _, hyper, _ = bucket(device="cuda")
    gt.train_grid_sharded("cuda", 3, cfg, TCFG, spec, hyper, unsup,
                          num_steps=2, backend="pallas")
    torch.cuda.synchronize()

    def call():
        gt.train_grid_sharded("cuda", 3, cfg, TCFG, spec, hyper, unsup,
                              num_steps=STEPS, backend="pallas")
        torch.cuda.synchronize()

    profiling.take_spans()
    with profiling.trace(str(tmp_path / "prof")) as prof:
        call()
    log = profiling.take_spans()
    on_device = [e.name() for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA")]
    assert [r["name"] for r in log][0] == "mmae.entry"
    assert on_device and not [n for n in on_device
                              if n.startswith("mmae.")]
