#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``multimodalautoencoder_tpu_torch/
csrc`` with nvcc (one process per source, started together; [3]-[6] need
``fused_dense`` alone and run while the others build) and drives
every ported path at the reference scale (the 2000-row study of 5 x 200
features):

- serve: each ``fused_dense`` shape against its plain version, then
  ``cli fill`` and ``cli embed`` from checkpoints of a 1000 -> 100 tied
  DAE and VAE, and each dense layer timed in turns with ``torch.addmm``
  against its f32 bound (phases [1]-[6]);
- grid training: the in-kernel generator against its twin, the training
  kernels against their plain twin at small widths (the demo's among
  them) and on the three 1000-wide ACII buckets (60 instances each), then
  those buckets through
  ``train_grid_sharded(backend="pallas")`` for 2,000 steps with the
  sweep's recipe, the best instance saved and served by ``cli fill``, and
  the step timed by launch type and launch by launch (phases [7]-[10]);
- the two-phase classification sweep: the phase-2 kernels against their
  twin at small widths (the demo's among them) and on the validation
  bucket's 80 instances, the validation bucket (tied 1000 -> 100, head
  50 -> 20, 16 settings x 5 folds) through
  ``MMAEClassificationSweep.run()`` at 5,000 + 5,000 steps with its
  winner exported and served by ``cli embed``, the full
  576-setting default grid through ``cli sweep-classification`` at 100 +
  100 steps, and one phase-2 step timed by launch type and launch by
  launch against each launch's bound and ``torch.bmm`` (phases
  [11]-[14]);
- the MMAE sweep: the depth >= 3 kernels against their twin at a small
  width and on the three 1000 -> 500 -> 100 buckets (60 instances each),
  those buckets through ``MMAESweep(backend="pallas", probe="device",
  save_best_params=True).run()`` at 2,000 steps with its winner served by
  ``cli fill``, the default 108-setting grid through ``cli sweep-mmae`` at
  100 steps, one deep step timed, and the device-memory stream probe
  against its twins, each stream timed in turns with its library call
  (phases [15]-[19]);
- single-run training: ``fused_dense`` under autograd at the training
  shapes against its plain twin and timed in turns with ``torch.addmm``,
  the single-run trainer (``trainer.train`` / ``train_classification``) at
  full width with ``use_pallas`` on and off (each step held against a
  float64 step; 500-step runs, which replay CUDA graphs, each bit-equal
  to its eager-loop control; ms per step of both, the device's idle
  share), and ``cli train`` with its checkpoint reloaded and resumed by
  the facade (phases [20]-[22]).  [13] and [17] run their CLI sweeps with
  ``--check-test``, and [13] adds the validation bucket with
  ``share_phase1=False``;
- the comparison baselines and the rest of the data layer, on the
  reference-scale study of ``synthetic.reference_scale_loaders``: the NN
  baseline at full width (each default architecture 2,000 steps replayed
  from CUDA graphs, no host sync in the step loop, bit-equal to its
  eager-loop control, ms per step of both and the device's idle share),
  ``NNSweep(device="cuda").run()`` over the default 32-setting grid, ``cli
  feature-select`` PCA / SKB on the card against float64 and a scipy
  F-score ranking, the native CSV engine against the default reader, and
  ``cli baseline svm``'s error without scikit-learn (phases [23]-[26]);
- the device split and the sharded sweeps: [9]'s tied bucket split over
  ``["cuda:0", "cuda:0"]`` against one device, each instance expected bit
  for bit; ``tools/multihost_sweep.py --hosts 2 --distributed`` on gloo
  over the 108-setting grid with both ranks on the card, its merged ledger
  against ``cli merge-shards`` and its global winner served through
  ``fused_dense`` by ``cli fill``; ``cli sweep-classification
  --process-shard i 2`` as two concurrent processes over the 576-setting
  grid, merged (started with [28], so both share the card); and the
  reference recipe's parity band on kernel 2, with [9]'s utilization rows
  (phases [27]-[30]);
- the end-to-end demo and the installed wheel: ``python -m
  multimodalautoencoder_tpu_torch.examples.acii_pipeline`` on the card
  (the MMAE sweep on kernel 2, the two-phase sweep on kernel 4, the best
  model trained, a file repaired, the NN baseline on it), every printed
  metric finite; and a wheel built from the checkout and installed
  read-only with ``pip --target``, from which a fresh interpreter reads
  the study with ``--engine native`` and serves it through ``fused_dense``
  with ``cli fill``, its libraries built outside the install (phases
  [31]-[32]; the wheel is built, installed and run in a thread of its own
  from [7] on and checked at [32]).

Each phase's wall time follows it on a line of its own (``[n] took``).
The winners of [9], [12], [16] and [28] are served with ``--engine
native``; [4] and [6] serve with the default reader.

Any failed phase ends the run with a non-zero exit; so does a machine
without CUDA.  The last lines of standard output are the card's name and
power limit (as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them), one JSON object describing each
kernel, and the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``python3 chip_smoke.py --deep`` runs [15] and [18] alone, every gate
reported.  ``python3 chip_smoke.py --deep-ab <checkout>`` runs kernel 3 of
another checkout (the parent's) and of this one, each in processes of its
own, from the same state and seeds: parameters and moments after 10 steps
compared bit for bit, and the tied deep step timed in turns; ``python3
chip_smoke.py --cls-ab <checkout>`` does the same for kernel 4 over the
validation bucket and its variants (f32 moments, bf16 operands, VAE,
untied, a one-layer head, batches 37 and 20) and the F = 30 cases, and
times the validation bucket's step launch by launch beside each launch's
bound and ``torch.bmm`` of its products; ``python3 chip_smoke.py
--train-ab <checkout>`` does the same for kernel 2 over the three
1000-wide ACII buckets with bf16 and f32 moments, a 500- and a 300-wide
bucket, phase 1 of the validation bucket (N = 20) and F = 30 cases over
every activation, and times the tied 1000-wide step and phase 1's launch
by launch.  ``python3 chip_smoke.py --single-run`` runs [20] and [21]
alone, [21] with a control route (the kernel route with bf16 operands),
every gate reported; ``python3
chip_smoke.py --baselines`` runs [23]-[26] alone, every gate reported.
``python3 chip_smoke.py --split-cards`` runs [27] over every visible card
at [9]'s 2,000 steps; ``python3 chip_smoke.py --pipeline`` runs [8]'s
and [11]'s F = 30 cases (the demo's widths among them), [31] and [32]
alone, every gate reported.  ``python3 chip_smoke.py --count-launches <cli
arguments>`` runs one
``cli`` command and prints its kernels' launch counts (how [29] reads
them from processes of their own).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL = 1e-4          # kernel vs plain, f32 sums in different orders
LEAN = 0.1          # |lean| of an f32 product's error from float64
ROWS = 2000
LAYERS = (1000, 100)
SEED = 0
# the sweep's recipe (sweep/wrappers.py:173-186, :248-253)
LR, BATCH = 1e-3, 20
# [9]'s steps: the sweep's 15,000 cut to 2,000 for the smoke's time limit
# (as are [12]'s and [16]'s, CLS_RUN_STEPS and MMAE_RUN_STEPS)
STEPS = 2000
NAMES = ("call", "location", "screen", "sms", "survey")
# [31]'s widths (examples/acii_pipeline.py): the MMAE grid's two
# architectures at 30 features and the two-phase sweep's (16, 8) + (8,)
DEMO_LAYERS, DEMO_HEAD = ((24, 8), (16, 8)), (8,)
# MMAESweep's default grid (sweep/wrappers.py:160-168, :257-265)
ACII_PARAMS = {
    "architecture": [[1000, 100], [500, 100], [300, 100]],
    "tie_weights": [True, False],
    "dropout_prob": [1.0, 0.5],
    "weight_penalty": [0.0, 0.01, 0.001],
    "weight_initialization": ["normal"],
    "activation_function": ["softsign", "relu"],
    "variational": [False],
}
DEVICE = "cuda"
# H100 SXM published peaks: HBM bytes/s, f32 CUDA-core FLOP/s, and the
# dense tensor-core rates for TF32 and bf16 operands
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
TF32_FLOP_PER_S, BF16_FLOP_PER_S = 495e12, 989e12
# clock cycles a spin kernel holds the stream while the host queues the
# calls that device_ms times (about 5 ms)
SPIN_CYCLES = 10_000_000


class SmokeFailure(RuntimeError):
    pass


# Failed checks of a run that reports every gate instead of stopping at
# the first (None: a failed check raises).
FAILED = None


def check(cond, msg: str) -> None:
    if not cond:
        if FAILED is None:
            raise SmokeFailure(msg)
        FAILED.append(msg)
        print(f"  FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Like :func:`cuda_ms`, but with the calls queued ahead of the
    device: a spin kernel holds the stream while the host enqueues the
    ``inner`` calls, so the events time the device's work and not the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def types_vs_bmm(profile, groups, bounds, n_inst: int, card: str) -> dict:
    """Each launch type of a training step on the device beside
    ``torch.bmm`` of the same products (the library yardstick; the port
    never calls it), in turns: the kernels' per-launch CUDA events over a
    window (``profile()`` -> ms/step by type), bmm of each type's products
    on the device alone (:func:`device_ms`), bmm again, the kernels
    again.  The weight-gradient type's bmm is its products without Adam."""
    ops = {t: [(torch.rand((n_inst, m, k), device=DEVICE),
                torch.rand((n_inst, k, n), device=DEVICE))
               for m, k, n in shapes] for t, shapes in groups.items()}

    def bmm_turn():
        return {t: device_ms(lambda o=o: [torch.bmm(a, b) for a, b in o],
                             reps=5, inner=5) for t, o in ops.items()}

    k1 = profile()
    b1, b2 = bmm_turn(), bmm_turn()
    k2 = profile()
    out = {}
    for t, bound in bounds.items():
        ms = (k1.get(t, 0.0) + k2.get(t, 0.0)) / 2
        if ms <= 0.0:
            continue
        lib = (b1[t] + b2[t]) / 2 if t in ops else None
        out[t] = {"ms": ms, "library_ms": lib, "bound_ms": bound["bound_ms"],
                  "bound_by": bound["bound_by"]}
        vs = (f", torch.bmm {b1[t]:.4f} / {b2[t]:.4f} ms ({len(ops[t])} "
              f"products{', no Adam' if t == 'weight_grad_adam' else ''})"
              if t in ops else "")
        print(f"    {t:18s} {k1.get(t, 0.0):.4f} / {k2.get(t, 0.0):.4f} "
              f"ms/step{vs}; bound {bound['bound_ms']:.4f} ms by "
              f"{bound['bound_by']} ({100 * bound['bound_ms'] / ms:.1f} % "
              f"of it reached)  [{card}]")
    return out


def dense_bounds(m: int, k: int, n: int, bf16: bool = False):
    """The least time (ms) of ``act(x @ w + b)`` at (m, k, n) for the
    arithmetic the kernel does, and what bounds it: f32 FMAs on the CUDA
    cores for f32 operands, one bf16 product for bf16 operands; bytes are
    x, w, b read once and the output written once.  Also the 3xTF32 figure
    (three TF32 products a multiply-add) of the tensor-core kernel that
    served f32 operands of more than FFMA_MAX_ROWS rows before the FFMA
    kernel did."""
    flop = 2.0 * m * k * n
    nbytes = 4.0 * (m * k + k * n + n + m * n)
    t_ops = flop / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    tf32 = max(3 * flop / TF32_FLOP_PER_S, t_bytes)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", tf32 * 1e3)


def xavier(k: int, n: int, g: torch.Generator) -> torch.Tensor:
    bound = (6.0 / (k + n)) ** 0.5
    return (2 * torch.rand((k, n), generator=g, device="cuda") - 1) * bound


def lean(err: torch.Tensor, exact: torch.Tensor) -> float:
    """How far an error leans toward zero: its mean along the exact
    value's sign over its root mean square (0 for rounding to nearest,
    about -0.6 for 3xTF32 on the tensor cores at K = 1000)."""
    return float((err * exact.sign()).mean() / err.pow(2).mean().sqrt())


def phase_kernel_vs_plain(dk):
    """Every listed shape, activation and bf16 mode; at the serve shapes
    (M = ROWS) also the f32 product against float64, its worst error
    within TOL and its lean toward zero within LEAN.  Returns the largest
    absolute error of each operand type (f32, bf16) and the serve shapes'
    largest |lean|."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # (M, K, N, tied view of w)
        (ROWS, 1000, 1000, False), (ROWS, 1000, 100, False),
        (ROWS, 1000, 100, True), (ROWS, 100, 1000, False),
        (ROWS, 100, 1000, True),
        (ROWS, 1000, 1000, True), (37, 96, 70, False), (37, 96, 70, True)]
    worst = {False: 0.0, True: 0.0}
    worst_lean = 0.0
    for m, k, n, tied in cases:
        # inputs like the serve path's: data in [0, 1] at K = 1000, hidden
        # softsign values in (-1, 1) otherwise
        x = torch.rand((m, k), generator=g, device="cuda")
        if k != 1000:
            x = 2 * x - 1
        w = xavier(n, k, g).T if tied else xavier(k, n, g)
        check(w.is_contiguous() != tied, "tied case must be a strided view")
        b = 0.1 * torch.randn((n,), generator=g, device="cuda")
        if m == ROWS:
            exact = x.double() @ w.double()
            err = dk.fused_dense(x, w, torch.zeros_like(b)).double() - exact
            e_max, e_lean = float(err.abs().max()), lean(err, exact)
            worst_lean = max(worst_lean, abs(e_lean))
            print(f"  ({m},{k},{n}) {'w.T view' if tied else 'w':8s} f32 "
                  f"x @ w against float64: max_abs_err={e_max:.3e}, lean "
                  f"{e_lean:+.3f}")
            check(e_max <= TOL and abs(e_lean) <= LEAN,
                  f"f32 product at ({m},{k},{n}) tied={tied} is "
                  f"{e_max:.3e} from float64 (gate {TOL}), lean "
                  f"{e_lean:+.3f} (gate {LEAN})")
        for act in dk.ACTIVATIONS:
            for bf16 in (False, True):
                got = dk.fused_dense(x, w, b, act, bf16)
                want = dk.fused_dense_reference(x, w, b, act, bf16)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst[bf16] = max(worst[bf16], err)
                ok = bool(torch.allclose(got, want, atol=TOL, rtol=TOL))
                print(f"  ({m},{k},{n}) {'w.T view' if tied else 'w':8s} "
                      f"{act:8s} bf16={int(bf16)} max_abs_err={err:.3e}"
                      f" {'ok' if ok else 'MISMATCH'}")
                check(ok, f"kernel disagrees with plain at ({m},{k},{n}) "
                          f"tied={tied} {act} bf16={bf16}: {err}")
    # the kernel writes every element of its output
    x = torch.rand((37, 96), generator=g, device="cuda")
    w, b = xavier(96, 70, g), torch.zeros(70, device="cuda")
    out = torch.full((37, 70), float("nan"), device="cuda")
    dk.KERNELS.fused_dense(x, w, b, out, dk.ACTIVATION_IDS["tanh"], False)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "kernel left outputs unwritten")
    print(f"  worst: f32 operands {worst[False]:.3e}, bf16 operands "
          f"{worst[True]:.3e}; serve shapes' |lean| {worst_lean:.3f}")
    return worst[False], worst[True], worst_lean


def check_served(cmd: str, name: str, csv_path: str, dl) -> None:
    """What ``cli fill`` / ``cli embed`` wrote next to ``csv_path``: the
    loader's rows in its order; a fill that changed every -1 span and
    nothing else, or finite (rows, 100) embeddings.  Removes the file."""
    from multimodalautoencoder_tpu_torch.data.loader import read_csv

    out_path = os.path.join(
        os.path.dirname(csv_path),
        ("MMAE_filled-" if cmd == "fill" else "embedding-")
        + os.path.basename(csv_path))
    check(os.path.exists(out_path), f"{out_path} was not written")
    out = read_csv(out_path)
    check(list(out.index) == list(dl.frame.index),
          f"{cmd} {name}: row order differs from the loader's")
    if cmd == "fill":
        X_in = dl.frame.matrix(dl.wanted_feats)
        blank = np.zeros_like(X_in, dtype=bool)
        for m in range(dl.num_modalities):
            s, e = dl.modality_table.span(m)
            rows = (X_in[:, s:e] == -1.0).all(axis=1)
            blank[rows, s:e] = True
        check(blank.any(), "the study has no missing modality spans")
        X_out = out.matrix(dl.wanted_feats)
        check(np.isfinite(X_out).all(), f"fill {name}: non-finite")
        # the CSV text round trip moves a value by at most an ulp
        changed = ~np.isclose(X_in, X_out, rtol=0, atol=1e-12,
                              equal_nan=True)
        check(changed.any(), f"fill {name}: nothing was filled")
        check(not (changed & ~blank).any(),
              f"fill {name}: cells outside -1 spans changed")
        check(np.isclose(X_in[blank], -1.0).all()
              and not np.isclose(X_out[blank], -1.0).any(),
              f"fill {name}: a blank span was left at -1")
    else:
        dims = [c for c in out.names if c.startswith("ae_embedding_dim")]
        emb = out.matrix(dims)
        check(emb.shape == (ROWS, LAYERS[-1]),
              f"embed {name}: shape {emb.shape}")
        check(np.isfinite(emb).all(), f"embed {name}: non-finite")
    os.remove(out_path)


def phase_serve(workdir: str, dk):
    """The slice through the CLI a user calls; returns (kernel launches on
    the main path, the DAE checkpoint's path, the loader)."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.models import mmae
    from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    csv_path = synthetic.write_reference_scale_csv(workdir, num_rows=ROWS,
                                                   seed=SEED)
    dl = DataLoader(csv_path, supervised=False, fill_gaps_with=-1.0,
                    suppress_output=True, seed=SEED)
    print(f"  study: {ROWS} rows, {dl.num_feats} features, "
          f"{dl.num_modalities} modalities "
          f"({time.perf_counter() - t0:.1f} s to write and load)")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    configs = {
        "dae": MMAEConfig(num_feats=dl.num_feats, layer_sizes=LAYERS,
                          tie_weights=True, activation="softsign",
                          use_pallas=True),
        "vae": MMAEConfig(num_feats=dl.num_feats, layer_sizes=LAYERS,
                          variational=True, use_pallas=True),
    }
    cks = {name: ckpt.save_checkpoint(
        os.path.join(workdir, "ck"), name,
        mmae.init(cfg, generator=g, device="cuda"), cfg, step=1)
        for name, cfg in configs.items()}

    per_call = {}
    dk.KERNELS.launches = 0
    for name, ck in cks.items():
        for cmd in ("fill", "embed"):
            before = dk.KERNELS.launches
            t0 = time.perf_counter()
            rc = cli.main([cmd, csv_path, "--checkpoint", ck,
                           "--normalize-and-fill", "--device", "cuda",
                           "--seed", str(SEED)])
            torch.cuda.synchronize()
            per_call[(name, cmd)] = (dk.KERNELS.launches - before,
                                     time.perf_counter() - t0)
            check(rc == 0, f"cli {cmd} {name} returned {rc}")
            check_served(cmd, name, csv_path, dl)
    launches = dk.KERNELS.launches
    for (name, cmd), (n, secs) in per_call.items():
        print(f"  cli {cmd:5s} {name}: {n} kernel launches, {secs:.2f} s "
              "host wall (CSV read, forward, CSV write)")
        check(n == 2 * len(LAYERS),
              f"{cmd} {name}: {n} kernel launches, expected "
              f"{2 * len(LAYERS)} per forward")
    for mod in ("jax", "pandas", "sklearn", "multimodalautoencoder_tpu"):
        check(mod not in sys.modules, f"the serve path imported {mod}")
    return launches, cks["dae"], dl


def phase_reconstruction(dk, ck_path, dl):
    """The DAE's reconstruction on the kernel path against the plain path
    on the card, and against the CPU on the first rows."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt
    from multimodalautoencoder_tpu_torch.train import trainer

    params, cfg, _, _ = ckpt.load_checkpoint_auto(
        ck_path, MMAEConfig(num_feats=dl.num_feats), verbose=False,
        device="cuda")
    check(cfg.use_pallas, "the checkpoint lost use_pallas")
    x = torch.as_tensor(dl.frame.matrix(dl.wanted_feats),
                        dtype=torch.float32, device="cuda")
    recon_k, loss_k = trainer.predict(params, cfg, x)
    recon_p, loss_p = trainer.predict(params, cfg.replace(use_pallas=False),
                                      x)
    torch.cuda.synchronize()
    err = float((recon_k - recon_p).abs().max())
    print(f"  DAE reconstruction, kernel vs plain on the card: "
          f"max_abs_err={err:.3e}; loss {float(loss_k):.6f} vs "
          f"{float(loss_p):.6f}")
    check(err <= TOL, f"DAE reconstruction differs from plain by {err}")
    cpu = ckpt.load_checkpoint_auto(ck_path, MMAEConfig(), verbose=False,
                                    device="cpu")[0]
    recon_c, _ = trainer.predict(cpu, cfg, x[:256].cpu())
    err_c = float((recon_k[:256].cpu() - recon_c).abs().max())
    print(f"  DAE reconstruction, kernel on the card vs CPU (256 rows): "
          f"max_abs_err={err_c:.3e}")
    check(err_c <= TOL, f"DAE reconstruction differs from CPU by {err_c}")
    return params, cfg, x


def phase_timing(dk, params, cfg, x, card: str):
    """Forward over all rows, kernel path against plain path (median of
    CUDA-event timings, taken in the order plain, kernel, kernel, plain),
    and each dense layer of that forward alone on the device, in turns with
    ``torch.addmm`` (TF32 off), against its bound under the kernel's
    arithmetic (f32 FMAs) and the earlier 3xTF32 kernel's bound; then each
    layer with bf16 operands, in turns with ``torch.addmm`` of bf16
    tensors, against its bf16 bound."""
    from multimodalautoencoder_tpu_torch.models import mmae

    plain_cfg = cfg.replace(use_pallas=False)
    with torch.no_grad():
        def fwd(c):
            return lambda: mmae.forward(params, c, x)
        p1, k1, k2, p2 = (cuda_ms(fwd(c)) for c in
                          (plain_cfg, cfg, cfg, plain_cfg))
        print(f"  forward, {x.shape[0]} rows x {x.shape[1]} features, "
              f"{LAYERS}: kernel {k1:.4f} / {k2:.4f} ms, plain "
              f"{p1:.4f} / {p2:.4f} ms  [{card}]")
        # the four dense layers of the tied DAE forward
        h = torch.rand((x.shape[0], LAYERS[0]), device="cuda")
        e = torch.rand((x.shape[0], LAYERS[1]), device="cuda")
        w1, w2 = params.enc_w
        b1, b2 = params.enc_b
        d1, d2 = params.dec_b
        layers = [("enc 1", x, w1, b1, cfg.activation),
                  ("enc 2", h, w2, b2, "linear"),
                  ("dec 1 (w.T)", e, w2.T, d1, cfg.activation),
                  ("dec 2 (w.T)", h, w1.T, d2, "linear")]
        print("  each layer on the device alone (calls queued ahead), in "
              "turns: kernel, torch.addmm, torch.addmm, kernel")
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   tf32_ms=0.0)
        by = {"bytes": 0.0, "operations": 0.0}
        wins = 0
        for name, a, w, b, act in layers:
            k1, l1, l2, k2 = (device_ms(f) for f in (
                lambda: dk.fused_dense(a, w, b, act),
                lambda: torch.addmm(b, a, w), lambda: torch.addmm(b, a, w),
                lambda: dk.fused_dense(a, w, b, act)))
            t_p = device_ms(lambda: dk.fused_dense_reference(a, w, b, act))
            t_k, t_l = (k1 + k2) / 2, (l1 + l2) / 2
            m, k, n = a.shape[0], a.shape[1], w.shape[1]
            t_b, bound_by, t_tf32 = dense_bounds(m, k, n)
            by[bound_by] += t_b
            wins += t_k <= t_l
            for key, v in (("ms", t_k), ("plain_ms", t_p),
                           ("library_ms", t_l), ("bound_ms", t_b),
                           ("tf32_ms", t_tf32)):
                tot[key] += v
            print(f"  {name:12s} ({m},{k},{n}) {act:8s}: kernel {k1:.4f} / "
                  f"{k2:.4f} ms ({2.0 * m * k * n / t_k / 1e9:.1f} TFLOP/s),"
                  f" torch.addmm {l1:.4f} / {l2:.4f} ms, plain {t_p:.4f} "
                  f"ms; f32 bound {t_b:.4f} ms ({bound_by}, "
                  f"{100 * t_b / t_k:.1f} % of it reached), 3xTF32 figure "
                  f"{t_tf32:.4f} ms  [{card}]")
        print(f"  4 layers: kernel {tot['ms']:.4f} ms, torch.addmm "
              f"{tot['library_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
              f"bound {tot['bound_ms']:.4f} ms "
              f"({100 * tot['bound_ms'] / tot['ms']:.1f} %), 3xTF32 figure "
              f"{tot['tf32_ms']:.4f} ms; no slower than torch.addmm at "
              f"{wins} of 4 layers  [{card}]")
        # bf16 operands (MMAEConfig(compute_dtype="bfloat16"), mma.sync),
        # in turns with torch.addmm on bf16 copies of the operands
        print("  bf16 operands, each layer on the device alone, in turns: "
              "kernel, torch.addmm of bf16 tensors, torch.addmm, kernel")
        bf16 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        by16 = {"bytes": 0.0, "operations": 0.0}
        for name, a, w, b, act in layers:
            a16, w16, b16 = a.bfloat16(), w.bfloat16(), b.bfloat16()
            k1, l1, l2, k2 = (device_ms(f) for f in (
                lambda: dk.fused_dense(a, w, b, act, True),
                lambda: torch.addmm(b16, a16, w16),
                lambda: torch.addmm(b16, a16, w16),
                lambda: dk.fused_dense(a, w, b, act, True)))
            t_p = device_ms(lambda: dk.fused_dense_reference(a, w, b, act,
                                                             True))
            m, k, n = a.shape[0], a.shape[1], w.shape[1]
            t_b, bound_by, _ = dense_bounds(m, k, n, bf16=True)
            by16[bound_by] += t_b
            for key, v in (("ms", (k1 + k2) / 2), ("plain_ms", t_p),
                           ("library_ms", (l1 + l2) / 2), ("bound_ms", t_b)):
                bf16[key] += v
            print(f"  {name:12s} ({m},{k},{n}) {act:8s} bf16: kernel "
                  f"{k1:.4f} / {k2:.4f} ms, torch.addmm {l1:.4f} / {l2:.4f}"
                  f" ms, plain {t_p:.4f} ms; bound {t_b:.4f} ms "
                  f"({bound_by})  [{card}]")
        bf16["bound_by"] = max(by16, key=by16.get)
        print(f"  4 layers bf16: kernel {bf16['ms']:.4f} ms, torch.addmm "
              f"{bf16['library_ms']:.4f} ms, plain {bf16['plain_ms']:.4f} "
              f"ms, bound {bf16['bound_ms']:.4f} ms ({bf16['bound_by']}, "
              f"{100 * bf16['bound_ms'] / bf16['ms']:.1f} % of it reached)"
              f"  [{card}]")
        # host-paced, as a serve call pays it and as earlier runs timed it:
        # the 4 layers back to back from the host, in turns
        def kernel():
            return [dk.fused_dense(a, w, b, act)
                    for _, a, w, b, act in layers]

        def library():
            return [torch.addmm(b, a, w) for _, a, w, b, _ in layers]

        hk1, hl1, hl2, hk2 = (cuda_ms(f) for f in (kernel, library, library,
                                                  kernel))
        h_p = cuda_ms(lambda: [dk.fused_dense_reference(a, w, b, act)
                               for _, a, w, b, act in layers])
        print(f"  the 4 layers back to back from the host, in turns: kernel "
              f"{hk1:.4f} / {hk2:.4f} ms, torch.addmm {hl1:.4f} / {hl2:.4f} "
              f"ms, plain {h_p:.4f} ms  [{card}]")
    return {"ms": (hk1 + hk2) / 2, "plain_ms": h_p,
            "library_ms": (hl1 + hl2) / 2, "bound_ms": tot["bound_ms"],
            "bound_by": max(by, key=by.get),
            "timing": "host-paced; device_* on the device alone",
            "device_ms": tot["ms"], "device_plain_ms": tot["plain_ms"],
            "device_library_ms": tot["library_ms"], "device_bf16": bf16}


def phase_breakdown(csv_path: str, ck_path: str, card: str) -> None:
    """Where one ``fill`` call's wall time goes, step by step, as
    ``cli fill`` runs them (host clock; the forward ends in a copy back
    to the host, so it includes the device time)."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader, \
        read_csv
    from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt
    from multimodalautoencoder_tpu_torch.train import trainer

    t0 = time.perf_counter()
    read_csv(csv_path)
    read_secs = time.perf_counter() - t0
    steps = []
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        steps.append((name, now - t))
        t = now

    dl = DataLoader(csv_path, supervised=False, fill_gaps_with=-1.0,
                    suppress_output=True, seed=SEED)
    lap("DataLoader (read_csv, normalize_fill_df)")
    params, cfg, _, _ = ckpt.load_checkpoint_auto(
        ck_path, MMAEConfig(num_feats=dl.num_feats), verbose=False,
        device="cuda")
    lap("load_checkpoint_auto")
    x = torch.as_tensor(dl.frame.matrix(dl.wanted_feats),
                        dtype=torch.float32, device="cuda")
    recon, _ = trainer.predict(params, cfg, x)
    recon = recon.cpu().numpy()
    lap("forward (copy in, predict, copy out)")
    filled = dl.fill_df_with_reconstruction(dl.frame, recon)
    lap("fill_df_with_reconstruction")
    filled.to_csv(csv_path + ".filled")
    lap("Frame.to_csv")
    os.remove(csv_path + ".filled")
    total = sum(secs for _, secs in steps)
    for name, secs in steps:
        print(f"  {name:42s} {secs:8.3f} s  {100 * secs / total:5.1f} %")
    print(f"  {'total':42s} {total:8.3f} s  (read_csv alone: "
          f"{read_secs:.3f} s)  [{card}]")


def build_kernels(libs) -> None:
    """One nvcc process per source, all started together."""
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs]:
            fut.result()
    for lib in libs:
        lib.load()


def phase_rng(ptk) -> dict:
    """The in-kernel generator check (tests_tpu/test_hardware.py:28-46):
    the probe kernel's (8, 128) uniforms bit-equal to ops/philox.py, every
    row distinct."""
    from multimodalautoencoder_tpu_torch.ops import philox

    ptk.KERNELS.probe_launches = 0
    u = ptk.philox_probe(7, "cuda")
    torch.cuda.synchronize()
    launches = ptk.KERNELS.probe_launches
    want = philox.probe_uniforms(7)
    same = bool(torch.equal(u.cpu(), want))
    rows = len({tuple(r.tolist()) for r in u.cpu()})
    print(f"  probe (8, 128), seed 7: bit-equal to the twin: {same}; "
          f"{rows} distinct rows; range [{float(u.min()):.6f}, "
          f"{float(u.max()):.6f}]")
    check(same, "the probe kernel's draws differ from ops/philox.py")
    check(rows == 8, "the probe's rows repeat")
    check(0.0 <= float(u.min()) and float(u.max()) < 1.0, "out of [0, 1)")
    ms = cuda_ms(lambda: ptk.philox_probe(7, "cuda"))
    plain_ms = cuda_ms(lambda: philox.probe_uniforms(7, device="cuda"))
    # 1024 Philox4x32-10 draws of ~120 integer operations; 4 KB written
    flop, nbytes = 1024 * 120.0, 4.0 * 1024
    t_f, t_b = flop / F32_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    # the launch floor: an empty kernel at the probe's launch shape, both
    # queued ahead of the device (device_ms), in turns probe, empty,
    # empty, probe
    turns = [device_ms(fn) for fn in (
        lambda: ptk.philox_probe(7, "cuda"), lambda: ptk.empty_launch("cuda"),
        lambda: ptk.empty_launch("cuda"), lambda: ptk.philox_probe(7, "cuda"))]
    probe_dev, floor = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"  probe kernel {ms:.4f} ms, twin on the card {plain_ms:.4f} ms "
          f"(one launch; bound {max(t_f, t_b):.2e} ms)")
    print(f"  on the device, queued: probe {turns[0]:.5f} / {turns[3]:.5f} "
          f"ms, empty kernel {turns[1]:.5f} / {turns[2]:.5f} ms a launch; "
          f"the probe's bound with its launch floor {max(t_f, t_b, floor):.5f}"
          f" ms ({100 * max(t_f, t_b, floor) / probe_dev:.1f} % of its device"
          f" time reached)  [{card_line()}]")
    return {"launches": launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_f, t_b),
            "bound_by": "operations" if t_f >= t_b else "bytes",
            "device_ms": probe_dev, "launch_floor_ms": floor}


def family_cfg(base, family: str):
    return base.replace(tie_weights=family == "tied softsign",
                        variational=family == "vae",
                        activation="relu" if family == "untied relu"
                        else "softsign").validate()


def phase_kernel_vs_twin(ptk, buckets, folded_full, spec_full) -> float:
    """The training kernels against their twin on the card over the first
    10 steps (corruption, dropout, L2 and decay on; same seeds and
    params0), with f32 and bf16 moments, at three sizes: F = 30, (16, 6),
    the three families with 2 settings x 2 folds; F = 30 at the demo's
    widths ([31]: (24, 8) and (16, 8)), its families (tied and untied
    softsign, VAE) and its settings (dropout 1.0 and 0.5, no L2) x 2
    folds; and the main path's own runs, each 1000-wide ACII bucket's 12
    settings x 5 folds (N = 60, softsign and relu mixed per instance).
    ``buckets`` may be empty (``--pipeline``: the F = 30 cases alone).

    Each step starts the kernels from the twin's state, so every step is
    held on its own: run free, a relu instance whose objective is already
    falling fast turns a pre-activation that sits within rounding of 0
    into the other branch, and the two runs then part by far more than
    their sums' rounding.  Random decisions are bit-identical, so a step's
    parameters differ only by f32 sums in another order; the tolerance is
    TOL.  An element whose gradient sits at rounding level can flip the
    sign of Adam's m / sqrt(v) and move by up to ~lr: such elements are
    counted per instance and step, and the phase fails if one instance has
    more than 1e-5 of its parameters (at least 8) over TOL in a step, if
    any parameter moves by more than 2 lr, or if an objective after the
    10 steps differs by more than TOL (relative)."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig, \
        TrainConfig
    from multimodalautoencoder_tpu_torch.data.modalities import \
        ModalityTable
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    steps = 10
    rng = np.random.default_rng(SEED)
    small = gt.FoldedData.from_ragged(
        [rng.random((40, 30)), rng.random((33, 30))],
        [rng.random((9, 30)), rng.random((7, 30))], device=DEVICE)
    base = MMAEConfig(num_feats=30, layer_sizes=(16, 6),
                      weight_initialization="normal")
    two = [{"dropout_prob": 0.5, "weight_penalty": 0.01},
           {"dropout_prob": 1.0, "weight_penalty": 0.001}]
    cases = [(f"small F=30 (16, 6) {family}", family_cfg(base, family), two,
              small, NoiseSpec.build(family_cfg(base, family),
                                     ModalityTable.uniform(5, 6, NAMES)))
             for family in ("tied softsign", "untied relu", "vae")]
    demo = [{"dropout_prob": 1.0, "weight_penalty": 0.0},
            {"dropout_prob": 0.5, "weight_penalty": 0.0}]
    for layers in DEMO_LAYERS:
        for family in ("tied softsign", "untied softsign", "vae"):
            cfg = family_cfg(base.replace(layer_sizes=layers), family)
            cases.append((f"demo F=30 {layers} {family}", cfg, demo, small,
                          NoiseSpec.build(cfg, ModalityTable.uniform(
                              5, 6, NAMES))))
    cases += [(f"{name} bucket, N=60", cfg, members, folded_full, spec_full)
              for name, cfg, members in buckets]
    worst = 0.0
    for label, cfg, settings, folded, spec in cases:
        for moments in ("float32", "bfloat16"):
            tcfg = TrainConfig(learning_rate=LR, batch_size=BATCH,
                               decay=True, decay_steps=1000,
                               decay_rate=0.95, clip_gradients=False,
                               optimizer_state_dtype=moments)
            hyper = gt.HyperStack.from_settings(settings, cfg, tcfg)
            C, K = hyper.num_configs, folded.num_folds
            g = torch.Generator().manual_seed(SEED)
            twin = ptk.prepare_run(g, cfg, tcfg, spec, hyper, folded,
                                   ptk.init_grid_params(g, cfg, C, K))
            per_inst = sum(t[0].numel() for t in twin.params
                           if t is not None)
            bound = max(8, 1e-5 * per_inst)
            err, most, total = 0.0, 0, 0
            for step in range(steps):
                run = twin.clone()
                ptk.train_grid_kernel(run, step, 1)
                ptk.train_grid_kernel_reference(twin, step, 1)
                torch.cuda.synchronize()
                over = sum(((a - b).abs() > TOL).reshape(a.shape[0], -1)
                           .sum(1) for a, b in zip(run.params, twin.params)
                           if a is not None)
                err = max([err] + [float((a - b).abs().max()) for a, b in
                                   zip(run.params, twin.params)
                                   if a is not None])
                most, total = max(most, int(over.max())), total + \
                    int(over.sum())
            objs = [ptk.noisy_val_losses(
                r.grid_params(C, K), cfg, spec, hyper, folded,
                torch.Generator().manual_seed(1)) for r in (run, twin)]
            obj_rel = float(((objs[0] - objs[1]).abs()
                             / objs[1].abs()).max())
            ok = (most <= bound and err <= 2 * LR and obj_rel <= TOL
                  and bool(torch.isfinite(objs[0]).all()))
            worst = max(worst, err)
            print(f"  {label:34s} {moments:8s} max |dp| {err:.3e}; "
                  f"{total} params over {TOL} in {steps} steps, at most "
                  f"{most} of an instance's {per_inst} in one step (bound "
                  f"{bound:.0f}); objective rel diff {obj_rel:.2e} "
                  f"{'ok' if ok else 'MISMATCH'}")
            check(ok, f"kernels disagree with the twin: {label} {moments}")
            del run, twin
    return worst


def sweep_buckets(dl, layers=LAYERS):
    """The ACII grid as MMAESweep builds it, and its three buckets of
    ``layers`` (1000 -> 100 unless named) as (name, cfg, settings)."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.sweep import grid

    settings = grid.add_extra_vae_params(grid.enumerate_grid(ACII_PARAMS))
    buckets = grid.bucket_settings(settings)
    check(len(settings) == 108 and len(buckets) == 9
          and all(len(b) == 12 for _, b in buckets),
          f"the ACII grid gave {len(settings)} settings in "
          f"{len(buckets)} buckets")
    base = MMAEConfig(num_feats=dl.num_feats, loss="sigmoid_cross_entropy",
                      normalization="between_0_and_1", mask_with=-1.0,
                      fill_missing_with=0.0)
    out = []
    for key, members in buckets:
        s = members[0]
        if tuple(s["architecture"]) != tuple(layers):
            continue
        cfg = base.replace(
            layer_sizes=tuple(s["architecture"]),
            tie_weights=bool(s["tie_weights"]),
            variational=bool(s["variational"]),
            weight_initialization=s["weight_initialization"]).validate()
        name = "vae" if cfg.variational else (
            "tied" if cfg.tie_weights else "untied")
        out.append((name, cfg, members))
    check(sorted(n for n, _, _ in out) == ["tied", "untied", "vae"],
          f"the grid lacks a {layers} bucket")
    return base, out


@contextlib.contextmanager
def timed_loops(module, name: str):
    """CUDA events around every call of ``module.<name>`` made inside the
    block (each is one ctypes call whose C loop enqueues a whole run);
    yields the list the (start, end) pairs go to."""
    inner = getattr(module, name)
    pairs = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        inner(*args, **kwargs)
        end.record()
        pairs.append((start, end))

    setattr(module, name, timed)
    try:
        yield pairs
    finally:
        setattr(module, name, inner)


def phase_train(workdir: str, ptk, dk, dl, folded, buckets, spec,
                card: str):
    """The slice end to end: the three 1000-wide ACII buckets trained on
    the study's CV folds through ``train_grid_sharded`` on the kernels with
    the sweep's recipe, the best instance saved and served."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.config import ACTIVATIONS, \
        TrainConfig
    from multimodalautoencoder_tpu_torch.ops import optim
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt

    plans = []
    for name, cfg, members in buckets:
        tcfg = TrainConfig(learning_rate=LR, batch_size=BATCH,
                           num_steps=STEPS, decay=True,
                           decay_steps=1000, decay_rate=0.95,
                           clip_gradients=False, seed=SEED,
                           optimizer_state_dtype="bfloat16")
        hyper = gt.HyperStack.from_settings(members, cfg, tcfg)
        check(gt.resolve_backend("auto", cfg, tcfg, spec, on_gpu=True)
              == "pallas", f"{name}: 'auto' did not resolve to the kernels")
        _, loss0 = gt.train_grid_sharded(DEVICE, SEED, cfg, tcfg, spec,
                                         hyper, folded, num_steps=0,
                                         backend="pallas")
        relu = torch.tensor([m["activation_function"] == "relu"
                             for m in members], device=loss0.device
                            ).view(-1, 1).expand_as(loss0)
        plans.append((name, cfg, tcfg, hyper, members, loss0, relu))

    # the main path: every count at 0 just before, read just after
    ptk.KERNELS.launches = 0
    results = []
    for name, cfg, tcfg, hyper, members, loss0, relu in plans:
        t = time.perf_counter()
        before = ptk.KERNELS.launches
        with timed_loops(ptk, "train_grid_kernel") as loops:
            params, losses = gt.train_grid_sharded(
                DEVICE, SEED, cfg, tcfg, spec, hyper, folded,
                backend="pallas")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(len(loops) == 1, f"{name}: {len(loops)} kernel loops")
        loop_s = loops[0][0].elapsed_time(loops[0][1]) / 1e3
        results.append((name, cfg, tcfg, hyper, members, loss0, relu,
                        losses, params, wall, loop_s,
                        ptk.KERNELS.launches - before))
    launches = ptk.KERNELS.launches

    best = None
    for (name, cfg, tcfg, hyper, members, loss0, relu, losses, params, wall,
         loop_s, n) in results:
        S = tcfg.num_steps
        N = losses.numel()
        want = S * ptk.launches_per_step(cfg.tie_weights, cfg.variational)
        finite = torch.isfinite(losses)
        print(f"  {name:6s} N={N} S={S}: {wall:.2f} s wall, kernel loop "
              f"{loop_s:.3f} s by CUDA events: {1e3 * loop_s / S:.4f} ms/step"
              f" ({1e3 * wall / S:.4f} wall/S), "
              f"{N * S / loop_s:,.0f} instance-steps/s; {n} launches  "
              f"[{card}]")
        for act, sel in (("softsign", ~relu), ("relu", relu)):
            ok = sel & finite
            after = float(losses[ok].median()) if ok.any() else float("nan")
            print(f"    {act:8s}: objective median "
                  f"{float(loss0[sel].median()):.2f} -> {after:.6g}; "
                  f"{int(ok.sum())} of {int(sel.sum())} finite, "
                  f"{int((sel & (losses < loss0)).sum())} below their "
                  "0-step objective")
        check(n == want, f"{name}: {n} kernel launches, expected {want}")
        # A VAE's log-sigma head fed by a relu layer blows up (exp
        # overflows to NaN, or the sampled embedding swamps the
        # reconstruction) in the JAX package's own trainer too, with the
        # study's -1 gap targets and with targets in [0, 1] alike
        # (tests/test_torch_relu_divergence.py, ROADMAP Queue 3).  Phase
        # [8] held those instances against the twin over the first 10
        # steps of this very run (same seed, settings and params0); every
        # other instance must end finite and below its start.
        held = ~relu if cfg.variational else torch.ones_like(relu)
        check(bool(finite[held].all()), f"{name}: an objective held to "
              "convergence is not finite")
        check(bool((losses[held] < loss0[held]).all()),
              f"{name}: {int((losses[held] >= loss0[held]).sum())} "
              "instances did not go below their 0-step objective")
        fin = torch.where(finite, losses, torch.full_like(losses,
                                                          float("inf")))
        c, k = divmod(int(torch.argmin(fin)), losses.shape[1])
        if best is None or float(losses[c, k]) < best[0]:
            best = (float(losses[c, k]), name, cfg, hyper, members, params,
                    c, k, S)
    for mod in ("jax", "pandas", "sklearn", "multimodalautoencoder_tpu"):
        check(mod not in sys.modules, f"the training path imported {mod}")

    loss, name, cfg, hyper, members, params, c, k, S = best
    served = cfg.replace(
        activation=ACTIVATIONS[int(hyper.act_id[c])],
        dropout_prob=float(hyper.keep_prob[c]),
        weight_penalty=float(hyper.weight_penalty[c]), use_pallas=True)
    ck = ckpt.save_checkpoint(os.path.join(workdir, "ck_trained"),
                              f"best_{name}",
                              optim.tree_map(lambda a: a[c, k], params),
                              served, step=S)
    before = dk.KERNELS.launches
    rc = cli.main(["fill", dl.filename, "--checkpoint", ck,
                   "--normalize-and-fill", "--device", DEVICE, "--seed",
                   str(SEED), "--engine", "native"])
    torch.cuda.synchronize()
    check(rc == 0, f"cli fill of the trained checkpoint returned {rc}")
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    serve_dl = DataLoader(dl.filename, supervised=False, fill_gaps_with=-1.0,
                          suppress_output=True, seed=SEED)
    check_served("fill", "trained", dl.filename, serve_dl)
    print(f"  best instance: {name} bucket, config {c} "
          f"({members[c]['activation_function']}, keep "
          f"{members[c]['dropout_prob']}, penalty "
          f"{members[c]['weight_penalty']}), fold {k}, objective {loss:.3f};"
          f" saved to {os.path.basename(ck)} and served by cli fill "
          f"({dk.KERNELS.launches - before} fused_dense launches)")
    tied = next(r for r in results if r[0] == "tied")
    # (name, cfg, tcfg, instance-steps/s of the kernel loop) for [30]
    rates = [(r[0], r[1], r[2], r[7].numel() * r[2].num_steps / r[10])
             for r in results]
    return launches, tied, rates


def phase_step_timing(ptk, tied, folded, spec, card: str) -> dict:
    """One step of the tied 1000-wide bucket (60 instances): the kernels
    by CUDA events from freshly initialised parameters (the first 300
    steps in one call, then windows of 50) and from the bucket's trained
    ones, each launch type against its bound, then each launch against
    its own bound (``ptk.launch_bounds``) with its grid, panel, ``ncol``
    and ``K``, the twin on the card, and the step's products as torch.bmm
    calls (the library yardstick; the port never calls it), in turns with
    the kernels.  The grouped update's type bound is the weight and bias
    updates' together."""
    cfg, tcfg, hyper, params = tied[1], tied[2], tied[3], tied[8]
    C, K = hyper.num_configs, folded.num_folds
    N = C * K
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    inner = 50
    bounds = ptk.launch_type_bounds(cfg, N, BATCH, True)
    w, b = bounds.pop("weight_grad_adam"), bounds.pop("bias_grad_adam")
    bounds["weight_grad_adam"] = ptk._bound(w["bytes"] + b["bytes"],
                                            w["flop"] + b["flop"])
    step = ptk.step_bound(cfg, N, BATCH, True)
    print(f"  tied {F} -> {H1} -> {H2}, N={N}, B={BATCH}, bf16 moments;"
          f" bound {step['bound_ms']:.4f} ms/step ({step['bound_by']}: "
          f"{step['bytes'] / 1e9:.3f} GB, {step['flop'] / 1e9:.2f} GFLOP)")
    out = {}
    for label, start in (("fresh", None), ("trained", params)):
        g = torch.Generator().manual_seed(SEED)
        p0 = ptk.init_grid_params(g, cfg, C, K) if start is None else start
        run = ptk.prepare_run(g, cfg, tcfg, spec, hyper, folded, p0)
        first = 20 if start is not None else 300
        with timed_loops(ptk, "train_grid_kernel") as loops:
            ptk.train_grid_kernel(run, 0, first)
        torch.cuda.synchronize()
        if start is None:
            print(f"  fresh parameters, steps 0-299 in one call: "
                  f"{loops[0][0].elapsed_time(loops[0][1]) / first:.4f} "
                  f"ms/step  [{card}]")
        ms = cuda_ms(lambda: ptk.train_grid_kernel(run, first, inner),
                     reps=5, inner=1) / inner
        print(f"  {label:7s} parameters: {ms:.4f} ms/step by the kernels, "
              f"{ms / step['bound_ms']:.1f}x the bound  [{card}]")
        out[label] = (ms, run)
    run = out["fresh"][1]

    def profile():
        prof: dict = {}
        ptk.train_grid_kernel(run, 1000, inner, profile=prof)
        return {t: v / inner for t, v in prof.items()}

    # (m, k, n) of the 4 forward, 3 backward and 4 weight-gradient products
    groups = {"forward_products": [(BATCH, F, H1), (BATCH, H1, H2),
                                   (BATCH, H2, H1), (BATCH, H1, F)],
              "backward_products": [(BATCH, F, H1), (BATCH, H1, H2),
                                    (BATCH, H2, H1)],
              "weight_grad_adam": [(F, BATCH, H1), (F, BATCH, H1),
                                   (H1, BATCH, H2), (H1, BATCH, H2)]}
    print("  fresh parameters by launch type (events, serialised), in "
          "turns with torch.bmm of its products on the device")
    types = types_vs_bmm(profile, groups, bounds, N, card)

    def per_launch():
        ms: list = []
        ptk.train_grid_kernel(run, 1000, inner, launch_ms=ms)
        return [v / inner for v in ms]

    each = ptk.launch_bounds(cfg, N, BATCH, True)
    products = {i: [(BATCH, r["K"] + r["K2"], r["ncol"])]
                for i, r in enumerate(each) if "K" in r}
    products[len(each) - 1] = groups["weight_grad_adam"]
    print(f"  fresh parameters launch by launch (events, serialised), in "
          f"turns with torch.bmm of its products; {len(each)} launches, "
          f"ptk.launches_per_step "
          f"{ptk.launches_per_step(cfg.tie_weights, cfg.variational)}")
    launches = launches_vs_bmm(per_launch, each, products, N, card)
    twin = run.clone()
    plain_ms = cuda_ms(lambda: ptk.train_grid_kernel_reference(twin, 0, 1),
                       reps=3, inner=3)
    bmm_ms = sum(t["library_ms"] for t in types.values()
                 if t["library_ms"] is not None)
    print(f"  twin on the card {plain_ms:.4f} ms/step; the step's 11 "
          f"products by torch.bmm {bmm_ms:.4f} ms  [{card}]")
    return {"ms": out["fresh"][0], "plain_ms": plain_ms, "bmm_ms": bmm_ms,
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "launch_types": types, "launches": launches}


# ------------------------------------------------ the classification sweep

# bench_classification.py:55-60: the validation bucket
VALIDATION_BUCKET = dict(mmae_layer_sizes=[[1000, 100]],
                         classification_layer_sizes=[[50, 20]],
                         tie_weights=[True], mmae_test_variational=[False])
CLS_STEPS = 15000    # each phase of the sweep (mmae_ and classification_)
# [12]'s run of each phase: the sweep's 15,000 cut for the time limit
CLS_RUN_STEPS = 5000
GRID_STEPS = 100     # each phase of [13]'s full default grid
CLS_LR = 1e-4        # the sweep's phase-2 learning rate
# phase-2 kernels vs twin, one step from the same state, either operand
# type: both sides round bf16 operands alike, so only the f32 sums' order
# differs (a parameter's rounding unit is about 1e-8)
TOL_CLS = 1e-6
# Adam in its linear regime for the checks: at eps 0.1 an update is about
# lr g / eps, in proportion to its gradient, where at the sweep's eps 1e-8
# the first updates are lr sign(g) whatever the gradient's size
LINEAR_LR, LINEAR_EPS = 1e-2, 0.1


def validation_settings(dl):
    """The validation bucket's cfg and 16 settings, as
    MMAEClassificationSweep builds them from its default grid."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.sweep.wrappers import \
        MMAEClassificationSweep as Sweep

    b = VALIDATION_BUCKET
    settings = [s for s in Sweep.default_grid()[0]
                if [s["mmae_architecture"]] == b["mmae_layer_sizes"]
                and [s["classification_layers"]]
                == b["classification_layer_sizes"]
                and [s["tie_weights"]] == b["tie_weights"]
                and [s["variational"]] == b["mmae_test_variational"]]
    check(len(settings) == 16, f"validation bucket: {len(settings)}")
    cfg = MMAEConfig(num_feats=dl.num_feats, loss="sigmoid_cross_entropy",
                     normalization="between_0_and_1", num_labels=3,
                     layer_sizes=LAYERS, classification_layer_sizes=(50, 20),
                     tie_weights=True, weight_initialization="normal"
                     ).validate()
    return cfg, settings


def cls_hypers(cfg, settings, tcfg):
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.sweep.wrappers import \
        MMAEClassificationSweep as Sweep

    return (gt.HyperStack.from_settings(
        [Sweep._mmae_subsetting(s) for s in settings], cfg, tcfg),
        gt.ClassifierHyperStack.from_settings(settings, cfg))


def phase_cls_kernel_vs_twin(pck, ptk, sup_folded, spec_full, cfg_full,
                             settings_full) -> float:
    """The phase-2 kernels against their twin on the card over 10 steps,
    each step started from the twin's state (relu instances part from any
    second run within a few steps), corruption and dropout on, every
    parameter held to TOL_CLS after each step.  With Adam in its linear
    regime (LINEAR_LR, LINEAR_EPS), where an update is proportional to its
    gradient and a wrong gradient shows: at F = 30, (16, 6), every head
    depth x loss x DAE/VAE x moment type x operand type with 2 settings x
    2 folds; at F = 30 and the demo's widths ([31]: (16, 8), head (8,),
    relu, dropout 1.0 and 0.5, no L2), loss x DAE/VAE x moment type x
    operand type; and the validation bucket's own 80 instances at full
    width (bf16 and f32 moments).  Then those 80 at the sweep's lr 1e-4
    and eps 1e-8, where the first updates are lr sign(g): there an
    instance may have at most 1e-5 of its parameters (at least 8) over
    TOL_CLS in a step, Adam sign flips where a gradient sits at rounding
    level.  Every parameter must stay finite.  Without ``cfg_full``
    (``--pipeline``) the F = 30 cases run alone."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig, \
        TrainConfig
    from multimodalautoencoder_tpu_torch.data.modalities import \
        ModalityTable
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    rng = np.random.default_rng(SEED)
    cases = []
    for loss in ("sigmoid_cross_entropy", "softmax"):
        ys = [rng.integers(0, 3, n).astype(np.float32) if loss == "softmax"
              else rng.integers(0, 2, (n, 3)).astype(np.float32)
              for n in (40, 33)]
        small = gt.FoldedData.from_ragged(
            [rng.random((40, 30)), rng.random((33, 30))],
            [rng.random((9, 30)), rng.random((7, 30))], device=DEVICE,
            train_y_list=ys, val_y_list=[y[:9] for y in ys])
        mixed = [{"mmae_dropout_prob": 0.5, "dropout_prob": 0.5,
                  "weight_penalty": 0.01, "mmae_activation_function": "relu",
                  "activation_func": "relu"},
                 {"mmae_dropout_prob": 1.0, "dropout_prob": 1.0,
                  "weight_penalty": 0.0,
                  "mmae_activation_function": "softsign",
                  "activation_func": "softsign"}]
        demo = [{"mmae_dropout_prob": 1.0, "dropout_prob": p,
                 "weight_penalty": 0.0, "mmae_activation_function": "relu",
                 "activation_func": "relu"} for p in (1.0, 0.5)]
        shapes = [((16, 6), head, mixed) for head in ((), (8,), (8, 4))]
        shapes.append((DEMO_LAYERS[1], DEMO_HEAD, demo))
        for layers, head, settings in shapes:
            for family in ("dae", "vae"):
                for ops in ("float32", "bfloat16"):
                    cfg = MMAEConfig(
                        num_feats=30, layer_sizes=layers,
                        tie_weights=family == "dae",
                        variational=family == "vae",
                        classification_layer_sizes=head, num_labels=3,
                        classification_loss=loss, compute_dtype=ops,
                        weight_initialization="normal").validate()
                    spec = NoiseSpec.build(cfg, ModalityTable.uniform(
                        5, 6, NAMES))
                    for moments in ("float32", "bfloat16"):
                        label = (f"F=30 {layers} {loss[:7]} head {head} "
                                 f"{family} ops {ops[:4]}")
                        cases.append((label, cfg, settings, small, spec,
                                      moments, LINEAR_LR, LINEAR_EPS))
    small_cases = len(cases)
    for lr, eps in ((LINEAR_LR, LINEAR_EPS), (CLS_LR, 1e-8)):
        if cfg_full is None:
            break
        for moments in ("bfloat16", "float32"):
            cases.append((f"validation bucket N=80 lr {lr:g} eps {eps:g}",
                          cfg_full, settings_full, sup_folded, spec_full,
                          moments, lr, eps))
    worst = 0.0
    steps = 10
    for label, cfg, settings, folded, spec, moments, lr, eps in cases:
        tcfg = TrainConfig(learning_rate=LR, batch_size=BATCH,
                           clip_gradients=False)
        cls_tcfg = TrainConfig(learning_rate=lr, batch_size=100,
                               clip_gradients=False,
                               optimizer_state_dtype=moments)
        hyper, chyper = cls_hypers(cfg, settings, tcfg)
        C, K = hyper.num_configs, folded.num_folds
        g = torch.Generator().manual_seed(SEED)
        twin = pck.prepare_cls_run(
            g, cfg, cls_tcfg, spec, hyper, chyper, folded,
            ptk.init_grid_params(g, pck.phase1_cfg(cfg), C, K),
            pck.init_heads(g, cfg, C, K), adam_eps=eps)
        per_inst = sum(t[0].numel() for t in twin.params if t is not None)
        # sign flips only where Adam is not linear
        bound = 0 if eps == LINEAR_EPS else max(8, int(1e-5 * per_inst))
        err, most, total = 0.0, 0, 0
        for step in range(steps):
            run = twin.clone()
            pck.train_cls_kernel(run, step, 1)
            pck.train_cls_kernel_reference(twin, step, 1)
            torch.cuda.synchronize()
            over = sum(((a - b).abs() > TOL_CLS).reshape(a.shape[0], -1)
                       .sum(1) for a, b in zip(run.params, twin.params)
                       if a is not None)
            err = max([err] + [float((a - b).abs().max()) for a, b in
                               zip(run.params, twin.params)
                               if a is not None])
            most, total = max(most, int(over.max())), total + int(
                over.sum())
        ok = most <= bound and all(bool(torch.isfinite(t).all())
                                   for t in run.params if t is not None)
        worst = max(worst, err)
        if label.startswith("validation") or not ok:
            print(f"  {label:40s} {moments:8s} max |dp| {err:.3e}; {total}"
                  f" params over {TOL_CLS} in {steps} steps, at most "
                  f"{most} of an instance's {per_inst} in one step (bound "
                  f"{bound}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"phase-2 kernels disagree with the twin: {label} "
                  f"{moments}")
        del run, twin
    demo = sum(c[1].layer_sizes == DEMO_LAYERS[1] for c in cases)
    print(f"  {small_cases} cases at F = 30 held, {demo} of them at the "
          f"demo's widths (worst max |dp| over all cases {worst:.3e})")
    return worst


def majority_rate(sup_folded) -> float:
    """The majority-class rate of the val folds, averaged over folds and
    labels (generic_wrapper.py:549-561)."""
    from multimodalautoencoder_tpu_torch.ops import metrics

    y = sup_folded.val_y.permute(0, 2, 1)                    # (K, L, R)
    R = y.shape[-1]
    valid = (torch.arange(R, device=y.device).view(1, 1, -1)
             < sup_folded.val_n.view(-1, 1, 1))
    return float(torch.nanmean(metrics.majority_baseline(y, valid)))


def phase_cls_sweep(workdir: str, pck, ptk, study_path: str, unsup, sup,
                    card: str):
    """The validation bucket end to end through
    MMAEClassificationSweep(backend="pallas", save_best_params=True).run()
    at CLS_RUN_STEPS + CLS_RUN_STEPS steps, then the exported winner
    served by ``cli embed``.  Returns (phase-2 launches, the ledger rows)."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels
    from multimodalautoencoder_tpu_torch.sweep.wrappers import \
        MMAEClassificationSweep

    results = os.path.join(workdir, "cls_results")
    # the main path: every count at 0 just before, read just after
    ptk.KERNELS.launches = 0
    pck.KERNELS.launches = 0
    t0 = time.perf_counter()
    with timed_loops(ptk, "train_grid_kernel") as p1, \
            timed_loops(cls_train_kernels, "train_cls_kernel") as p2:
        sweep = MMAEClassificationSweep(
            unsup, sup, mmae_num_steps=CLS_RUN_STEPS,
            classification_num_steps=CLS_RUN_STEPS, results_path=results,
            backend="pallas", save_best_params=True, seed=SEED,
            verbose=False, device=DEVICE, **VALIDATION_BUCKET)
        best = sweep.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p1_launches, p2_launches = ptk.KERNELS.launches, pck.KERNELS.launches
    rows = sweep.ledger.rows
    C, K = len(rows), sweep.num_cross_folds
    U = len({(r["mmae_dropout_prob"], r["mmae_weight_penalty"])
             for r in rows})
    check(len(p1) == 1 and len(p2) == 1,
          f"{len(p1)} phase-1 and {len(p2)} phase-2 kernel loops")
    s1 = p1[0][0].elapsed_time(p1[0][1]) / 1e3
    s2 = p2[0][0].elapsed_time(p2[0][1]) / 1e3
    print(f"  {C} settings x {K} folds: {wall:.2f} s wall "
          f"(train {sweep.phase_seconds['train']:.2f} s, metrics "
          f"{sweep.phase_seconds['metrics']:.2f} s)  [{card}]")
    for name, secs, n_inst, launches, per_step in (
            ("phase 1", s1, U * K, p1_launches,
             ptk.launches_per_step(True, False)),
            ("phase 2", s2, C * K, p2_launches,
             pck.launches_per_step(3, False))):
        print(f"  {name}: N={n_inst}, kernel loop {secs:.3f} s by CUDA "
              f"events: {1e3 * secs / CLS_RUN_STEPS:.4f} ms/step, "
              f"{n_inst * CLS_RUN_STEPS / secs:,.0f} instance-steps/s; "
              f"{launches} launches ({per_step} a step)  [{card}]")
        check(launches == CLS_RUN_STEPS * per_step,
              f"{name}: {launches} launches, expected "
              f"{CLS_RUN_STEPS * per_step}")
    check(C == 16, f"the validation bucket wrote {C} rows")
    check(all(r["backend_used"] == "pallas" for r in rows),
          "a row did not run on the kernels")
    for key in ("val_acc", "val_auc"):
        check(all(np.isfinite(float(r[key])) for r in rows),
              f"a row's {key} is not finite")
    print(f"  {'mmae keep/L2':13s} {'head keep/L2':13s} {'val_acc':>8s} "
          f"{'val_auc':>8s} {'noisy acc':>9s} {'clean acc':>9s} "
          f"{'p1 loss':>9s}")
    for r in rows:
        print(f"  {r['mmae_dropout_prob']:4} {r['mmae_weight_penalty']:<8} "
              f"{r['dropout_prob']:4} {r['weight_penalty']:<8} "
              f"{r['val_acc']:8.4f} {r['val_auc']:8.4f} "
              f"{r['noisy_val_acc']:9.4f} {r['clean_val_acc']:9.4f} "
              f"{r['val_mmae_loss']:9.3f}")
    base = majority_rate(sweep.sup_folded)
    top = float(best["val_acc"]["val_acc"])
    print(f"  best val_acc {top:.4f} against the val folds' majority-class "
          f"rate {base:.4f}")
    check(top > base, f"best val_acc {top} does not beat the majority "
                      f"rate {base}")
    for mod in ("jax", "pandas", "sklearn", "multimodalautoencoder_tpu"):
        check(mod not in sys.modules, f"the sweep path imported {mod}")

    ck = os.path.join(results, f"best_mmae_cls-{CLS_RUN_STEPS}.npz")
    check(os.path.exists(ck), f"{ck} was not exported")
    rc = cli.main(["embed", study_path, "--checkpoint", ck,
                   "--normalize-and-fill", "--device", DEVICE, "--seed",
                   str(SEED), "--engine", "native"])
    torch.cuda.synchronize()
    check(rc == 0, f"cli embed of the exported winner returned {rc}")
    serve_dl = DataLoader(study_path, supervised=False, fill_gaps_with=-1.0,
                          suppress_output=True, seed=SEED)
    check_served("embed", "best_mmae_cls", study_path, serve_dl)
    print(f"  exported {os.path.basename(ck)} and served it with cli embed "
          f"--device {DEVICE}: {ROWS} finite 100-wide embeddings")
    return p2_launches, rows, s2 / CLS_RUN_STEPS * 1e3


def phase_full_grid(workdir: str, pck, ptk, study_path: str, card: str):
    """The reference's full default grid (576 settings in 36 buckets) at
    GRID_STEPS + GRID_STEPS steps through ``cli sweep-classification
    --device cuda``: every bucket through both kernels."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.sweep import engine, grid
    from multimodalautoencoder_tpu_torch.sweep.wrappers import \
        MMAEClassificationSweep as Sweep

    settings = Sweep.default_grid()[0]
    buckets = grid.bucket_settings(settings)
    families = {Sweep._family_key(b[0]) for _, b in buckets}
    want_p1 = GRID_STEPS * sum(ptk.launches_per_step(tied, vae)
                               for _, tied, vae, _ in families)
    want_p2 = GRID_STEPS * sum(
        pck.launches_per_step(len(b[0]["classification_layers"]) + 1,
                              b[0]["variational"]) for _, b in buckets)
    results = os.path.join(workdir, "grid_results")
    ptk.KERNELS.launches = 0
    pck.KERNELS.launches = 0
    t0 = time.perf_counter()
    rc, tested = _cli_lines(
        ["sweep-classification", study_path, study_path, "--num-steps",
         str(GRID_STEPS), "--device", DEVICE, "--normalize-and-fill",
         "--seed", str(SEED), "--results-path", results, "--check-test"],
        "test ")
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli sweep-classification returned {rc}")
    scores = dict(line[len("test "):].split(" -> ") for line in tested)
    print(f"  --check-test: the best val_acc setting retrained on fold 0 "
          f"({GRID_STEPS} + {GRID_STEPS} steps, the single-run trainer): "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in scores.items()))
    check(0.0 <= float(scores.get("test_acc", "nan")) <= 1.0,
          f"--check-test printed {tested}")
    ledger = engine.ResultsLedger(results, "MMAE_NN_classifier-acii",
                                  cont=True)
    used = sorted({r["backend_used"] for r in ledger.rows})
    acc = np.asarray([float(r["val_acc"]) for r in ledger.rows])
    print(f"  {len(settings)} settings in {len(buckets)} buckets, "
          f"{len(families)} phase-1 families: {wall:.1f} s wall; "
          f"{len(ledger)} rows, backend_used {used}; val_acc "
          f"{np.nanmin(acc):.3f}-{np.nanmax(acc):.3f} "
          f"({int(np.isnan(acc).sum())} NaN)  [{card}]")
    print(f"  launches: phase 1 {ptk.KERNELS.launches} (expected "
          f"{want_p1}), phase 2 {pck.KERNELS.launches} (expected "
          f"{want_p2}); at the sweep's {CLS_STEPS} + {CLS_STEPS} steps "
          f"{ptk.KERNELS.launches * CLS_STEPS // GRID_STEPS} and "
          f"{pck.KERNELS.launches * CLS_STEPS // GRID_STEPS}")
    check(len(settings) == 576 and len(buckets) == 36,
          f"the default grid gave {len(settings)} in {len(buckets)}")
    check(len(ledger) == 576, f"{len(ledger)} ledger rows")
    check(used == ["pallas"], f"backends {used}")
    check(ptk.KERNELS.launches == want_p1
          and pck.KERNELS.launches == want_p2, "launch counts")


def phase_cls_step_timing(pck, ptk, sup_folded, spec, cfg, settings,
                          card: str) -> dict:
    """One phase-2 step of the validation bucket (80 instances, bf16
    moments): the kernels by CUDA events (windows of 50 steps), each
    launch type, then each launch against its own bound
    (``cls_launch_bounds``) with its grid, panel and thread tile, the
    bound, the twin on the card, and the step's 14 products as torch.bmm
    calls (the library yardstick; the port never calls it), in turns with
    the kernels.  The grouped update's type bound is the weight and bias
    updates' together."""
    from multimodalautoencoder_tpu_torch.config import TrainConfig

    tcfg = TrainConfig(learning_rate=LR, batch_size=BATCH,
                       clip_gradients=False)
    cls_tcfg = TrainConfig(learning_rate=CLS_LR, batch_size=100,
                           clip_gradients=False,
                           optimizer_state_dtype="bfloat16")
    hyper, chyper = cls_hypers(cfg, settings, tcfg)
    C, K = hyper.num_configs, sup_folded.num_folds
    N, B = C * K, cls_tcfg.batch_size
    g = torch.Generator().manual_seed(SEED)
    run = pck.prepare_cls_run(
        g, cfg, cls_tcfg, spec, hyper, chyper, sup_folded,
        ptk.init_grid_params(g, pck.phase1_cfg(cfg), C, K),
        pck.init_heads(g, cfg, C, K))
    bound = pck.cls_step_bound(cfg, N, B, True)
    bounds = pck.cls_launch_type_bounds(cfg, N, B, True)
    w, b = bounds.pop("weight_grad_adam"), bounds.pop("bias_grad_adam")
    bounds["weight_grad_adam"] = ptk._bound(w["bytes"] + b["bytes"],
                                            w["flop"] + b["flop"])
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    print(f"  tied {F} -> {H1} -> {H2}, head 50 -> 20 -> 3, N={N}, B={B}, "
          f"bf16 moments; bound {bound['bound_ms']:.4f} ms/step "
          f"({bound['bound_by']}: {bound['bytes'] / 1e9:.3f} GB, "
          f"{bound['flop'] / 1e9:.2f} GFLOP)")
    inner = 50
    pck.train_cls_kernel(run, 0, 20)
    ms = cuda_ms(lambda: pck.train_cls_kernel(run, 20, inner), reps=5,
                 inner=1) / inner
    print(f"  kernels {ms:.4f} ms/step ({N / ms * 1e3:,.0f} instance-steps"
          f"/s, {bound['flop'] / ms / 1e9:.2f} TFLOP/s)  [{card}]")

    def profile():
        prof: dict = {}
        pck.train_cls_kernel(run, 1000, inner, profile=prof)
        return {t: v / inner for t, v in prof.items()}

    # (m, k, n) of the forward, backward-data and weight-gradient products
    d = [H2, 50, 20, 3]
    groups = {"forward_products": [(B, F, H1), (B, H1, H2)]
              + [(B, d[j], d[j + 1]) for j in range(3)],
              "backward_products": [(B, d[j + 1], d[j]) for j in range(3)]
              + [(B, H2, H1)],
              "weight_grad_adam": [(F, B, H1), (H1, B, H2)]
              + [(d[j], B, d[j + 1]) for j in range(3)]}
    print("  by launch type (events, serialised), in turns with torch.bmm "
          "of its products on the device")
    types = types_vs_bmm(profile, groups, bounds, N, card)

    def per_launch():
        each: list = []
        pck.train_cls_kernel(run, 1000, inner, launch_ms=each)
        return [v / inner for v in each]

    each = pck.cls_launch_bounds(cfg, N, B, True)
    products = {i: [(B, b["K"] + b["K2"], b["ncol"])]
                for i, b in enumerate(each) if "K" in b}
    products[len(each) - 1] = groups["weight_grad_adam"]
    print(f"  launch by launch (events, serialised), in turns with torch.bmm"
          f" of its products; {len(each)} launches, pck.launches_per_step "
          f"{pck.launches_per_step(len(d) - 1, cfg.variational)}")
    launches = launches_vs_bmm(per_launch, each, products, N, card)
    twin = run.clone()
    plain_ms = cuda_ms(lambda: pck.train_cls_kernel_reference(twin, 0, 1),
                       reps=3, inner=3)
    bmm_ms = sum(t["library_ms"] for t in types.values()
                 if t["library_ms"] is not None)
    print(f"  twin on the card {plain_ms:.4f} ms/step; the step's "
          f"{sum(map(len, groups.values()))} products by torch.bmm "
          f"{bmm_ms:.4f} ms  [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bmm_ms": bmm_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "launch_types": types, "launches": launches}



# ------------------------------------------------------ the MMAE sweep
# [16]: MMAESweep at full width on the deep family (24 DAE + 12 VAE
# settings in 3 buckets of 12 settings x 5 folds)
DEEP_LAYERS = (1000, 500, 100)
MMAE_STEPS = 15000   # the sweep's num_steps
MMAE_RUN_STEPS = 2000  # [16]'s run: the sweep's 15,000 cut for the time limit
MMAE_GRID_STEPS = 100  # [17]'s default 108-setting grid, cut for time
SIGN_FLIP_FRACTION = 1e-5


def deep_buckets(base):
    """The deep grid of [16] as MMAESweep builds it: (name, cfg, settings)
    for its tied, untied and VAE buckets."""
    from multimodalautoencoder_tpu_torch.sweep import grid

    params = dict(ACII_PARAMS, architecture=[list(DEEP_LAYERS)])
    settings = grid.add_extra_vae_params(grid.enumerate_grid(params))
    out = []
    for _, members in grid.bucket_settings(settings):
        s = members[0]
        cfg = base.replace(layer_sizes=DEEP_LAYERS,
                           tie_weights=bool(s["tie_weights"]),
                           variational=bool(s["variational"]),
                           weight_initialization=s["weight_initialization"]
                           ).validate()
        name = "vae" if cfg.variational else (
            "tied" if cfg.tie_weights else "untied")
        out.append((name, cfg, members))
    check(len(settings) == 36 and sorted(n for n, _, _ in out)
          == ["tied", "untied", "vae"] and all(len(m) == 12
                                               for _, _, m in out),
          f"the deep grid gave {len(settings)} settings in {len(out)}")
    return out


def as_float64(run):
    """A copy of a twin's run whose parameters and data are float64 (its
    moments keep their type): the same step in more precise arithmetic."""
    out = run.clone()
    out.params = [t.double() for t in out.params]
    out.train = out.train.double()
    return out


def phase_deep_kernel_vs_twin(pdk, ptk, buckets, folded_full,
                              spec_full) -> float:
    """Kernel 3 against its twin on the card over 10 steps, each step
    started from the twin's state, corruption, dropout, L2 and decay on.
    With Adam in its linear regime (eps LINEAR_EPS), where an update is
    proportional to its gradient: at F = 30 for depth 3 (16, 10, 6) and 4
    (20, 14, 10, 6), tied softsign / untied relu / VAE, f32 and bf16
    moments (2 settings x 2 folds) at LINEAR_LR, and on [16]'s three
    full-width buckets (N = 60) at the sweep's lr, every parameter within
    TOL_CLS.  Then the full-width buckets at the sweep's lr and eps 1e-8,
    where the first updates are lr sign(g): an instance may have at most
    1e-5 of its parameters (at least 8) over TOL_CLS in a step (Adam sign
    flips where a gradient sits at rounding level).

    At full width the f32 twin is itself held against a float64 twin from
    the same state: where rounding alone moves an instance's parameters
    past TOL_CLS (the f32 twin misses the f64 one), the kernel may miss the
    f32 twin there too, by at most twice as many parameters; everywhere
    else nothing is excused.  (At lr 1e-2 the relu VAE instances diverge
    within these steps in either twin, so the full-width cases run at the
    sweep's lr.)  Every case is reported before the phase fails."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig, \
        TrainConfig
    from multimodalautoencoder_tpu_torch.data.modalities import \
        ModalityTable
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    rng = np.random.default_rng(SEED)
    small = gt.FoldedData.from_ragged(
        [rng.random((40, 30)), rng.random((33, 30))],
        [rng.random((9, 30)), rng.random((7, 30))], device=DEVICE)
    two = [{"dropout_prob": 0.5, "weight_penalty": 0.01,
            "activation_function": "relu"},
           {"dropout_prob": 1.0, "weight_penalty": 0.001,
            "activation_function": "softsign"}]
    cases = []
    for layers in ((16, 10, 6), (20, 14, 10, 6)):
        base = MMAEConfig(num_feats=30, layer_sizes=layers,
                          weight_initialization="normal")
        for family in ("tied softsign", "untied relu", "vae"):
            cfg = family_cfg(base, family)
            spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
            for moments in ("float32", "bfloat16"):
                cases.append((f"F=30 {layers} {family}", cfg, two, small,
                              spec, moments, LINEAR_LR, LINEAR_EPS))
    for lr, eps in ((LR, LINEAR_EPS), (LR, 1e-8)):
        for name, cfg, members in buckets:
            for moments in ("bfloat16", "float32"):
                cases.append((f"{name} {DEEP_LAYERS} N=60 lr {lr:g} eps "
                              f"{eps:g}", cfg, members, folded_full,
                              spec_full, moments, lr, eps))
    worst, failed = 0.0, []
    steps = 10
    for label, cfg, settings, folded, spec, moments, lr, eps in cases:
        tcfg = TrainConfig(learning_rate=lr, batch_size=BATCH, decay=True,
                           decay_steps=1000, decay_rate=0.95,
                           clip_gradients=False,
                           optimizer_state_dtype=moments)
        hyper = gt.HyperStack.from_settings(settings, cfg, tcfg)
        C, K = hyper.num_configs, folded.num_folds
        g = torch.Generator().manual_seed(SEED)
        twin = pdk.prepare_deep_run(g, cfg, tcfg, spec, hyper, folded,
                                    ptk.init_grid_params(g, cfg, C, K),
                                    adam_eps=eps)
        per_inst = sum(t[0].numel() for t in twin.params)
        bound = 0 if eps == LINEAR_EPS else max(
            8, int(SIGN_FLIP_FRACTION * per_inst))
        full = not label.startswith("F=30")

        def over(a_list, b_list):
            """Per instance: parameters more than TOL_CLS apart."""
            return sum(((a.double() - b.double()).abs() > TOL_CLS)
                       .reshape(a.shape[0], -1).sum(1)
                       for a, b in zip(a_list, b_list))

        err = floor_err = 0.0
        most = total = floor_most = excused = 0
        ok = True
        for step in range(steps):
            run = twin.clone()
            ref = as_float64(twin) if full else None
            pdk.train_deep_kernel(run, step, 1)
            pdk.train_deep_kernel_reference(twin, step, 1)
            if full:
                pdk.train_deep_kernel_reference(ref, step, 1)
            torch.cuda.synchronize()
            n_k = over(run.params, twin.params)
            allowed = torch.full_like(n_k, bound)
            if full:
                # the f32 twin's own distance from the float64 one
                n_t = over(twin.params, ref.params)
                allowed = allowed + 2 * n_t
                excused += int(torch.minimum(n_k, 2 * n_t).sum())
                floor_most = max(floor_most, int(n_t.max()))
                floor_err = max([floor_err] + [
                    float((a.double() - b).abs().max())
                    for a, b in zip(twin.params, ref.params)])
            err = max([err] + [float((a - b).abs().max())
                               for a, b in zip(run.params, twin.params)])
            most, total = max(most, int(n_k.max())), total + int(n_k.sum())
            ok = ok and bool((n_k <= allowed).all()) and not any(
                bool((torch.isfinite(b) & ~torch.isfinite(a)).any())
                for a, b in zip(run.params, twin.params))
        worst = max(worst, err)
        if full or not ok:
            floor = (f"; the f32 twin vs f64: max {floor_err:.2e}, at most "
                     f"{floor_most} over, {excused} excused" if full else "")
            print(f"  {label:44s} {moments:8s} max |dp| {err:.3e}; {total}"
                  f" params over {TOL_CLS} in {steps} steps, at most "
                  f"{most} of an instance's {per_inst} in one step (bound "
                  f"{bound}){floor} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            failed.append(f"{label} {moments}")
        del run, twin
    print(f"  {sum(c[0].startswith('F=30') for c in cases)} cases at F = 30"
          f" (worst max |dp| over all cases {worst:.3e})")
    check(not failed, f"deep kernels disagree with the twin: {failed}")
    return worst


@contextlib.contextmanager
def captured_calls(module, name: str):
    """Every call of ``module.<name>`` made inside the block, as (args,
    kwargs, result)."""
    inner = getattr(module, name)
    calls = []

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def phase_mmae_sweep(workdir: str, pdk, ptk, dk, study, sup, card: str):
    """The slice end to end: MMAESweep(layer_sizes=[DEEP_LAYERS],
    backend="pallas", probe="device", save_best_params=True).run() on the
    study with its classification loader, MMAE_RUN_STEPS steps, then its
    exported winner served by ``cli fill``.  Returns (kernel 3's launches,
    the tied bucket's (cfg, tcfg, hyper, params), the rows)."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.config import ACTIVATIONS
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.sweep.wrappers import MMAESweep

    results = os.path.join(workdir, "mmae_results")
    # the main path: every count at 0 just before, read just after
    pdk.KERNELS.launches = 0
    ptk.KERNELS.launches = 0
    t0 = time.perf_counter()
    with timed_loops(pdk, "train_deep_kernel") as loops, \
            captured_calls(gt, "train_grid_sharded") as calls:
        sweep = MMAESweep(study, classification_data_loader=sup,
                          layer_sizes=[DEEP_LAYERS], backend="pallas",
                          probe="device", save_best_params=True,
                          num_steps=MMAE_RUN_STEPS, results_path=results,
                          seed=SEED, verbose=False, device=DEVICE)
        best, _, extras = sweep.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, depth2 = pdk.KERNELS.launches, ptk.KERNELS.launches
    rows = sweep.ledger.rows
    print(f"  {len(rows)} settings x {sweep.num_cross_folds} folds in "
          f"{len(calls)} buckets: {wall:.2f} s wall (train "
          f"{sweep.phase_seconds['train']:.2f} s, probe "
          f"{sweep.phase_seconds['probe']:.2f} s)  [{card}]")
    check(len(rows) == 36, f"the sweep wrote {len(rows)} rows")
    check(all(r["backend_used"] == "pallas" for r in rows),
          "a row did not run on the kernels")
    check(len(loops) == 3 and len(calls) == 3,
          f"{len(loops)} kernel loops for {len(calls)} buckets")
    check(depth2 == 0, f"{depth2} depth-2 kernel launches in a deep sweep")
    want = 0
    tied = None
    relu = ACTIVATIONS.index("relu")
    for (args, kwargs, (params, losses)), (start, end) in zip(calls, loops):
        cfg, tcfg, hyper = args[2], args[3], args[5]
        per_step = pdk.launches_per_step(len(cfg.layer_sizes),
                                         cfg.tie_weights, cfg.variational)
        want += MMAE_RUN_STEPS * per_step
        secs = start.elapsed_time(end) / 1e3
        N = losses.numel()
        name = "vae" if cfg.variational else (
            "tied" if cfg.tie_weights else "untied")
        _, loss0 = gt.train_grid_sharded(*args, num_steps=0, **kwargs)
        is_relu = (hyper.act_id == relu).view(-1, 1).expand_as(losses).to(
            losses.device)
        held = ~is_relu if cfg.variational else torch.ones_like(is_relu)
        finite = torch.isfinite(losses)
        print(f"  {name:6s} N={N}: kernel loop {secs:.3f} s by CUDA events:"
              f" {1e3 * secs / MMAE_RUN_STEPS:.4f} ms/step, "
              f"{N * MMAE_RUN_STEPS / secs:,.0f} instance-steps/s; "
              f"{per_step} launches a step; "
              f"{int((held & finite & (losses < loss0)).sum())} of "
              f"{int(held.sum())} held instances finite and below their "
              f"start ({int(finite.sum())} of {N} finite)  [{card}]")
        check(bool(finite[held].all()), f"{name}: a held objective is not "
              "finite")
        check(bool((losses[held] < loss0[held]).all()),
              f"{name}: {int((losses[held] >= loss0[held]).sum())} "
              "instances did not go below their 0-step objective")
        if name == "tied":
            tied = (cfg, tcfg, hyper, params)
    print(f"  kernel 3 launches {launches} (expected {want}); depth-2 "
          f"kernel launches {depth2}")
    check(launches == want, "kernel 3 launch count")
    probe_cols = [c for c in sweep.ledger.columns if c.startswith("svm_")]
    vals = np.asarray([[float(r[c]) for c in probe_cols] for r in rows])
    print(f"  {len(probe_cols)} probe columns, values "
          f"{vals.min():.4f}-{vals.max():.4f}; best objective "
          f"{float(best['val_sigmoid_cross_entropy']):.3f} "
          f"({best['architecture']}, tied {best['tie_weights']}, "
          f"{best['activation_function']}, keep {best['dropout_prob']}, "
          f"penalty {best['weight_penalty']}); best svm_val_acc "
          f"{float(extras['svm_val_acc']['svm_val_acc']):.4f}")
    check(len(probe_cols) == 6 * (len(sweep.labels) + 1)
          and np.isfinite(vals).all()
          and (vals >= 0).all() and (vals <= 1).all(),
          "probe columns missing, non-finite or outside [0, 1]")
    for mod in ("jax", "pandas", "sklearn", "multimodalautoencoder_tpu"):
        check(mod not in sys.modules, f"the MMAE sweep imported {mod}")

    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    ck = os.path.join(results, f"best_mmae-{MMAE_RUN_STEPS}.npz")
    check(os.path.exists(ck), f"{ck} was not exported")
    before = dk.KERNELS.launches
    rc = cli.main(["fill", study.filename, "--checkpoint", ck,
                   "--normalize-and-fill", "--device", DEVICE, "--seed",
                   str(SEED), "--engine", "native"])
    torch.cuda.synchronize()
    check(rc == 0, f"cli fill of best_mmae returned {rc}")
    serve_dl = DataLoader(study.filename, supervised=False,
                          fill_gaps_with=-1.0, suppress_output=True,
                          seed=SEED)
    check_served("fill", "best_mmae", study.filename, serve_dl)
    print(f"  exported {os.path.basename(ck)} and served it with cli fill "
          f"--device {DEVICE} ({dk.KERNELS.launches - before} fused_dense "
          "launches: the export keeps the sweep's plain config)")
    return launches, tied, rows


def phase_full_mmae_grid(workdir: str, pdk, ptk, study_path: str,
                         card: str):
    """The default 108-setting ACII grid (9 depth-2 buckets, every width,
    untied and VAE) through ``cli sweep-mmae --device cuda`` with the
    probe, at MMAE_GRID_STEPS steps."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.sweep import engine, grid

    settings = grid.add_extra_vae_params(grid.enumerate_grid(ACII_PARAMS))
    buckets = grid.bucket_settings(settings)
    want = MMAE_GRID_STEPS * sum(
        ptk.launches_per_step(b[0]["tie_weights"] and not b[0]["variational"],
                              b[0]["variational"]) for _, b in buckets)
    results = os.path.join(workdir, "mmae_grid_results")
    ptk.KERNELS.launches = 0
    pdk.KERNELS.launches = 0
    t0 = time.perf_counter()
    rc, tested = _cli_lines(
        ["sweep-mmae", study_path, study_path, "--num-steps",
         str(MMAE_GRID_STEPS), "--device", DEVICE, "--normalize-and-fill",
         "--seed", str(SEED), "--results-path", results, "--check-test"],
        "held-out test:")
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli sweep-mmae returned {rc}")
    test_loss = float(tested[0].split()[-1]) if len(tested) == 1 \
        else float("nan")
    print(f"  --check-test: the best setting retrained on fold 0 "
          f"({MMAE_GRID_STEPS} steps, the single-run trainer), held-out "
          f"test loss {test_loss:.4f}")
    check(np.isfinite(test_loss), f"--check-test printed {tested}")
    ledger = engine.ResultsLedger(results, "MMAE-acii", cont=True)
    used = sorted({r["backend_used"] for r in ledger.rows})
    acc = np.asarray([float(r["svm_val_acc"]) for r in ledger.rows])
    print(f"  {len(settings)} settings in {len(buckets)} buckets: "
          f"{wall:.1f} s wall; {len(ledger)} rows, backend_used {used}; "
          f"svm_val_acc {np.nanmin(acc):.3f}-{np.nanmax(acc):.3f} "
          f"({int(np.isnan(acc).sum())} NaN); launches "
          f"{ptk.KERNELS.launches} (expected {want}; "
          f"{ptk.KERNELS.launches * MMAE_STEPS // MMAE_GRID_STEPS} at the "
          f"sweep's {MMAE_STEPS} steps), kernel 3 {pdk.KERNELS.launches}  "
          f"[{card}]")
    check(len(ledger) == 108, f"{len(ledger)} ledger rows")
    check(used == ["pallas"], f"backends {used}")
    check(ptk.KERNELS.launches == want and pdk.KERNELS.launches == 0,
          "launch counts")


def deep_products(cfg, batch: int) -> dict:
    """(m, k, n) of every product of one deep step by launch type: forward
    (encoder, the VAE head, decoder), backward data (decoder down to gz,
    encoder down to layer 1), weight gradients (two per tied weight)."""
    d = [cfg.num_feats] + list(cfg.layer_sizes)
    L, B = len(d) - 1, batch
    vae = cfg.variational
    fwd = [(B, d[i], d[i + 1]) for i in range(L)]
    fwd += [(B, d[L - 1], d[L])] if vae else []
    fwd += [(B, d[L - j], d[L - j - 1]) for j in range(L)]
    bwd = [(B, d[L - j - 2], d[L - j - 1]) for j in range(L - 1)]
    bwd += [(B, d[L - 1], d[L])]
    bwd += [(B, d[i + 2], d[i + 1]) for i in range(L - 1)]
    bwd += [(B, d[L], d[L - 1])] if vae else []
    n_w = 2 if cfg.tie_weights else 1
    wgr = [(d[i], B, d[i + 1]) for i in range(L)] * n_w
    wgr += [(d[L - j], B, d[L - j - 1]) for j in range(L)] \
        if not cfg.tie_weights else []
    wgr += [(d[L - 1], B, d[L])] if vae else []
    return {"forward_products": fwd, "backward_products": bwd,
            "weight_grad_adam": wgr}


def launches_vs_bmm(per_launch, bounds, products, n_inst: int,
                    card: str) -> list:
    """Each launch of a training step (kernel 2's, 3's or 4's) on the
    device beside ``torch.bmm`` of its products (the update's: its
    weight-gradient products, without Adam), in turns: the kernels'
    per-launch CUDA events over a window (``per_launch()`` -> ms by
    launch), bmm launch by launch (device alone), bmm again, the kernels
    again.  ``bounds`` is ``launch_bounds``, ``deep_launch_bounds`` or
    ``cls_launch_bounds`` (launch order);
    ``products`` maps a launch's index to its (m, k, n) products."""
    ops = {i: [(torch.rand((n_inst, m, k), device=DEVICE),
                torch.rand((n_inst, k, n), device=DEVICE))
               for m, k, n in shapes] for i, shapes in products.items()}

    def bmm_turn():
        return {i: device_ms(lambda o=o: [torch.bmm(a, b) for a, b in o],
                             reps=5, inner=5) for i, o in ops.items()}

    k1 = per_launch()
    b1, b2 = bmm_turn(), bmm_turn()
    k2 = per_launch()
    check(len(k1) == len(bounds) == len(k2),
          f"{len(k1)} launches timed, {len(bounds)} planned")
    print(f"    {'#':>2s} {'launch':16s} {'grid':>13s} {'panel':>5s} "
          f"{'ncol':>5s} {'K':>5s} {'ms (turn 1 / 2)':>17s} "
          f"{'torch.bmm':>17s} {'bound':>7s} {'by':5s} share")
    rows = []
    for i, b in enumerate(bounds):
        ms = (k1[i] + k2[i]) / 2
        lib = (b1[i] + b2[i]) / 2 if i in ops else None
        grid = "x".join(map(str, b["grid"])) if "grid" in b else "-"
        kk = f"{b['K']}+{b['K2']}" if b.get("K2") else str(b.get("K", "-"))
        vs = f"{b1[i]:.4f} / {b2[i]:.4f}" if i in ops else "-"
        print(f"    {i:2d} {b['name']:16s} {grid:>13s} "
              f"{str(b.get('panel', '-')):>5s} "
              f"{str(b.get('ncol', '-')):>5s} {kk:>5s} "
              f"{k1[i]:.4f} / {k2[i]:.4f} {vs:>17s} {b['bound_ms']:.4f} "
              f"{b['bound_by'][:5]:5s} {100 * b['bound_ms'] / ms:.1f} %")
        rows.append({"name": b["name"], "grid": b.get("grid"),
                     "panel": b.get("panel"), "ncol": b.get("ncol"),
                     "K": b.get("K"), "ms": ms,
                     "library_ms": lib, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"]})
    print(f"    sum {sum(r['ms'] for r in rows):.4f} ms; bounds sum "
          f"{sum(r['bound_ms'] for r in rows):.4f} ms  [{card}]")
    return rows


def phase_deep_step_timing(pdk, ptk, tied, folded, spec, card: str) -> dict:
    """One step of [16]'s tied bucket (60 instances, bf16 moments): the
    kernels by CUDA events from fresh parameters (the first 300 steps in
    one call, then windows of 50) and from the trained ones, each launch
    type against its bound, then each launch against its own bound
    (``deep_launch_bounds``) with its grid, ``ncol`` and ``K``, the twin on
    the card, and the step's products as torch.bmm calls (the library
    yardstick; the port never calls it), in turns with the kernels.  The
    grouped update's type bound is the weight and bias updates' together."""
    cfg, tcfg, hyper, params = tied
    C, K = hyper.num_configs, folded.num_folds
    N = C * K
    inner = 50
    bounds = pdk.deep_launch_type_bounds(cfg, N, BATCH, True)
    w, b = bounds.pop("weight_grad_adam"), bounds.pop("bias_grad_adam")
    bounds["weight_grad_adam"] = ptk._bound(w["bytes"] + b["bytes"],
                                            w["flop"] + b["flop"])
    step = pdk.deep_step_bound(cfg, N, BATCH, True)
    print(f"  tied {cfg.num_feats} -> {' -> '.join(map(str, cfg.layer_sizes))}"
          f", N={N}, B={BATCH}, bf16 moments; bound {step['bound_ms']:.4f} "
          f"ms/step ({step['bound_by']}: {step['bytes'] / 1e9:.3f} GB, "
          f"{step['flop'] / 1e9:.2f} GFLOP)")
    out = {}
    for label, start in (("fresh", None), ("trained", params)):
        g = torch.Generator().manual_seed(SEED)
        p0 = ptk.init_grid_params(g, cfg, C, K) if start is None else start
        run = pdk.prepare_deep_run(g, cfg, tcfg, spec, hyper, folded, p0)
        first = 20 if start is not None else 300
        with timed_loops(pdk, "train_deep_kernel") as loops:
            pdk.train_deep_kernel(run, 0, first)
        torch.cuda.synchronize()
        if start is None:
            print(f"  fresh parameters, steps 0-299 in one call: "
                  f"{loops[0][0].elapsed_time(loops[0][1]) / first:.4f} "
                  f"ms/step  [{card}]")
        ms = cuda_ms(lambda: pdk.train_deep_kernel(run, first, inner),
                     reps=5, inner=1) / inner
        print(f"  {label:7s} parameters: {ms:.4f} ms/step by the kernels, "
              f"{ms / step['bound_ms']:.1f}x the bound  [{card}]")
        out[label] = (ms, run)
    run = out["fresh"][1]

    def profile():
        prof: dict = {}
        pdk.train_deep_kernel(run, 1000, inner, profile=prof)
        return {t: v / inner for t, v in prof.items()}

    groups = deep_products(cfg, BATCH)
    print("  fresh parameters by launch type (events, serialised), in "
          "turns with torch.bmm of its products on the device")
    types = types_vs_bmm(profile, groups, bounds, N, card)

    def per_launch():
        ms: list = []
        pdk.train_deep_kernel(run, 1000, inner, launch_ms=ms)
        return [v / inner for v in ms]

    each = pdk.deep_launch_bounds(cfg, N, BATCH, True)
    products = {i: [(BATCH, b["K"] + b["K2"], b["ncol"])]
                for i, b in enumerate(each) if "K" in b}
    products[len(each) - 1] = groups["weight_grad_adam"]
    print(f"  fresh parameters launch by launch (events, serialised), in "
          f"turns with torch.bmm of its products; {len(each)} launches, "
          f"pdk.launches_per_step "
          f"{pdk.launches_per_step(len(cfg.layer_sizes), cfg.tie_weights,
                                   cfg.variational)}")
    launches = launches_vs_bmm(per_launch, each, products, N, card)
    twin = run.clone()
    plain_ms = cuda_ms(lambda: pdk.train_deep_kernel_reference(twin, 0, 1),
                       reps=3, inner=3)
    bmm_ms = sum(t["library_ms"] for t in types.values()
                 if t["library_ms"] is not None)
    print(f"  twin on the card {plain_ms:.4f} ms/step; the step's "
          f"{sum(map(len, groups.values()))} products by torch.bmm "
          f"{bmm_ms:.4f} ms  [{card}]")
    return {"ms": out["fresh"][0], "plain_ms": plain_ms, "bmm_ms": bmm_ms,
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "launch_types": types, "launches": launches}


def phase_hbm(hbm, card: str) -> dict:
    """Kernel 5, the bandwidth probe, on its main path (``hbm_bench.
    measure`` over the untied 1000-wide bucket's bf16 moments, counts at 0
    just before; each stream in turns with its library call), then each
    stream against its twin on the card: the read checksum equal to
    ``torch.sum`` on every pass, the copy and the fill bit for bit."""
    hbm.KERNELS.launches = 0
    result = hbm.measure()
    torch.cuda.synchronize()
    launches = hbm.KERNELS.launches
    for name, r in result.items():
        share = 100 * r["gb_per_s"] * 1e9 / HBM_BYTES_PER_S
        k1, l1, l2, k2 = r["turns"]
        print(f"  {name:6s} {r['bytes'] / 1e9:.3f} GB a pass: kernel "
              f"{k1:.4f} / {k2:.4f} ms, {r['gb_per_s']:.1f} GB/s ({share:.1f}"
              f" % of the datasheet's 3350 GB/s); {r['library']} {l1:.4f} / "
              f"{l2:.4f} ms, {r['library_gb_per_s']:.1f} GB/s  [{card}]")
    n = hbm.MOMENT_BYTES // 4
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    src = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                        device=DEVICE, generator=g)
    dst = torch.zeros_like(src)
    sums = hbm.read_sums(src, steps=2)
    hbm.copy(src, dst, steps=2)
    torch.cuda.synchronize()
    want = int(src.sum(dtype=torch.int64))
    same_copy = bool(torch.equal(dst, src))
    hbm.fill(dst, 0x3F800000)
    torch.cuda.synchronize()
    same_fill = bool((dst == 0x3F800000).all())
    print(f"  vs twins: read checksum {sums.tolist()} == {want}: "
          f"{sums.tolist() == [want] * 2}; copy bit-equal: {same_copy}; "
          f"fill bit-equal: {same_fill}")
    check(sums.tolist() == [want] * 2 and same_copy and same_fill,
          "a stream kernel disagrees with its twin")
    want = len(hbm.PATTERNS) * 2 * (hbm.REPS + 1) * hbm.STEPS
    check(launches == want, f"{launches} stream launches, expected {want}")
    mixed = result["mixed"]
    return {"launches": launches, "max_abs_err": 0.0, "ms": mixed["ms"],
            "plain_ms": mixed["library_ms"],
            "bound_ms": mixed["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": mixed["library_ms"],
            "gb_per_s": {k: r["gb_per_s"] for k, r in result.items()}}


# [20]-[22]: the single-run trainer and its entry points
# (M, K, N, w is the tied decoder's transposed view) of one tied 1000 -> 100
# forward, and the rows a training forward gives it: a training batch (10
# in cli train, 20 in the sweep's recipe), a phase-2 batch (100) and the
# val evaluation (200)
DENSE_LAYERS = ((1000, 1000, False, "softsign"), (1000, 100, False, "linear"),
                (100, 1000, True, "softsign"), (1000, 1000, True, "linear"))
TRAIN_ROWS = (10, 20, 100, 200)
TIMED_ROWS = (20, 100)
SINGLE_STEPS = 500    # [21]'s runs and [22]'s cli train
SINGLE_RECORD = 200   # record period of [21]'s runs
# steps of the calls under torch.profiler ([21], [23]): eager, graphed
IDLE_SHORT, IDLE_STEPS = 100, 500
# [21]'s step gate: from the same state and draws, the kernel route's
# gradient may be at most STEP_GATE times as far from a float64 plain
# step's as the f32 plain route's is.  The gradient is read from Adam's
# first moments after the step, which are linear in it (L2 over every
# moment).  The parameters are reported, not gated: in Adam's first steps
# an update is about lr sign(g) (lr g / eps below eps), so a gradient
# within rounding of zero moves its parameter by up to 2 lr on whichever
# route its rounding happens to strike, and the ratio of the two routes'
# parameter distances depends on the seed, not on the kernel
STEP_GATE = 2.0
GATE_STEPS = 10


def phase_dense_autograd(dk, card: str) -> dict:
    """``fused_dense`` under autograd: at the training shapes (TRAIN_ROWS x
    DENSE_LAYERS, both orientations of w), every activation and operand
    type, the kernel route's forward and its dx, dw, db against the plain
    twin (the plain forward and the Pallas VJP's formula on its output) at
    [3]'s tolerance; the gradient of the tied view reaches its leaf.  Then
    each layer's forward timed at M = 20 and 100 on the device, in turns
    with ``torch.addmm``, against ``dense_bounds``."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst = {False: 0.0, True: 0.0}
    cases = 0
    for m in TRAIN_ROWS:
        for k, n, tied, _ in DENSE_LAYERS:
            x = torch.rand((m, k), generator=g, device=DEVICE)
            if k != 1000:
                x = 2 * x - 1
            leaf = xavier(n, k, g) if tied else xavier(k, n, g)
            b = 0.1 * torch.randn((n,), generator=g, device=DEVICE)
            gout = torch.randn((m, n), generator=g, device=DEVICE)
            for act in dk.ACTIVATIONS:
                for bf16 in (False, True):
                    xs, ls, bs = (t.clone().requires_grad_()
                                  for t in (x, leaf, b))
                    out = dk.fused_dense(xs, ls.T if tied else ls, bs, act,
                                         bf16)
                    out.backward(gout)
                    w = leaf.T if tied else leaf
                    want = dk.fused_dense_reference(x, w, b, act, bf16)
                    gz = dk.activation_grad(gout, want, act)
                    dw = x.T @ gz
                    pairs = ((out.detach(), want), (xs.grad, gz @ w.T),
                             (ls.grad, dw.T if tied else dw),
                             (bs.grad, gz.sum(0)))
                    torch.cuda.synchronize()
                    err = max(float((a - b_).abs().max()) for a, b_ in pairs)
                    ok = all(bool(torch.allclose(a, b_, atol=TOL, rtol=TOL))
                             for a, b_ in pairs)
                    worst[bf16] = max(worst[bf16], err)
                    cases += 1
                    if not ok:
                        print(f"  ({m},{k},{n}) {'w.T' if tied else 'w'} "
                              f"{act} bf16={int(bf16)}: max_abs_err "
                              f"{err:.3e} MISMATCH")
                    check(ok, f"fused_dense gradients disagree with the twin"
                              f" at ({m},{k},{n}) tied={tied} {act} "
                              f"bf16={bf16}: {err}")
    print(f"  {cases} cases (M in {TRAIN_ROWS}, the 4 layers, 5 "
          f"activations, f32 and bf16 operands): forward, dx, dw, db within "
          f"{TOL}; worst f32 {worst[False]:.3e}, bf16 {worst[True]:.3e}")
    timed = {}
    for m in TIMED_ROWS:
        tot = dict(ms=0.0, library_ms=0.0, plain_ms=0.0, bound_ms=0.0)
        by = {"bytes": 0.0, "operations": 0.0}
        for k, n, tied, act in DENSE_LAYERS:
            a = torch.rand((m, k), device=DEVICE)
            w = xavier(n, k, g).T if tied else xavier(k, n, g)
            b = torch.zeros(n, device=DEVICE)
            k1, l1, l2, k2 = (device_ms(f) for f in (
                lambda: dk.fused_dense(a, w, b, act),
                lambda: torch.addmm(b, a, w), lambda: torch.addmm(b, a, w),
                lambda: dk.fused_dense(a, w, b, act)))
            t_p = device_ms(lambda: dk.fused_dense_reference(a, w, b, act))
            t_b, bound_by, _ = dense_bounds(m, k, n)
            by[bound_by] += t_b
            for key, v in (("ms", (k1 + k2) / 2), ("library_ms",
                                                   (l1 + l2) / 2),
                           ("plain_ms", t_p), ("bound_ms", t_b)):
                tot[key] += v
            print(f"  M={m:3d} ({k},{n}){' w.T' if tied else '    '} "
                  f"{act:8s}: kernel {k1:.4f} / {k2:.4f} ms, torch.addmm "
                  f"{l1:.4f} / {l2:.4f} ms, plain {t_p:.4f} ms; bound "
                  f"{t_b:.4f} ms ({bound_by})  [{card}]")
        tot["bound_by"] = max(by, key=by.get)
        print(f"  M={m}: 4 layers kernel {tot['ms']:.4f} ms, torch.addmm "
              f"{tot['library_ms']:.4f}, plain {tot['plain_ms']:.4f}, bound "
              f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}, "
              f"{100 * tot['bound_ms'] / tot['ms']:.1f} % of it reached)  "
              f"[{card}]")
        timed[m] = tot
    return {"grad_max_abs_err": worst[False],
            "grad_max_abs_err_bf16": worst[True], "train_rows": timed}


def single_run_setup(study_path: str):
    """The 2000-row study as the facade loads it (Train / Val / Test rows,
    its 3 labels), on the card; the tied softsign 1000 -> 100 DAE with a
    (50, 20) -> 3 head, the sweep's phase-1 recipe and the phase-2
    defaults (lr 1e-4, batch 100)."""
    from multimodalautoencoder_tpu_torch.config import (
        ClassifierTrainConfig, MMAEConfig, TrainConfig)
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec

    dl = DataLoader(study_path, supervised=True, fill_gaps_with=-1.0,
                    suppress_output=True, seed=SEED)
    arr = dl.device_arrays(DEVICE)
    cfg = MMAEConfig(num_feats=dl.num_feats, layer_sizes=LAYERS,
                     tie_weights=True, activation="softsign",
                     weight_initialization="normal",
                     classification_layer_sizes=(50, 20),
                     num_labels=3).validate()
    tcfg = TrainConfig(learning_rate=LR, batch_size=BATCH, decay=True,
                       decay_steps=1000, decay_rate=0.95,
                       clip_gradients=False, record_every_nth=SINGLE_RECORD)
    cls_tcfg = ClassifierTrainConfig(clip_gradients=False,
                                     record_every_nth=SINGLE_RECORD)
    spec = NoiseSpec.build(cfg, dl.modality_table).to(DEVICE)
    return dl, arr, cfg, tcfg, cls_tcfg, spec


def gate_step(phase: int, routes: dict, tcfg, spec, state, x, y):
    """One training step (phase 1: ``unsupervised_step``, phase 2:
    ``classification_step``) from ``state`` on each route of ``routes``
    (name -> cfg), every route with the draws of ``state.generator`` (left
    as it was), and the ``"plain"`` route in float64 from the same state
    and draws, the yardstick.  Returns ({name: (new state, fused_dense
    launches)}, the float64 state).  ``y`` is unused in phase 1."""
    from multimodalautoencoder_tpu_torch.ops import dense_kernels as dk
    from multimodalautoencoder_tpu_torch.ops import optim
    from multimodalautoencoder_tpu_torch.train import trainer

    gs = state.generator.get_state()
    device = state.generator.device

    def f64(t):
        return t.double() if t.is_floating_point() else t

    def take(cfg, s, xx, yy):
        s = s._replace(generator=torch.Generator(device=device).set_state(gs))
        if phase == 1:
            return trainer.unsupervised_step(s, cfg, tcfg, spec, xx)[0]
        return trainer.classification_step(s, cfg, tcfg, spec, xx, yy)[0]

    ref = take(routes["plain"], trainer.TrainState(
        optim.tree_map(f64, state.params),
        optim.tree_map(f64, state.opt_state), state.step, None),
        x.double(), y.double())
    out = {}
    for name, cfg in routes.items():
        n0 = dk.KERNELS.launches
        new = take(cfg, state, x, y)
        out[name] = (new, dk.KERNELS.launches - n0)
    return out, ref


def gate_distances(a, b):
    """(L2 distance over Adam's first moments, L2 distance over the
    parameters, largest |parameter difference|) between two states."""
    from multimodalautoencoder_tpu_torch.ops import optim

    def dist(ta, tb):
        sq = mx = 0.0
        for p, q in zip(optim.tree_leaves(ta), optim.tree_leaves(tb)):
            d = p.double() - q.double()
            sq += float(torch.sum(d * d))
            mx = max(mx, float(d.abs().max()))
        return sq ** 0.5, mx

    return (dist(a.opt_state.mu, b.opt_state.mu)[0],
            *dist(a.params, b.params))


def phase_step_gate(arr, cfg, tcfg, cls_tcfg, spec) -> dict:
    """Each of GATE_STEPS steps from the plain route's state, for softsign
    and relu, phase 1 and phase 2 (``gate_step``): the kernel route
    (``use_pallas``) must be no further from the float64 step in its
    gradient than STEP_GATE times the plain route's, and a control, the
    kernel route with bf16 operands, must be further (the gate can tell a
    bf16 product from an f32 one).  The kernel route's fused_dense
    launches per step are counted."""
    from multimodalautoencoder_tpu_torch.ops import optim
    from multimodalautoencoder_tpu_torch.train import trainer

    x, y = arr["train_x"], arr["train_y"]
    out = {"launches_per_step": {}}
    for phase in (1, 2):
        p_tcfg = tcfg if phase == 1 else cls_tcfg
        for act in ("softsign", "relu"):
            c = cfg.replace(activation=act)
            routes = {"plain": c, "kernel": c.replace(use_pallas=True),
                      "bf16": c.replace(use_pallas=True,
                                        compute_dtype="bfloat16")}
            st = trainer.init_state(SEED, c, tcfg, DEVICE)
            if phase == 2:
                st = trainer.state_for_params(st.params, cls_tcfg,
                                              st.generator)
            ratios, control, p_ratios, launches = [], [], [], set()
            p_max = k_max = 0.0
            for _ in range(GATE_STEPS):
                took, ref = gate_step(phase, routes, p_tcfg, spec, st, x, y)
                (g_p, d_p, m_p), (g_k, d_k, m_k), (g_b, _, _) = (
                    gate_distances(took[r][0], ref)
                    for r in ("plain", "kernel", "bf16"))
                ratios.append(g_k / max(g_p, 1e-30))
                control.append(g_b / max(g_p, 1e-30))
                p_ratios.append(d_k / max(d_p, 1e-30))
                p_max, k_max = max(p_max, m_p), max(k_max, m_k)
                launches.add(took["kernel"][1])
                kern = took["kernel"][0]
                check(g_k <= STEP_GATE * g_p and all(
                    bool(torch.isfinite(t).all())
                    for t in optim.tree_leaves(kern.params)),
                    f"phase {phase} {act}: the kernel route's gradient is "
                    f"{g_k:.3e} from the f64 step's, the plain route's "
                    f"{g_p:.3e} (gate {STEP_GATE}x)")
                check(g_b > STEP_GATE * g_p,
                      f"phase {phase} {act}: the bf16 control's gradient is "
                      f"{g_b:.3e} from the f64 step's, within the gate "
                      f"({STEP_GATE} x {g_p:.3e})")
                check(took["plain"][1] == 0,
                      "the plain route launched fused_dense")
                st = took["plain"][0]
            check(len(launches) == 1, f"phase {phase} {act}: fused_dense "
                                      f"launches per step {launches}")
            out["launches_per_step"][f"phase{phase}"] = launches.pop()
            print(f"  phase {phase} {act:8s}: kernel/plain gradient distance"
                  f" from the f64 step, per step "
                  f"{' '.join(f'{r:.2f}' for r in ratios)} (gate "
                  f"{STEP_GATE}); bf16 control/plain {min(control):.1f} to "
                  f"{max(control):.1f}; parameter distance kernel/plain "
                  f"{min(p_ratios):.2f} to {max(p_ratios):.2f} (not gated),"
                  f" largest |dp| from f64: plain {p_max:.3e}, kernel "
                  f"{k_max:.3e}")
            out[f"phase{phase}_{act}"] = {
                "max_ratio": max(ratios), "min_control_ratio": min(control),
                "param_ratios": [min(p_ratios), max(p_ratios)],
                "plain_max_abs": p_max, "kernel_max_abs": k_max}
    return out


def device_busy_ms(fn) -> tuple:
    """(device busy ms, device events) of ``fn()`` under torch.profiler,
    CUDA activity only: the kernels' and copies' own durations, read from
    the profiler's raw events (parsing them into FunctionEvents costs
    seconds for every 10^5 events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return sum(e.duration_ns() for e in events) / 1e6, len(events)


def idle_share(call, steps: int, ms_per_step: float) -> dict:
    """The device's idle share of a run that takes ``ms_per_step`` a step
    (by CUDA events, unprofiled): 1 - its kernels' time a step over that,
    the kernels' time a step from torch.profiler over ``call(steps)``, a
    call of the same function (the run's set-up and records included),
    with the device ops a step.  (The profiler's own clock would not do:
    under CUPTI the gaps between a graph's kernels widen and vary from
    call to call.)"""
    busy, n = device_busy_ms(lambda: call(steps))
    check(busy > 0, f"the profiler saw no device activity in {steps} steps")
    return {"idle": 1.0 - busy / steps / ms_per_step,
            "busy_ms_per_step": busy / steps, "ms_per_step": ms_per_step,
            "ops_per_step": n / steps}


def phase_single_run(dk, study_path: str, card: str,
                     control: bool = False) -> dict:
    """The single-run trainer at full width ([21]): the step gate, then a
    SINGLE_STEPS-step run of each phase on each route (the plain route
    first) through the entry points, which replay CUDA graphs
    (``ops/step_graph.py``), each finite with a falling noisy val loss,
    and the kernel route's final parameters scored alike by both routes'
    forwards.  Each run has a control: the same step functions in the
    eager loop (``step_graph.eager_route``) from the same state and
    generator, which the graphed run must equal bit for bit (parameters,
    optimizer state, step, curves) with as many fused_dense launches.  ms
    per step by host clock and by CUDA events for both, the host syncs of
    the graphed run (sync debug mode 'warn': the curves' one copy to the
    host), the kernel route's fused_dense launches (the main path: counts
    at 0 just before each graphed run, read just after), then a 200-step
    window of each route in turns, and the device's idle share of the
    kernel route's runs, graphed and eager (``idle_share``; graphed at
    most 50 %).  With ``control``, the kernel
    route with bf16 operands runs too, and its final losses are set
    beside the plain route's as the two routes' are."""
    from multimodalautoencoder_tpu_torch.ops import step_graph
    from multimodalautoencoder_tpu_torch.train import trainer

    dl, arr, cfg, tcfg, cls_tcfg, spec = single_run_setup(study_path)
    print(f"  study: {len(dl.train_X)} train, {len(dl.val_X)} val, "
          f"{len(dl.test_X)} test rows; {cfg.layer_sizes} tied "
          f"{cfg.activation}, head {cfg.classification_layer_sizes} -> 3")
    print(f"  the step gate: {GATE_STEPS} steps, each from the plain "
          f"route's state")
    gate = phase_step_gate(arr, cfg, tcfg, cls_tcfg, spec)

    x, vx = arr["train_x"], arr["val_x"]
    y, vy = arr["train_y"], arr["val_y"]
    routes = {"plain": cfg, "kernel": cfg.replace(use_pallas=True)}
    if control:
        routes["bf16"] = cfg.replace(use_pallas=True,
                                     compute_dtype="bfloat16")

    def run(c, phase, state, steps=SINGLE_STEPS, eager=False,
            record=SINGLE_RECORD):
        """One entry-point run, timed by the host clock and CUDA events
        (ms a step); with ``eager`` inside ``step_graph.eager_route()``,
        the control.  Counts the host syncs (sync debug mode 'warn') and
        the fused_dense launches."""
        p1 = tcfg.replace(record_every_nth=record)
        p2 = cls_tcfg.replace(record_every_nth=record)
        torch.cuda.synchronize()
        dk.KERNELS.launches = 0
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings(record=True) as caught, \
                (step_graph.eager_route() if eager
                 else contextlib.nullcontext()):
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                ev0.record()
                if phase == 1:
                    new, curves = trainer.train(state, c, p1, spec, x, vx,
                                                steps)
                else:
                    new, curves = trainer.train_classification(
                        state, c, p2, spec, x, y, vx, vy, steps)
                ev1.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = sum("called a synchronizing" in str(w.message)
                    for w in caught)
        return new, curves, {"host_ms": 1e3 * wall / steps,
                             "event_ms": ev0.elapsed_time(ev1) / steps,
                             "launches": dk.KERNELS.launches,
                             "syncs": syncs}

    def same_run(a, b):
        (sa, ca), (sb, cb) = a, b
        return (all(torch.equal(p, q) for p, q in zip(
            trainer.optim.tree_leaves((sa.params, sa.opt_state, sa.step)),
            trainer.optim.tree_leaves((sb.params, sb.opt_state, sb.step))))
            and all(np.array_equal(p, q) for p, q in zip(ca, cb)))

    runs, launches = {}, {}
    for route, c in routes.items():
        st = trainer.init_state(SEED, c, tcfg, DEVICE)
        res = {}
        for phase in (1, 2):
            if phase == 2:
                st = trainer.state_for_params(
                    st.params, cls_tcfg,
                    torch.Generator(device=DEVICE).set_state(
                        st.generator.get_state()))
            gs = st.generator.get_state()
            # the graphed route, the entry points' own: the main path
            new, curves, m = run(c, phase, st)
            # the control: the same step functions in the eager loop, from
            # the same state and generator
            ctl = st._replace(
                generator=torch.Generator(device=DEVICE).set_state(gs))
            c_new, c_curves, cm = run(c, phase, ctl, eager=True)
            same = same_run((new, curves), (c_new, c_curves))
            st = new
            loss = curves.val_loss
            res[phase] = dict(m, loss=loss, params=st.params,
                              eager_host_ms=cm["host_ms"],
                              eager_event_ms=cm["event_ms"],
                              eager_launches=cm["launches"])
            if route == "kernel":
                launches[phase] = m["launches"]
            records = -(-SINGLE_STEPS // SINGLE_RECORD)
            print(f"  {route:6s} phase {phase}: {SINGLE_STEPS} steps, "
                  f"graphed {m['host_ms']:.4f} ms/step host clock, "
                  f"{m['event_ms']:.4f} CUDA events; eager control "
                  f"{cm['host_ms']:.4f} / {cm['event_ms']:.4f}; bit-equal "
                  f"parameters, optimizer state and curves: {same}; host "
                  f"syncs {m['syncs']} (the curves' one copy at the end; 0 "
                  f"in the loop); noisy val loss {loss[0]:.4f} -> "
                  f"{loss[-1]:.4f} ({records} records); fused_dense "
                  f"launches {m['launches']} (eager {cm['launches']})  "
                  f"[{card}]")
            check(same, f"{route} phase {phase}: the graphed run differs "
                        f"from the eager control")
            check(m["syncs"] == 1, f"{route} phase {phase}: {m['syncs']} "
                                   f"host syncs in the graphed run")
            check(m["launches"] == cm["launches"],
                  f"{route} phase {phase}: fused_dense launches graphed "
                  f"{m['launches']}, eager {cm['launches']}")
            check(len(loss) == records and np.isfinite(loss).all(),
                  f"{route} phase {phase}: curves {loss}")
            check(loss[-1] < loss[0], f"{route} phase {phase}: the val loss "
                                      f"did not fall ({loss[0]} -> "
                                      f"{loss[-1]})")
            check(all(bool(torch.isfinite(t).all())
                       for t in trainer.optim.tree_leaves(st.params)),
                  f"{route} phase {phase}: non-finite parameters")
        runs[route] = res
    records = -(-SINGLE_STEPS // SINGLE_RECORD)
    # one launch a dense layer in a forward: phase 1 runs the encoder and
    # the decoder, phase 2 the encoder; each record evaluates two batches
    per_step = gate.pop("launches_per_step")
    depth = len(cfg.layer_sizes)
    check(per_step == {"phase1": 2 * depth, "phase2": depth},
          f"fused_dense launches a step {per_step}")
    want = {p: per_step[f"phase{p}"] * (SINGLE_STEPS + 2 * records)
            for p in (1, 2)}
    check(launches == want, f"fused_dense launches {launches}, expected "
                            f"{want}")
    check(runs["plain"][1]["launches"] == 0
          and runs["plain"][2]["launches"] == 0,
          "the plain route launched fused_dense")
    with torch.no_grad():
        for phase in (1, 2):
            params = runs["kernel"][phase]["params"]

            def score(c):
                g = torch.Generator(device=DEVICE).manual_seed(SEED)
                if phase == 1:
                    return float(trainer.evaluate_reconstruction(
                        params, c, spec, vx, g))
                return float(trainer.evaluate_classification(
                    params, c, vx, vy, g)[0])

            k_loss, p_loss = score(routes["kernel"]), score(routes["plain"])
            print(f"  phase {phase}: the kernel route's final parameters on "
                  f"the {len(vx)} val rows: {k_loss:.6f} by the kernel "
                  f"route, {p_loss:.6f} by the plain route (within {TOL})")
            check(abs(k_loss - p_loss) <= TOL * abs(p_loss),
                  f"phase {phase}: the two forwards score the kernel "
                  f"route's parameters {k_loss} and {p_loss}")
            b = runs["plain"][phase]["loss"][-1]
            for route in routes:
                if route != "plain":
                    a = runs[route][phase]["loss"][-1]
                    print(f"  phase {phase}: final noisy val loss {route} "
                          f"{a:.4f}, plain {b:.4f}, ratio "
                          f"{max(a / b, b / a):.4f} (reported, not gated: "
                          f"the trajectories part by rounding)")

    # the two routes in turns (kernel, plain, plain, kernel), 200 steps
    window = 200
    turns = {"kernel": [], "plain": []}
    for route in ("kernel", "plain", "plain", "kernel"):
        c = routes[route]
        st = trainer.init_state(SEED, c, tcfg, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(st, c, tcfg, spec, x, vx, window)
        torch.cuda.synchronize()
        turns[route].append(1e3 * (time.perf_counter() - t0) / window)
    print(f"  {window}-step windows in turns, host clock, graphed: kernel "
          f"{turns['kernel'][0]:.4f} / {turns['kernel'][1]:.4f} ms/step, "
          f"plain {turns['plain'][0]:.4f} / {turns['plain'][1]:.4f}  "
          f"[{card}]")

    kc = routes["kernel"]
    idle = {}
    for phase in (1, 2):
        st = trainer.init_state(SEED, kc, tcfg, DEVICE)
        if phase == 2:
            st = trainer.state_for_params(st.params, cls_tcfg, st.generator)
        for eager in (False, True):
            run(kc, phase, st, 10, eager)   # warm: libraries, profiler
            ms = runs["kernel"][phase]["eager_event_ms" if eager
                                       else "event_ms"]
            sh = idle_share(lambda n: run(kc, phase, st, n, eager),
                            IDLE_SHORT if eager else IDLE_STEPS, ms)
            idle[f"phase{phase}_{'eager' if eager else 'graphed'}"] = sh
            print(f"  device idle share of the kernel route's phase-{phase} "
                  f"run, {'eager loop' if eager else 'graphed'}: "
                  f"{100 * sh['idle']:.1f} % (kernels "
                  f"{sh['busy_ms_per_step']:.4f} ms a step over a "
                  f"{IDLE_SHORT if eager else IDLE_STEPS}-step call, "
                  f"torch.profiler; the run {ms:.4f} ms a step; "
                  f"{sh['ops_per_step']:.1f} device ops a step)  [{card}]")
        graphed = idle[f"phase{phase}_graphed"]["idle"]
        check(graphed <= 0.5, f"phase {phase}: the graphed run's device "
                              f"idles {100 * graphed:.1f} % of it")
    return {"gate": gate, "launches": launches[1] + launches[2],
            "launches_per_step": per_step,
            "ms_per_step": {f"{r}_phase{p}": runs[r][p]["event_ms"]
                            for r in runs for p in (1, 2)},
            "host_ms_per_step": {f"{r}_phase{p}": runs[r][p]["host_ms"]
                                 for r in runs for p in (1, 2)},
            "eager_ms_per_step": {f"{r}_phase{p}": runs[r][p]["eager_event_ms"]
                                  for r in runs for p in (1, 2)},
            "eager_host_ms_per_step": {
                f"{r}_phase{p}": runs[r][p]["eager_host_ms"]
                for r in runs for p in (1, 2)},
            "turns_ms": turns, "idle_share": idle}


def phase_cli_train(workdir: str, study_path: str, card: str) -> None:
    """``cli train --device cuda --arch 1000 100`` for SINGLE_STEPS steps on
    the study, its checkpoint reloaded by
    ``MultimodalAutoencoder.load_saved_model`` (parameters, Adam state,
    step and curves), then resumed for 100 steps."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.api import MultimodalAutoencoder
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.ops import optim
    from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt

    ckdir = os.path.join(workdir, "train_ck")
    t0 = time.perf_counter()
    rc = cli.main(["train", study_path, "--device", DEVICE, "--arch",
                   *map(str, LAYERS), "--num-steps", str(SINGLE_STEPS),
                   "--normalize-and-fill", "--seed", str(SEED),
                   "--checkpoint-dir", ckdir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli train returned {rc}")
    path = ckpt.latest_checkpoint(ckdir)
    check(path is not None and path.endswith(f"-{SINGLE_STEPS}.npz"),
          f"cli train wrote {path}")
    print(f"  cli train: {wall:.2f} s wall ({1e3 * wall / SINGLE_STEPS:.4f}"
          f" ms a step with the set-up) -> {os.path.basename(path)}  "
          f"[{card}]")
    model = MultimodalAutoencoder(
        filename=study_path, layer_sizes=LAYERS, variational=False,
        normalize_and_fill=True, fill_gaps_with=-1.0, checkpoint_dir=ckdir,
        seed=SEED, verbose=False, device=DEVICE)
    model.load_saved_model()
    saved, _, curves, _ = ckpt.load_checkpoint_auto(
        path, MMAEConfig(), verbose=False, device=DEVICE)
    same = all(bool(torch.equal(a, b)) for a, b in zip(
        optim.tree_leaves(model.params), optim.tree_leaves(saved)))
    step = int(model.state.step)
    moments = float(sum(t.abs().sum() for t in
                        optim.tree_leaves(model.state.opt_state.mu)))
    loss = curves["val_loss"]
    print(f"  reloaded: step {step}, {len(model.val_loss)} curve entries "
          f"(val loss {loss[0]:.4f} -> {loss[-1]:.4f}), parameters equal: "
          f"{same}, Adam moments restored (sum |m| {moments:.4e})")
    check(same and step == SINGLE_STEPS and moments > 0,
          "the reloaded model differs from the checkpoint")
    check(np.isfinite(loss).all() and loss[-1] < loss[0],
          f"cli train's val loss {loss[0]} -> {loss[-1]}")
    model.train(num_steps=100)
    step = int(model.state.step)
    print(f"  resumed 100 steps: step {step}, {len(model.val_loss)} curve "
          f"entries, last val loss {model.val_loss[-1]:.4f}")
    check(step == SINGLE_STEPS + 100 and len(model.val_loss)
          == (SINGLE_STEPS + 100) // 50
          and np.isfinite(model.val_loss).all(), "the resumed run")


def phase_unshared_bucket(workdir: str, pck, ptk, unsup, sup, card: str):
    """The validation bucket with ``share_phase1=False`` at GRID_STEPS +
    GRID_STEPS steps: every setting pretrains its own MMAE on kernel 2,
    then phase 2 on kernel 4, as the reference retrains."""
    from multimodalautoencoder_tpu_torch.sweep.wrappers import \
        MMAEClassificationSweep

    ptk.KERNELS.launches = 0
    pck.KERNELS.launches = 0
    t0 = time.perf_counter()
    sweep = MMAEClassificationSweep(
        unsup, sup, mmae_num_steps=GRID_STEPS,
        classification_num_steps=GRID_STEPS, share_phase1=False,
        results_path=os.path.join(workdir, "unshared_results"),
        backend="pallas", seed=SEED, verbose=False, device=DEVICE,
        **VALIDATION_BUCKET)
    sweep.sweep_all_parameters()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sweep.ledger.rows
    want = (GRID_STEPS * ptk.launches_per_step(True, False),
            GRID_STEPS * pck.launches_per_step(3, False))
    got = (ptk.KERNELS.launches, pck.KERNELS.launches)
    acc = np.asarray([float(r["val_acc"]) for r in rows])
    print(f"  share_phase1=False: {len(rows)} settings x "
          f"{sweep.num_cross_folds} folds, phase 1 at N = "
          f"{len(rows) * sweep.num_cross_folds}: {wall:.1f} s wall; "
          f"launches {got} (expected {want}); val_acc {acc.min():.3f}-"
          f"{acc.max():.3f}  [{card}]")
    check(len(rows) == 16 and np.isfinite(acc).all()
          and {r["backend_used"] for r in rows} == {"pallas"},
          "the unshared bucket's rows")
    check(got == want, f"unshared bucket launches {got}, expected {want}")


# [23]-[26]: the comparison baselines, feature selection and the rest of
# the data layer, on the reference-scale study of reference_scale_loaders
NN_STEPS = 5000      # the NN baseline's num_steps (baselines/neural_net.py)
NN_RUN_STEPS = 2000  # [23]'s fits: NN_STEPS cut for the smoke's time limit
NN_RECORD = 500      # [23]'s record period
NN_SAME_STEPS = 500  # [23]'s runs with and without recording
# [24]'s default 32-setting grid at 5 folds: 200 steps a fit, cut from
# 5,000 for the smoke's time limit.  In the eager loop a step was
# host-bound (3-8 ms on an H100 host) and 200 steps a fit took 216 s once,
# so the smoke ran 50; replayed from CUDA graphs the sweep at 200 steps
# takes well under that (PERF.md)
NN_GRID_STEPS = 200
PCA_DIMS = 100
# the ledger columns of the JAX package's NNSweep, in its order (the smoke
# cannot import the JAX package; tests/test_torch_baselines.py holds the
# port's columns to the JAX sweep's)
NN_LEDGER_COLUMNS = [
    "architecture", "batch_size", "dropout_prob", "learning_rate",
    "weight_penalty", "val_acc", "val_auc", "val_f1", "val_precision",
    "val_recall", "noisy_val_acc", "noisy_val_auc", "clean_val_acc",
    "clean_val_auc"]


def _labels_2d(y) -> np.ndarray:
    y = np.asarray(y, dtype=np.float32)
    return y[:, None] if y.ndim == 1 else y


def phase_nn_baseline(sup, card: str) -> dict:
    """[23]: the NN baseline's MLP at full width on the card, one fit of
    each default architecture on fold 0 (keep 0.5, penalty 1e-3, batch
    100, NN_RUN_STEPS steps, accuracies recorded every NN_RECORD steps).
    Each fit runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
    host synchronisation inside the step loop fails the phase; ms per step by
    the host clock and by CUDA events around the loop.  The fit replays
    CUDA graphs (``ops/step_graph.py``); the control runs the same step
    in the eager loop (``step_graph.eager_route``) for NN_SAME_STEPS steps
    from the same state, beside a graphed run of as many, both timed.  The
    device's idle share of each and its kernels per step from
    torch.profiler (``idle_share``).  Gates: finite parameters, val
    accuracy at or above the majority rate, the graphed run bit-equal to
    the eager control (parameters, Adam state, curves), the graphed
    route's idle share at most 50 %, and (first architecture,
    NN_SAME_STEPS steps) the same final parameters with recording every
    NN_RECORD steps and without.
    Returns the per-architecture numbers and the extrapolated wall time of
    the default grid (``cli baseline nn``)."""
    from multimodalautoencoder_tpu_torch.baselines.neural_net import (
        DEFAULT_ARCHS, DEFAULT_DROPOUTS, DEFAULT_PENALTIES)
    from multimodalautoencoder_tpu_torch.models import neural_net as nn
    from multimodalautoencoder_tpu_torch.ops import optim, step_graph

    sup.set_to_cross_validation_fold(0)
    tx, vx = (torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
              for a in (sup.train_X, sup.val_X))
    ty, vy = (torch.as_tensor(_labels_2d(a), device=DEVICE)
              for a in (sup.train_Y, sup.val_Y))
    frac = _labels_2d(sup.val_Y).mean(axis=0)
    majority = float(np.mean(np.maximum(frac, 1 - frac)))
    print(f"  fold 0: {tx.shape[0]} train, {vx.shape[0]} val rows, "
          f"{tx.shape[1]} features, {ty.shape[1]} labels; val majority "
          f"rate {majority:.4f}")
    out = {}
    for ai, arch in enumerate(DEFAULT_ARCHS):
        cfg = nn.NNConfig(input_size=tx.shape[1], layer_sizes=tuple(arch),
                          output_size=ty.shape[1], dropout_prob=0.5,
                          weight_penalty=1e-3, learning_rate=1e-3,
                          batch_size=100, seed=SEED)
        nn.train(nn.init_state(cfg, DEVICE), cfg, tx, ty, vx, vy, 20)
        state = nn.init_state(cfg, DEVICE)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            start.record()
            state, (ta, va) = nn.train(state, cfg, tx, ty, vx, vy,
                                       NN_RUN_STEPS,
                                       record_every_nth=NN_RECORD)
            end.record()
            enqueue = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / NN_RUN_STEPS
        event_ms = start.elapsed_time(end) / NN_RUN_STEPS
        leaves = nn.params_to_numpy(state.params)
        train_acc = float(nn.accuracy(state.params, cfg, tx, ty))
        val_acc = float(nn.accuracy(state.params, cfg, vx, vy))
        curve = va.cpu().numpy()

        # the control: the same step in the eager loop from the same
        # state, NN_SAME_STEPS steps recorded every NN_RECORD
        pair = []
        for eager in (False, True):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with (step_graph.eager_route() if eager
                  else contextlib.nullcontext()):
                t1 = time.perf_counter()
                e0.record()
                r = nn.train(nn.init_state(cfg, DEVICE), cfg, tx, ty, vx,
                             vy, NN_SAME_STEPS, record_every_nth=NN_RECORD)
                e1.record()
                torch.cuda.synchronize()
            pair.append((r, 1e3 * (time.perf_counter() - t1) / NN_SAME_STEPS,
                         e0.elapsed_time(e1) / NN_SAME_STEPS))
        (g_run, _, _), (e_run, eager_host, eager_event) = pair
        same = all(torch.equal(a, b) for a, b in zip(
            optim.tree_leaves((g_run[0].params, g_run[0].opt_state,
                               g_run[0].step, *g_run[1])),
            optim.tree_leaves((e_run[0].params, e_run[0].opt_state,
                               e_run[0].step, *e_run[1]))))
        check(same, f"{arch}: the graphed run differs from the eager "
                    f"control after {NN_SAME_STEPS} steps")

        idle = {}
        for eager in (False, True):
            with (step_graph.eager_route() if eager
                  else contextlib.nullcontext()):
                nn.train(state, cfg, tx, ty, vx, vy, 10)
                idle["eager" if eager else "graphed"] = idle_share(
                    lambda n: nn.train(state, cfg, tx, ty, vx, vy, n,
                                       record_every_nth=NN_RECORD),
                    IDLE_SHORT if eager else IDLE_STEPS,
                    eager_event if eager else event_ms)
        g_idle, e_idle = idle["graphed"], idle["eager"]
        print(f"  {str(tuple(arch)):16s} graphed {host_ms:.4f} ms/step by "
              f"the host clock ({1e3 * enqueue / NN_RUN_STEPS:.4f} to "
              f"enqueue), {event_ms:.4f} by CUDA events; eager control "
              f"{eager_host:.4f} / {eager_event:.4f} ms/step "
              f"({NN_SAME_STEPS} steps), bit-equal parameters, Adam state "
              f"and curves: {same}; 0 host syncs in {NN_RUN_STEPS} steps "
              f"(sync debug mode 'error'); device idle "
              f"{100 * g_idle['idle']:.1f} % graphed, "
              f"{100 * e_idle['idle']:.1f} % eager (kernels "
              f"{g_idle['busy_ms_per_step']:.4f} ms a step, "
              f"{g_idle['ops_per_step']:.1f} device ops, torch.profiler); "
              f"train acc "
              f"{train_acc:.4f}, val acc {val_acc:.4f} (recorded every "
              f"{NN_RECORD}: {np.round(curve, 4).tolist()})  [{card}]")
        check(g_idle["idle"] <= 0.5, f"{arch}: the graphed run's device "
                                     f"idles {100 * g_idle['idle']:.1f} % "
                                     f"of it")
        check(all(np.isfinite(a).all() for a in leaves),
              f"{arch}: non-finite parameters")
        check(val_acc >= majority,
              f"{arch}: val acc {val_acc:.4f} under the majority rate "
              f"{majority:.4f}")
        check(len(curve) == NN_RUN_STEPS // NN_RECORD,
              f"{arch}: curve length")
        if ai == 0:
            runs = [nn.train(nn.init_state(cfg, DEVICE), cfg, tx, ty, vx,
                             vy, NN_SAME_STEPS, record_every_nth=rec)[0]
                    for rec in (NN_RECORD, 0)]
            same = all(np.array_equal(a, b) for a, b in zip(
                *(nn.params_to_numpy(r.params) for r in runs)))
            print(f"  {tuple(arch)}: final parameters after "
                  f"{NN_SAME_STEPS} steps with and without recording "
                  f"{'equal' if same else 'DIFFER'}")
            check(same, "recording changed the final parameters")
        out[str(tuple(arch))] = dict(
            host_ms_per_step=host_ms, event_ms_per_step=event_ms,
            eager_host_ms_per_step=eager_host,
            eager_event_ms_per_step=eager_event, idle_share=g_idle,
            eager_idle_share=e_idle,
            train_acc=train_acc, val_acc=val_acc)
    # the default grid: each architecture in 8 of the 32 settings, each
    # setting 5 folds of NN_STEPS steps
    n_per_arch = len(DEFAULT_DROPOUTS) * len(DEFAULT_PENALTIES)
    grid_s = sum(5 * n_per_arch * NN_STEPS * v["host_ms_per_step"] / 1e3
                 for v in out.values())
    print(f"  extrapolated: the default grid (cli baseline nn: "
          f"{n_per_arch * len(DEFAULT_ARCHS)} settings x 5 folds x "
          f"{NN_STEPS} steps) trains for {grid_s / 60:.1f} min at these "
          f"step times  [{card}]")
    return {"archs": out, "majority": majority,
            "default_grid_train_s": grid_s}


def phase_nn_sweep(workdir: str, sup, card: str) -> dict:
    """[24]: ``NNSweep(device="cuda")`` over the default 32-setting grid,
    5 folds at NN_GRID_STEPS steps (cut from 5,000 for time), with
    ``check_test``.  Gates: no fit error, every ledger value finite, the
    JAX sweep's columns, a finite held-out battery."""
    from multimodalautoencoder_tpu_torch.baselines.neural_net import NNSweep

    t0 = time.perf_counter()
    sweep = NNSweep(sup, num_steps=NN_GRID_STEPS, check_test=True,
                    results_path=os.path.join(workdir, "nn_results"),
                    verbose=False, device=DEVICE, seed=SEED)
    best, test = sweep.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sweep.ledger.rows
    scores = np.asarray([[float(r[c]) for c in NN_LEDGER_COLUMNS[5:]]
                         for r in rows])
    print(f"  {len(rows)} settings x {sweep.num_cross_folds} folds x "
          f"{NN_GRID_STEPS} steps: {wall:.1f} s wall; fit errors "
          f"{sweep.fit_errors}; val_acc {scores[:, 0].min():.4f}-"
          f"{scores[:, 0].max():.4f}, best {best['architecture']} keep "
          f"{best['dropout_prob']} penalty {best['weight_penalty']}; "
          f"held-out {({k: round(v, 4) for k, v in test.items()})}  "
          f"[{card}]")
    check(sweep.fit_errors == 0, f"{sweep.fit_errors} NN fit errors")
    check(len(rows) == 32 and np.isfinite(scores).all(),
          "NN sweep rows not all finite")
    check(sweep.ledger.columns == NN_LEDGER_COLUMNS,
          f"NN ledger columns {sweep.ledger.columns}")
    check(test is not None and len(test) == 9
          and np.isfinite(list(test.values())).all(),
          f"held-out battery {test}")
    return {"wall_s": wall, "fit_errors": sweep.fit_errors}


def phase_feature_selection(study_path: str, card: str) -> dict:
    """[25]: ``cli feature-select <study> pca 100 --backend jax`` and
    ``skb 100 --label happiness_label`` on the card, then the PCA's SVD
    against a float64 numpy SVD of the same Train rows (explained-variance
    ratio within 1e-4, each component within 1e-3 up to its sign) and the
    SKB indices against an F-score ranking by scipy.stats.f_oneway; the
    SVD timed on the device by CUDA events."""
    from scipy import stats

    from multimodalautoencoder_tpu_torch.data import feature_selection as fs
    from multimodalautoencoder_tpu_torch.data.loader import (label_values,
                                                              read_csv)

    outs = {}
    for kind, extra in (("pca", []), ("skb", ["--label",
                                              "happiness_label"])):
        t0 = time.perf_counter()
        rc, lines = _cli_lines(["feature-select", study_path, kind,
                                str(PCA_DIMS), "--backend", "jax",
                                "--fill-missing", "0", "--device", DEVICE]
                               + extra, "wrote:")
        check(rc == 0 and len(lines) == 1, f"feature-select {kind}")
        outs[kind] = read_csv(lines[0].split()[-1])
        print(f"  cli feature-select {kind} {PCA_DIMS}: "
              f"{time.perf_counter() - t0:.2f} s wall")
    frame, X_train, X_all, _ = fs.load_raw_data(study_path)
    X_train, X_all = np.nan_to_num(X_train), np.nan_to_num(X_all)
    dims = [f"pca_dim{i}" for i in range(PCA_DIMS)]
    check(np.isfinite(outs["pca"].matrix(dims)).all()
          and len(outs["pca"]) == len(frame), "pca output")

    pca = fs.TorchPCA(PCA_DIMS, DEVICE).fit(X_train)
    xc = X_train - X_train.mean(axis=0)
    _, s, vt = np.linalg.svd(xc, full_matrices=False)
    var = s ** 2 / (len(X_train) - 1)
    evr_err = float(np.abs(pca.explained_variance_ratio_
                           - (var / var.sum())[:PCA_DIMS]).max())
    comp_err = float(max(min(np.abs(a - b).max(), np.abs(a + b).max())
                         for a, b in zip(pca.components_, vt[:PCA_DIMS])))
    xt = torch.as_tensor(xc, device=DEVICE)          # float64, as fit()
    svd_ms = cuda_ms(lambda: torch.linalg.svd(xt, full_matrices=False),
                     reps=3, inner=2)
    print(f"  PCA on the card ({X_train.shape[0]} x {X_train.shape[1]} "
          f"Train rows): explained-variance ratio {evr_err:.3e} from "
          f"float64, components {comp_err:.3e} (up to sign); "
          f"torch.linalg.svd {svd_ms:.3f} ms on the device  [{card}]")
    check(evr_err <= 1e-4 and comp_err <= 1e-3,
          f"PCA against float64: {evr_err}, {comp_err}")

    y = label_values(frame, "happiness_label")[
        frame.columns["dataset"] == "Train"]
    keep = ~np.isnan(y)
    xs, ys = X_train[keep], y[keep]
    f_ref = np.nan_to_num(stats.f_oneway(
        *[xs[ys == c] for c in np.unique(ys)], axis=0).statistic)
    want = np.sort(np.argsort(f_ref)[::-1][:PCA_DIMS])
    _, idx = fs.transform_select_K_best(xs, ys, X_all, PCA_DIMS, "jax")
    got = outs["skb"].matrix([f"skb_dim{i}" for i in range(PCA_DIMS)])
    same = np.array_equal(idx, want)
    print(f"  skb: {PCA_DIMS} indices {'equal' if same else 'DIFFER from'} "
          f"the scipy F-score ranking; written values within "
          f"{float(np.abs(got - X_all[:, want]).max()):.1e}")
    check(same, "skb indices")
    check(np.allclose(got, X_all[:, want], rtol=1e-12, atol=0),
          "skb written values")
    return {"svd_ms": svd_ms, "evr_err": evr_err, "component_err": comp_err}


def phase_data_layer(workdir: str, study_path: str, card: str) -> dict:
    """[26]: the native engine built from csrc/csv_loader.cpp at first
    use, against the default reader (the same columns and rows; each
    native value the correctly rounded value of its text, the real check
    of the parser, and within 1 ulp of pandas' reading, the values that
    differ counted);
    ``DataLoader(engine="native")``;
    ``count_gaps_in_modalities``; and ``cli baseline svm`` without
    scikit-learn, which must exit non-zero naming it."""
    import csv as csv_lib
    import importlib.util

    from multimodalautoencoder_tpu_torch.data import fast_csv
    from multimodalautoencoder_tpu_torch.data import preprocess as pp
    from multimodalautoencoder_tpu_torch.data.loader import (DataLoader,
                                                              read_csv)

    t0 = time.perf_counter()
    native = fast_csv.read_csv(study_path)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    default = read_csv(study_path)
    t_default = time.perf_counter() - t0
    feats = pp.get_wanted_feats_from_df(default.names)
    check(native.names == default.names
          and list(native.index) == list(default.index),
          "native columns or rows differ")
    for name in default.names:
        if name not in feats:
            check(list(native.columns[name]) == list(default.columns[name]),
                  f"native text column {name}")
    a, b = native.matrix(feats), default.matrix(feats)
    with open(study_path, newline="") as f:
        rows = list(csv_lib.reader(f))
    cols = [rows[0].index(n) for n in feats]
    exact = np.array([[float(r[j]) if r[j] else np.nan for j in cols]
                      for r in rows[1:]])
    check(np.array_equal(a, exact, equal_nan=True),
          "native values not correctly rounded")
    fin = ~np.isnan(a)
    ulp = np.abs(a[fin].view(np.int64) - b[fin].view(np.int64))
    print(f"  native engine: built {os.path.relpath(fast_csv.LIB.library)} "
          f"with g++ in {fast_csv.LIB.build_seconds or 0.0:.1f} s; read in "
          f"{t_native:.3f} s (default reader {t_default:.3f} s); "
          f"{len(default)} rows x {len(default.names)} columns equal; every "
          f"value correctly rounded; {int((ulp > 0).sum())} of "
          f"{int(fin.sum())} values differ from the default (pandas') "
          f"reading, by at most {int(ulp.max())} ulp")
    # the study was rewritten from pandas' values when its folds were
    # persisted, so the two readings agree within an ulp here and this
    # gate cannot catch a parser fault (the correctly-rounded gate above
    # does); on a raw CSV pandas' 17-digit cut can be 100+ ulp off
    check(int(ulp.max()) <= 1,
          f"native and default readings {int(ulp.max())} ulp apart")
    dl = DataLoader(study_path, engine="native", cross_validation=True,
                    normalize_and_fill=True, fill_gaps_with=-1.0,
                    suppress_output=True, seed=SEED)
    check(dl.train_X.shape[1] == len(feats) and np.isfinite(dl.train_X).all(),
          "DataLoader(engine='native')")
    gaps = pp.count_gaps_in_modalities(default)
    print(f"  DataLoader(engine='native'): train {dl.train_X.shape}; "
          f"count_gaps_in_modalities: {gaps}")
    check(sum(gaps.values()) == len(default), "gap histogram rows")

    hide = importlib.util.find_spec("sklearn") is not None
    code = ("import sys\n"
            + ("sys.modules['sklearn'] = None\n" if hide else "")
            + "from multimodalautoencoder_tpu_torch import cli\n"
              "sys.exit(cli.main(sys.argv[1:]))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "baseline", "svm", study_path,
         "--normalize-and-fill", "--device", DEVICE, "--results-path",
         os.path.join(workdir, "svm_results")],
        capture_output=True, text=True, timeout=300)
    msg = proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ""
    print(f"  cli baseline svm without scikit-learn"
          f"{' (hidden)' if hide else ''}: exit {proc.returncode}, "
          f"{msg!r}")
    check(proc.returncode != 0 and "scikit-learn" in proc.stderr,
          f"cli baseline svm: exit {proc.returncode}, {proc.stderr[-500:]}")
    return {"differing_values": int((ulp > 0).sum()),
            "max_ulp": int(ulp.max())}


def phase_baselines(workdir: str, card: str, csv_path: str = None) -> dict:
    """[23]-[26] on the reference-scale study (a copy of ``csv_path`` where
    given) in the supervised loader of ``synthetic.reference_scale_loaders``
    (normalized and filled, whole-modality gaps set to -1)."""
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader

    base = os.path.join(workdir, "baselines")
    os.makedirs(base)
    t0 = time.perf_counter()
    sup = DataLoader(reference_csv(base, csv_path), supervised=True,
                     cross_validation=True, suppress_output=True,
                     normalize_and_fill=True, fill_gaps_with=-1.0)
    print(f"[23] the NN baseline at full width: {NN_RUN_STEPS} steps on "
          f"fold 0 for each default architecture (study "
          f"{'copied' if csv_path else 'written'} and loaded in "
          f"{time.perf_counter() - t0:.1f} s)")
    t_phase = time.perf_counter()
    nn_run = phase_nn_baseline(sup, card)
    print(f"  [23] took {time.perf_counter() - t_phase:.1f} s")
    print(f"[24] NNSweep(device='{DEVICE}').run() over the default "
          f"32-setting grid, 5 folds x {NN_GRID_STEPS} steps, check_test")
    nn_grid = phase_nn_sweep(workdir, sup, card)
    print(f"[25] feature selection on the card: cli feature-select pca / "
          f"skb {PCA_DIMS} --backend jax --device {DEVICE}")
    feat = phase_feature_selection(sup.filename, card)
    print("[26] the data layer: engine='native', count_gaps_in_modalities, "
          "and the missing-scikit-learn error")
    data = phase_data_layer(workdir, sup.filename, card)
    out = {"nn": nn_run, "nn_grid": nn_grid, "feature_selection": feat,
           "data": data}
    print(json.dumps({"baselines": out}))
    return out


# [27]-[30]: the instance split, the sharded sweeps, the parity band
SPLIT_STEPS = 500        # [27]'s run of [9]'s tied bucket
SHARD_STEPS = 100        # each phase of [28] and [29]


def phase_split(ptk, tied, folded, spec, card: str, devices=None,
                steps: int = SPLIT_STEPS) -> dict:
    """[9]'s tied 1000 -> 100 bucket (60 instances) at ``steps`` steps
    through ``train_grid_sharded`` on one device and on ``devices``
    (default ["cuda:0", "cuda:0"]): each chunk launches kernel 2 on its
    own instances, and every instance's parameters and objective should
    equal the unsplit run's bit for bit (each instance's Philox key is its
    own seed); else they are held to [8]'s tolerance and the largest
    difference is printed."""
    from multimodalautoencoder_tpu_torch.ops import optim
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.parallel import mesh

    cfg, tcfg, hyper = tied[1], tied[2].replace(num_steps=steps), tied[3]
    per_step = ptk.launches_per_step(cfg.tie_weights, cfg.variational)
    runs, counts, walls, chunks = {}, {}, {}, {}
    dev0 = f"{DEVICE}:0"
    devices = [dev0, dev0] if devices is None else list(devices)
    for name, devs in (("one", dev0), ("split", devices)):
        seen = []
        inner = ptk.train_grid_kernel

        def counted(run, first, steps, seen=seen, inner=inner):
            seen.append(run.n_inst)
            inner(run, first, steps)

        ptk.train_grid_kernel = counted
        # the path: the count at 0 just before, read just after
        ptk.KERNELS.launches = 0
        t0 = time.perf_counter()
        try:
            runs[name] = gt.train_grid_sharded(devs, SEED, cfg, tcfg, spec,
                                               hyper, folded,
                                               backend="pallas")
            torch.cuda.synchronize()
        finally:
            ptk.train_grid_kernel = inner
        walls[name] = time.perf_counter() - t0
        counts[name], chunks[name] = ptk.KERNELS.launches, sorted(seen)
    pa, la = runs["one"]
    pb, lb = runs["split"]
    leaves = list(zip(optim.tree_leaves(pa), optim.tree_leaves(pb)))
    same = all(torch.equal(a, b) for a, b in leaves) and torch.equal(la, lb)
    worst = max(max(float((a - b).abs().max()) for a, b in leaves),
                float((la - lb).abs().max() / lb.abs().max()))
    N, D = la.numel(), len(devices)
    print(f"  tied bucket N={N}, {steps} steps: one device "
          f"{walls['one']:.2f} s wall, {counts['one']} launches; split over "
          f"{[str(d) for d in devices]} {walls['split']:.2f} s wall, chunks "
          f"of {chunks['split']} instances, {counts['split']} launches "
          f"({counts['split'] // max(len(chunks['split']), 1)} a chunk)  "
          f"[{card}]")
    print(f"  every instance's parameters and objective bit-equal: {same}"
          f" (largest difference {worst:.3e})")
    check(chunks["one"] == [N] and chunks["split"] == sorted(
        hi - lo for lo, hi in mesh.chunk_bounds(N, D)),
          f"chunks {chunks}")
    check(counts["one"] == steps * per_step
          and counts["split"] == D * steps * per_step,
          f"launches {counts}, {steps * per_step} a run expected")
    check(same or worst <= TOL, f"the split run differs by {worst:.3e}")
    return {"split_launches": counts["split"], "split_bit_equal": same,
            "split_max_abs_err": worst, "one_wall_s": walls["one"],
            "split_wall_s": walls["split"]}


def worker_lines(out: str) -> list:
    """The JSON lines of a sharded sweep's workers (those with "host")."""
    rows = []
    for line in out.splitlines():
        if line.startswith("{") and '"host"' in line:
            rows.append(json.loads(line))
    return sorted(rows, key=lambda r: r["host"])


def _setting_key(row, grid_cols) -> tuple:
    return tuple(str(row[c]) for c in grid_cols)


def phase_distributed_mmae(workdir: str, dk, ptk, study_path: str,
                           card: str) -> dict:
    """``tools/multihost_sweep.py --hosts 2 --distributed`` over the
    default 108-setting ACII grid at SHARD_STEPS steps, both ranks on
    cuda:0 in one gloo job, reading the study with the native engine;
    then ``cli merge-shards --best-checkpoint best_mmae`` and the winner
    served through kernel 1 by ``cli fill``."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.sweep import engine, grid
    from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt

    out = os.path.join(workdir, "multihost")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m",
         "multimodalautoencoder_tpu_torch.tools.multihost_sweep",
         "--hosts", "2", "--distributed", "--steps", str(SHARD_STEPS),
         "--engine", "native", "--grid", "full", "--folds", "5", "--data",
         study_path, "--device", DEVICE, "--out", out, "--seed", str(SEED),
         "--timeout", "600"], capture_output=True, text=True, env=env,
        timeout=660)
    wall = time.perf_counter() - t0
    sys.stdout.write("".join(f"  | {line}\n"
                             for line in r.stdout.splitlines()))
    if r.returncode:
        sys.stdout.write(r.stderr[-4000:])
    check(r.returncode == 0 and "merged 2 shards" in r.stdout,
          f"the distributed sweep returned {r.returncode}")
    workers = worker_lines(r.stdout)
    settings = grid.add_extra_vae_params(grid.enumerate_grid(ACII_PARAMS))
    grid_cols = list(settings[0])
    ledger = engine.ResultsLedger(out, "MMAE-acii", cont=True)
    keys = [_setting_key(row, grid_cols) for row in ledger.rows]
    in_job = open(ledger.path).read()
    rc, lines = _cli_lines(["merge-shards", out, "MMAE-acii", "--num-shards",
                            "2", "--best-checkpoint", "best_mmae"],
                           "global best checkpoint:")
    check(rc == 0 and len(lines) == 1, f"cli merge-shards returned {rc}")
    win = lines[0].split(": ", 1)[1] if lines else ""
    again = open(ledger.path).read()
    losses = np.asarray([engine.as_float(row["val_sigmoid_cross_entropy"])
                         for row in ledger.rows])
    best = ledger.rows[int(np.nanargmin(losses))] if np.isfinite(
        losses).any() else {}
    extra = ckpt.checkpoint_meta(win)["extra"] if win else {}
    for w in workers:
        print(f"  shard {w['host']}: {w['settings_trained']} settings in "
              f"{w['wall_s']:.1f} s, kernel 2 launches "
              f"{w['launches']['train']}  [{card}]")
    print(f"  the pair: {wall:.1f} s wall from launch to merged ledger "
          f"(beside [17]'s single-process sweep of the same grid above); "
          f"{len(ledger)} rows, {len(set(keys))} distinct settings, "
          f"{int(np.isfinite(losses).sum())} finite objectives; cli "
          f"merge-shards rewrote the same ledger: "
          f"{in_job == again}; global winner {os.path.basename(win)} "
          f"(score {extra.get('score', float('nan')):.4f}, merged best "
          f"{engine.as_float(best.get('val_sigmoid_cross_entropy')):.4f})")
    check(len(workers) == 2 and all(w["launches"]["train"] > 0
                                    for w in workers),
          f"workers {workers}: kernel 2 did not run in both")
    check(len(ledger) == 108 and sorted(keys) == sorted(
        _setting_key(s_, grid_cols) for s_ in settings),
          "the merged ledger does not hold the 108 settings once each")
    check(in_job == again, "cli merge-shards gave other rows than the "
          "in-job merge")
    check(bool(best) and abs(float(extra.get("score", np.nan))
                             - engine.as_float(
                                 best["val_sigmoid_cross_entropy"])) < 1e-6
          and {k: str(v) for k, v in extra.get("setting", {}).items()}
          == {c: str(best[c]) for c in extra.get("setting", {})},
          "the global winner is not the merged ledger's best finite row")

    params, cfg, _, _ = ckpt.load_checkpoint_auto(
        win, MMAEConfig(num_feats=1000), verbose=False, device="cpu")
    served = ckpt.save_checkpoint(os.path.join(workdir, "ck_sharded"),
                                  "winner", params,
                                  cfg.replace(use_pallas=True),
                                  step=SHARD_STEPS)
    before = dk.KERNELS.launches
    rc = cli.main(["fill", study_path, "--checkpoint", served,
                   "--normalize-and-fill", "--device", DEVICE, "--seed",
                   str(SEED), "--engine", "native"])
    torch.cuda.synchronize()
    served_launches = dk.KERNELS.launches - before
    check(rc == 0 and served_launches > 0,
          f"cli fill of the global winner returned {rc} with "
          f"{served_launches} fused_dense launches")
    check_served("fill", "global winner", study_path,
                 DataLoader(study_path, supervised=False, fill_gaps_with=-1.0,
                            suppress_output=True, seed=SEED))
    print(f"  the winner ({cfg.layer_sizes}, tied {cfg.tie_weights}, "
          f"variational {cfg.variational}) served by cli fill --device "
          f"{DEVICE}: {served_launches} fused_dense launches")
    return {"wall_s": wall, "shard_wall_s": [w["wall_s"] for w in workers],
            "launches": [w["launches"]["train"] for w in workers],
            "serve_launches": served_launches}


@contextlib.contextmanager
def sharded_classification(workdir: str, study_path: str):
    """[29]'s two processes: ``cli sweep-classification --process-shard i
    2 --device cuda`` for i = 0, 1 over the 576-setting default grid at
    SHARD_STEPS + SHARD_STEPS steps, each through ``chip_smoke.py
    --count-launches`` (which prints its kernels' launch counts), started
    on entry; yields (processes, results directory, start time) and kills
    whichever still runs on exit.  The full run starts them before [28]
    and checks them after it, so the two sharded sweeps share the card."""
    results = os.path.join(workdir, "cls_shards")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--count-launches",
         "sweep-classification", study_path, study_path, "--num-steps",
         str(SHARD_STEPS), "--device", DEVICE, "--normalize-and-fill",
         "--seed", str(SEED), "--results-path", results,
         "--save-best-params", "--process-shard", str(i), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        yield procs, results, t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_sharded_classification(started, card: str) -> dict:
    """[29]: waits for ``sharded_classification``'s processes
    (``started``), then ``cli merge-shards --best-checkpoint
    best_mmae_cls`` over their 576 settings."""
    from multimodalautoencoder_tpu_torch.sweep import engine
    from multimodalautoencoder_tpu_torch.sweep.wrappers import \
        MMAEClassificationSweep as Sweep

    procs, results, t0 = started
    outs = [p.communicate(timeout=600) for p in procs]
    wall = time.perf_counter() - t0
    counts = []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            sys.stdout.write(err[-4000:])
        check(p.returncode == 0, f"shard {i} returned {p.returncode}")
        line = [x for x in out.splitlines() if x.startswith("LAUNCHES ")]
        counts.append(json.loads(line[-1][len("LAUNCHES "):]) if line
                      else {})
    rc, lines = _cli_lines(["merge-shards", results,
                            "MMAE_NN_classifier-acii", "--num-shards", "2",
                            "--best-checkpoint", "best_mmae_cls"],
                           "global best checkpoint:")
    check(rc == 0 and len(lines) == 1, f"cli merge-shards returned {rc}")
    ledger = engine.ResultsLedger(results, "MMAE_NN_classifier-acii",
                                  cont=True)
    settings = Sweep.default_grid()[0]
    grid_cols = list(settings[0])
    keys = [_setting_key(row, grid_cols) for row in ledger.rows]
    metrics = [c for c in ledger.columns
               if c.startswith(("val_", "noisy_val", "clean_val"))]
    vals = np.asarray([[engine.as_float(row.get(c)) for c in metrics]
                       for row in ledger.rows])
    finite_rows = int(np.isfinite(vals).all(axis=1).sum())
    used = sorted({row["backend_used"] for row in ledger.rows})
    for i, c in enumerate(counts):
        print(f"  shard {i}: kernel 2 launches {c.get('train')}, kernel 4 "
              f"launches {c.get('cls')}")
    print(f"  two processes on cuda:0 (beside [28]'s): {wall:.1f} s wall; "
          f"merged {len(ledger)} rows, {len(set(keys))} distinct settings, "
          f"{finite_rows} with "
          f"every metric finite ({len(metrics)} metric columns), "
          f"backend_used {used}; {lines[0] if lines else ''}  [{card}]")
    check(len(ledger) == 576 and sorted(keys) == sorted(
        _setting_key(s_, grid_cols) for s_ in settings),
          "the merged ledger does not hold the 576 settings once each")
    check(finite_rows == 576, f"{576 - finite_rows} rows with a non-finite "
          "metric")
    check(used == ["pallas"], f"backends {used}")
    check(len(counts) == 2 and all(c.get("cls", 0) > 0 for c in counts),
          f"kernel 4 did not launch in both processes: {counts}")
    return {"wall_s": wall, "launches": [c.get("cls") for c in counts]}


def phase_parity_band(ptk, rates, card: str) -> dict:
    """``utils.parity.reference_recipe_observables(backend="pallas",
    device="cuda", num_runs=3)``: the reference recipe's three runs on
    kernel 2 land inside tests/fixtures/parity_band.json; then
    ``utils.flops.utilization_row`` for [9]'s three buckets from their
    measured instance-steps/s."""
    from multimodalautoencoder_tpu_torch.utils import flops, parity

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "parity_band.json")) as f:
        band = json.load(f)
    steps = band["recipe"]["num_steps"]
    ptk.KERNELS.launches = 0
    obs = parity.reference_recipe_observables(
        backend="pallas", num_runs=3, num_steps=steps, device=DEVICE)
    torch.cuda.synchronize()
    launches = ptk.KERNELS.launches
    problems = parity.check_band(obs, band)
    print(f"  noisy-val loss {np.round(obs['noisy_val_loss'], 4).tolist()} "
          f"in [{band['noisy_val_loss'][0]:.4f}, "
          f"{band['noisy_val_loss'][1]:.4f}]; per-modality RMSE "
          f"{np.round(obs['per_modality_rmse'], 4).tolist()}; kernel 2 "
          f"launches {launches}; {len(problems)} outside the band")
    for p_ in problems:
        print(f"    {p_}")
    check(launches == steps * ptk.launches_per_step(True, False),
          f"{launches} kernel 2 launches")
    check(not problems, "the kernel's recipe runs left the parity band")
    rows = []
    for name, cfg, tcfg, rate in rates:
        row = flops.utilization_row(f"[9] {name}", cfg, tcfg, rate)
        rows.append(row)
        print(f"  utilization {row['name']}: {rate:,.0f} instance-steps/s, "
              f"{row['useful_gflops_per_s']:,.0f} useful GFLOP/s "
              f"({row['pct_f32_peak']:.1f} % of the f32 peak), "
              f"{row['hbm_gb_per_s']:,.0f} GB/s ({row['pct_hbm_peak']:.1f} %"
              f" of the memory rate)  [{card}]")
    return {"launches": launches, "utilization": rows}


# [31]: the end-to-end demo at the sizes below; its widths stay the demo's
# (30 features, (24, 8) and (16, 8)), which [6], [12], [17], [21] and [23]
# drive at the reference's widths
PIPELINE_ARGS = ("--rows", "2000", "--steps", "2000", "--folds", "5",
                 "--baseline", "nn")


def phase_pipeline(workdir: str, ptk, pck, card: str) -> dict:
    """[31]: ``examples/acii_pipeline.py`` on the card with PIPELINE_ARGS,
    as ``python -m multimodalautoencoder_tpu_torch.examples.acii_pipeline``
    runs it: every printed metric finite, both sweeps' rows on the kernels
    (``backend_used == "pallas"``), kernels 2 and 4 launched (counted from
    0 before the run), the repaired file's observed cells the input's.
    Returns the launches and each step's wall seconds."""
    import io

    from multimodalautoencoder_tpu_torch.data.loader import read_csv
    from multimodalautoencoder_tpu_torch.data.preprocess import \
        get_wanted_feats_from_df
    from multimodalautoencoder_tpu_torch.examples import acii_pipeline
    from multimodalautoencoder_tpu_torch.sweep import engine

    out_dir = os.path.join(workdir, "pipeline")
    buf = io.StringIO()
    ptk.KERNELS.launches = 0
    pck.KERNELS.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = acii_pipeline.main(list(PIPELINE_ARGS)
                                 + ["--device", DEVICE, "--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mmae_train_step": ptk.KERNELS.launches,
                "cls_train_step": pck.KERNELS.launches}
    text = buf.getvalue()
    sys.stdout.write("".join(f"  | {line}\n" for line in text.splitlines()))
    numbers = acii_pipeline.printed_numbers(text)
    print(f"  {len(numbers)} printed metrics, "
          f"{sum(np.isfinite(numbers))} finite; kernel launches {launches}")
    check(len(numbers) == 11 and bool(np.isfinite(numbers).all()),
          f"the pipeline printed non-finite metrics: {numbers}")
    for name in ("mmae_ledger", "cls_ledger"):
        ledger = engine.ResultsLedger(
            os.path.dirname(out[name]),
            os.path.basename(out[name])[:-len(".csv")], cont=True)
        used = ledger.column("backend_used")
        print(f"  {os.path.basename(out[name])}: {len(ledger)} rows, "
              f"backend_used {sorted(set(used))}")
        check(len(used) > 0 and set(used) == {"pallas"},
              f"{name}: rows off the kernels: {used}")
    check(out["settings"] == 12, f"{out['settings']} MMAE settings, not 12")
    for kernel, n in launches.items():
        check(n > 0, f"[31] launched {kernel} {n} times")
    before, after = read_csv(out["csv"]), read_csv(out["filled"])
    feats = get_wanted_feats_from_df(before.names)
    x, y = before.matrix(feats), after.matrix(feats)
    seen = ~np.isnan(x)
    same = (x.shape == y.shape and after.names == before.names
            and bool(np.isclose(y[seen], x[seen], rtol=0, atol=1e-12).all()))
    print(f"  repaired file {os.path.basename(out['filled'])}: "
          f"{y.shape[0]} rows x {y.shape[1]} features, {int(seen.sum())} "
          f"observed cells unchanged: {same}; {int(np.isnan(x).sum())} "
          f"empty before, {int(np.isnan(y).sum())} after")
    check(same, "the repaired file changed observed cells")
    print("  step seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()))
    print(f"  [31] {wall:.1f} s wall  [{card}]")
    return {"launches": launches, "wall_s": wall,
            "seconds": out["seconds"]}


WHEEL_PROBE = r"""
import json, os, sys, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch
import multimodalautoencoder_tpu_torch as port
from multimodalautoencoder_tpu_torch import cli
from multimodalautoencoder_tpu_torch.data import fast_csv
from multimodalautoencoder_tpu_torch.data.preprocess import \
    get_wanted_feats_from_df
from multimodalautoencoder_tpu_torch.ops import cuda_library
from multimodalautoencoder_tpu_torch.ops import dense_kernels as dk

study, ck, values = sys.argv[1:4]
t0 = time.perf_counter()
with ThreadPoolExecutor(2) as pool:     # g++ and nvcc together
    list(pool.map(lambda lib: lib.load(), (fast_csv.LIB, dk.KERNELS)))
built = time.perf_counter() - t0
frame = fast_csv.read_csv(study)
np.save(values, frame.matrix(get_wanted_feats_from_df(frame.names)))
dk.KERNELS.launches = 0
t0 = time.perf_counter()
rc = cli.main(["fill", study, "--checkpoint", ck, "--normalize-and-fill",
               "--device", "cuda", "--engine", "native", "--seed", "0"])
torch.cuda.synchronize()
print("WHEEL " + json.dumps({
    "rc": rc, "package": port.__file__, "build_dir": cuda_library.build_dir(),
    "libraries": [fast_csv.LIB.library, dk.KERNELS.library],
    "build_s": built, "fill_s": time.perf_counter() - t0,
    "fused_dense_launches": dk.KERNELS.launches,
    "modules": sorted(m for m in ("jax", "pandas", "sklearn",
                                  "multimodalautoencoder_tpu")
                      if m in sys.modules)}), flush=True)
"""


def serve_study(workdir: str):
    """The reference-scale study, its loader, and a tied softsign 1000 ->
    100 DAE checkpoint with ``use_pallas`` (random weights from SEED)."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.models import mmae
    from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt

    csv_path = synthetic.write_reference_scale_csv(workdir, num_rows=ROWS,
                                                   seed=SEED)
    dl = DataLoader(csv_path, supervised=False, fill_gaps_with=-1.0,
                    suppress_output=True, seed=SEED)
    cfg = MMAEConfig(num_feats=dl.num_feats, layer_sizes=LAYERS,
                     tie_weights=True, activation="softsign",
                     use_pallas=True)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    ck = ckpt.save_checkpoint(os.path.join(workdir, "ck"), "dae",
                              mmae.init(cfg, generator=g, device=DEVICE),
                              cfg, step=1)
    return csv_path, ck, dl


def install_wheel(workdir: str, csv_path: str, ck_path: str) -> dict:
    """[32]'s run: a wheel built from this checkout, installed with ``pip
    --target`` into a directory made read-only, and WHEEL_PROBE in a fresh
    interpreter whose imports resolve there (``PYTHONPATH`` the install
    alone, run from another directory) on ``csv_path`` and ``ck_path``.
    It prints nothing, so the full run starts it in a thread of its own
    after [6] and checks it at [32]."""
    from multimodalautoencoder_tpu_torch.tools import wheel_check

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(workdir, "wheel")
    run_dir = os.path.join(root, "run")
    os.makedirs(run_dir)
    values = os.path.join(root, "native.npy")
    t0 = time.perf_counter()
    with wheel_check.read_only_install(repo, root) as (site, env):
        packaged = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", WHEEL_PROBE, csv_path,
                            ck_path, values], capture_output=True,
                           text=True, env=env, cwd=run_dir, timeout=600)
    return {"root": root, "site": site, "values": values,
            "packaged": packaged, "wall": time.perf_counter() - t0, "r": r}


def phase_installed_wheel(csv_path: str, dl, card: str, run: dict) -> dict:
    """[32]: ``install_wheel``'s run (``run``) checked: the fresh
    interpreter read the study with the native engine, values equal to
    this checkout's reading, and ran ``cli fill --engine native`` on the
    card: 4 ``fused_dense`` launches (one forward), the libraries built
    outside the install."""
    from multimodalautoencoder_tpu_torch.data import fast_csv
    from multimodalautoencoder_tpu_torch.data.preprocess import \
        get_wanted_feats_from_df

    root, site, values, r = run["root"], run["site"], run["values"], run["r"]
    packaged, wall = run["packaged"], run["wall"]
    lines = [line for line in r.stdout.splitlines()
             if line.startswith("WHEEL ")]
    if r.returncode or not lines:
        sys.stdout.write(r.stdout[-4000:] + r.stderr[-4000:])
    check(r.returncode == 0 and len(lines) == 1,
          f"the installed wheel's run returned {r.returncode}")
    got = json.loads(lines[0][len("WHEEL "):])
    install = os.path.realpath(site) + os.sep
    outside = all(not os.path.realpath(p).startswith(install)
                  for p in [got["build_dir"]] + got["libraries"])
    frame = fast_csv.read_csv(csv_path)
    mine = frame.matrix(get_wanted_feats_from_df(frame.names))
    theirs = np.load(values)
    equal = mine.shape == theirs.shape and np.array_equal(
        mine.view(np.int64), theirs.view(np.int64))
    print(f"  wheel built and installed in {packaged:.1f} s; the fresh "
          f"interpreter imported {os.path.relpath(got['package'], root)}, "
          f"built {', '.join(os.path.basename(p) for p in got['libraries'])}"
          f" in {got['build_s']:.1f} s into {got['build_dir']} (outside "
          f"the install: {outside})")
    print(f"  --engine native from the install: {theirs.shape} values bit "
          f"for bit this checkout's reading: {equal}; cli fill --engine "
          f"native {got['fill_s']:.2f} s, fused_dense launches "
          f"{got['fused_dense_launches']} (4 a forward); imported "
          f"{got['modules'] or 'none'} of jax / pandas / sklearn / the JAX "
          f"package  [{card}]")
    check(got["rc"] == 0, f"cli fill from the wheel returned {got['rc']}")
    check(got["package"].startswith(install),
          f"the port was imported from {got['package']}, not the install")
    check(outside, f"a library was built inside the install: {got}")
    check(equal, "the installed native engine read other values")
    check(got["fused_dense_launches"] == 2 * len(LAYERS),
          f"{got['fused_dense_launches']} fused_dense launches, expected "
          f"{2 * len(LAYERS)}")
    check(not got["modules"], f"the installed port imported {got['modules']}")
    check_served("fill", "wheel", csv_path, dl)
    print(f"  [32] {wall + packaged:.1f} s wall  [{card}]")
    return {"fused_dense_launches": got["fused_dense_launches"],
            "wall_s": wall + packaged, "build_dir": got["build_dir"]}


def main_pipeline() -> int:
    """[31] and [32] alone, after [8]'s and [11]'s F = 30 cases (the
    demo's widths among them), every gate reported rather than only the
    first that fails; the last line lists the failed checks, and the exit
    code is 1 if there are any."""
    global FAILED
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk

    FAILED = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}")
    build_kernels([ptk.KERNELS, pck.KERNELS])
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir:
        for label, title, fn in (
                ("[8]", "kernel 2 vs its twin at F = 30",
                 lambda: phase_kernel_vs_twin(ptk, [], None, None)),
                ("[11]", "kernel 4 vs its twin at F = 30",
                 lambda: phase_cls_kernel_vs_twin(pck, ptk, None, None,
                                                  None, None)),
                ("[31]", "the end-to-end demo",
                 lambda: phase_pipeline(workdir, ptk, pck, card)),
                ("[32]", "the installed wheel",
                 lambda: installed_wheel_alone(workdir, card))):
            print(f"{label} {title}")
            try:
                fn()
            except Exception as exc:   # reported with the checks
                check(False, f"{label}: {type(exc).__name__}: {exc}")
    print(card)
    print(json.dumps({"pipeline": True, "failed_checks": FAILED}))
    return 1 if FAILED else 0


def installed_wheel_alone(workdir: str, card: str) -> dict:
    """[32] on a study and checkpoint of its own, in this thread."""
    csv_path, ck_path, dl = serve_study(workdir)
    return phase_installed_wheel(csv_path, dl, card,
                                 install_wheel(workdir, csv_path, ck_path))


def main_split_cards() -> int:
    """[27] over every visible card (``mesh.local_devices()``): [9]'s tied
    bucket at STEPS steps on cuda:0 alone and split over the cards, each
    instance held bit for bit, wall times beside each other."""
    from multimodalautoencoder_tpu_torch.config import TrainConfig
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.parallel import mesh

    global FAILED
    FAILED = []
    devices = mesh.local_devices()
    print(f"[27] over {len(devices)} cards: "
          + "; ".join(torch.cuda.get_device_name(d) for d in devices))
    build_kernels([ptk.KERNELS])
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir:
        _, folded, _, buckets, spec = training_study(workdir)
        _, cfg, members = next(b for b in buckets if b[0] == "tied")
        tcfg = TrainConfig(learning_rate=LR, batch_size=BATCH,
                           num_steps=STEPS, decay=True, decay_steps=1000,
                           decay_rate=0.95, clip_gradients=False, seed=SEED,
                           optimizer_state_dtype="bfloat16")
        hyper = gt.HyperStack.from_settings(members, cfg, tcfg)
        phase_split(ptk, ("tied", cfg, tcfg, hyper), folded, spec, card,
                    devices, STEPS)
    print(f"failed: {FAILED}")
    return 1 if FAILED else 0


def main_count_launches(argv) -> int:
    """``cli.main(argv)`` in this process, then one line ``LAUNCHES
    {"train": n, "deep": n, "cls": n, "dense": n}`` with the training
    kernels' and fused_dense's launch counts: how [29] reads the kernels'
    launches in processes of their own."""
    from multimodalautoencoder_tpu_torch import cli
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck
    from multimodalautoencoder_tpu_torch.ops import dense_kernels as dk
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk

    rc = cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    print("LAUNCHES " + json.dumps({
        "train": ptk.KERNELS.launches, "deep": pdk.KERNELS.launches,
        "cls": pck.KERNELS.launches, "dense": dk.KERNELS.launches}),
        flush=True)
    return rc


def _cli_lines(argv, prefix: str):
    """Run ``cli.main(argv)``, echo its standard output, and return the
    lines that start with ``prefix``."""
    import io

    from multimodalautoencoder_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    sys.stdout.write(buf.getvalue())
    return rc, [line for line in buf.getvalue().splitlines()
                if line.startswith(prefix)]


def training_study(workdir: str, csv_path: str = None):
    """The reference-scale study for training (a copy of ``csv_path``, the
    same file, where given), its CV folds on the card, the ACII grid's
    base config and 1000-wide buckets, and the noise spec."""
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer

    train_dir = os.path.join(workdir, "train")
    os.makedirs(train_dir)
    t0 = time.perf_counter()
    study = DataLoader(reference_csv(train_dir, csv_path), supervised=False,
        cross_validation=True, fill_gaps_with=-1.0, suppress_output=True,
        seed=SEED)
    print(f"  study for training: {ROWS} rows, {study.num_feats} "
          f"features, {study.num_folds} CV folds "
          f"({time.perf_counter() - t0:.1f} s to "
          f"{'copy' if csv_path else 'write'} and load)")
    folded = grid_trainer.FoldedData.from_loader(study, study.num_folds,
                                                 device=DEVICE)
    base, buckets = sweep_buckets(study)
    spec = NoiseSpec.build(base, study.modality_table)
    print(f"  108 settings in 9 buckets of 12; folds: train rows "
          f"{folded.train_n.tolist()}, val rows "
          f"{folded.val_n.tolist()}")
    return study, folded, base, buckets, spec


def reference_csv(directory: str, csv_path: str = None) -> str:
    """The reference-scale study as ``<directory>/acii.csv``: a copy of
    ``csv_path`` (written by ``synthetic.write_reference_scale_csv`` with
    the same rows and seed) where given, else written anew."""
    from multimodalautoencoder_tpu_torch.data import synthetic

    if csv_path is None:
        return synthetic.write_reference_scale_csv(directory, num_rows=ROWS,
                                                   seed=SEED)
    return shutil.copy(csv_path, os.path.join(directory, "acii.csv"))


def supervised_study(study):
    """The same study with its labels, its supervised folds on the card,
    and the validation bucket's config and settings."""
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer

    sup = DataLoader(study.filename, supervised=True,
                     cross_validation=True, fill_gaps_with=-1.0,
                     suppress_output=True, seed=SEED)
    sup_folded = grid_trainer.FoldedData.from_loader(
        sup, sup.num_folds, device=DEVICE, supervised=True,
        noisy_flags=True)
    cfg_v, settings_v = validation_settings(sup)
    return sup, sup_folded, cfg_v, settings_v


def main_single_run() -> int:
    """[20] and [21] alone, [21] with its bf16 control route, every gate
    reported rather than only the first that fails; the last line lists
    the failed checks, and the exit code is 1 if there are any."""
    global FAILED
    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.ops import dense_kernels as dk

    FAILED = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}")
    build_kernels([dk.KERNELS])
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir:
        study = synthetic.write_reference_scale_csv(workdir, num_rows=ROWS,
                                                    seed=SEED)
        print(f"[20] fused_dense under autograd at the training shapes (TF32"
              f" off, atol=rtol={TOL})")
        phase_dense_autograd(dk, card)
        print(f"[21] the single-run trainer at full width, {SINGLE_STEPS} "
              f"steps a route, with the bf16 control route")
        phase_single_run(dk, study, card, control=True)
    print(card)
    print(json.dumps({"single_run": True, "failed_checks": FAILED}))
    return 1 if FAILED else 0


def main_baselines() -> int:
    """[23]-[26] alone, every gate reported rather than only the first
    that fails; the last line lists the failed checks, and the exit code
    is 1 if there are any."""
    global FAILED

    FAILED = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir:
        try:
            phase_baselines(workdir, card)
        except Exception as exc:   # reported with the checks
            check(False, f"{type(exc).__name__}: {exc}")
    for mod in ("jax", "pandas", "sklearn", "multimodalautoencoder_tpu"):
        check(mod not in sys.modules, f"the baseline path imported {mod}")
    print(f"  [23]-[26] in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"baselines": True, "failed_checks": FAILED}))
    return 1 if FAILED else 0


# --deep-ab: kernel 3 of this checkout against another tree's (PR 11's),
# each in a process of its own, from the same state and seeds
AB_STEPS = 10
AB_TIMED_STEPS = 50


def update_reading(profiler: list, types: dict, bounds: dict) -> dict:
    """The grouped update's device ms a step (its launch in ``profiler``,
    torch.profiler's (name, ms) a launch; else the launch type's CUDA-event
    ms in ``types``) and its own bound: the weight- and bias-update rows
    of the launch-type bounds ``bounds`` together."""
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk

    seen = [ms for name, ms in profiler if "update_group" in name]
    w, b = bounds["weight_grad_adam"], bounds["bias_grad_adam"]
    return {"update_ms": seen[-1] if seen else types["weight_grad_adam"],
            "update_bound_ms": ptk._bound(w["bytes"] + b["bytes"],
                                          w["flop"] + b["flop"])["bound_ms"]}


def print_update_share(runs: list, card: str) -> None:
    """Each tree's grouped-update launch (its launch type's CUDA-event ms a
    step, which both trees report, the mean of its two runs in the turns
    of :data:`AB_RUNS`) against its own bound (from the runs that carry
    it)."""
    bound = next((r["update_bound_ms"] for r in runs
                  if "update_bound_ms" in r), None)
    if bound is None:
        return
    for tree, (a, b) in (("parent", (runs[0], runs[3])),
                         ("change", (runs[1], runs[2]))):
        ms_a = a["types"]["weight_grad_adam"]
        ms_b = b["types"]["weight_grad_adam"]
        ms = (ms_a + ms_b) / 2
        print(f"    {tree} update_group_kernel: {ms:.4f} ms a step "
              f"(runs {ms_a:.4f} / {ms_b:.4f}), {100 * bound / ms:.1f} % of "
              f"its {bound:.4f} ms bound  [{card}]")


def ab_cases(pdk, base_full, folded_full, spec_full):
    """(label, cfg, settings, folded, spec, moments, lr, Adam eps): [15]'s
    F = 30 families at depths 3 and 4 with f32 and bf16 moments, [16]'s
    three full-width buckets with the sweep's bf16 moments, and the WIDE
    cases of tests/test_torch_deep_kernel.py::
    test_cuda_deep_kernels_match_twin (F = 330, (257, 130, 6), N = 60,
    lr 1e-2, eps 0.1)."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.data.modalities import \
        ModalityTable
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    rng = np.random.default_rng(SEED)
    small = gt.FoldedData.from_ragged(
        [rng.random((40, 30)), rng.random((33, 30))],
        [rng.random((9, 30)), rng.random((7, 30))], device=DEVICE)
    two = [{"dropout_prob": 0.5, "weight_penalty": 0.01,
            "activation_function": "relu"},
           {"dropout_prob": 1.0, "weight_penalty": 0.001,
            "activation_function": "softsign"}]
    cases = []
    for layers in ((16, 10, 6), (20, 14, 10, 6)):
        base = MMAEConfig(num_feats=30, layer_sizes=layers,
                          weight_initialization="normal")
        for family in ("tied softsign", "untied relu", "vae"):
            cfg = family_cfg(base, family)
            spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
            for moments in ("float32", "bfloat16"):
                cases.append((f"F=30 {layers} {family} {moments}", cfg, two,
                              small, spec, moments, LINEAR_LR, 1e-8))
    for name, cfg, members in deep_buckets(base_full):
        cases.append((f"{name} {DEEP_LAYERS} N=60 bfloat16", cfg, members,
                      folded_full, spec_full, "bfloat16", LR, 1e-8))
    rng = np.random.default_rng(1)
    wide = gt.FoldedData.from_ragged(
        [rng.random((40, 330)), rng.random((33, 330))],
        [rng.random((9, 330)), rng.random((7, 330))], device=DEVICE)
    pair = [{"dropout_prob": 0.5, "weight_penalty": 0.01},
            {"dropout_prob": 1.0, "weight_penalty": 0.0,
             "activation_function": "softsign"}]
    thirty = [dict(pair[i % 2], weight_penalty=0.01 * (i % 3) / 2)
              if i >= 2 else pair[i] for i in range(30)]
    for family in ("tied", "vae"):
        cfg = MMAEConfig(num_feats=330, layer_sizes=(257, 130, 6),
                         tie_weights=family == "tied",
                         variational=family == "vae",
                         activation="softsign" if family == "tied"
                         else "relu").validate()
        spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 66, NAMES))
        cases.append((f"WIDE {family} F=330 N=60 float32", cfg, thirty,
                      wide, spec, "float32", LINEAR_LR, LINEAR_EPS))
    return cases


def profiler_launches(fn) -> list:
    """(kernel name, device ms) of every kernel ``fn`` launches, in order
    (copies left out), by torch.profiler; [] where the profiler sees no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset"))),
                    key=lambda e: e.time_range.start)
    return [(e.name.replace("(anonymous namespace)::", "").split("(")[0]
             .split("<")[0].split("::")[-1],
             e.time_range.elapsed_us() / 1e3) for e in events]


def main_deep_state(out_dir: str, dump: bool) -> int:
    """Worker of --deep-ab, on the package under MMAE_PACKAGE_ROOT: with
    ``dump``, kernel 3 runs AB_STEPS steps of each of :func:`ab_cases`
    from the seed's state and saves parameters and moments; always, the
    tied full-width bucket's step is timed (ms/step over windows of
    AB_TIMED_STEPS, by launch type, and launch by launch by torch.profiler).
    The last line is ``DEEP-STATE`` and a JSON object."""
    import multimodalautoencoder_tpu_torch as pkg
    from multimodalautoencoder_tpu_torch.config import TrainConfig
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    pdk.KERNELS.load()
    print(f"  package {os.path.dirname(pkg.__file__)}; kernel 3 built in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {"cases": []}
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir:
        _, folded, base, _, spec = training_study(workdir)
        cases = ab_cases(pdk, base, folded, spec)

        def start(cfg, settings, fold, sp, moments, lr, eps):
            tcfg = TrainConfig(learning_rate=lr, batch_size=BATCH,
                               decay=True, decay_steps=1000,
                               decay_rate=0.95, clip_gradients=False,
                               optimizer_state_dtype=moments)
            hyper = gt.HyperStack.from_settings(settings, cfg, tcfg)
            C, K = hyper.num_configs, fold.num_folds
            g = torch.Generator().manual_seed(SEED)
            return pdk.prepare_deep_run(g, cfg, tcfg, sp, hyper, fold,
                                        ptk.init_grid_params(g, cfg, C, K),
                                        adam_eps=eps)

        for i, case in enumerate(cases if dump else []):
            label = case[0]
            run = start(*case[1:])
            twin = run.clone()
            before = pdk.KERNELS.launches
            pdk.train_deep_kernel(run, 0, AB_STEPS)
            torch.cuda.synchronize()
            torch.save({k: [t.cpu() for t in getattr(run, k)]
                        for k in ("params", "m", "v")},
                       os.path.join(out_dir, f"case{i}.pt"))
            launches = pdk.KERNELS.launches - before
            # one step from the seed's state against the f32 twin
            del run
            kern = twin.clone()
            pdk.train_deep_kernel(kern, 0, 1)
            pdk.train_deep_kernel_reference(twin, 0, 1)
            torch.cuda.synchronize()
            gaps = [(float((a - b).abs().max()),
                     int(((a - b).abs() > TOL_CLS).sum()))
                    for a, b in zip(kern.params, twin.params)]
            out["cases"].append({"label": label, "launches": launches,
                                 "step0_vs_twin": gaps})
            del kern, twin
        label, cfg, settings, fold, sp, moments, lr, eps = next(
            c for c in cases if c[0].startswith("tied ("))
        run = start(cfg, settings, fold, sp, moments, lr, eps)
        pdk.train_deep_kernel(run, 0, 20)
        out["ms"] = [cuda_ms(lambda: pdk.train_deep_kernel(
            run, 20, AB_TIMED_STEPS), reps=5, inner=1) / AB_TIMED_STEPS
            for _ in range(2)]
        prof: dict = {}
        pdk.train_deep_kernel(run, 1000, AB_TIMED_STEPS, profile=prof)
        out["types"] = {t: v / AB_TIMED_STEPS for t, v in prof.items()}
        per_step = pdk.launches_per_step(len(cfg.layer_sizes),
                                         cfg.tie_weights, cfg.variational)
        steps = 5
        kernels = profiler_launches(
            lambda: pdk.train_deep_kernel(run, 2000, steps))
        out["launches"] = per_step
        if len(kernels) == steps * per_step:
            out["profiler"] = [
                (kernels[i][0], sum(kernels[s * per_step + i][1]
                                    for s in range(steps)) / steps)
                for i in range(per_step)]
        else:
            out["profiler"] = []
            print(f"  torch.profiler saw {len(kernels)} kernels for "
                  f"{steps * per_step} launches")
        out.update(update_reading(out["profiler"], out["types"],
                                  pdk.deep_launch_type_bounds(
                                      cfg, run.n_inst, run.batch, True)))
    print("DEEP-STATE " + json.dumps(out), flush=True)
    return 0


def main_deep_ab(parent_root: str) -> int:
    """Kernel 3 of ``parent_root`` (the parent's checkout) against this
    checkout's, each tree in processes of its own (--deep-state), in turns
    parent, change, change, parent: parameters and moments after AB_STEPS
    steps of :func:`ab_cases` compared bit for bit (the first two runs),
    and the tied full-width step timed in all four."""
    global FAILED
    FAILED = []
    parent_root = os.path.abspath(parent_root)
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_ab_") as tmp:
        results = run_ab_workers("--deep-state", "DEEP-STATE", parent_root,
                                 tmp)
        compare_ab_states(results, tmp, "kernel 3")
    timed = [r for r in results if r]
    if len(timed) == 4:
        print(f"  tied {DEEP_LAYERS} N=60 B={BATCH} bf16 moments, ms/step "
              f"(two windows of {AB_TIMED_STEPS} each): "
              + "; ".join(f"{AB_RUNS[i]} {r['ms'][0]:.4f} / {r['ms'][1]:.4f}"
                          for i, r in enumerate(timed)) + f"  [{card}]")
        for i, r in enumerate(timed):
            print(f"  {AB_RUNS[i]} by launch type: " + ", ".join(
                f"{t} {v:.4f}" for t, v in r["types"].items() if v > 0))
            print(f"  {AB_RUNS[i]} launch by launch (torch.profiler, "
                  f"{r['launches']} a step): " + ", ".join(
                      f"{n} {ms:.4f}" for n, ms in r["profiler"]))
        print_update_share(timed, card)
    print(card)
    print(json.dumps({"deep_ab": True, "failed_checks": FAILED}))
    return 1 if FAILED else 0


def main_deep() -> int:
    """[15] and [18] alone: kernel 3 against its twin, then one deep tied
    step timed by launch type and launch by launch, its "trained"
    parameters from MMAE_RUN_STEPS steps of the tied bucket through
    ``train_deep_pallas``; every gate reported."""
    global FAILED
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk

    FAILED = []
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}")
    build_kernels([pdk.KERNELS])
    print(f"[2] ptxas ({pdk.KERNELS.build_seconds:.1f} s):")
    for name, res in sorted(pdk.KERNELS.resources().items()):
        print(f"    {name}: {res}")
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir:
        _, folded, base, _, spec = training_study(workdir)
        deep = deep_buckets(base)
        for label, title, fn in (
                ("[15]", "kernel 3 vs its twin",
                 lambda: phase_deep_kernel_vs_twin(pdk, ptk, deep, folded,
                                                   spec)),
                ("[18]", "one deep tied step, timed",
                 lambda: deep_step_alone(pdk, ptk, deep, folded, spec,
                                         card))):
            print(f"{label} {title}")
            try:
                fn()
            except Exception as exc:   # reported with the checks
                check(False, f"{label}: {type(exc).__name__}: {exc}")
    print(card)
    print(json.dumps({"deep": True, "failed_checks": FAILED}))
    return 1 if FAILED else 0


def deep_step_alone(pdk, ptk, deep, folded, spec, card: str) -> dict:
    """[18] outside the smoke: the tied bucket trained MMAE_RUN_STEPS
    steps by ``train_deep_pallas`` stands in for [16]'s parameters."""
    from multimodalautoencoder_tpu_torch.config import TrainConfig
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    _, cfg, members = next(b for b in deep if b[0] == "tied")
    tcfg = TrainConfig(learning_rate=LR, batch_size=BATCH,
                       num_steps=MMAE_RUN_STEPS, decay=True,
                       decay_steps=1000, decay_rate=0.95,
                       clip_gradients=False, seed=SEED,
                       optimizer_state_dtype="bfloat16")
    hyper = gt.HyperStack.from_settings(members, cfg, tcfg)
    t0 = time.perf_counter()
    params, _ = pdk.train_deep_pallas(SEED, cfg, tcfg, spec, hyper, folded)
    torch.cuda.synchronize()
    print(f"  tied bucket trained {MMAE_RUN_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f} s  [{card}]")
    return phase_deep_step_timing(pdk, ptk, (cfg, tcfg, hyper, params),
                                  folded, spec, card)


# --cls-ab: kernel 4 of this checkout against another tree's (the parent's),
# each in a process of its own, from the same state and seeds; states of
# more than AB_FULL_ELEMENTS elements are compared by digests of their bits
AB_FULL_ELEMENTS = 20_000_000
CLS_AB_BATCHES = (100, 37, 20)


def bits_digest(t: torch.Tensor) -> list:
    """Two 64-bit sums of ``t``'s raw bits, each element weighted by its
    own odd weight: equal for bit-equal tensors, and for tensors that
    differ in any element equal by chance only (integer sums wrap, so the
    digest does not depend on the order of the sum)."""
    b = t.reshape(-1).view(torch.int32 if t.element_size() == 4
                           else torch.int16).to(torch.int64)
    i = torch.arange(b.numel(), device=b.device, dtype=torch.int64)
    w1 = (i * 2654435761 + 97) % 4294967291 * 2 + 1
    w2 = (i * 40503 + 11) % 2147483629 * 2 + 1
    return [int((b * w1).sum()), int((b * w2).sum()), b.numel()]


def cls_ab_cases(sup_folded, spec_full, cfg_v, settings_v):
    """(label, cfg, settings, folded, spec, moments, lr, Adam eps, batch):
    the validation bucket at the sweep's lr 1e-4 / eps 1e-8 and batch 100
    (bf16 moments), with f32 moments, bf16 operands, as a VAE, untied, with
    a one-layer head, and at batch 37 and 20; then at F = 30 every loss x
    head depth (n_cls 1-3) x DAE/VAE x operand type, the demo's widths
    ((16, 8), head (8,)), and batches 37 and 20, in [11]'s linear regime."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.data.modalities import \
        ModalityTable
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    full = "validation bucket N=80"
    cases = [(f"{full} B={b}", cfg_v, settings_v, sup_folded, spec_full,
              "bfloat16", CLS_LR, 1e-8, b) for b in CLS_AB_BATCHES]
    for label, cfg, moments in (
            ("f32 moments", cfg_v, "float32"),
            ("bf16 operands", cfg_v.replace(compute_dtype="bfloat16"),
             "bfloat16"),
            ("VAE", cfg_v.replace(variational=True, tie_weights=False),
             "bfloat16"),
            ("untied", cfg_v.replace(tie_weights=False), "bfloat16"),
            ("head ()", cfg_v.replace(classification_layer_sizes=()),
             "bfloat16")):
        cases.append((f"{full} {label}", cfg.validate(), settings_v,
                      sup_folded, spec_full, moments, CLS_LR, 1e-8, 100))
    rng = np.random.default_rng(SEED)
    mixed = [{"mmae_dropout_prob": 0.5, "dropout_prob": 0.5,
              "weight_penalty": 0.01, "mmae_activation_function": "relu",
              "activation_func": "relu"},
             {"mmae_dropout_prob": 1.0, "dropout_prob": 1.0,
              "weight_penalty": 0.0, "mmae_activation_function": "softsign",
              "activation_func": "softsign"}]
    for loss in ("sigmoid_cross_entropy", "softmax"):
        ys = [rng.integers(0, 3, n).astype(np.float32) if loss == "softmax"
              else rng.integers(0, 2, (n, 3)).astype(np.float32)
              for n in (40, 33)]
        small = gt.FoldedData.from_ragged(
            [rng.random((40, 30)), rng.random((33, 30))],
            [rng.random((9, 30)), rng.random((7, 30))], device=DEVICE,
            train_y_list=ys, val_y_list=[y[:9] for y in ys])
        shapes = [((16, 6), head, 100) for head in ((), (8,), (8, 4))]
        shapes += [(DEMO_LAYERS[1], DEMO_HEAD, 100), ((16, 6), (8, 4), 37),
                   ((16, 6), (8,), 20)]
        for layers, head, batch in shapes:
            for family in ("dae", "vae"):
                for ops in ("float32", "bfloat16"):
                    cfg = MMAEConfig(
                        num_feats=30, layer_sizes=layers,
                        tie_weights=family == "dae",
                        variational=family == "vae",
                        classification_layer_sizes=head, num_labels=3,
                        classification_loss=loss, compute_dtype=ops,
                        weight_initialization="normal").validate()
                    spec = NoiseSpec.build(cfg, ModalityTable.uniform(
                        5, 6, NAMES))
                    cases.append((
                        f"F=30 {layers} {loss[:7]} head {head} {family} "
                        f"ops {ops[:4]} B={batch}", cfg, mixed, small, spec,
                        ops, LINEAR_LR, LINEAR_EPS, batch))
    return cases


def cls_products(cfg, batch: int) -> list:
    """(launch name, [(m, k, n)]) of every product launch of one phase-2
    step in launch order, then the update's weight-gradient products: the
    shapes ``torch.bmm`` is timed at beside each launch."""
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    d = [H2] + list(cfg.classification_layer_sizes) + [cfg.num_labels]
    nc, B = len(d) - 1, batch
    vae = cfg.variational
    out = [("encode 1", [(B, F, H1)]), ("encode 2", [(B, H1, H2)])]
    out += [("lv head", [(B, H1, H2)])] if vae else []
    out += [(f"head {j}", [(B, d[j], d[j + 1])]) for j in range(nc)]
    out += [(f"head {j} grad", [(B, d[j + 1], d[j])])
            for j in range(nc - 1, -1, -1)]
    out += [("g1", [(B, H2 * (2 if vae else 1), H1)])]
    wgr = [(F, B, H1), (H1, B, H2)] + ([(H1, B, H2)] if vae else [])
    out += [("update", wgr + [(d[j], B, d[j + 1]) for j in range(nc)])]
    return out


def cls_step_names(cfg) -> list:
    """The launches of one phase-2 step by name, in launch order (the
    grouped update last)."""
    prods = [name for name, _ in cls_products(cfg, 1)]
    vae = cfg.variational
    nc = len(cfg.classification_layer_sizes) + 1
    n_fwd = 2 + (1 if vae else 0) + nc
    return (["sample"] + prods[:n_fwd - nc] + (["vae sample"] if vae else [])
            + prods[n_fwd - nc:n_fwd] + ["loss grad"]
            + prods[n_fwd:-2] + (["vae grad"] if vae else []) + prods[-2:])


def main_cls_state(out_dir: str, dump: bool) -> int:
    """Worker of --cls-ab, on the package under MMAE_PACKAGE_ROOT: with
    ``dump``, kernel 4 runs AB_STEPS steps of each of :func:`cls_ab_cases`
    from the seed's state and saves parameters and moments (bits, or
    digests of them past AB_FULL_ELEMENTS); always, the validation
    bucket's step is timed: ms/step over windows of AB_TIMED_STEPS, by
    launch type, and launch by launch by torch.profiler in turns with
    ``torch.bmm`` of each launch's products.  The last line is
    ``CLS-STATE`` and a JSON object."""
    import multimodalautoencoder_tpu_torch as pkg
    from multimodalautoencoder_tpu_torch.config import TrainConfig
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    pck.KERNELS.load()
    print(f"  package {os.path.dirname(pkg.__file__)}; kernel 4 built in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {"cases": []}
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir:
        study, _, _, _, spec = training_study(workdir)
        _, sup_folded, cfg_v, settings_v = supervised_study(study)
        cases = cls_ab_cases(sup_folded, spec, cfg_v, settings_v)

        def start(cfg, settings, fold, sp, moments, lr, eps, batch):
            tcfg = TrainConfig(learning_rate=LR, batch_size=BATCH,
                               clip_gradients=False)
            cls_tcfg = TrainConfig(learning_rate=lr, batch_size=batch,
                                   clip_gradients=False,
                                   optimizer_state_dtype=moments)
            hyper, chyper = cls_hypers(cfg, settings, tcfg)
            C, K = hyper.num_configs, fold.num_folds
            g = torch.Generator().manual_seed(SEED)
            return pck.prepare_cls_run(
                g, cfg, cls_tcfg, sp, hyper, chyper, fold,
                ptk.init_grid_params(g, pck.phase1_cfg(cfg), C, K),
                pck.init_heads(g, cfg, C, K), adam_eps=eps)

        for i, case in enumerate(cases if dump else []):
            label = case[0]
            run = start(*case[1:])
            twin = run.clone()
            before = pck.KERNELS.launches
            pck.train_cls_kernel(run, 0, AB_STEPS)
            torch.cuda.synchronize()
            state = {k: [t for t in getattr(run, k) if t is not None]
                     for k in ("params", "m", "v")}
            if sum(t.numel() for ts in state.values() for t in ts) \
                    > AB_FULL_ELEMENTS:
                state = {k: [bits_digest(t) for t in ts]
                         for k, ts in state.items()}
            else:
                state = {k: [t.cpu() for t in ts] for k, ts in state.items()}
            torch.save(state, os.path.join(out_dir, f"case{i}.pt"))
            launches = pck.KERNELS.launches - before
            del run
            kern = twin.clone()
            pck.train_cls_kernel(kern, 0, 1)
            pck.train_cls_kernel_reference(twin, 0, 1)
            torch.cuda.synchronize()
            gaps = [(float((a - b).abs().max()),
                     int(((a - b).abs() > TOL_CLS).sum()))
                    for a, b in zip(kern.params, twin.params)
                    if a is not None]
            out["cases"].append({"label": label, "launches": launches,
                                 "step0_vs_twin": gaps})
            del kern, twin
        run = start(*cases[0][1:])
        cfg = cases[0][1]
        pck.train_cls_kernel(run, 0, 20)
        out["ms"] = [cuda_ms(lambda: pck.train_cls_kernel(
            run, 20, AB_TIMED_STEPS), reps=5, inner=1) / AB_TIMED_STEPS
            for _ in range(2)]
        prof: dict = {}
        pck.train_cls_kernel(run, 1000, AB_TIMED_STEPS, profile=prof)
        out["types"] = {t: v / AB_TIMED_STEPS for t, v in prof.items()}
        nc = len(cfg.classification_layer_sizes) + 1
        per_step = pck.launches_per_step(nc, cfg.variational)
        names = cls_step_names(cfg)
        steps = 5

        def by_launch():
            # one step more than is read: the profiler can miss the first
            # kernel it traces
            kernels = profiler_launches(
                lambda: pck.train_cls_kernel(run, 2000, steps + 1))
            if not steps * per_step <= len(kernels) <= (steps + 1) \
                    * per_step:
                print(f"  torch.profiler saw {len(kernels)} kernels for "
                      f"{(steps + 1) * per_step} launches")
                return []
            kernels = kernels[-steps * per_step:]
            each = [(kernels[i][0], sum(kernels[s * per_step + i][1]
                                        for s in range(steps)) / steps)
                    for i in range(per_step)]
            # launches past the step's products are its update (one
            # launch a weight and a bias in a tree before the grouped one)
            head = each[:len(names) - 1]
            tail = each[len(names) - 1:]
            return head + [("+".join(sorted({k for k, _ in tail})),
                            sum(ms for _, ms in tail))]

        B = run.batch
        ops = {name: [(torch.rand((run.n_inst, m, k), device=DEVICE),
                       torch.rand((run.n_inst, k, n), device=DEVICE))
                      for m, k, n in shapes]
               for name, shapes in cls_products(cfg, B)}

        def bmm_turn():
            return {name: device_ms(
                lambda o=o: [torch.bmm(a, b) for a, b in o], reps=5,
                inner=5) for name, o in ops.items()}

        k1 = by_launch()
        b1, b2 = bmm_turn(), bmm_turn()
        k2 = by_launch()
        out["launches"] = per_step
        out["names"] = names
        out["profiler"] = ([(n1, (m1 + m2) / 2) for (n1, m1), (_, m2)
                            in zip(k1, k2)] if k1 and k2 else [])
        out["bmm"] = {name: (b1[name] + b2[name]) / 2 for name in b1}
        out.update(update_reading(out["profiler"], out["types"],
                                  pck.cls_launch_type_bounds(
                                      cfg, run.n_inst, B,
                                      bool(run.bf16_moments))))
    print("CLS-STATE " + json.dumps(out), flush=True)
    return 0


def ab_states_differ(a: dict, b: dict):
    """(elements that differ, elements, first differences) between two
    saved states: bit for bit where both hold tensors, else by digest (a
    tensor whose digests differ counts whole)."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    differ, total, first = 0, 0, []
    for k in ("params", "m", "v"):
        for j, (x, y) in enumerate(zip(a[k], b[k])):
            if isinstance(x, list) or isinstance(y, list):
                total += x[2]
                if x != y:
                    differ += x[2]
                    first.append((k, j, "digest"))
                continue
            ne = x.view(bits[x.dtype]) != y.view(bits[y.dtype])
            total += x.numel()
            differ += int(ne.sum())
            for idx in ne.nonzero()[:3].tolist():
                first.append((k, j, idx, float(x[tuple(idx)]),
                              float(y[tuple(idx)])))
    return differ, total, first


AB_RUNS = ("parent", "change", "change", "parent")


def run_ab_workers(flag: str, tag: str, parent_root: str, tmp: str) -> list:
    """The --deep-ab / --cls-ab workers (``flag``) in turns parent, change,
    change, parent, each in a process of its own on its tree's package;
    the first two dump their states into ``tmp``.  Returns each worker's
    JSON object (None where it printed none)."""
    here = os.path.dirname(os.path.abspath(__file__))
    results = []
    for i, name in enumerate(AB_RUNS):
        root = parent_root if name == "parent" else here
        d = os.path.join(tmp, f"run{i}")
        os.makedirs(d)
        print(f"[ab {i}] {name}: {root}", flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), flag, d,
             "dump" if i < 2 else "time"],
            env=dict(os.environ, MMAE_PACKAGE_ROOT=root), cwd=root,
            capture_output=True, text=True, timeout=1500)
        lines = proc.stdout.splitlines()
        for line in lines:
            if not line.startswith(tag + " "):
                print(line)
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
        check(proc.returncode == 0, f"{flag} {name} returned "
              f"{proc.returncode}")
        state = [json.loads(line[len(tag) + 1:]) for line in lines
                 if line.startswith(tag + " ")]
        results.append(state[0] if state else None)
    return results


def compare_ab_states(results: list, tmp: str, kernel: str) -> None:
    """The states the first parent and change workers dumped, case by
    case: every parameter and moment bit for bit (a check each), beside
    each tree's step 0 against the f32 twin."""
    if not (results[0] and results[1]):
        return
    for i, case in enumerate(results[0]["cases"]):
        a = torch.load(os.path.join(tmp, "run0", f"case{i}.pt"))
        b = torch.load(os.path.join(tmp, "run1", f"case{i}.pt"))
        differ, total, first = ab_states_differ(a, b)
        print(f"  {case['label']:56s} {differ} of {total} parameter and "
              f"moment elements differ after {AB_STEPS} steps; launches "
              f"{case['launches']} (parent) / "
              f"{results[1]['cases'][i]['launches']}"
              + (f"; first {first[:6]}" if first else ""))
        for name, r in (("parent", results[0]), ("change", results[1])):
            gaps = r["cases"][i]["step0_vs_twin"]
            print(f"    {name} step 0 vs the f32 twin: max |dp| "
                  f"{max(g[0] for g in gaps):.3e}, "
                  f"{sum(g[1] for g in gaps)} over {TOL_CLS} "
                  f"(by tensor {[g[1] for g in gaps]})")
        check(differ == 0, f"{case['label']}: {differ} elements differ "
              f"from the parent's {kernel}")


def main_cls_ab(parent_root: str) -> int:
    """Kernel 4 of ``parent_root`` (the parent's checkout) against this
    checkout's, each tree in processes of its own (--cls-state), in turns
    parent, change, change, parent: parameters and moments after AB_STEPS
    steps of :func:`cls_ab_cases` compared bit for bit (the first two
    runs), and the validation bucket's step timed in all four, launch by
    launch beside its own bound and ``torch.bmm`` of its products."""
    global FAILED
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck

    FAILED = []
    parent_root = os.path.abspath(parent_root)
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_ab_") as tmp:
        results = run_ab_workers("--cls-state", "CLS-STATE", parent_root,
                                 tmp)
        compare_ab_states(results, tmp, "kernel 4")
    timed = [r for r in results if r]
    if len(timed) == 4:
        print(f"  validation bucket (tied 1000 -> 100, head 50 -> 20 -> 3, "
              f"N=80, B=100, bf16 moments), ms/step (two windows of "
              f"{AB_TIMED_STEPS} each): " + "; ".join(
                  f"{AB_RUNS[i]} {r['ms'][0]:.4f} / {r['ms'][1]:.4f}"
                  for i, r in enumerate(timed)) + f"  [{card}]")
        for i, r in enumerate(timed):
            print(f"  {AB_RUNS[i]} by launch type: " + ", ".join(
                f"{t} {v:.4f}" for t, v in r["types"].items() if v > 0))
        cfg = MMAEConfig(num_feats=1000, layer_sizes=LAYERS,
                         classification_layer_sizes=(50, 20), num_labels=3,
                         tie_weights=True).validate()
        # a tree older than the per-launch bounds prints none
        per_launch = getattr(pck, "cls_launch_bounds", None)
        bounds = {b["name"]: b for b in (
            per_launch(cfg, 80, 100, True) if per_launch else [])}
        print(f"  launch by launch (torch.profiler, 5 steps; parent "
              f"{timed[0]['launches']} launches a step, change "
              f"{timed[1]['launches']}); ms parent / change, torch.bmm of "
              f"the launch's products in turns, own bound  [{card}]")
        both = [r["profiler"] for r in timed]
        if all(both):
            for j, name in enumerate(timed[1]["names"]):
                ms = [p[j][1] for p in both]
                bmm = timed[1]["bmm"].get(name)
                b = bounds.get(name)
                print(f"    {j:2d} {name:12s} {both[1][j][0][:24]:24s} "
                      f"{(ms[0] + ms[3]) / 2:.4f} / {(ms[1] + ms[2]) / 2:.4f}"
                      + (f"  bmm {bmm:.4f}" if bmm is not None else
                         "  bmm -     ")
                      + (f"  bound {b['bound_ms']:.4f} {b['bound_by'][:5]}"
                         if b else "") + (f"  grid {b['grid']} panel "
                                          f"{b['panel']}x{b['cols']}"
                                          if b and "grid" in b else ""))
            print(f"    parent's update launches: {both[0][-1][0]}")
        print_update_share(timed, card)
    print(card)
    print(json.dumps({"cls_ab": True, "failed_checks": FAILED}))
    return 1 if FAILED else 0


# --train-ab: kernel 2 of this checkout against another tree's (the parent's),
# each in a process of its own, from the same state and seeds
TRAIN_AB_ACTS = ("linear", "relu", "tanh", "softsign", "softplus")


def train_ab_cases(study, spec_full):
    """(label, cfg, settings, folded, spec, moments, batch): the three
    1000-wide ACII buckets (N = 60) with bf16 and f32 moments, the tied
    500-wide and the VAE 300-wide bucket, phase 1 of [12]'s validation
    bucket (N = 20), and at F = 30 the three families over all five
    activations with L2 on and off, with both moment types at batch 20
    and with bf16 moments at batch 13 (not a multiple of 4).  The
    sweep's recipe throughout: lr 1e-3, smooth decay."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.data.modalities import \
        ModalityTable
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.sweep.wrappers import \
        MMAEClassificationSweep as Sweep

    folded = gt.FoldedData.from_loader(study, study.num_folds, device=DEVICE)
    cases = []
    _, buckets = sweep_buckets(study)
    for name, cfg, members in buckets:
        for moments in ("bfloat16", "float32"):
            cases.append((f"{name} {LAYERS} N=60 {moments}", cfg, members,
                          folded, spec_full, moments, BATCH))
    for layers, family in (((500, 100), "tied"), ((300, 100), "vae")):
        _, more = sweep_buckets(study, layers)
        _, cfg, members = next(b for b in more if b[0] == family)
        cases.append((f"{family} {layers} N=60 bfloat16", cfg, members,
                      folded, spec_full, "bfloat16", BATCH))
    _, sup_folded, cfg_v, settings_v = supervised_study(study)
    uniq = []
    for s in settings_v:
        if Sweep._mmae_subsetting(s) not in uniq:
            uniq.append(Sweep._mmae_subsetting(s))
    cases.append((f"validation bucket phase 1 N={len(uniq) * 5} bfloat16",
                  pck.phase1_cfg(cfg_v), uniq, sup_folded, spec_full,
                  "bfloat16", BATCH))
    rng = np.random.default_rng(SEED)
    small = gt.FoldedData.from_ragged(
        [rng.random((40, 30)), rng.random((33, 30))],
        [rng.random((9, 30)), rng.random((7, 30))], device=DEVICE)
    ten = [{"activation_function": act, "dropout_prob": 0.5 if pen else 1.0,
            "weight_penalty": pen}
           for act in TRAIN_AB_ACTS for pen in (0.0, 0.01)]
    base = MMAEConfig(num_feats=30, layer_sizes=(16, 6),
                      weight_initialization="normal")
    for family in ("tied softsign", "untied relu", "vae"):
        cfg = family_cfg(base, family)
        spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
        for moments, batch in (("float32", BATCH), ("bfloat16", BATCH),
                               ("bfloat16", 13)):
            cases.append((f"F=30 (16, 6) {family} {moments} B={batch}", cfg,
                          ten, small, spec, moments, batch))
    return cases


def train_products(cfg, batch: int) -> dict:
    """(m, k, n) of every product launch of one depth-2 step by launch
    name (``ptk.launch_bounds``' names), the update's being its
    weight-gradient products: the shapes ``torch.bmm`` is timed at beside
    each launch."""
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    B, vae = batch, cfg.variational
    out = {"z1": [(B, F, H1)], "mu": [(B, H1, H2)], "z3": [(B, H2, H1)],
           "z4": [(B, H1, F)], "g3": [(B, F, H1)], "gz": [(B, H1, H2)],
           "g1": [(B, H2 * (2 if vae else 1), H1)]}
    if vae:
        out["lv"] = [(B, H1, H2)]
    out["update"] = [(F, B, H1), (H1, B, H2)] * 2 \
        + ([(H1, B, H2)] if vae else [])
    return out


def main_train_state(out_dir: str, dump: bool) -> int:
    """Worker of --train-ab, on the package under MMAE_PACKAGE_ROOT: with
    ``dump``, kernel 2 runs AB_STEPS steps of each of
    :func:`train_ab_cases` from the seed's state and saves parameters and
    moments (bits, or digests of them past AB_FULL_ELEMENTS); always, the
    tied 1000-wide bucket's step (N = 60) and the validation bucket's
    phase-1 step (N = 20) are timed: ms/step over windows of
    AB_TIMED_STEPS, by launch type, and launch by launch by
    torch.profiler, beside ``torch.bmm`` of each launch's products where
    the tree plans its launches (``ptk.launch_bounds``).  The last line
    is ``TRAIN-STATE`` and a JSON object."""
    import multimodalautoencoder_tpu_torch as pkg
    from multimodalautoencoder_tpu_torch.config import TrainConfig
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ptk.KERNELS.load()
    print(f"  package {os.path.dirname(pkg.__file__)}; kernel 2 built in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {"cases": []}
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir:
        study, _, _, _, spec = training_study(workdir)
        cases = train_ab_cases(study, spec)

        def start(cfg, settings, fold, sp, moments, batch):
            tcfg = TrainConfig(learning_rate=LR, batch_size=batch,
                               decay=True, decay_steps=1000,
                               decay_rate=0.95, clip_gradients=False,
                               optimizer_state_dtype=moments)
            hyper = gt.HyperStack.from_settings(settings, cfg, tcfg)
            C, K = hyper.num_configs, fold.num_folds
            g = torch.Generator().manual_seed(SEED)
            return ptk.prepare_run(g, cfg, tcfg, sp, hyper, fold,
                                   ptk.init_grid_params(g, cfg, C, K))

        for i, case in enumerate(cases if dump else []):
            label = case[0]
            run = start(*case[1:])
            twin = run.clone()
            before = ptk.KERNELS.launches
            ptk.train_grid_kernel(run, 0, AB_STEPS)
            torch.cuda.synchronize()
            state = {k: [t for t in getattr(run, k) if t is not None]
                     for k in ("params", "m", "v")}
            if sum(t.numel() for ts in state.values() for t in ts) \
                    > AB_FULL_ELEMENTS:
                state = {k: [bits_digest(t) for t in ts]
                         for k, ts in state.items()}
            else:
                state = {k: [t.cpu() for t in ts] for k, ts in state.items()}
            torch.save(state, os.path.join(out_dir, f"case{i}.pt"))
            launches = ptk.KERNELS.launches - before
            del run
            kern = twin.clone()
            ptk.train_grid_kernel(kern, 0, 1)
            ptk.train_grid_kernel_reference(twin, 0, 1)
            torch.cuda.synchronize()
            gaps = [(float((a - b).abs().max()),
                     int(((a - b).abs() > TOL).sum()))
                    for a, b in zip(kern.params, twin.params)
                    if a is not None]
            out["cases"].append({"label": label, "launches": launches,
                                 "step0_vs_twin": gaps})
            del kern, twin

        plan = getattr(ptk, "launch_bounds", None)
        for key, prefix in (("tied", "tied (1000, 100) N=60 bfloat16"),
                            ("phase1", "validation bucket phase 1")):
            case = next(c for c in cases if c[0].startswith(prefix))
            cfg = case[1]
            run = start(*case[1:])
            ptk.train_grid_kernel(run, 0, 20)
            res = {"label": case[0], "ms": [cuda_ms(
                lambda: ptk.train_grid_kernel(run, 20, AB_TIMED_STEPS),
                reps=5, inner=1) / AB_TIMED_STEPS for _ in range(2)]}
            prof: dict = {}
            ptk.train_grid_kernel(run, 1000, AB_TIMED_STEPS, profile=prof)
            res["types"] = {t: v / AB_TIMED_STEPS for t, v in prof.items()}
            before = ptk.KERNELS.launches
            ptk.train_grid_kernel(run, 3000, 1)
            per_step = ptk.KERNELS.launches - before
            steps = 5
            res["names"], res["bmm"] = [], {}
            if plan is not None:
                rows = plan(cfg, run.n_inst, run.batch, True)
                res["names"] = [r["name"] for r in rows]

            def by_launch():
                # one step more than is read: the profiler can miss the
                # first kernel it traces
                kernels = profiler_launches(
                    lambda: ptk.train_grid_kernel(run, 2000, steps + 1))
                if not steps * per_step <= len(kernels) \
                        <= (steps + 1) * per_step:
                    print(f"  torch.profiler saw {len(kernels)} kernels "
                          f"for {(steps + 1) * per_step} launches")
                    return []
                kernels = kernels[-steps * per_step:]
                return [(kernels[i][0], sum(kernels[s * per_step + i][1]
                                            for s in range(steps)) / steps)
                        for i in range(per_step)]

            k1 = by_launch()
            if plan is not None:
                ops = {name: [(torch.rand((run.n_inst, m, k), device=DEVICE),
                               torch.rand((run.n_inst, k, n), device=DEVICE))
                              for m, k, n in shapes]
                       for name, shapes in train_products(
                           cfg, run.batch).items()}

                def bmm_turn():
                    return {name: device_ms(
                        lambda o=o: [torch.bmm(a, b) for a, b in o],
                        reps=5, inner=5) for name, o in ops.items()}

                b1, b2 = bmm_turn(), bmm_turn()
                res["bmm"] = {name: (b1[name] + b2[name]) / 2 for name in b1}
            k2 = by_launch()
            res["launches"] = per_step
            res["profiler"] = ([(n1, (m1 + m2) / 2) for (n1, m1), (_, m2)
                                in zip(k1, k2)] if k1 and k2 else [])
            res.update(update_reading(res["profiler"], res["types"],
                                      ptk.launch_type_bounds(
                                          cfg, run.n_inst, run.batch,
                                          bool(run.bf16_moments))))
            out[key] = res
            del run
    print("TRAIN-STATE " + json.dumps(out), flush=True)
    return 0


def main_train_ab(parent_root: str) -> int:
    """Kernel 2 of ``parent_root`` (the parent's checkout) against this
    checkout's, each tree in processes of its own (--train-state), in
    turns parent, change, change, parent: parameters and moments after
    AB_STEPS steps of :func:`train_ab_cases` compared bit for bit (the
    first two runs), and the tied 1000-wide step (N = 60) and the
    validation bucket's phase-1 step (N = 20) timed in all four, launch
    by launch beside ``torch.bmm`` of each launch's products."""
    global FAILED
    FAILED = []
    parent_root = os.path.abspath(parent_root)
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_ab_") as tmp:
        results = run_ab_workers("--train-state", "TRAIN-STATE", parent_root,
                                 tmp)
        compare_ab_states(results, tmp, "kernel 2")
    timed = [r for r in results if r]
    if len(timed) == 4:
        for key in ("tied", "phase1"):
            runs = [r[key] for r in timed]
            print(f"  {runs[0]['label']}, B={BATCH}, ms/step (two windows "
                  f"of {AB_TIMED_STEPS} each): " + "; ".join(
                      f"{AB_RUNS[i]} {r['ms'][0]:.4f} / {r['ms'][1]:.4f}"
                      for i, r in enumerate(runs)) + f"  [{card}]")
            for i, r in enumerate(runs):
                print(f"    {AB_RUNS[i]} by launch type: " + ", ".join(
                    f"{t} {v:.4f}" for t, v in r["types"].items() if v > 0))
            print_update_share(runs, card)
            for tree, (a, b) in (("parent", (runs[0], runs[3])),
                                 ("change", (runs[1], runs[2]))):
                if not (a["profiler"] and b["profiler"]):
                    continue
                names = b["names"] or [""] * len(b["profiler"])
                print(f"    {tree}, launch by launch (torch.profiler, 5 "
                      f"steps, mean of its two runs; {a['launches']} "
                      f"launches a step): ms, torch.bmm of the launch's "
                      f"products  [{card}]")
                for j, ((kn, m1), (_, m2)) in enumerate(zip(a["profiler"],
                                                            b["profiler"])):
                    bmm = b["bmm"].get(names[j])
                    print(f"      {j:2d} {names[j]:7s} {kn[:26]:26s} "
                          f"{(m1 + m2) / 2:.4f}"
                          + (f"  bmm {bmm:.4f}" if bmm is not None else ""))
    print(card)
    print(json.dumps({"train_ab": True, "failed_checks": FAILED}))
    return 1 if FAILED else 0


def main() -> int:
    if sys.argv[1:2] == ["--count-launches"]:
        return main_count_launches(sys.argv[2:])
    workers = {"--deep-state": main_deep_state,
               "--cls-state": main_cls_state,
               "--train-state": main_train_state}
    if sys.argv[1:2] and sys.argv[1] in workers and len(sys.argv) == 4:
        # the package under MMAE_PACKAGE_ROOT, not this file's
        sys.path.insert(0, os.environ["MMAE_PACKAGE_ROOT"])
        return workers[sys.argv[1]](sys.argv[2], sys.argv[3] == "dump")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--single-run"]:
        return main_single_run()
    if sys.argv[1:] == ["--baselines"]:
        return main_baselines()
    if sys.argv[1:] == ["--split-cards"]:
        return main_split_cards()
    if sys.argv[1:] == ["--pipeline"]:
        return main_pipeline()
    if sys.argv[1:2] == ["--deep-ab"] and len(sys.argv) == 3:
        return main_deep_ab(sys.argv[2])
    if sys.argv[1:2] == ["--cls-ab"] and len(sys.argv) == 3:
        return main_cls_ab(sys.argv[2])
    if sys.argv[1:2] == ["--train-ab"] and len(sys.argv) == 3:
        return main_train_ab(sys.argv[2])
    if sys.argv[1:] == ["--deep"]:
        return main_deep()
    check(len(sys.argv) == 1, "usage: chip_smoke.py "
          "[--single-run | --baselines | "
          "--split-cards | --pipeline | --deep | --deep-ab <checkout> | "
          "--cls-ab <checkout> | --train-ab <checkout> | --count-launches "
          "<cli arguments>]")
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck
    from multimodalautoencoder_tpu_torch.ops import dense_kernels as dk
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
    from multimodalautoencoder_tpu_torch.tools import hbm_bench as hbm

    t_start = time.perf_counter()
    t_lap = [t_start]

    def took(tag: str) -> None:
        """The time since the last phase's end, as its own line."""
        now = time.perf_counter()
        print(f"  {tag} took {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    # one nvcc process per source, all started together; [3]-[6] need
    # fused_dense alone and run while the training libraries build
    libs = (dk.KERNELS, hbm.KERNELS, ptk.KERNELS, pck.KERNELS, pdk.KERNELS)
    builder = ThreadPoolExecutor(len(libs))
    builds = [builder.submit(lib.build) for lib in libs]
    builds[0].result()
    dk.KERNELS.load()
    print(f"[2] built {os.path.relpath(dk.KERNELS.library)} from "
          f"{os.path.relpath(dk.KERNELS.source)} with nvcc "
          f"{' '.join(dk.NVCC_FLAGS)} in {dk.KERNELS.build_seconds:.1f} s; "
          "the other four build beside [3]-[6]")
    took("[1]-[2]")

    print(f"[3] fused_dense kernel vs plain (TF32 off, atol=rtol={TOL})")
    max_err, max_err_bf16, max_lean = phase_kernel_vs_plain(dk)
    took("[3]")

    # [32]'s wheel is built, installed and run in a thread of its own from
    # [7] on (it prints nothing there; [32] checks it); the pool's exit
    # waits for it before the work directory goes
    with tempfile.TemporaryDirectory(prefix="mmae_chip_smoke_") as workdir, \
            ThreadPoolExecutor(1) as background, builder:
        print("[4] serve path: cli fill/embed --device cuda from two "
              "use_pallas checkpoints (tied softsign DAE, VAE)")
        launches, ck_dae, dl = phase_serve(workdir, dk)
        params, cfg, x = phase_reconstruction(dk, ck_dae, dl)
        took("[4]")
        print("[5] timing")
        dense = phase_timing(dk, params, cfg, x, card)
        took("[5]")
        print("[6] one cli fill call (DAE), step by step")
        phase_breakdown(dl.filename, ck_dae, card)
        took("[6]")
        for fut in builds:
            fut.result()
        for lib in libs[1:]:
            lib.load()
        print(f"  built {os.path.relpath(hbm.KERNELS.library)} in "
              f"{hbm.KERNELS.build_seconds:.1f} s, the training libraries "
              f"in {ptk.KERNELS.build_seconds:.1f} / "
              f"{pck.KERNELS.build_seconds:.1f} / "
              f"{pdk.KERNELS.build_seconds:.1f} s (all five started "
              "together); ptxas:")
        for lib in libs:
            print(f"    {os.path.basename(lib.library)}")
            for name, res in sorted(lib.resources().items()):
                print(f"      {name}: {res}")
        took("builds after [6]")
        wheel_run = background.submit(install_wheel, workdir, dl.filename,
                                      ck_dae)

        print(f"[7] built {os.path.relpath(ptk.KERNELS.library)} from "
              f"{os.path.relpath(ptk.KERNELS.source)} in "
              f"{ptk.KERNELS.build_seconds:.1f} s (ptxas after [6])")
        probe = phase_rng(ptk)

        study, folded, base, buckets, spec = training_study(workdir,
                                                            dl.filename)
        took("[7]")
        print(f"[8] training kernels vs their twin on the card (TF32 off,"
              f" 10 steps, lr {LR}, tolerance {TOL})")
        train_err = phase_kernel_vs_twin(ptk, buckets, folded, spec)
        took("[8]")

        print(f"[9] grid training, end to end: the three 1000-wide ACII "
              f"buckets, {STEPS} steps each, through "
              f"train_grid_sharded(backend='pallas')")
        train_launches, tied, rates = phase_train(
            workdir, ptk, dk, study, folded, buckets, spec, card)
        took("[9]")
        print("[10] one training step, timed")
        step = phase_step_timing(ptk, tied, folded, spec, card)
        took("[10]")

        print(f"[11] built {os.path.relpath(pck.KERNELS.library)} from "
              f"{os.path.relpath(pck.KERNELS.source)} in "
              f"{pck.KERNELS.build_seconds:.1f} s (with the others; ptxas "
              "after [6])")
        sup, sup_folded, cfg_v, settings_v = supervised_study(study)
        print(f"  phase-2 kernels vs their twin on the card (TF32 off, 10 "
              f"steps, tolerance {TOL_CLS} with either operand type)")
        cls_err = phase_cls_kernel_vs_twin(pck, ptk, sup_folded, spec, cfg_v,
                                           settings_v)
        took("[11]")
        print(f"[12] the validation bucket end to end: "
              f"MMAEClassificationSweep(backend='pallas', "
              f"save_best_params=True).run(), {CLS_RUN_STEPS} + "
              f"{CLS_RUN_STEPS} "
              "steps")
        cls_launches, _, _ = phase_cls_sweep(workdir, pck, ptk,
                                             study.filename, study, sup,
                                             card)
        took("[12]")
        print(f"[13] the full default grid through cli sweep-classification"
              f" --device {DEVICE} --check-test, {GRID_STEPS} + {GRID_STEPS}"
              " steps, then the validation bucket unshared")
        phase_full_grid(workdir, pck, ptk, study.filename, card)
        phase_unshared_bucket(workdir, pck, ptk, study, sup, card)
        took("[13]")
        print("[14] one phase-2 step of the validation bucket, timed")
        cls_step = phase_cls_step_timing(pck, ptk, sup_folded, spec, cfg_v,
                                         settings_v, card)
        took("[14]")

        print(f"[15] built {os.path.relpath(pdk.KERNELS.library)} from "
              f"{os.path.relpath(pdk.KERNELS.source)} in "
              f"{pdk.KERNELS.build_seconds:.1f} s (with the others; ptxas "
              "after [6])")
        deep = deep_buckets(base)
        print(f"  kernel 3 vs its twin on the card (TF32 off, 10 steps, "
              f"tolerance {TOL_CLS})")
        deep_err = phase_deep_kernel_vs_twin(pdk, ptk, deep, folded, spec)
        took("[15]")
        print(f"[16] the MMAE sweep end to end: MMAESweep(layer_sizes="
              f"[{DEEP_LAYERS}], backend='pallas', probe='device', "
              f"save_best_params=True).run(), {MMAE_RUN_STEPS} steps")
        deep_launches, tied_deep, _ = phase_mmae_sweep(
            workdir, pdk, ptk, dk, study, sup, card)
        took("[16]")
        print(f"[17] the default 108-setting grid through cli sweep-mmae "
              f"--device {DEVICE} --check-test, {MMAE_GRID_STEPS} steps")
        phase_full_mmae_grid(workdir, pdk, ptk, study.filename, card)
        took("[17]")
        print("[18] one deep tied step, timed")
        deep_step = phase_deep_step_timing(pdk, ptk, tied_deep, folded,
                                           spec, card)
        took("[18]")
        print(f"[19] built {os.path.relpath(hbm.KERNELS.library)} in "
              f"{hbm.KERNELS.build_seconds:.1f} s (with the others); the "
              f"bandwidth probe over {hbm.MOMENT_BYTES / 1e9:.3f} GB, "
              f"{hbm.STEPS} passes a pattern")
        stream = phase_hbm(hbm, card)
        took("[19]")

        print(f"[20] fused_dense under autograd at the training shapes (TF32"
              f" off, atol=rtol={TOL})")
        dense_train = phase_dense_autograd(dk, card)
        took("[20]")
        print(f"[21] the single-run trainer at full width: trainer.train / "
              f"train_classification, use_pallas on and off, "
              f"{SINGLE_STEPS} steps each")
        single = phase_single_run(dk, dl.filename, card)
        took("[21]")
        print(f"[22] cli train --device {DEVICE} --arch "
              f"{' '.join(map(str, LAYERS))}, reloaded and resumed")
        phase_cli_train(workdir, dl.filename, card)
        took("[22]")
        phase_baselines(workdir, card, dl.filename)
        took("[23]-[26]")

        print(f"[27] the instance split on the card: [9]'s tied bucket, "
              f"{SPLIT_STEPS} steps, on [cuda:0, cuda:0] against one device")
        split = phase_split(ptk, tied, folded, spec, card)
        took("[27]")
        with sharded_classification(workdir, study.filename) as shards:
            print(f"[28] the distributed MMAE sweep: "
                  f"tools/multihost_sweep.py --hosts 2 --distributed on "
                  f"gloo, the 108-setting grid at {SHARD_STEPS} steps, both "
                  f"ranks on cuda:0, --engine native, beside [29]'s "
                  f"processes")
            sharded = phase_distributed_mmae(workdir, dk, ptk,
                                             study.filename, card)
            print(f"[29] the sharded classification sweep: cli "
                  f"sweep-classification --process-shard i 2 --device "
                  f"{DEVICE}, two concurrent processes started with [28], "
                  f"576 settings at {SHARD_STEPS} + {SHARD_STEPS} steps, "
                  f"then cli merge-shards")
            sharded_cls = phase_sharded_classification(shards, card)
        took("[28]-[29]")
        print("[30] the parity band on kernel 2: the reference recipe's "
              "three runs, then [9]'s utilization rows")
        band = phase_parity_band(ptk, rates, card)
        took("[30]")
        print(f"[31] the end-to-end demo: python -m multimodalautoencoder_"
              f"tpu_torch.examples.acii_pipeline {' '.join(PIPELINE_ARGS)} "
              f"--device {DEVICE}")
        pipeline = phase_pipeline(workdir, ptk, pck, card)
        took("[31]")
        print("[32] the installed wheel: built from this checkout, installed"
              " read-only with pip --target, --engine native and cli fill "
              "from a fresh interpreter (started after [6])")
        wheel = phase_installed_wheel(dl.filename, dl, card,
                                      wheel_run.result())
        took("[32]")
        for mod in ("jax", "pandas", "sklearn", "multimodalautoencoder_tpu"):
            check(mod not in sys.modules, f"the port's paths imported {mod}")

    print(f"  whole run {time.perf_counter() - t_start:.1f} s")
    print(card)
    src = "multimodalautoencoder_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        dict({"name": "fused_dense", "route": "cuda",
              "source": src + "fused_dense.cu",
              "replaces": "multimodalautoencoder_tpu/ops/pallas_kernels.py"
                          ":63",
              "launches": launches + single["launches"],
              "serve_launches": launches,
              "sharded_winner_serve_launches": sharded["serve_launches"],
              "installed_wheel_serve_launches":
                  wheel["fused_dense_launches"],
              "train_launches": single["launches"],
              "max_abs_err": max_err, "max_abs_err_bf16": max_err_bf16,
              "serve_max_abs_lean": max_lean,
              "train": dict(dense_train, **{k: v for k, v in single.items()
                                            if k != "launches"})},
             **dense),
        {"name": "mmae_train_step", "route": "cuda",
         "source": src + "train_kernel.cu",
         "replaces": "multimodalautoencoder_tpu/ops/train_kernel.py:274",
         "launches": train_launches, "max_abs_err": train_err,
         "split": split, "sharded_launches": sharded["launches"],
         "pipeline_launches": pipeline["launches"]["mmae_train_step"],
         "parity_band_launches": band["launches"],
         "ms": step["ms"], "plain_ms": step["plain_ms"],
         "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
         "library_ms": None,
         "bmm_ms": step["bmm_ms"], "launch_types": step["launch_types"],
         "per_launch": step["launches"]},
        {"name": "cls_train_step", "route": "cuda",
         "source": src + "cls_train_kernel.cu",
         "replaces": "multimodalautoencoder_tpu/ops/train_kernel.py:1439",
         "launches": cls_launches, "max_abs_err": cls_err,
         "sharded_launches": sharded_cls["launches"],
         "pipeline_launches": pipeline["launches"]["cls_train_step"],
         "ms": cls_step["ms"], "plain_ms": cls_step["plain_ms"],
         "bound_ms": cls_step["bound_ms"], "bound_by": cls_step["bound_by"],
         "library_ms": None,
         "bmm_ms": cls_step["bmm_ms"],
         "launch_types": cls_step["launch_types"],
         "per_launch": cls_step["launches"]},
        dict({"name": "philox_probe", "route": "cuda",
              "source": src + "train_kernel.cu",
              "replaces": "tests_tpu/test_hardware.py:28",
              "library_ms": None}, **probe),
        {"name": "mmae_deep_train_step", "route": "cuda",
         "source": src + "train_deep_kernel.cu",
         "replaces": "multimodalautoencoder_tpu/ops/train_kernel.py:589",
         "launches": deep_launches, "max_abs_err": deep_err,
         "ms": deep_step["ms"], "plain_ms": deep_step["plain_ms"],
         "bound_ms": deep_step["bound_ms"],
         "bound_by": deep_step["bound_by"], "library_ms": None,
         "bmm_ms": deep_step["bmm_ms"],
         "launch_types": deep_step["launch_types"],
         "per_launch": deep_step["launches"]},
        dict({"name": "hbm_stream", "route": "cuda",
              "source": src + "hbm_stream.cu",
              "replaces": "tools/hbm_bench.py:60"},
             **{k: v for k, v in stream.items() if k != "gb_per_s"}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
