"""A sweep sharded over processes, end to end.

Counterpart of ``examples/multihost_sweep.py``.  Each worker process
trains a deterministic round-robin slice of the settings
(``process_shard``), writes its ledger shard and exports its slice
winner; the shards merge into one results CSV and the shard-tagged
checkpoints give the global winner (``parallel/multihost.py``).

Two modes:

- default: N workers run one after another, each told its shard;
- ``--distributed``: N concurrent workers join one ``torch.distributed``
  job on gloo (``multihost.initialize``), take their shard from their
  rank, meet at ``multihost.barrier()``, rank 0 merges the shards inside
  the job, and they leave it with ``multihost.shutdown()``.  They meet
  through a file in ``--out`` (no port to pick), or at rank 0's TCP store
  on ``--coordinator host:port``, as on several machines (port 0: rank 0
  takes a free port and writes it to that file).

Run from anywhere (the workers get the repository on ``PYTHONPATH``)::

    python -m multimodalautoencoder_tpu_torch.tools.multihost_sweep \\
        [--hosts 2] [--steps 300] [--distributed] [--classification] \\
        [--grid small|full] [--data study.csv] [--device cuda]

``--grid full`` is the sweep's default grid (108 MMAE settings, or 576
two-phase settings with ``--classification``); ``small`` a 2-setting
grid.  Without ``--data`` a synthetic 300-row study is written into
``--out``.  The last line reads ``merged N shards -> <ledger> (k
settings)`` once the merged ledger holds every setting once and the
global winner checkpoint matches its best row.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "multimodalautoencoder_tpu_torch.tools.multihost_sweep"

GRIDS = {
    "small": dict(layer_sizes=[[32, 8]], tie_weights=[True, False],
                  dropout_probs=[1.0], weight_penalties=[0.0],
                  activation_funcs=["relu"], test_variational=False),
    "full": {},
}
CLS_GRIDS = {
    "small": dict(mmae_layer_sizes=[[32, 8]],
                  classification_layer_sizes=[[8], [6, 4]],
                  tie_weights=[True], mmae_dropout_probs=[1.0],
                  mmae_weight_penalties=[0.0],
                  mmae_activation_funcs=["relu"],
                  mmae_test_variational=[False], weight_penalties=[0.0],
                  dropout_probs=[1.0], activation_funcs=["relu"]),
    "full": {},
}


def _sweep(args, idx: int, count: int):
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.sweep import wrappers

    kw = dict(cross_validation=True, normalize_and_fill=True,
              fill_gaps_with=-1.0, suppress_output=True, engine=args.engine)
    unsup = DataLoader(args.data, supervised=False, **kw)
    common = dict(results_path=args.out, cont=False,
                  num_cross_folds=args.folds, verbose=False,
                  process_shard=(idx, count), save_best_params=True,
                  device=args.device.split(","), seed=args.seed)
    if args.classification:
        sup = DataLoader(args.data, supervised=True, **kw)
        sweep = wrappers.MMAEClassificationSweep(
            unsup, sup, mmae_num_steps=args.steps,
            classification_num_steps=args.steps, **common,
            **CLS_GRIDS[args.grid])
    else:
        sweep = wrappers.MMAESweep(unsup, probe=None, num_steps=args.steps,
                                   **common, **GRIDS[args.grid])
    sweep.sweep_all_parameters()
    return sweep


def _prefix(args) -> str:
    from multimodalautoencoder_tpu_torch.sweep import engine

    return engine.get_save_prefix(
        args.out, "MMAE_NN_classifier" if args.classification else "MMAE",
        os.path.basename(args.data), replace=True)


def rendezvous_file(out: str) -> str:
    """Where the workers of ``--distributed`` meet without a coordinator,
    or find the port of ``--coordinator host:0``."""
    return os.path.join(out, "rendezvous")


def worker(args) -> None:
    """One process: train this process's slice.  With ``--distributed``
    the shard comes from the distributed job's rank."""
    from multimodalautoencoder_tpu_torch.parallel import multihost

    if args.distributed:
        idx, count = multihost.initialize(
            coordinator_address=args.coordinator or None,
            num_processes=args.hosts, process_id=args.process_id,
            rendezvous_file=rendezvous_file(args.out))
        if (idx, count) != (args.process_id, args.hosts):
            raise SystemExit(f"joined as {idx} of {count}, expected "
                             f"{args.process_id} of {args.hosts}")
    else:
        idx, count = args.process_id, args.hosts
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels, \
        train_deep_kernels, train_kernels

    t0 = time.perf_counter()
    sweep = _sweep(args, idx, count)
    print(json.dumps({"host": idx, "settings_trained": len(sweep.ledger),
                      "wall_s": time.perf_counter() - t0,
                      "launches": {
                          "train": train_kernels.KERNELS.launches,
                          "deep": train_deep_kernels.KERNELS.launches,
                          "cls": cls_train_kernels.KERNELS.launches}}),
          flush=True)
    if args.distributed:
        # every shard on disk before the merge
        multihost.barrier("ledger_shards_written")
        if idx == 0:
            merged = multihost.merge_ledger_shards(args.out, _prefix(args),
                                                   num_shards=count)
            print(json.dumps({"merged": merged}), flush=True)
        multihost.shutdown()


def main(args) -> None:
    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.parallel import multihost
    from multimodalautoencoder_tpu_torch.sweep import engine
    from multimodalautoencoder_tpu_torch.train.checkpoint import \
        checkpoint_meta

    os.makedirs(args.out, exist_ok=True)
    if not args.data:
        args.data = synthetic.write_csv(
            os.path.join(args.out, "data.csv"), num_rows=300, seed=11,
            label_names=("happy_label", "health_label"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    base = [sys.executable, "-m", MODULE, "--worker", "--hosts",
            str(args.hosts), "--steps", str(args.steps), "--out", args.out,
            "--data", args.data, "--grid", args.grid, "--folds",
            str(args.folds), "--device", args.device, "--engine",
            args.engine, "--seed", str(args.seed)] \
        + (["--classification"] if args.classification else [])
    t0 = time.perf_counter()
    if args.distributed:
        if args.coordinator:
            base += ["--coordinator", args.coordinator]
        if os.path.exists(rendezvous_file(args.out)):
            os.remove(rendezvous_file(args.out))   # an ended job's
        procs = [subprocess.Popen(
            base + ["--process-id", str(i), "--distributed"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i in range(args.hosts)]
        try:
            outs = [p.communicate(timeout=args.timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = []
        for i, (p, (out, err)) in enumerate(zip(procs, outs)):
            sys.stdout.write(out)
            if p.returncode:
                sys.stderr.write(f"-- worker {i}:\n{err}")
                failed.append(f"worker {i} failed ({p.returncode})")
        if failed:
            raise SystemExit("; ".join(failed))
    else:
        for i in range(args.hosts):
            r = subprocess.run(base + ["--process-id", str(i)],
                               capture_output=True, text=True, env=env,
                               timeout=args.timeout)
            sys.stdout.write(r.stdout)
            if r.returncode:
                sys.stderr.write(r.stderr)
                raise SystemExit(f"worker {i} failed ({r.returncode})")
    wall = time.perf_counter() - t0

    prefix = _prefix(args)
    if args.distributed:
        merged = os.path.join(args.out, prefix + ".csv")
        if not os.path.exists(merged):
            raise SystemExit(f"rank 0 wrote no merged ledger {merged}")
    else:
        merged = multihost.merge_ledger_shards(args.out, prefix,
                                               num_shards=args.hosts)
    ledger = engine.ResultsLedger(args.out, prefix, cont=True)
    grid = [c for c in ledger.columns if not c.startswith(
        ("val_", "noisy_", "clean_", "svm_", "time_", "backend_",
         "inst_steps"))]
    keys = [tuple(str(r[c]) for c in grid) for r in ledger.rows]
    if len(set(keys)) != len(keys):
        raise SystemExit("the merged ledger repeats a setting")
    metric, min_or_max, name = (("val_acc", "max", "best_mmae_cls")
                                if args.classification else
                                ("val_sigmoid_cross_entropy", "min",
                                 "best_mmae"))
    best = ledger.find_best_setting(metric, min_or_max)
    win = multihost.select_global_best_checkpoint(args.out, name,
                                                  num_shards=args.hosts)
    score = checkpoint_meta(win)["extra"]["score"]
    if abs(float(score) - engine.as_float(best[metric])) > 1e-6:
        raise SystemExit(f"the global winner {win} scores {score}, the "
                         f"merged ledger's best {best[metric]}")
    print(json.dumps({"wall_s": wall, "winner": win, "score": score}))
    print(f"merged {args.hosts} shards -> {merged} ({len(ledger)} "
          "settings)", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--folds", type=int, default=2)
    ap.add_argument("--grid", choices=sorted(GRIDS), default="small")
    ap.add_argument("--out", default="multihost_sweep_out")
    ap.add_argument("--data", default="",
                    help="the study CSV (default: a synthetic study "
                         "written into --out)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (or comma-separated devices) each "
                         "worker trains on")
    ap.add_argument("--engine", choices=("pandas", "native"),
                    default="pandas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds to wait for the workers")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="concurrent workers in one torch.distributed job "
                         "(gloo)")
    ap.add_argument("--classification", action="store_true",
                    help="shard the two-phase classification sweep")
    ap.add_argument("--coordinator", default="",
                    help="host:port of rank 0's TCP store with "
                         "--distributed; port 0: rank 0 takes a free port "
                         "and writes it to a file in --out (default: the "
                         "workers meet through a file in --out)")
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)
    if args.data:
        args.data = os.path.abspath(args.data)
    return args


if __name__ == "__main__":
    a = parse_args()
    worker(a) if a.worker else main(a)
