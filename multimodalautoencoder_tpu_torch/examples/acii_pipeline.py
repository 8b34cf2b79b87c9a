"""End-to-end ACII-2017 pipeline on synthetic data, on one torch device.

Counterpart of ``examples/acii_pipeline.py``, step for step, with its
arguments, grids and printed sections.  It reproduces the reference's
workflow (jobs_to_run.txt:1-11) at demo scale:

1. the MMAE hyperparameter sweep with the embedding-quality probe
   (``probe="device"``: the training kernel on a GPU);
2. the two-phase MMAE + classification-head sweep (the phase-2 kernel);
3. the best MMAE trained alone, its per-modality RMSE, a file's missing
   modalities filled (``fill_missing_data_in_file``), and a classifier on
   the repaired data: the reference's SVM (``--baseline svm``, the JAX
   demo's, scikit-learn on the host) or one setting of the NN baseline on
   the device (``--baseline nn``).

Run::

    python -m multimodalautoencoder_tpu_torch.examples.acii_pipeline \\
        [--steps N] [--rows N] [--folds N] [--out DIR] \\
        [--device cuda|cpu] [--baseline svm|nn]

``--device`` (default ``cuda``) is where everything trains; nothing falls
back to another device.  ``--baseline svm`` needs scikit-learn and raises
an ImportError that names it where it is missing.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

LABELS = ("happy_label", "health_label", "calm_label")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--rows", type=int, default=400)
    ap.add_argument("--folds", type=int, default=2)
    ap.add_argument("--out", default="acii_demo_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device everything trains on")
    ap.add_argument("--baseline", choices=("svm", "nn"), default="svm",
                    help="the classifier on the repaired file")
    return ap.parse_args(argv)


def printed_numbers(text: str) -> list:
    """Every decimal number (and nan / inf) in ``text``, paths aside: the
    metrics a run printed, for checking that they are finite."""
    return [float(x) for x in re.findall(
        r"(?<![\w/.-])(-?\d+\.\d+|-?nan|-?inf)(?![\w/.-])", text)]


def best_arch(best):
    a = best["architecture"]
    return ast.literal_eval(a) if isinstance(a, str) else a


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the pipeline; returns what it printed as numbers, the files it
    wrote and each step's wall seconds."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here")
    os.makedirs(args.out, exist_ok=True)

    from multimodalautoencoder_tpu_torch.api import MultimodalAutoencoder
    from multimodalautoencoder_tpu_torch.baselines import neural_net, svm
    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader
    from multimodalautoencoder_tpu_torch.sweep import engine
    from multimodalautoencoder_tpu_torch.sweep.wrappers import (
        MMAEClassificationSweep, MMAESweep)

    results = os.path.join(args.out, "results")
    seconds: Dict[str, float] = {}
    out: Dict = {"seconds": seconds}
    t0 = time.perf_counter()

    csv = synthetic.write_csv(os.path.join(args.out, "wearables.csv"),
                              num_rows=args.rows, seed=0,
                              label_names=LABELS)
    print(f"== synthetic dataset: {csv}")
    unsup = DataLoader(csv, supervised=False, cross_validation=True,
                       suppress_output=True, normalize_and_fill=True,
                       fill_gaps_with=-1.0)
    sup = DataLoader(csv, supervised=True, cross_validation=True,
                     suppress_output=True, normalize_and_fill=True,
                     fill_gaps_with=-1.0)
    out["csv"] = csv
    seconds["data"] = time.perf_counter() - t0

    print("\n== 1. MMAE grid search (config-parallel) ==")
    t = time.perf_counter()
    sweep = MMAESweep(
        unsup, classification_data_loader=sup,
        layer_sizes=[[24, 8], [16, 8]], tie_weights=[True, False],
        dropout_probs=[1.0, 0.5], weight_penalties=[0.0],
        activation_funcs=["softsign"], test_variational=True,
        results_path=results, num_steps=args.steps,
        num_cross_folds=args.folds, labels_to_predict=list(sup.wanted_labels),
        svm_Cs=[1.0], svm_gammas=[0.01], save_best_params=True,
        verbose=False, device=device)
    best, _, extras = sweep.run()
    out["mmae_ledger"] = sweep.ledger.path
    out["settings"] = len(sweep.ledger)
    out["best_loss"] = engine.as_float(best["val_sigmoid_cross_entropy"])
    print(f"settings tested: {len(sweep.ledger)}; "
          f"best noisy-val loss: {out['best_loss']:.4f} "
          f"(arch {best['architecture']}, tied {best['tie_weights']})")
    if "svm_val_acc" in extras:
        out["probe_acc"] = engine.as_float(
            extras["svm_val_acc"]["svm_val_acc"])
        print(f"best embedding probe acc: {out['probe_acc']:.3f}")
    seconds["mmae_sweep"] = time.perf_counter() - t

    print("\n== 2. Two-phase MMAE + classifier sweep ==")
    t = time.perf_counter()
    cls_sweep = MMAEClassificationSweep(
        unsup, sup,
        mmae_layer_sizes=[[16, 8]], classification_layer_sizes=[[8]],
        tie_weights=[True], mmae_dropout_probs=[1.0],
        mmae_weight_penalties=[0.0], mmae_activation_funcs=["relu"],
        mmae_test_variational=[False], weight_penalties=[0.0],
        dropout_probs=[1.0, 0.5], activation_funcs=["relu"],
        mmae_num_steps=args.steps, classification_num_steps=args.steps,
        results_path=results, num_cross_folds=args.folds, verbose=False,
        device=device)
    cls = cls_sweep.run()["val_acc"]
    out["cls_ledger"] = cls_sweep.ledger.path
    out["cls_val_acc"] = engine.as_float(cls["val_acc"])
    out["cls_noisy_val_acc"] = engine.as_float(cls.get("noisy_val_acc"))
    out["cls_clean_val_acc"] = engine.as_float(cls.get("clean_val_acc"))
    print(f"best val_acc: {out['cls_val_acc']:.3f} "
          f"(noisy {out['cls_noisy_val_acc']:.3f} / "
          f"clean {out['cls_clean_val_acc']:.3f})")
    seconds["cls_sweep"] = time.perf_counter() - t

    name = args.baseline.upper()
    print(f"\n== 3. Train best MMAE -> repair missing data -> {name} ==")
    t = time.perf_counter()
    model = MultimodalAutoencoder(
        data_loader=unsup, layer_sizes=list(best_arch(best)),
        variational=bool(best["variational"]),
        tie_weights=bool(best["tie_weights"]), learning_rate=1e-3,
        batch_size=20, verbose=False,
        checkpoint_dir=os.path.join(args.out, "ckpt"), device=device)
    model.train(num_steps=args.steps,
                record_every_nth=max(args.steps // 4, 1))
    rms = model.get_reconstruction_loss_per_modality(unsup.val_X)
    out["rmse"] = {n: float(r) for n, r in zip(unsup.modality_names, rms)}
    print("per-modality masked RMSE:",
          {n: round(r, 3) for n, r in out["rmse"].items()})
    seconds["train_best"] = time.perf_counter() - t
    t = time.perf_counter()
    filled = model.fill_missing_data_in_file(os.path.basename(csv),
                                             path=os.path.dirname(csv))
    out["filled"] = filled
    print("repaired file:", filled)
    seconds["fill"] = time.perf_counter() - t

    t = time.perf_counter()
    repaired = DataLoader(filled, supervised=True, cross_validation=True,
                          suppress_output=True, normalize_and_fill=True,
                          wanted_label="happy_label",
                          labels_to_sign=args.baseline == "svm",
                          persist_cv_folds=False)
    common = dict(results_path=results, wanted_label="happy_label",
                  num_cross_folds=args.folds, verbose=False)
    if args.baseline == "svm":
        baseline = svm.SVMSweep(repaired, c_vals=[1.0], beta_vals=[0.01],
                                kernels=["rbf"], **common)
    else:
        smallest = min(neural_net.DEFAULT_ARCHS, key=sum)
        baseline = neural_net.NNSweep(
            repaired, layer_sizes=[smallest],
            dropout_probs=neural_net.DEFAULT_DROPOUTS[:1],
            weight_penalties=neural_net.DEFAULT_PENALTIES[:1],
            num_steps=args.steps, device=device, **common)
    baseline.sweep_all_parameters()
    out["baseline_ledger"] = baseline.ledger.path
    out["baseline_val_acc"] = float(np.nanmax(
        [engine.as_float(v) for v in baseline.ledger.column("val_acc")]))
    print(f"{name} on MMAE-repaired data: val_acc "
          f"{out['baseline_val_acc']:.3f}")
    seconds["baseline"] = time.perf_counter() - t
    seconds["total"] = time.perf_counter() - t0
    print("\ndone; artifacts in", args.out)
    return out


if __name__ == "__main__":
    main()
