"""Probe selection parity: does the on-device ridge probe rank settings as
the reference's SVM probe does?

Counterpart of ``multimodalautoencoder_tpu/sweep/probe_parity.py``.  The
MMAE sweep's ``svm_val_acc`` / ``svm_val_auc`` columns drive the choice
of the best embedding (autoencoder_wrapper.py:272-284, :384-385).  The
reference computes them with host libsvm SVCs; the
sweep's default, with the on-device random-Fourier ridge probe
(``sweep/probe.py``).  What matters for model selection is that both
order the settings alike and pick the same (or an equivalent) winner, so
:func:`measure_probe_agreement` runs one reduced-scale sweep once per
probe, with the same data, settings and seed, and :func:`ranking_agreement`
compares the per-setting probe columns: the Spearman rank correlation,
each winner's rank under the other probe, and the score the device
probe's winner loses under the SVM probe.
:func:`measure_probe_agreement_at_scale` makes the comparison at the
reference's scale, both probes scoring each bucket's same trained
parameters.  scipy and scikit-learn are imported at first use; without
scikit-learn the SVM probe raises an ImportError that names it.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from multimodalautoencoder_tpu_torch.sweep import engine

SETTING_COLS = ("architecture", "tie_weights", "dropout_prob",
                "weight_penalty", "weight_initialization",
                "activation_function", "variational")
PROBE_COLS = ("svm_val_acc", "svm_val_auc")


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (average ranks for ties)."""
    from scipy import stats

    return float(stats.spearmanr(a, b).statistic)


def _run_sweep(probe: str, loaders, workdir: str, *, num_steps: int,
               folds: int, seed: int, layer_sizes, test_variational: bool,
               backend: str, device) -> List[Dict]:
    from multimodalautoencoder_tpu_torch.sweep.wrappers import MMAESweep

    unsup, sup = loaders
    sweep = MMAESweep(
        unsup, sup, layer_sizes=layer_sizes, dropout_probs=(1.0, 0.5),
        weight_penalties=(0.0, 0.01), activation_funcs=("relu",),
        test_variational=test_variational,
        results_path=os.path.join(workdir, f"results_{probe}"),
        num_steps=num_steps, num_cross_folds=folds, probe=probe, seed=seed,
        verbose=False, backend=backend, device=device)
    sweep.run()
    return sweep.ledger.rows


def measure_probe_agreement(num_steps: int = 600, folds: int = 2,
                            seed: int = 0,
                            layer_sizes=((48, 12), (24, 12)),
                            test_variational: bool = True,
                            num_rows: int = 500, backend: str = "xla",
                            workdir: Optional[str] = None,
                            device="cuda") -> Dict[str, dict]:
    """The same reduced-scale MMAE sweep with ``probe='svm'`` and
    ``probe='device'`` on ``device``, and their ranking agreement
    (:func:`ranking_agreement`)."""
    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader

    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="probe_parity_")
    try:
        path = synthetic.write_csv(
            os.path.join(workdir, "probe_parity.csv"), num_rows=num_rows,
            seed=seed,
            modalities=(("call", 30), ("location", 30), ("screen", 30),
                        ("sms", 30), ("survey", 30)),
            label_names=("happiness_label", "health_label",
                         "calmness_label"))
        kw = dict(cross_validation=True, suppress_output=True,
                  normalize_and_fill=True, fill_gaps_with=-1.0)
        loaders = (DataLoader(path, supervised=False, **kw),
                   DataLoader(path, supervised=True, **kw))
        run = dict(num_steps=num_steps, folds=folds, seed=seed,
                   layer_sizes=layer_sizes,
                   test_variational=test_variational, backend=backend,
                   device=device)
        svm_rows = _run_sweep("svm", loaders, workdir, **run)
        dev_rows = _run_sweep("device", loaders, workdir, **run)
        return ranking_agreement(svm_rows, dev_rows)
    finally:
        if own_tmp:
            shutil.rmtree(workdir, ignore_errors=True)


def ranking_agreement(svm_rows: List[Dict],
                      dev_rows: List[Dict]) -> Dict[str, dict]:
    """Per probe column, the ranking agreement of two probes' ledger rows
    of the same settings, joined on the settings: ``{column: {"spearman",
    "n_settings", "best_svm_rank_in_device", "best_device_rank_in_svm",
    "winner_rel_gap"}}``.  ``winner_rel_gap`` is the SVM-probe score lost
    by selecting the device probe's winner, relative to the SVM probe's
    own winner's score (0: the same or an equivalent winner)."""
    def key(row):
        return tuple(str(row[c]) for c in SETTING_COLS if c in row)

    dev_by_key = {key(r): r for r in dev_rows}
    pairs = [(r, dev_by_key[key(r)]) for r in svm_rows
             if key(r) in dev_by_key]
    assert len(pairs) == len(svm_rows) == len(dev_rows), (
        len(pairs), len(svm_rows), len(dev_rows))
    out = {}
    for col in PROBE_COLS:
        s = np.array([engine.as_float(a[col]) for a, _ in pairs])
        d = np.array([engine.as_float(b[col]) for _, b in pairs])
        # ranks: 0 is the best (highest) score
        svm_order = np.argsort(-s, kind="stable")
        dev_order = np.argsort(-d, kind="stable")
        svm_rank = np.empty(len(s), int)
        svm_rank[svm_order] = np.arange(len(s))
        dev_rank = np.empty(len(d), int)
        dev_rank[dev_order] = np.arange(len(d))
        best_svm, best_dev = int(svm_order[0]), int(dev_order[0])
        out[col] = {
            "spearman": spearman(s, d),
            "n_settings": int(len(s)),
            "best_svm_rank_in_device": int(dev_rank[best_svm]),
            "best_device_rank_in_svm": int(svm_rank[best_dev]),
            "winner_rel_gap": float((s[best_svm] - s[best_dev])
                                    / max(abs(s[best_svm]), 1e-12)),
        }
    return out


def measure_probe_agreement_at_scale(
        num_steps: int = 15000, folds: int = 5, seed: int = 0,
        backend: str = "auto", workdir: Optional[str] = None,
        num_rows: int = 2000, partial_out: Optional[str] = None,
        device="cuda",
        layer_sizes=((1000, 100), (500, 100), (300, 100))
) -> Dict[str, dict]:
    """Probe agreement at the reference's scale: the 108-setting MMAE grid
    (``layer_sizes`` and the VAE augmentation, autoencoder_wrapper.py
    :127-136) trained ``num_steps`` steps on the reference-scale study
    (``synthetic.reference_scale_loaders``), each bucket trained once on
    ``device`` and scored by both probes on the same parameters, so any
    disagreement is the probes' alone.  Buckets run widest architecture
    first; ``partial_out`` receives the agreement so far after every
    bucket, tagged with its coverage (``partial=True`` until the last).
    The host SVC grid costs 108 settings x ``folds`` x 3 labels x 6 fits,
    about quadratic in ``num_rows``.  Returns :func:`ranking_agreement`'s
    dict with a ``_coverage`` entry."""
    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.sweep import grid as grid_lib
    from multimodalautoencoder_tpu_torch.sweep.wrappers import MMAESweep

    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="probe_parity_scale_")
    os.makedirs(workdir, exist_ok=True)
    try:
        unsup, sup = synthetic.reference_scale_loaders(
            workdir, num_rows=num_rows, seed=seed)
        sweep = MMAESweep(unsup, sup, layer_sizes=layer_sizes, probe="svm",
                          results_path=os.path.join(workdir, "res"),
                          num_steps=num_steps, num_cross_folds=folds,
                          seed=seed, backend=backend, verbose=False,
                          device=device)
        buckets = sorted(grid_lib.bucket_settings(
            sweep.list_of_param_settings),
            key=lambda kb: -int(kb[1][0]["architecture"][0]))
        if not buckets:
            raise ValueError("the probe-parity grid has no shape buckets")
        svm_rows, dev_rows, settings = [], [], []

        def joined(rows):
            return [{**s, **r} for s, r in zip(settings, rows)]

        for bi, (_, bucket) in enumerate(buckets):
            t0 = time.time()
            cfg = sweep._cfg_for_bucket(bucket[0])
            hyper = gt.HyperStack.from_settings(bucket, cfg, sweep.tcfg)
            params, losses = gt.train_grid_sharded(
                sweep.devices, cls_train_kernels.derive_seed(seed, 0, bi),
                cfg, sweep.tcfg, sweep.spec, hyper, sweep.folded,
                backend=backend)
            losses.cpu()                # wait for the training
            t1 = time.time()
            dev = sweep._device_probe_rows(sweep._device_probe_launch(
                params, cfg, hyper, len(bucket),
                cls_train_kernels.derive_seed(seed, 3, bi)), len(bucket))
            t2 = time.time()
            svm = sweep._svm_probe_bucket(params, cfg, hyper, len(bucket))
            print(f"bucket {bi + 1}/{len(buckets)} (arch "
                  f"{bucket[0]['architecture']}, {len(bucket)} settings): "
                  f"train {t1 - t0:.1f} s, device probe {t2 - t1:.1f} s, "
                  f"svm probe {time.time() - t2:.1f} s", flush=True)
            settings += [dict(s) for s in bucket]
            svm_rows += svm
            dev_rows += dev
            coverage = {
                "partial": bi + 1 < len(buckets),
                "buckets_done": bi + 1, "buckets_total": len(buckets),
                "settings_done": len(settings),
                "settings_total": sweep.num_settings,
                "num_steps": num_steps, "folds": folds,
                "num_rows": num_rows}
            out = ranking_agreement(joined(svm_rows), joined(dev_rows))
            out["_coverage"] = coverage
            if partial_out:
                with open(partial_out, "w") as f:
                    json.dump(out, f, indent=2)
        return out
    finally:
        if own_tmp:
            shutil.rmtree(workdir, ignore_errors=True)
