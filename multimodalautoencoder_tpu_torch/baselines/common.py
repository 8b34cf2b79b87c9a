"""The comparison baselines' shared template.

Counterpart of ``multimodalautoencoder_tpu/baselines/common.py``.  The
reference's four baselines (SVM, RF, LR, NN) follow its
ClassificationWrapper template (generic_wrapper.py:371-547,
comparison_algorithms/*): per setting, loop the CV folds, fit a fresh
estimator on the fold's train split, predict val, and score the
acc/AUC/F1/precision/recall battery, with separate noisy/clean-data
scores; nanmean across folds.  A fit or prediction that raises degrades
to majority-class predictions (svm.py:98-103), and the sweep counts each
such event in ``fit_errors``.  An error of the device (out of memory, a
failed kernel launch, any CUDA error) is no fit error: it propagates.

The sweep stays serial per setting, the reference's shape
(``engine.SerialSweep``).  The metric battery runs on the port's
``ops/metrics.all_classification_metrics`` with CPU tensors: these sweeps
score host predictions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.ops import metrics as metrics_lib
from multimodalautoencoder_tpu_torch.sweep import engine


def require_sklearn(what: str):
    """Import scikit-learn for ``what``, or raise an ImportError that names
    it: the port does not depend on it, and a missing estimator must not
    turn every fit into a majority vote."""
    try:
        import sklearn
    except ImportError as e:
        raise ImportError(
            f"{what} needs scikit-learn, which is not installed; the "
            "port's device paths (the NN baseline, feature-select --backend "
            "jax, probe='device') run without it") from e
    return sklearn


def is_device_error(e: BaseException) -> bool:
    """An error of the device rather than of a fit: CUDA out of memory,
    a CUDA or accelerator error, or a failed launch of a port kernel."""
    accelerator = getattr(torch, "AcceleratorError", None)
    if isinstance(e, torch.cuda.OutOfMemoryError) or (
            accelerator is not None and isinstance(e, accelerator)):
        return True
    text = str(e)
    return isinstance(e, RuntimeError) and (
        "CUDA" in text or "kernel launch failed" in text)


def majority_class_predictions(train_y: np.ndarray, n: int) -> np.ndarray:
    """Most-frequent-class fallback (comparison_algorithms/svm.py:98-103,
    which uses sign(mean) for {-1,1} labels, generalised to the mode).
    Multi-label ``train_y`` gives a per-column mode of matching width."""
    train_y = np.asarray(train_y)
    if train_y.ndim > 1:
        return np.stack([majority_class_predictions(train_y[:, c], n)
                         for c in range(train_y.shape[1])], axis=1)
    vals, counts = np.unique(train_y, return_counts=True)
    return np.full(n, vals[np.argmax(counts)])


def _battery(preds, y) -> Dict[str, float]:
    """The metric battery of one prediction vector (or matrix) against its
    labels, as floats."""
    preds = np.asarray(preds, dtype=float)
    y = np.asarray(y, dtype=float)
    if y.ndim > 1:  # multi-label: each (row, label) cell is a sample
        if preds.ndim == 1:
            # degraded predictions narrower than the label matrix: score
            # what aligns rather than fail the whole sweep
            y = y[:, 0]
        else:
            preds = preds.reshape(-1)
            y = y.reshape(-1)
    # sign labels {-1, 1} -> {0, 1} for the battery
    if (y < 0).any():
        y = (y > 0).astype(float)
        preds = (preds > 0).astype(float)
    m = metrics_lib.all_classification_metrics(
        torch.as_tensor(preds, dtype=torch.float32),
        torch.as_tensor(y, dtype=torch.float32))
    return {k: float(v) for k, v in m.items()}


class ClassificationBaselineSweep(engine.SerialSweep):
    """Serial CV sweep over a fit/predict estimator.

    Subclasses implement :meth:`define_params`, :meth:`fit` and
    :meth:`predict_model`.
    """

    def __init__(self, data_loader, results_path: str = "results",
                 classifier_name: str = "CLF",
                 wanted_label: Optional[str] = None,
                 num_cross_folds: int = 5, check_noisy_data: bool = True,
                 cont: bool = False, check_test: bool = False,
                 optimize_for: str = "val_acc", min_or_max: str = "max",
                 save_results_every_nth: int = 1, verbose: bool = True):
        self.data_loader = data_loader
        self.num_cross_folds = num_cross_folds
        # the reference ties these together (svm.py:56-64); a loader
        # without the noisy/clean split has no noisy_val_X to score
        self.check_noisy_data = (check_noisy_data and
                                 getattr(data_loader,
                                         "separate_noisy_data", True))
        self.model = None
        self.fit_errors = 0   # fits and predictions degraded to majority
        prefix = engine.get_save_prefix(
            results_path, classifier_name,
            getattr(data_loader, "filename", "data.csv"),
            wanted_label=wanted_label, replace=cont)
        super().__init__(results_path, prefix, optimize_for, min_or_max,
                         cont=cont, check_test=check_test,
                         save_results_every_nth=save_results_every_nth,
                         verbose=verbose)

    # model hooks ---------------------------------------------------------
    def fit(self, setting: Dict[str, Any], train_X, train_Y):
        raise NotImplementedError

    def predict_model(self, model, X) -> np.ndarray:
        raise NotImplementedError

    # template ------------------------------------------------------------
    def predict_on_data(self, X) -> np.ndarray:
        """Predict, degrading to the majority class on failure
        (svm.py:90-103)."""
        if self.model is not None:
            try:
                return np.asarray(self.predict_model(self.model, X))
            except Exception as e:
                if is_device_error(e):
                    raise
                self.fit_errors += 1
                if self.verbose:
                    print("predict error:", repr(e))
        return majority_class_predictions(self.data_loader.train_Y, len(X))

    def train_and_predict(self, setting: Dict[str, Any],
                          predict_on: str = "val") -> np.ndarray:
        dl = self.data_loader
        try:
            self.model = self.fit(setting, dl.train_X, dl.train_Y)
        except Exception as e:
            if is_device_error(e):
                raise
            self.fit_errors += 1
            if self.verbose:
                print("fit error:", repr(e))
            self.model = None
        X = dl.test_X if predict_on == "test" else dl.val_X
        return self.predict_on_data(X)

    def get_cross_validation_results(self, setting: Dict[str, Any]
                                     ) -> Dict[str, Any]:
        """Per-fold metric battery and noisy/clean slices
        (generic_wrapper.py:433-497)."""
        dl = self.data_loader
        cols: Dict[str, list] = {k: [] for k in
                                 ("acc", "auc", "f1", "precision",
                                  "recall")}
        noisy = {"acc": [], "auc": []}
        clean = {"acc": [], "auc": []}
        for f in range(self.num_cross_folds):
            dl.set_to_cross_validation_fold(f)
            preds = self.train_and_predict(setting)
            if preds is None or dl.val_Y is None:
                continue
            m = _battery(preds, dl.val_Y)
            for k in cols:
                cols[k].append(m[k])
            if self.check_noisy_data:
                for part, X, Y in ((noisy, dl.noisy_val_X, dl.noisy_val_Y),
                                   (clean, dl.clean_val_X, dl.clean_val_Y)):
                    if len(X):
                        mp = _battery(self.predict_on_data(X), Y)
                        part["acc"].append(mp["acc"])
                        part["auc"].append(mp["auc"])
        row = dict(setting)
        for k in cols:
            row[f"val_{k}"] = engine.nanmean(cols[k]) if cols[k] else \
                float("nan")
        if self.check_noisy_data:
            for name, part in (("noisy", noisy), ("clean", clean)):
                for k in ("acc", "auc"):
                    row[f"{name}_val_{k}"] = engine.nanmean(part[k]) \
                        if part[k] else float("nan")
        return row

    def test_on_test(self, setting: Dict[str, Any]) -> Dict[str, float]:
        """Held-out evaluation of the best setting
        (generic_wrapper.py:514-547): fit on fold 0's train split, the
        full battery on test (and its noisy/clean slices)."""
        dl = self.data_loader
        dl.set_to_cross_validation_fold(0)
        preds = self.train_and_predict(setting, predict_on="test")
        out = {f"test_{k}": v
               for k, v in _battery(preds, dl.test_Y).items()}
        if self.check_noisy_data:
            for name, X, Y in (("noisy", dl.noisy_test_X, dl.noisy_test_Y),
                               ("clean", dl.clean_test_X, dl.clean_test_Y)):
                if len(X):
                    m = _battery(self.predict_on_data(X), Y)
                    out.update({f"{name}_test_acc": m["acc"],
                                f"{name}_test_auc": m["auc"]})
        return out
