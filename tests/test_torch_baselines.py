"""The port's comparison baselines (``baselines/``) against the JAX
package's, on the CPU at a small size:

- the metric battery ``_battery`` on the same predictions within 1e-6
  (both score in float32), for binary, sign and multi-label cases, and
  ``majority_class_predictions``' shapes;
- the SVM, RF and LR sweeps' ledgers on the same CSV, with numpy's global
  generator seeded the same way before each run (the random forest and
  liblinear draw from it): the same settings and columns, the same
  scores within 1e-6 (not 1e-12: both batteries score in float32, and the
  accuracy's mean is summed in another order, so it differs by up to a
  float32 rounding, 4.0e-8 measured; every other score is equal);
- the NN sweep's settings and columns, and its mean val_acc inside the
  spread of the JAX sweep's over 3 seeds (the two packages draw other
  random numbers);
- ``cli baseline`` for each model; a fit error degraded to majority-class
  predictions and counted, a device error propagated; and the error that
  names scikit-learn where it is missing."""

import functools
import os
import sys

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalautoencoder_tpu.baselines import common as jcommon
from multimodalautoencoder_tpu.baselines import (logistic_regression as jlr,
                                                 neural_net as jnn_sweep,
                                                 random_forest as jrf,
                                                 svm as jsvm)
from multimodalautoencoder_tpu.data.loader import DataLoader as JaxLoader
from multimodalautoencoder_tpu_torch import cli
from multimodalautoencoder_tpu_torch.baselines import (common,
                                                       logistic_regression,
                                                       neural_net,
                                                       random_forest, svm)
from multimodalautoencoder_tpu_torch.data import synthetic
from multimodalautoencoder_tpu_torch.data.loader import DataLoader

LABEL = "happy_label"
SMALL = {
    "svm": dict(c_vals=(1.0, 10.0), beta_vals=(0.01, 0.1)),
    "rf": dict(num_trees=(5,), criteria=("gini", "entropy"),
               max_depths=(None, 3), min_leafs=(1,)),
    "lr": dict(penalties=("l1", "l2"), c_vals=(0.1, 1.0)),
    "nn": dict(layer_sizes=((8, 4),), dropout_probs=(1.0,),
               weight_penalties=(0.0, 0.01), num_steps=150),
}


@pytest.fixture
def study(tmp_path):
    path = str(tmp_path / "b.csv")
    synthetic.make_frame(num_rows=150, seed=3,
                         label_names=(LABEL, "calm_label")).to_csv(path)
    return path


def loader_pair(path, wanted_label=LABEL, labels_to_sign=False):
    kw = dict(supervised=True, cross_validation=True,
              normalize_and_fill=True, fill_gaps_with=-1.0,
              suppress_output=True, wanted_label=wanted_label,
              labels_to_sign=labels_to_sign)
    return JaxLoader(path, **kw), DataLoader(path, **kw)


@pytest.mark.parametrize("case", ["binary", "sign", "multi", "degraded",
                                  "single_class"])
def test_battery_matches_jax(case):
    rng = np.random.default_rng(0)
    y = (rng.random(60) < 0.4).astype(float)
    preds = np.where(rng.random(60) < 0.8, y, 1 - y)
    if case == "sign":
        y, preds = 2 * y - 1, 2 * preds - 1
    elif case == "multi":
        y = (rng.random((60, 3)) < 0.5).astype(float)
        preds = np.where(rng.random((60, 3)) < 0.7, y, 1 - y)
    elif case == "degraded":
        y = (rng.random((60, 3)) < 0.5).astype(float)
    elif case == "single_class":
        y = np.ones(60)
    want = jcommon._battery(preds, y)
    got = common._battery(preds, y)
    assert list(got) == list(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_majority_class_predictions_match_jax():
    y1 = np.array([0, 1, 1, 1, 0])
    y2 = np.array([[0, 1], [1, 1], [0, 0], [0, 1]])
    for y, n in ((y1, 7), (y2, 3), (2 * y1 - 1, 4)):
        got = common.majority_class_predictions(y, n)
        want = jcommon.majority_class_predictions(y, n)
        np.testing.assert_array_equal(got, want)
        assert got.shape == ((n,) if y.ndim == 1 else (n, y.shape[1]))


@pytest.mark.parametrize("model", ["svm", "rf", "lr"])
def test_sklearn_sweep_ledgers_match_jax(model, study, tmp_path):
    jcls, pcls = {"svm": (jsvm.SVMSweep, svm.SVMSweep),
                  "rf": (jrf.RFSweep, random_forest.RFSweep),
                  "lr": (jlr.LRSweep, logistic_regression.LRSweep)}[model]
    jl, pl = loader_pair(study, labels_to_sign=model == "svm")
    rows = {}
    for side, cls, dl in (("jax", jcls, jl), ("port", pcls, pl)):
        np.random.seed(0)
        sweep = cls(dl, results_path=str(tmp_path / side), verbose=False,
                    num_cross_folds=3, check_test=True, wanted_label=LABEL,
                    **SMALL[model])
        best, test = sweep.run()
        rows[side] = (pd.read_csv(sweep.ledger.path, index_col=0), dict(best),
                      test)
    (jdf, jbest, jtest), (pdf, pbest, ptest) = rows["jax"], rows["port"]
    assert list(pdf.columns) == list(jdf.columns)
    assert len(pdf) == len(jdf)
    score_cols = [c for c in jdf.columns if "val_" in c]
    for c in jdf.columns:
        if c in score_cols:
            np.testing.assert_allclose(pdf[c], jdf[c], rtol=0, atol=1e-6,
                                       err_msg=c)
        else:
            assert list(map(str, pdf[c])) == list(map(str, jdf[c])), c
    assert str(pbest) and list(ptest) == list(jtest)
    for k in jtest:
        assert ptest[k] == pytest.approx(jtest[k], abs=1e-6), k


def test_nn_sweep_matches_jax_columns_and_score_spread(study, tmp_path):
    """600 steps a fit: at 150, a seed's mean val_acc varies over 0.70-0.91
    in the port and 0.82-0.88 in the JAX package (6 seeds each); at 600,
    over 0.916-0.947 and 0.916-0.959, so 3 JAX seeds span what the port
    reads."""
    jl, pl = loader_pair(study)
    grid = dict(SMALL["nn"], num_steps=600)
    port = neural_net.NNSweep(pl, results_path=str(tmp_path / "port"),
                              verbose=False, num_cross_folds=2, device="cpu",
                              wanted_label=LABEL, **grid)
    port.sweep_all_parameters()
    assert port.fit_errors == 0
    scores = []
    for seed in range(3):
        js = jnn_sweep.NNSweep(jl, results_path=str(tmp_path / f"j{seed}"),
                               verbose=False, num_cross_folds=2, seed=seed,
                               wanted_label=LABEL, **grid)
        js.sweep_all_parameters()
        jdf = pd.read_csv(js.ledger.path, index_col=0)
        scores.append(float(jdf["val_acc"].mean()))
    assert port.ledger.columns == list(jdf.columns)
    assert [r["weight_penalty"] for r in port.ledger.rows] == list(
        jdf["weight_penalty"])
    mean = np.mean([r["val_acc"] for r in port.ledger.rows])
    assert min(scores) <= mean <= max(scores), (mean, scores)


@pytest.mark.parametrize("model", ["svm", "rf", "lr", "nn"])
def test_cli_baseline_runs(model, study, tmp_path, monkeypatch, capsys):
    mod = {"svm": svm, "rf": random_forest, "lr": logistic_regression,
           "nn": neural_net}[model]
    name = {"svm": "SVMSweep", "rf": "RFSweep", "lr": "LRSweep",
            "nn": "NNSweep"}[model]
    monkeypatch.setattr(mod, name, functools.partial(
        getattr(mod, name), verbose=False, **SMALL[model]))
    out = str(tmp_path / "res")
    args = ["baseline", model, study, LABEL, "--normalize-and-fill",
            "--folds", "2", "--device", "cpu", "--results-path", out,
            "--check-test"]
    assert cli.main(args) == 0
    printed = capsys.readouterr().out
    assert "val_acc" in printed and "test_acc" in printed
    prefix = {"svm": "SVM", "rf": "RF", "lr": "LR", "nn": "NN"}[model]
    names = os.listdir(out)
    assert len(names) == 1 and names[0].startswith(f"{prefix}-b-")
    ledger = pd.read_csv(os.path.join(out, names[0]), index_col=0)
    assert np.isfinite(ledger["val_acc"]).all()


class _Failing(logistic_regression.LRSweep):
    def __init__(self, *a, error=None, **kw):
        self.error = error
        super().__init__(*a, **kw)

    def fit(self, setting, train_X, train_Y):
        raise self.error


def test_fit_errors_degrade_and_count_but_device_errors_propagate(
        study, tmp_path):
    _, pl = loader_pair(study)
    kw = dict(results_path=str(tmp_path / "r"), verbose=False,
              num_cross_folds=2, penalties=("l2",), c_vals=(1.0,))
    sweep = _Failing(pl, error=ValueError("bad fit"), **kw)
    sweep.sweep_all_parameters()
    assert sweep.fit_errors == 2
    majority = common.majority_class_predictions(pl.train_Y, len(pl.val_X))
    np.testing.assert_array_equal(
        sweep.train_and_predict({"penalty": "l2", "C": 1.0}), majority)
    for err in (torch.cuda.OutOfMemoryError("out of memory"),
                RuntimeError("CUDA error: an illegal memory access"),
                RuntimeError("fused_dense kernel launch failed: x (1)")):
        with pytest.raises(type(err)):
            _Failing(pl, error=err, **kw).sweep_all_parameters()


@pytest.mark.parametrize("model", ["svm", "rf", "lr"])
def test_missing_sklearn_is_named(model, study, tmp_path, monkeypatch):
    """Without scikit-learn the host baselines refuse to start, naming it,
    rather than degrade every fit to a majority vote."""
    _, pl = loader_pair(study)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    cls = {"svm": svm.SVMSweep, "rf": random_forest.RFSweep,
           "lr": logistic_regression.LRSweep}[model]
    with pytest.raises(ImportError, match="scikit-learn"):
        cls(pl, results_path=str(tmp_path / "r"))
    with pytest.raises(SystemExit, match="scikit-learn"):
        cli.main(["baseline", model, study, "--device", "cpu",
                  "--results-path", str(tmp_path / "c")])
    # the NN baseline runs on the device without it
    neural_net.NNSweep(pl, results_path=str(tmp_path / "n"), device="cpu")
