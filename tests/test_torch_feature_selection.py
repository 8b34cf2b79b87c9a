"""The port's feature selection (``data/feature_selection.py``) against
the JAX package's ``create_transformed_dataset`` on the same CSV, both
outputs re-read numerically:

- PCA, backend 'sklearn': the same columns and values within 1e-9 (the
  same scikit-learn on the same floats);
- PCA, backend 'jax' (the port's float64 torch SVD on the CPU here, XLA's
  float32 one in the JAX package): the same columns, each component's
  values within 1e-4 of the JAX package's up to its sign;
- SelectKBest, both backends: the same columns and values, exactly;
- the on-device PCA against a float64 SVD on the card (``cuda``)."""

import os
import sys

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalautoencoder_tpu.data import feature_selection as jfs
from multimodalautoencoder_tpu_torch import cli
from multimodalautoencoder_tpu_torch.data import feature_selection as fs
from multimodalautoencoder_tpu_torch.data import synthetic

LABEL = "happy_label"


@pytest.fixture
def study(tmp_path):
    path = str(tmp_path / "f.csv")
    synthetic.make_frame(num_rows=120, seed=6,
                         label_names=(LABEL, "calm_label")).to_csv(path)
    return path


def run_both(path, tmp_path, transform, backend, **kw):
    out = {}
    for side, fn in (("jax", jfs.create_transformed_dataset),
                     ("port", fs.create_transformed_dataset)):
        extra = dict(device="cpu") if side == "port" else {}
        written = fn(path, transform, 6, backend=backend, fill_missing=0.0,
                     out_path=str(tmp_path / f"{side}.csv"), verbose=False,
                     **kw, **extra)
        out[side] = pd.read_csv(written, index_col=0)
    return out["jax"], out["port"]


def dims(df, transform):
    return [c for c in df.columns if c.startswith(f"{transform}_dim")]


@pytest.mark.parametrize("backend", ["sklearn", "jax"])
def test_pca_matches_jax(backend, study, tmp_path):
    jdf, pdf = run_both(study, tmp_path, "pca", backend)
    assert list(pdf.columns) == list(jdf.columns)
    assert list(pdf.index) == list(jdf.index)
    cols = dims(jdf, "pca")
    assert len(cols) == 6
    for c in (c for c in jdf.columns if c not in cols):
        assert list(map(str, pdf[c])) == list(map(str, jdf[c])), c
    for c in cols:
        a, b = pdf[c].to_numpy(), jdf[c].to_numpy()
        if backend == "sklearn":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=c)
        else:
            err = min(np.abs(a - b).max(), np.abs(a + b).max())
            assert err <= 1e-4, (c, err)


@pytest.mark.parametrize("backend", ["sklearn", "jax"])
def test_select_k_best_matches_jax(backend, study, tmp_path):
    jdf, pdf = run_both(study, tmp_path, "skb", backend, label=LABEL)
    assert list(pdf.columns) == list(jdf.columns)
    for c in dims(jdf, "skb"):
        np.testing.assert_array_equal(pdf[c].to_numpy(), jdf[c].to_numpy())


def test_f_classif_and_indices_match_jax_and_sklearn(study):
    frame, X_train, _, _ = fs.load_raw_data(study)
    X = np.nan_to_num(X_train)
    from multimodalautoencoder_tpu_torch.data.loader import label_values
    y = label_values(frame, LABEL)[frame.columns["dataset"] == "Train"]
    keep = ~np.isnan(y)
    got = fs.f_classif_scores(X[keep], y[keep])
    np.testing.assert_array_equal(got, jfs.f_classif_scores(X[keep], y[keep]))
    from sklearn.feature_selection import f_classif
    # scikit-learn sums the squares in another order
    np.testing.assert_allclose(got, np.nan_to_num(f_classif(X[keep],
                                                            y[keep])[0]),
                               rtol=1e-9, atol=1e-12)
    _, idx = fs.transform_select_K_best(X[keep], y[keep], X, 6, "jax")
    np.testing.assert_array_equal(
        idx, fs.select_k_best_indices(X[keep], y[keep], 6))


def test_cli_feature_select_and_missing_sklearn(study, tmp_path,
                                                monkeypatch, capsys):
    assert cli.main(["feature-select", study, "pca", "4", "--backend", "jax",
                     "--fill-missing", "0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1].split()[-1]
    assert os.path.basename(out) == "pca_f.csv"
    assert dims(pd.read_csv(out, index_col=0), "pca") == [
        f"pca_dim{i}" for i in range(4)]
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(SystemExit, match="scikit-learn"):
        cli.main(["feature-select", study, "pca", "4", "--fill-missing",
                  "0"])
    with pytest.raises(ImportError, match="scikit-learn"):
        fs.transform_select_K_best(np.zeros((4, 3)), np.arange(4),
                                   np.zeros((4, 3)), 2, backend="sklearn")


@pytest.mark.cuda
def test_cuda_pca_against_float64(study):
    """The SVD on the card (float64) against numpy's float64 SVD of the
    same Train rows: explained-variance ratio within 1e-4, each component
    within 1e-3 up to its sign."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, X_train, _, _ = fs.load_raw_data(study)
    X = np.nan_to_num(X_train)
    pca = fs.TorchPCA(6, "cuda").fit(X)
    Xc = X - X.mean(axis=0)
    _, s, vt = np.linalg.svd(Xc, full_matrices=False)
    var = s ** 2 / (len(X) - 1)
    np.testing.assert_allclose(pca.explained_variance_ratio_,
                               (var / var.sum())[:6], rtol=0, atol=1e-4)
    for got, want in zip(pca.components_, vt[:6]):
        assert min(np.abs(got - want).max(), np.abs(got + want).max()) <= 1e-3
