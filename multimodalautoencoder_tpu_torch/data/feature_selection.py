"""Feature selection: PCA and SelectKBest dataset transforms.

Counterpart of ``multimodalautoencoder_tpu/data/feature_selection.py``
(reference ``feature_selection.py``): PCA fit on the Train rows with its
explained variance reported (:31-47), SelectKBest(f_classif) on the Train
rows with a label (:49-61, :83-93), and a transformed CSV written beside
the input with a ``pca_`` / ``skb_<label>_`` prefix, the logistics
columns kept and the new columns named ``<type>_dim<i>`` (:64-99).

Two backends, under the JAX package's names:

- ``sklearn``: scikit-learn's PCA and SelectKBest on the host, imported at
  first use; without scikit-learn this raises an ImportError naming it;
- ``jax``: the port's on-device path, the counterpart of the JAX
  package's ``JaxPCA``: :class:`TorchPCA`, a float64 SVD with
  ``torch.linalg.svd`` on ``device``, and :func:`f_classif_scores` in
  numpy.

The table is read with the port's ``loader.read_csv`` (no pandas).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.baselines.common import require_sklearn
from multimodalautoencoder_tpu_torch.data import preprocess as pp
from multimodalautoencoder_tpu_torch.data.loader import (Frame, label_values,
                                                          read_csv)

BACKENDS = ("sklearn", "jax")
SKLEARN_USE = "feature selection with backend='sklearn'"


def load_raw_data(path: str, engine: str = "pandas"):
    """CSV -> (frame, X_train, X_all, logistics columns) by the standard
    column triage (feature_selection.py:6-28)."""
    if engine == "native":
        from multimodalautoencoder_tpu_torch.data import fast_csv
        frame = fast_csv.read_csv(path)
    else:
        frame = read_csv(path)
    feat_cols = pp.get_wanted_feats_from_df(frame.names)
    logistic_cols = [c for c in frame.names if c not in set(feat_cols)]
    X_all = frame.matrix(feat_cols)
    X_train = X_all[frame.columns["dataset"] == "Train"]
    return frame, X_train, X_all, logistic_cols


# -- PCA ------------------------------------------------------------------

class TorchPCA:
    """PCA fit on the Train rows through an SVD on ``device``; the
    interface of sklearn's (the JAX package's ``JaxPCA``, which takes the
    SVD in float32).  The SVD runs in float64: in float32, the card's
    solver put a component of the reference-scale study 1.6e-3 from
    float64's, where trailing singular values lie a few 1e-4 apart."""

    def __init__(self, n_components: int, device="cuda"):
        self.n_components = n_components
        self.device = torch.device(device)
        self.mean_ = None
        self.components_ = None                # (k, F)
        self.explained_variance_ratio_ = None

    def fit(self, X: np.ndarray) -> "TorchPCA":
        x = torch.as_tensor(np.asarray(X, dtype=np.float64),
                            device=self.device)
        mean = x.mean(dim=0)
        _, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
        self.mean_ = mean.cpu().numpy()
        var = s.cpu().numpy() ** 2 / (X.shape[0] - 1)
        self.components_ = vt[:self.n_components].cpu().numpy()
        self.explained_variance_ratio_ = (var / var.sum())[
            :self.n_components]
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, dtype=float) - self.mean_) @ \
            self.components_.T


def transform_PCA(X_train: np.ndarray, X_all: np.ndarray,
                  n_components: int = 100, backend: str = "sklearn",
                  verbose: bool = True, device="cuda"):
    """Fit PCA on Train, transform all rows (feature_selection.py:31-47).
    Returns (transformed_X, pca_model)."""
    if backend == "jax":
        pca = TorchPCA(n_components, device).fit(X_train)
    else:
        require_sklearn(SKLEARN_USE)
        from sklearn.decomposition import PCA

        pca = PCA(n_components=n_components)
        pca.fit(X_train)
    if verbose:
        print("Total explained variance:",
              float(np.sum(pca.explained_variance_ratio_)))
    return pca.transform(X_all), pca


# -- SelectKBest ----------------------------------------------------------

def f_classif_scores(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """One-way ANOVA F-score of each feature (sklearn's f_classif), in
    numpy."""
    X = np.asarray(X, dtype=float)
    y = np.asarray(y)
    classes = np.unique(y)
    n = X.shape[0]
    grand_mean = X.mean(axis=0)
    ss_between = np.zeros(X.shape[1])
    ss_within = np.zeros(X.shape[1])
    for c in classes:
        Xc = X[y == c]
        mc = Xc.mean(axis=0)
        ss_between += len(Xc) * (mc - grand_mean) ** 2
        ss_within += ((Xc - mc) ** 2).sum(axis=0)
    df_between = len(classes) - 1
    df_within = n - len(classes)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = (ss_between / df_between) / (ss_within / df_within)
    return np.nan_to_num(f)


def select_k_best_indices(X_train: np.ndarray, Y_train: np.ndarray,
                          K: int) -> np.ndarray:
    """The K features of highest F-score, in column order."""
    return np.sort(np.argsort(f_classif_scores(X_train, Y_train))[::-1][:K])


def transform_select_K_best(X_train: np.ndarray, Y_train: np.ndarray,
                            X_all: np.ndarray, K: int = 100,
                            backend: str = "sklearn"):
    """Keep the K highest-F features (feature_selection.py:49-61).
    Returns (transformed_X, selected_indices)."""
    if backend == "jax":
        idx = select_k_best_indices(X_train, Y_train, K)
        return np.asarray(X_all, dtype=float)[:, idx], idx
    require_sklearn(SKLEARN_USE)
    from sklearn.feature_selection import SelectKBest, f_classif

    skb = SelectKBest(f_classif, k=K)
    skb.fit(X_train, Y_train)
    # get_support, not an argsort of scores_: sklearn ranks NaN scores
    # (constant features) last, an argsort would rank them first
    idx = skb.get_support(indices=True)
    return skb.transform(X_all), idx


# -- dataset transform ----------------------------------------------------

def create_transformed_dataset(path: str, transform_type: str,
                               num_features: int,
                               label: Optional[str] = None,
                               backend: str = "sklearn",
                               out_path: Optional[str] = None,
                               fill_missing: Optional[float] = None,
                               verbose: bool = True, device="cuda",
                               engine: str = "pandas") -> str:
    """Load, transform, and write ``<prefix><basename>`` beside the input
    (feature_selection.py:64-99): logistics columns kept, new columns
    ``<type>_dim<i>``; SKB fits only on the Train rows with a label.
    ``fill_missing`` imputes scattered NaN first (PCA and SKB take none).
    ``device`` is where the 'jax' backend's SVD runs.  Returns the output
    path."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (sklearn or jax)")
    frame, X_train, X_all, logistic_cols = load_raw_data(path, engine)
    if np.isnan(X_train).any() or np.isnan(X_all).any():
        if fill_missing is None:
            raise ValueError(
                "feature data contains NaN; impute first (e.g. "
                "preprocess.normalize_fill_df) or pass fill_missing=<value>")
        X_train = np.nan_to_num(X_train, nan=fill_missing)
        X_all = np.nan_to_num(X_all, nan=fill_missing)

    if transform_type == "pca":
        transformed_X, _ = transform_PCA(X_train, X_all, num_features,
                                         backend=backend, verbose=verbose,
                                         device=device)
        prefix = "pca_"
    elif transform_type == "skb":
        if label is None:
            raise ValueError("label parameter required for skb "
                             "transformation")
        if label not in logistic_cols:
            raise ValueError(f"label {label!r} must be in the dataframe")
        Y_train = label_values(frame, label)[
            frame.columns["dataset"] == "Train"]
        keep = ~np.isnan(Y_train)
        transformed_X, _ = transform_select_K_best(
            X_train[keep], Y_train[keep], X_all, num_features,
            backend=backend)
        prefix = f"skb_{label}_"
    else:
        raise ValueError(f"unknown transform_type {transform_type!r}")

    names = [f"{transform_type}_dim{i}" for i in range(num_features)]
    out = Frame(frame.index_name, frame.index,
                {c: frame.columns[c] for c in logistic_cols})
    out = out.with_columns(names, np.asarray(transformed_X, dtype=float))
    if out_path is None:
        d, base = os.path.split(path)
        out_path = os.path.join(d, prefix + base)
    out.to_csv(out_path)
    return out_path
