"""Synthetic multimodal wearable-style datasets, numpy only.

Counterpart of ``multimodalautoencoder_tpu/data/synthetic.py``: the same
random draws in the same order from ``np.random.default_rng(seed)``, so a
seed gives the same table in both packages, written with the same CSV
conventions (index column, prefix-named feature columns forming
modalities, ``*_label`` columns, a ``dataset`` column in
{Train, Val, Test}, ``user_id``, ``logistics_noisy``, scattered NaNs and
whole-modality gaps; data_funcs.py:1-19).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from multimodalautoencoder_tpu_torch.data.loader import DataLoader, Frame
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable

DEFAULT_MODALITIES: Tuple[Tuple[str, int], ...] = (
    ("call", 6), ("location", 8), ("screen", 5), ("sms", 4), ("survey", 7))

# The reference-scale study (autoencoder_wrapper.py:25, :127-136): 1000
# features over the 5 wearable modalities and the 3 mood labels.
REFERENCE_SCALE_MODALITIES: Tuple[Tuple[str, int], ...] = (
    ("call", 200), ("location", 200), ("screen", 200), ("sms", 200),
    ("survey", 200))
REFERENCE_SCALE_LABELS = ("happiness_label", "health_label",
                          "calmness_label")


def make_arrays(rng: np.random.Generator, num_rows: int,
                modalities: Sequence[Tuple[str, int]] = DEFAULT_MODALITIES,
                latent_dim: int = 6):
    """Low-rank structured data in (0, 1): features are noisy linear reads
    of a shared latent, so masked modalities are reconstructable from the
    others.  Returns (X, latent, table)."""
    names = [n for n, _ in modalities]
    widths = [w for _, w in modalities]
    num_feats = sum(widths)
    starts = np.concatenate([[0], np.cumsum(widths)])
    table = ModalityTable(names=tuple(names),
                          start_indices=tuple(int(s) for s in starts),
                          num_feats=num_feats)
    latent = rng.normal(size=(num_rows, latent_dim))
    proj = rng.normal(size=(latent_dim, num_feats)) / np.sqrt(latent_dim)
    X = latent @ proj + 0.1 * rng.normal(size=(num_rows, num_feats))
    X = 1.0 / (1.0 + np.exp(-X))
    return X.astype(np.float64), latent, table


def feature_names(table: ModalityTable) -> list:
    out = []
    for m in range(table.num_modalities):
        s, e = table.span(m)
        out.extend(f"{table.names[m]}_f{j}" for j in range(e - s))
    return out


def make_frame(num_rows: int = 400, seed: int = 0,
               modalities: Sequence[Tuple[str, int]] = DEFAULT_MODALITIES,
               label_names: Sequence[str] = ("happy_label",),
               noisy_frac: float = 0.25,
               nan_frac: float = 0.02,
               gap_frac: float = 0.1,
               splits: Tuple[float, float] = (0.7, 0.85),
               latent_dim: int = 6) -> Frame:
    """The conventions-compliant table (``make_dataframe`` in the JAX
    package).  ``noisy_frac`` rows get ``logistics_noisy=True``;
    ``gap_frac`` rows get one whole modality NaN'd out; ``nan_frac`` of
    all entries become scattered NaN."""
    rng = np.random.default_rng(seed)
    X, latent, table = make_arrays(rng, num_rows, modalities, latent_dim)
    feats = feature_names(table)

    labels = {label: (latent[:, li % latent.shape[1]] > 0).astype(float)
              for li, label in enumerate(label_names)}
    u = rng.random(num_rows)
    dataset = np.where(u < splits[0], "Train",
                       np.where(u < splits[1], "Val", "Test"))
    user_id = rng.integers(0, 30, size=num_rows)
    noisy = rng.random(num_rows) < noisy_frac

    # whole-modality gaps, then scattered NaN
    for r in np.nonzero(rng.random(num_rows) < gap_frac)[0]:
        m = rng.integers(0, table.num_modalities)
        s, e = table.span(m)
        X[r, s:e] = np.nan
    X[rng.random((num_rows, table.num_feats)) < nan_frac] = np.nan

    columns = {f: X[:, j] for j, f in enumerate(feats)}
    columns.update(labels)
    columns["dataset"] = dataset.astype(object)
    columns["user_id"] = user_id.astype(str).astype(object)
    columns["logistics_noisy"] = np.where(noisy, "True", "False").astype(
        object)
    return Frame("", np.arange(num_rows).astype(str), columns)


def write_csv(path: str, **kwargs) -> str:
    make_frame(**kwargs).to_csv(path)
    return path


def write_reference_scale_csv(workdir: str, num_rows: int = 2000,
                              seed: int = 0) -> str:
    """The reference-scale study (1000 features over 5 modalities, 2000
    rows, 3 labels) as ``<workdir>/acii.csv`` — the same file the JAX
    package's ``reference_scale_loaders`` writes."""
    return write_csv(os.path.join(workdir, "acii.csv"), num_rows=num_rows,
                     seed=seed, modalities=REFERENCE_SCALE_MODALITIES,
                     label_names=REFERENCE_SCALE_LABELS)


def reference_scale_loaders(workdir: str, num_rows: int = 2000,
                            seed: int = 0):
    """The reference-scale study written to ``<workdir>/acii.csv`` and
    wrapped in the unsupervised and supervised cross-validation
    DataLoaders the sweeps take (normalized and filled, whole-modality
    gaps set to -1): the JAX package's ``reference_scale_loaders``, the
    data of its benchmarks."""
    path = write_reference_scale_csv(workdir, num_rows=num_rows, seed=seed)
    unsup = DataLoader(path, supervised=False, cross_validation=True,
                       suppress_output=True, normalize_and_fill=True,
                       fill_gaps_with=-1.0)
    sup = DataLoader(path, supervised=True, cross_validation=True,
                     suppress_output=True, normalize_and_fill=True,
                     fill_gaps_with=-1.0)
    return unsup, sup
