"""The study a cell trains on, made from the run's seed.

A stand-in for the ACII 2017 study at the repository's reference scale:
rows of features in (0, 1) read off a shared low-rank latent, so a masked
modality is reconstructable from the others, grouped into modalities of
equal width, normalized to [0, 1] per column, scattered gaps filled with
0 and whole-modality gaps set to -1 (how the sweeps' loaders hand their
data over), binary mood labels from the latent's signs, a held-out test
share, and cross-validation folds over the rest: fold k's train rows are
every other fold's rows.  Both the program and the reference receive
these matrices.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Study:
    widths: List[int]
    names: List[str]
    train_x: List[np.ndarray]     # per fold (rows, F) float32
    train_y: List[np.ndarray]     # per fold (rows, L) float32
    val_x: List[np.ndarray]
    val_y: List[np.ndarray]

    @property
    def num_feats(self) -> int:
        return int(sum(self.widths))

    @property
    def num_folds(self) -> int:
        return len(self.train_x)


def make_study(seed: int, data: dict) -> Study:
    """The study a configuration's ``data`` block describes: ``rows``,
    ``modalities`` ([[name, width], ...]), ``labels``, ``folds``,
    ``latent_dim``, ``gap_frac`` (rows with one whole modality missing),
    ``nan_frac`` (scattered missing entries), ``test_frac``."""
    rng = np.random.default_rng([int(seed), 0xDA7A])
    rows = int(data["rows"])
    names = [str(m[0]) for m in data["modalities"]]
    widths = [int(m[1]) for m in data["modalities"]]
    F = sum(widths)
    d = int(data["latent_dim"])
    latent = rng.standard_normal((rows, d))
    proj = rng.standard_normal((d, F)) / np.sqrt(d)
    x = latent @ proj + 0.1 * rng.standard_normal((rows, F))
    x = 1.0 / (1.0 + np.exp(-x))
    lo, hi = x.min(axis=0), x.max(axis=0)
    x = (x - lo) / np.maximum(hi - lo, 1e-12)
    x[rng.random((rows, F)) < float(data["nan_frac"])] = 0.0
    starts = np.concatenate([[0], np.cumsum(widths)])
    gap_rows = np.nonzero(rng.random(rows) < float(data["gap_frac"]))[0]
    gap_mod = rng.integers(0, len(widths), size=len(gap_rows))
    for r, m in zip(gap_rows, gap_mod):
        x[r, starts[m]:starts[m + 1]] = -1.0
    n_labels = int(data["labels"])
    y = (latent[:, np.arange(n_labels) % d] > 0).astype(np.float32)
    keep = np.nonzero(rng.random(rows) >= float(data["test_frac"]))[0]
    K = int(data["folds"])
    fold_of = rng.permutation(len(keep)) % K
    x = x.astype(np.float32)
    tx, ty, vx, vy = [], [], [], []
    for k in range(K):
        tr, va = keep[fold_of != k], keep[fold_of == k]
        tx.append(np.ascontiguousarray(x[tr]))
        ty.append(np.ascontiguousarray(y[tr]))
        vx.append(np.ascontiguousarray(x[va]))
        vy.append(np.ascontiguousarray(y[va]))
    return Study(widths=widths, names=names, train_x=tx, train_y=ty,
                 val_x=vx, val_y=vy)
