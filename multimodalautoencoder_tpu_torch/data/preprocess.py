"""CSV preprocessing for serving: column triage, train-stat normalization,
two-tier imputation and the seeded shuffle, on numpy arrays.

Counterpart of ``multimodalautoencoder_tpu/data/preprocess.py`` (the
functions the serve path needs).  The JAX package does this on a pandas
DataFrame; here the steps take a float64 feature matrix with its
column-name list, and :func:`normalize_fill_df` applies them to a
``loader.Frame``.  The results are the same numbers (reference
``data_funcs.py``):

- column triage by substring blacklist (:449-468), label columns and the
  rows that lack a wanted label (:89-99, :428-447);
- per-feature normalization with statistics computed on **Train rows only**
  and applied to all rows (:547-572);
- drop columns fully null in any split (:574-621);
- two-tier imputation: whole-modality gaps (row >80% NaN within one prefix)
  filled first (:712-769), then every other missing cell (:419-420), and
  the histogram of those gaps (:771-833);
- a seeded shuffle: ``pd.DataFrame.sample(frac=1, random_state=s)`` orders
  rows as ``np.random.RandomState(s).permutation(n)``, used here directly;
- cross-validation folds drawn from ``np.random.default_rng(seed)``
  (:211-223, :623-635), the same column the JAX package assigns.
"""

from __future__ import annotations

import warnings
from typing import (TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable

if TYPE_CHECKING:
    from multimodalautoencoder_tpu_torch.data.loader import Frame

NUM_CROSS_VAL_FOLDS = 5  # data_funcs.py:27
FOLD_COLUMN = "logistics_cv_fold"

_LOGISTICS_SUBSTRINGS = ("user_id", "timestamp", "label", "Label", "dataset",
                         "logistics", "ppt_id")


def get_wanted_feats_from_df(columns: Sequence[str]) -> List[str]:
    """Feature columns = every column name not matching the logistics
    blacklist (data_funcs.py:449-468)."""
    return [c for c in columns
            if not any(s in c for s in _LOGISTICS_SUBSTRINGS)]


def get_label_cols(columns: Sequence[str]) -> List[str]:
    """Columns containing 'label'/'Label' (data_funcs.py:95)."""
    return [c for c in columns if "label" in c or "Label" in c]


def remove_rows_with_no_label(frame: "Frame",
                              wanted_labels: Optional[Sequence[str]]
                              ) -> "Frame":
    """Drop rows lacking any wanted label (data_funcs.py:428-447)."""
    if not wanted_labels:
        return frame
    from multimodalautoencoder_tpu_torch.data.loader import label_values
    keep = np.ones(len(frame), dtype=bool)
    for name in wanted_labels:
        keep &= ~np.isnan(label_values(frame, name))
    return frame if keep.all() else frame.take(keep)


def labels_to_sign(y: np.ndarray) -> np.ndarray:
    """{0,1} -> {-1,1} (data_funcs.py:529-530)."""
    return 2 * y - 1


def _column_stats(train: np.ndarray, normalization: str):
    """Per-column NaN-skipping statistics of the Train rows, computed as
    pandas computes them (NaN for a column with no values): (min, max)
    for between_0_and_1, (mean, population std) for z_score."""
    n = train.shape[1]
    if train.shape[0] == 0:
        nan = np.full(n, np.nan)
        return nan, nan
    cols = np.ascontiguousarray(train.T)   # one contiguous row per feature
    mask = np.isnan(cols)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if normalization == "between_0_and_1":
            return np.nanmin(cols, axis=1), np.nanmax(cols, axis=1)
        count = (~mask).sum(axis=1)
        mean = np.where(mask, 0.0, cols).sum(axis=1) / count
        sq = np.where(mask, 0.0, (mean[:, None] - cols) ** 2)
        std = np.sqrt(sq.sum(axis=1) / count)        # ddof=0
    return mean, std


def normalize_columns(X: np.ndarray, is_train: np.ndarray,
                      normalization: Optional[str] = "z_score"
                      ) -> np.ndarray:
    """Normalize features with Train-row statistics (data_funcs.py:547-572).

    z_score uses the population std (ddof=0); between_0_and_1 is train
    min-max.  A feature constant in Train divides by 1 (sklearn's
    StandardScaler convention, where the reference divides by 0)."""
    if normalization is None:
        return X
    if normalization not in ("z_score", "between_0_and_1"):
        raise ValueError(f"unknown normalization {normalization!r}")
    if normalization == "z_score":
        mean, std = _column_stats(X[is_train], normalization)
        return (X - mean) / np.where(std > 0, std, 1.0)
    lo, hi = _column_stats(X[is_train], normalization)
    span = hi - lo
    return (X - lo) / np.where(span > 0, span, 1.0)


def remove_null_cols(X: np.ndarray, features: Sequence[str],
                     dataset: np.ndarray) -> Tuple[np.ndarray, List[str]]:
    """Drop features fully null in ANY of Train/Val/Test
    (data_funcs.py:591-621); an absent split drops nothing.  Returns the
    kept columns of X and their names."""
    null = np.zeros(X.shape[1], dtype=bool)
    for dset in ("Train", "Test", "Val"):
        rows = dataset == dset
        if rows.any():
            null |= np.isnan(X[rows]).all(axis=0)
    keep = ~null
    return X[:, keep], [f for f, k in zip(features, keep) if k]


def fill_gaps_in_modalities(X: np.ndarray, fill_value: float,
                            wanted_feats: Sequence[str],
                            gap_threshold: float = 0.8,
                            subdivide_phys: bool = True) -> np.ndarray:
    """Whole-modality gap imputation (data_funcs.py:712-769): in each row,
    a modality whose span is more than ``gap_threshold`` NaN is overwritten
    whole with ``fill_value`` — its non-NaN entries included, as the
    reference does (:753-754).  Covers the last modality too (a fix of
    reference bug §2.8.8)."""
    table = ModalityTable.from_feature_names(list(wanted_feats),
                                             subdivide_phys=subdivide_phys)
    X = X.copy()
    nan = np.isnan(X)
    for m in range(table.num_modalities):
        s, e = table.span(m)
        rows = nan[:, s:e].mean(axis=1) > gap_threshold
        X[rows, s:e] = fill_value
    return X


def count_gaps_in_modalities(data: Union["Frame", np.ndarray],
                             wanted_feats: Optional[Sequence[str]] = None,
                             gap_threshold: float = 0.8,
                             subdivide_phys: bool = True) -> Dict[str, int]:
    """Histogram of co-missing modality sets (data_funcs.py:771-833): maps
    'modA, modB' to the number of rows where exactly that set of modalities
    is more than ``gap_threshold`` NaN ('None' when none is).  ``data`` is
    a ``loader.Frame`` (features found by name unless ``wanted_feats`` is
    given) or a feature matrix whose columns are ``wanted_feats``."""
    if isinstance(data, np.ndarray):
        if wanted_feats is None:
            raise ValueError("a feature matrix needs its wanted_feats")
        X = np.asarray(data, dtype=np.float64)
    else:
        if wanted_feats is None:
            wanted_feats = get_wanted_feats_from_df(data.names)
        X = data.matrix(list(wanted_feats))
    table = ModalityTable.from_feature_names(list(wanted_feats),
                                             subdivide_phys=subdivide_phys)
    nan = np.isnan(X)
    missing = np.zeros((len(X), table.num_modalities), dtype=bool)
    for m in range(table.num_modalities):
        s, e = table.span(m)
        missing[:, m] = nan[:, s:e].mean(axis=1) > gap_threshold
    out: Dict[str, int] = {}
    for row in missing:
        names = [table.names[i] for i in np.nonzero(row)[0]]
        key = ", ".join(names) if names else "None"
        out[key] = out.get(key, 0) + 1
    return out


def shuffle_order(num_rows: int, seed: Optional[int]) -> np.ndarray:
    """The row order of ``DataFrame.sample(frac=1, random_state=seed)``."""
    return np.random.RandomState(seed).permutation(num_rows)


def normalize_fill_df(frame: "Frame", wanted_feats: Sequence[str],
                      normalization: Optional[str] = "z_score",
                      remove_cols: bool = True,
                      fill_missing: float = 0.0,
                      fill_gaps: Optional[float] = None,
                      shuffle: bool = True,
                      seed: Optional[int] = 0,
                      subdivide_phys: bool = True
                      ) -> Tuple["Frame", List[str]]:
    """Normalize -> drop null cols -> gap-fill -> fill missing -> shuffle
    (data_funcs.py:385-426) on a ``loader.Frame``.  Returns (frame,
    surviving features).  The shuffle is seeded (the reference's is not,
    :423-424)."""
    feats = list(wanted_feats)
    X = frame.matrix(feats)
    dataset = frame.columns["dataset"]
    X = normalize_columns(X, dataset == "Train", normalization)
    if remove_cols:
        X, kept = remove_null_cols(X, feats, dataset)
        frame = frame.drop([f for f in feats if f not in set(kept)])
        feats = kept
    if fill_gaps is not None:
        X = fill_gaps_in_modalities(X, fill_gaps, feats,
                                    subdivide_phys=subdivide_phys)
    frame = frame.with_columns(feats, X).fillna(fill_missing)
    if shuffle:
        frame = frame.take(shuffle_order(len(frame), seed))
    return frame, feats


def assign_cross_val_folds(frame: "Frame",
                           num_folds: int = NUM_CROSS_VAL_FOLDS,
                           seed: int = 0) -> "Frame":
    """Give each non-Test row a uniform random fold and Test rows -1
    (data_funcs.py:211-223, :623-635), as a text column of integers.  A
    frame that already has the column is returned as it is, so persisted
    assignments stay stable.  Seeded, and honours ``num_folds`` (the
    reference does neither, SURVEY.md §2.8.7)."""
    from multimodalautoencoder_tpu_torch.data.loader import Frame

    if FOLD_COLUMN in frame.columns:
        return frame
    folds = np.random.default_rng(seed).integers(0, num_folds,
                                                 size=len(frame))
    folds = np.where(frame.columns["dataset"] == "Test", -1, folds)
    columns = dict(frame.columns)
    columns[FOLD_COLUMN] = folds.astype(str).astype(object)
    return Frame(frame.index_name, frame.index, columns)
