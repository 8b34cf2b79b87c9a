"""CSV tables without pandas, and the DataLoader's serve subset.

Counterpart of ``multimodalautoencoder_tpu/data/loader.py``.  The JAX
package keeps its host data in a pandas DataFrame read with
``pd.read_csv(path, index_col=0)``; here :class:`Frame` holds the same
table with the stdlib ``csv`` module and numpy:

- the first column is the row index, kept as its text;
- feature columns (:func:`preprocess.get_wanted_feats_from_df`) are float64,
  with pandas' default missing-value tokens read as NaN;
- every other column keeps its text, so it is written back as it was read.

Written back with :meth:`Frame.to_csv`, float columns are formatted as
pandas formats them (shortest round-trip text, NaN as an empty cell), so a
value read back from either package's output is the same float.

:class:`DataLoader` is the JAX class without pandas: the wanted features,
label triage, normalize-and-fill, the ``dataset`` splits or the
cross-validation folds with their labels and noisy/clean splits, the
modality table, the reconstruction fill-back (data_funcs.py:310-381), the
batch getters, and :meth:`DataLoader.device_arrays`, which puts the
matrices on a torch device.
"""

from __future__ import annotations

import csv
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.data import preprocess as pp
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable

# pandas' default missing-value tokens (pandas.io.parsers STR_NA_VALUES).
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


_POW10 = np.array([float(f"1e{k}") for k in range(309)])
_MAX_DIGITS = 17


def _xstrtod(cells: np.ndarray) -> np.ndarray:
    """Decimal text to float64 exactly as pandas' default C parser does
    (``precise_xstrtod`` in pandas' tokenizer): the first 17 digits,
    leading zeros included, accumulate in a double as ``n * 10 + d``,
    which is then scaled once by a power of ten.  This is not always the
    correctly rounded value (that differs in the last bit for some 17-digit
    text), but it is the value the JAX package's pandas reader gets.

    Returns NaN where a cell is not ``[+-]digits[.digits][(e|E)[+-]digits]``
    or its exponent leaves the table; the caller parses those otherwise.
    """
    n = len(cells)
    if n == 0:
        return np.empty(0)
    raw = np.asarray(cells, dtype=str)
    if np.char.find(raw, " ").max() >= 0:
        raw = np.char.strip(raw)
    try:
        ascii_ = raw.astype("S")
    except UnicodeEncodeError:   # not a number; the caller reports it
        ascii_ = np.char.encode(raw, "ascii", "replace")
    b = ascii_.view(np.uint8).reshape(n, -1)
    width = b.shape[1]
    col = np.arange(width)[None, :]
    length = (b != 0).sum(axis=1)
    is_digit = (b >= 48) & (b <= 57)
    neg = b[:, 0] == ord("-")
    start = (neg | (b[:, 0] == ord("+"))).astype(np.int64)

    def first(mask, default):
        found = mask.any(axis=1)
        return np.where(found, mask.argmax(axis=1), default)

    e_pos = first((b == ord("e")) | (b == ord("E")), length)
    in_mant = (col >= start[:, None]) & (col < e_pos[:, None])
    dot_pos = first((b == ord(".")) & in_mant, e_pos)
    mant_digit = is_digit & in_mant
    nd_int = (mant_digit & (col < dot_pos[:, None])).sum(axis=1)
    nd_frac = (mant_digit & (col > dot_pos[:, None])).sum(axis=1)
    n_mant = (in_mant & (col != dot_pos[:, None])).sum(axis=1)

    # exponent: optional sign, then at least one digit, to the end
    has_e = e_pos < length
    e_sign_at = e_pos + 1
    e_sign = np.take_along_axis(
        b, np.minimum(e_sign_at, width - 1)[:, None], axis=1)[:, 0]
    e_neg = has_e & (e_sign == ord("-"))
    e_start = e_sign_at + (has_e & ((e_sign == ord("-"))
                                    | (e_sign == ord("+"))))
    in_exp = (col >= e_start[:, None]) & (col < length[:, None])
    exp_val = np.zeros(n, dtype=np.int64)
    for j in range(width if has_e.any() else 0):
        d = in_exp[:, j]
        exp_val = np.where(d, np.minimum(exp_val * 10 + (b[:, j] - 48),
                                         10 ** 6), exp_val)
    ok = ((nd_int + nd_frac) > 0) & (n_mant == nd_int + nd_frac) \
        & ((is_digit | ~in_exp).all(axis=1)) \
        & (~has_e | (in_exp.sum(axis=1) > 0))

    # the first 17 mantissa digits, in order, skipping the point
    rank = np.cumsum(mant_digit, axis=1) - 1
    keep = mant_digit & (rank < _MAX_DIGITS)
    rows, cols = np.nonzero(keep)
    digits = np.zeros((n, _MAX_DIGITS))
    digits[rows, rank[rows, cols]] = b[rows, cols] - 48
    taken_int = np.minimum(nd_int, _MAX_DIGITS)
    taken_frac = np.minimum(nd_frac, _MAX_DIGITS - taken_int)
    taken = taken_int + taken_frac
    number = np.zeros(n)
    for i in range(_MAX_DIGITS):
        number = np.where(i < taken, number * 10.0 + digits[:, i], number)
    number = np.where(neg, -number, number)
    exponent = (nd_int - taken_int) - taken_frac \
        + np.where(e_neg, -exp_val, exp_val)

    ok &= (exponent <= 308) & (exponent >= -616)
    ex = np.where(ok, exponent, 0)
    big = _POW10[np.clip(ex, 0, 308)]
    small = _POW10[np.clip(-ex, 0, 308)]
    sub = _POW10[np.clip(-308 - ex, 0, 308)]
    with np.errstate(over="ignore"):
        out = np.where(ex > 0, number * big,
                       np.where(ex >= -308, number / small,
                                number / sub / _POW10[308]))
    return np.where(ok, out, np.nan)


def _parse_floats(cells: np.ndarray, where: str) -> np.ndarray:
    """Feature cells' text as float64, as pandas reads it: missing
    tokens are NaN, decimal numbers go through :func:`_xstrtod`, and any
    other spelling (``inf``, huge exponents) through ``float``."""
    cells = np.asarray(cells, dtype=str)
    na = np.isin(cells, list(NA_VALUES))
    out = _xstrtod(np.where(na, "0", cells))
    out[na] = np.nan
    for i in np.flatnonzero(np.isnan(out) & ~na):
        try:
            out[i] = float(cells[i])
        except ValueError:
            raise ValueError(f"{where}: feature cell {cells[i]!r} is not "
                             "a number") from None
    return out


def _format_floats(values: np.ndarray) -> np.ndarray:
    """pandas' ``to_csv`` text of a float column: ``astype(str)`` (the
    shortest round-trip text of the column's dtype), NaN as ''."""
    text = values.astype(str).astype(object)
    text[np.isnan(values)] = ""
    return text


def _is_numeric_text(cells: np.ndarray) -> bool:
    try:
        cells[~np.isin(cells, list(NA_VALUES))].astype(np.float64)
        return True
    except ValueError:
        return False


class Frame:
    """A table read from CSV: index labels plus named columns, each a
    float64 (or float32) array or an array of cell text."""

    def __init__(self, index_name: str, index: np.ndarray,
                 columns: Dict[str, np.ndarray]):
        self.index_name = index_name
        self.index = np.asarray(index, dtype=object)
        self.columns: Dict[str, np.ndarray] = dict(columns)
        for name, col in self.columns.items():
            if len(col) != len(self.index):
                raise ValueError(f"column {name!r} has {len(col)} rows, "
                                 f"the index {len(self.index)}")

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    def __len__(self) -> int:
        return len(self.index)

    def matrix(self, names: Sequence[str]) -> np.ndarray:
        """(rows, len(names)) float64 copy of the named float columns."""
        out = np.empty((len(self), len(names)), dtype=np.float64)
        for j, name in enumerate(names):
            col = self.columns[name]
            if col.dtype.kind != "f":
                raise ValueError(f"column {name!r} is text, not numbers")
            out[:, j] = col
        return out

    def with_columns(self, names: Sequence[str], values: np.ndarray
                     ) -> "Frame":
        """A copy with the named columns set from ``values``' columns (new
        names are appended)."""
        cols = dict(self.columns)
        for j, name in enumerate(names):
            cols[name] = np.array(values[:, j])
        return Frame(self.index_name, self.index, cols)

    def select(self, names: Sequence[str]) -> "Frame":
        return Frame(self.index_name, self.index,
                     {n: self.columns[n] for n in names})

    def drop(self, names: Sequence[str]) -> "Frame":
        gone = set(names)
        return Frame(self.index_name, self.index,
                     {n: c for n, c in self.columns.items() if n not in gone})

    def take(self, rows: np.ndarray) -> "Frame":
        """Rows by position (a permutation, subset or boolean mask)."""
        return Frame(self.index_name, self.index[rows],
                     {n: c[rows] for n, c in self.columns.items()})

    def fillna(self, value: float) -> "Frame":
        """Every missing cell set to ``value``, like pandas' ``fillna``:
        NaN in float columns; a missing-value token in a text column, as
        pandas would write the filled cell (a float in a column of
        numbers)."""
        cols = {}
        for name, col in self.columns.items():
            if col.dtype.kind == "f":
                col = np.where(np.isnan(col), value, col).astype(col.dtype)
            else:
                na = np.isin(col, list(NA_VALUES))
                if na.any():
                    fill = str(float(value)) if _is_numeric_text(col) \
                        else str(value)
                    col = np.where(na, fill, col).astype(object)
            cols[name] = col
        return Frame(self.index_name, self.index, cols)

    def to_csv(self, path: str) -> None:
        """Write with the index first, as ``DataFrame.to_csv`` does.  The
        text goes to a file beside ``path`` that then replaces it, so a
        process reading ``path`` meanwhile sees the old file or the new
        one, never a part: the shards of a sweep persist the same CV folds
        into one study at once."""
        cells = [self.index] + [
            _format_floats(c) if c.dtype.kind == "f" else c
            for c in self.columns.values()]
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w", newline="") as f:
                w = csv.writer(f, lineterminator="\n")
                w.writerow([self.index_name] + self.names)
                w.writerows(zip(*cells))
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def read_csv(path: str) -> Frame:
    """Read a CSV as ``pd.read_csv(path, index_col=0)`` sees it: feature
    columns as float64, other columns as text."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path} is empty")
    header, body = rows[0], rows[1:]
    for i, row in enumerate(body):
        if len(row) != len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(row)} cells, "
                             f"the header {len(header)}")
    cells = (np.array(body, dtype=object).reshape(len(body), len(header))
             if body else np.empty((0, len(header)), dtype=object))
    names = header[1:]
    feats = set(pp.get_wanted_feats_from_df(names))
    fcols = [j for j, name in enumerate(names, start=1) if name in feats]
    values = _parse_floats(cells[:, fcols].T.ravel(), path).reshape(
        len(fcols), len(body))
    parsed = dict(zip(fcols, values))
    columns = {name: parsed[j] if j in parsed else cells[:, j]
               for j, name in enumerate(names, start=1)}
    return Frame(header[0], cells[:, 0], columns)


def label_values(frame: Frame, name: str) -> np.ndarray:
    """A label column's cells as float64 (labels are not feature columns,
    so ``read_csv`` keeps their text); missing cells are NaN."""
    col = frame.columns[name]
    if col.dtype.kind == "f":
        return np.asarray(col, dtype=np.float64)
    return _parse_floats(col, f"label column {name!r}")


# ``logistics_noisy`` cells that pandas reads as True (a bool or 1 column)
_TRUE_TEXT = ("True", "true", "TRUE", "1", "1.0")


class DataLoader:
    """A CSV prepared for the model: the JAX package's DataLoader
    (data_funcs.py:29-131) on a pandas-free :class:`Frame`.  ``frame`` is
    the (normalized, filled, shuffled) table; ``test_X`` its Test rows.
    Without ``cross_validation``, ``train_X``/``val_X`` are its Train and
    Val rows; with it, they are the current fold's
    (:meth:`set_to_cross_validation_fold`, fold 0 at first).

    ``supervised`` (the default, as in the JAX package) adds the labels:
    every ``*label*`` column, or
    ``wanted_label`` alone; rows missing a wanted label are dropped before
    normalization, and each ``X`` matrix gets its ``Y`` (one column per
    label, or a vector for one label; {-1, 1} with ``labels_to_sign``).
    ``separate_noisy_data`` splits every matrix by ``logistics_noisy``
    into ``clean_*`` / ``noisy_*`` where the CSV has that column.

    ``extract_modalities=False`` leaves out the modality table and what
    derives from it (``modality_table``, ``modality_names``,
    ``modality_start_indices``, ``num_modalities``), as the JAX loader
    does: such a loader serves the baselines, not the MMAE.

    ``engine``: 'pandas' (the default) reads with :func:`read_csv`, which
    gives pandas' floats; 'native' with ``data/fast_csv.py``'s C++ parser,
    whose floats are correctly rounded (on 17-digit values they can differ
    from pandas' by many units in the last place)."""

    def __init__(self, filename: str, supervised: bool = True,
                 suppress_output: bool = False,
                 cross_validation: bool = False,
                 normalize_and_fill: bool = True,
                 normalization: Optional[str] = "between_0_and_1",
                 fill_missing_with: float = 0,
                 fill_gaps_with: Optional[float] = None,
                 extract_modalities: bool = True,
                 subdivide_physiology_features: bool = False,
                 wanted_label: Optional[str] = None,
                 labels_to_sign: bool = False,
                 separate_noisy_data: bool = True,
                 num_folds: int = pp.NUM_CROSS_VAL_FOLDS,
                 seed: int = 0,
                 persist_cv_folds: bool = True,
                 engine: str = "pandas"):
        if engine not in ("pandas", "native"):
            raise ValueError(f"unknown engine {engine!r} (pandas or native)")
        self.filename = filename
        self.supervised = supervised
        self.subdivide_phys = subdivide_physiology_features
        self.extract_modalities = extract_modalities
        self.cross_validation = cross_validation
        self.labels_to_sign = labels_to_sign
        self.num_folds = num_folds
        self._rng = np.random.default_rng(seed)
        if engine == "native":
            from multimodalautoencoder_tpu_torch.data import fast_csv
            self.frame = fast_csv.read_csv(filename)
        else:
            self.frame = read_csv(filename)
        if cross_validation:
            had_folds = pp.FOLD_COLUMN in self.frame.columns
            self.frame = pp.assign_cross_val_folds(self.frame, num_folds,
                                                   seed)
            if not had_folds and persist_cv_folds:
                # persist the assignment for stability across runs
                # (data_funcs.py:222), before any normalization; after a
                # native read only the fold column goes back, onto the
                # file as the default reader reads it (loader.py:73-84)
                out = self.frame
                if engine == "native":
                    raw = read_csv(filename)
                    out = Frame(raw.index_name, raw.index, dict(
                        raw.columns, **{pp.FOLD_COLUMN:
                                        self.frame.columns[pp.FOLD_COLUMN]}))
                out.to_csv(filename)
            self.fold = 0
        self.wanted_feats = pp.get_wanted_feats_from_df(self.frame.names)

        # label triage (data_funcs.py:89-99)
        self.num_labels: Optional[int] = None
        self.num_classes: Optional[int] = None
        if not supervised:
            self.wanted_labels = None
        elif wanted_label is not None:
            self.wanted_labels = [wanted_label]
        else:
            self.wanted_labels = pp.get_label_cols(self.frame.names)
            self.num_labels = len(self.wanted_labels)
            if len(self.wanted_labels) == 1:
                # pandas' unique() counts NaN as one value
                v = label_values(self.frame, self.wanted_labels[0])
                self.num_classes = len(np.unique(v[~np.isnan(v)])) \
                    + int(np.isnan(v).any())
        self.frame = pp.remove_rows_with_no_label(self.frame,
                                                  self.wanted_labels)
        self.separate_noisy_data = (separate_noisy_data
                                    and "logistics_noisy" in self.frame.columns)
        if normalize_and_fill:
            # gap imputation always works at phys SUB-BAND granularity
            # (data_funcs.py:734,743), whatever the modality extraction
            self.frame, self.wanted_feats = pp.normalize_fill_df(
                self.frame, self.wanted_feats, normalization=normalization,
                remove_cols=True, fill_missing=fill_missing_with,
                fill_gaps=fill_gaps_with, seed=seed, subdivide_phys=True)

        # matrix extraction (data_funcs.py:133-159, 470-532)
        self._X = self.frame.matrix(self.wanted_feats)
        self._Y = self._label_matrix(self.frame)
        dataset = self.frame.columns["dataset"]
        self.test_X, self.test_Y = self._matrices(dataset == "Test")
        if self.separate_noisy_data:
            (self.clean_test_X, self.clean_test_Y, self.noisy_test_X,
             self.noisy_test_Y) = self._noisy_clean(dataset == "Test")
        if cross_validation:
            self.set_to_cross_validation_fold(0)
        else:
            self.train_X, self.train_Y = self._matrices(dataset == "Train")
            self.val_X, self.val_Y = self._matrices(dataset == "Val")
            if self.separate_noisy_data:
                (self.clean_train_X, self.clean_train_Y, self.noisy_train_X,
                 self.noisy_train_Y) = self._noisy_clean(dataset == "Train")
                (self.clean_val_X, self.clean_val_Y, self.noisy_val_X,
                 self.noisy_val_Y) = self._noisy_clean(dataset == "Val")
        self.num_feats = int(self.train_X.shape[1])

        if extract_modalities:
            self.modality_table = ModalityTable.from_feature_names(
                self.wanted_feats, subdivide_phys=self.subdivide_phys)
            self.modality_names = list(self.modality_table.names)
            # includes the num_feats sentinel (data_funcs.py:122)
            self.modality_start_indices = list(
                self.modality_table.start_indices)
            self.num_modalities = self.modality_table.num_modalities
        if not suppress_output:
            print(f"{len(self.train_X)} rows in training data; "
                  f"{len(self.val_X)} validation; {len(self.test_X)} test; "
                  f"{self.num_feats} features")

    def fold_ids(self) -> np.ndarray:
        """Each row's CV fold (-1 for Test rows), in ``frame`` order."""
        return np.asarray(self.frame.columns[pp.FOLD_COLUMN]).astype(
            np.float64).astype(np.int64)

    def _label_matrix(self, frame: Frame) -> Optional[np.ndarray]:
        """Every row's labels: (rows,) for one wanted label, (rows, L)
        otherwise; None when unsupervised."""
        if self.wanted_labels is None:
            return None
        cols = [label_values(frame, n) for n in self.wanted_labels]
        y = cols[0] if len(cols) == 1 else np.stack(cols, axis=1)
        return pp.labels_to_sign(y) if self.labels_to_sign else y

    def _matrices(self, rows: np.ndarray):
        """(X, Y) of the rows selected by the boolean mask ``rows``."""
        return self._X[rows], None if self._Y is None else self._Y[rows]

    def noisy_flags(self, frame: Optional[Frame] = None) -> np.ndarray:
        """Each row's ``logistics_noisy`` flag, in the order of ``frame``
        (default: this loader's)."""
        col = (self.frame if frame is None else frame).columns[
            "logistics_noisy"]
        if col.dtype.kind == "f":
            return col == 1.0
        return np.isin(col, _TRUE_TEXT)

    def _noisy_clean(self, rows: np.ndarray):
        """(clean_X, clean_Y, noisy_X, noisy_Y) of the selected rows
        (data_funcs.py:225-261)."""
        noisy = self.noisy_flags()
        cx, cy = self._matrices(rows & ~noisy)
        nx, ny = self._matrices(rows & noisy)
        return cx, cy, nx, ny

    def get_noisy_clean_data_for_dataset(self, dset: str):
        """(clean_X, clean_Y, noisy_X, noisy_Y) of one dataset split
        (data_funcs.py:225-245)."""
        return self._noisy_clean(self.frame.columns["dataset"] == dset)

    def get_noisy_or_clean_data_matrices(self, frame: Frame,
                                         noisy: bool = True):
        """(X, Y) of the noisy or the clean rows of ``frame``
        (data_funcs.py:247-261)."""
        rows = self.noisy_flags(frame) == noisy
        sub = frame.take(rows)
        return sub.matrix(self.wanted_feats), self._label_matrix(sub)

    # batch getters (data_funcs.py:161-202): uniform with replacement

    def get_unsupervised_train_batch(self, batch_size: int) -> np.ndarray:
        idx = self._rng.integers(0, len(self.train_X), size=batch_size)
        return self.train_X[idx]

    def get_supervised_train_batch(self, batch_size: int):
        idx = self._rng.integers(0, len(self.train_X), size=batch_size)
        return self.train_X[idx], self.train_Y[idx]

    def get_unsupervised_val_batch(self, batch_size: int) -> np.ndarray:
        idx = self._rng.integers(0, len(self.val_X), size=batch_size)
        return self.val_X[idx]

    def get_supervised_val_batch(self, batch_size: int):
        idx = self._rng.integers(0, len(self.val_X), size=batch_size)
        return self.val_X[idx], self.val_Y[idx]

    def get_val_data(self):
        return self.val_X, self.val_Y

    def get_feature_size(self) -> int:
        return int(np.shape(self.train_X)[1])

    def _fold_rows(self, fold: int):
        """Boolean masks of fold ``fold``'s train rows (every other
        non-Test row) and val rows (the fold itself)."""
        folds = self.fold_ids()
        return (folds != fold) & (folds != -1), folds == fold

    def get_cross_val_data_for_fold(self, fold: int):
        """(train_X, train_Y, val_X, val_Y) of fold ``fold``: its val rows
        are the fold, its train rows every other non-Test row
        (data_funcs.py:278-308).  The Y entries are None when
        unsupervised."""
        train, val = self._fold_rows(fold)
        return self._matrices(train) + self._matrices(val)

    def get_cross_val_noisy_flags_for_fold(self, fold: int) -> np.ndarray:
        """Boolean ``logistics_noisy`` flags of fold ``fold``'s val rows, in
        the row order of :meth:`get_cross_val_data_for_fold`'s val
        matrices."""
        return self.noisy_flags()[self._fold_rows(fold)[1]]

    def set_noisy_clean_data_for_fold(self, fold: int) -> None:
        """Rebind only the noisy/clean matrices to fold ``fold``
        (data_funcs.py:263-277)."""
        train, val = self._fold_rows(fold)
        (self.clean_train_X, self.clean_train_Y, self.noisy_train_X,
         self.noisy_train_Y) = self._noisy_clean(train)
        (self.clean_val_X, self.clean_val_Y, self.noisy_val_X,
         self.noisy_val_Y) = self._noisy_clean(val)

    def set_to_cross_validation_fold(self, fold: int) -> None:
        self.fold = fold
        (self.train_X, self.train_Y,
         self.val_X, self.val_Y) = self.get_cross_val_data_for_fold(fold)
        if self.separate_noisy_data:
            self.set_noisy_clean_data_for_fold(fold)

    def device_arrays(self, device="cuda", dtype=torch.float32
                      ) -> Dict[str, torch.Tensor]:
        """train_X, val_X, test_X (and their Ys when supervised) as tensors
        on ``device``: f32 by default; the reference's float64 cast
        (data_funcs.py:534-545) is a host-side artifact."""
        out = {"train_x": torch.as_tensor(self.train_X, dtype=dtype,
                                          device=device),
               "val_x": torch.as_tensor(self.val_X, dtype=dtype,
                                        device=device),
               "test_x": torch.as_tensor(self.test_X, dtype=dtype,
                                         device=device)}
        if self.wanted_labels is not None:
            out.update({k: torch.as_tensor(v, dtype=torch.float32,
                                           device=device)
                        for k, v in (("train_y", self.train_Y),
                                     ("val_y", self.val_Y),
                                     ("test_y", self.test_Y))})
        return out

    def find_missing_modalities_indices(self, x: np.ndarray) -> List[int]:
        """A modality is 'missing' iff its span is all -1.0 — detected via
        span sum == -width (data_funcs.py:366-381)."""
        missing: List[int] = []
        x = np.asarray(x, dtype=float)
        for i in range(self.num_modalities):
            s, e = self.modality_table.span(i)
            if np.sum(x[s:e]) == -1.0 * (e - s):
                missing.extend(range(s, e))
        return missing

    def fill_frame_with_reconstruction(
            self, frame: Frame, Xbar: np.ndarray, verbose: bool = False,
            plot_to_debug: bool = False, plot_save_dir: Optional[str] = None,
            max_debug_plots: int = 10) -> Frame:
        """Overwrite ONLY missing-modality entries with the reconstruction
        (data_funcs.py:310-364), all rows at once per modality.

        ``plot_to_debug`` draws the reference's visual check
        (data_funcs.py:339-355): an original / reconstructed / filled
        overlay of each filled row, at most ``max_debug_plots`` of them
        (the reference stops after 10), through ``utils/plotting.py``.
        With ``plot_save_dir`` they are written there as PNGs
        (``filled_row_<i>.png``) instead of shown."""
        X_orig = frame.matrix(self.wanted_feats)
        X = X_orig.copy()
        any_filled = np.zeros(len(frame), dtype=bool)
        for i in range(self.num_modalities):
            s, e = self.modality_table.span(i)
            missing_rows = X[:, s:e].sum(axis=1) == -1.0 * (e - s)
            X[missing_rows, s:e] = Xbar[missing_rows, s:e]
            any_filled |= missing_rows
        if plot_to_debug:
            from multimodalautoencoder_tpu_torch.utils import plotting
            if plot_save_dir is not None:
                os.makedirs(plot_save_dir, exist_ok=True)
            for n_shown, ridx in enumerate(np.flatnonzero(any_filled)):
                if n_shown >= max_debug_plots:
                    if verbose:
                        print(f"Okay you've looked at {n_shown} plots, "
                              "quitting now")
                    break
                save_path = (None if plot_save_dir is None else
                             os.path.join(plot_save_dir,
                                          f"filled_row_{ridx}.png"))
                plotting.plot_filled_row(X_orig[ridx], Xbar[ridx], X[ridx],
                                         show=plot_save_dir is None,
                                         save_path=save_path)
        if verbose:
            n = int(any_filled.sum())
            print(f"Filled {n} rows with reconstruction "
                  f"({n / max(len(frame), 1):.1%})")
        return frame.with_columns(self.wanted_feats, X)

    # the JAX package's name (its frames are DataFrames)
    fill_df_with_reconstruction = fill_frame_with_reconstruction
