"""Sweep engine: results ledger, resume semantics, best-setting selection.

Counterpart of ``multimodalautoencoder_tpu/sweep/engine.py`` without
pandas.  The reference's durable state is a results table flushed to CSV,
used both for analysis and as the resume log (generic_wrapper.py:104-109,
:205-221, :256, :287-288).  :class:`ResultsLedger` keeps it as a list of
row dicts and writes the CSV the JAX package's pandas ledger writes and
reads: an unnamed index column first, the columns in order of first
appearance, list cells as ``str(list)``, floats as Python prints them,
``None`` and absent cells empty.  Either package's ledger resumes from the
other's file.  :class:`SerialSweep` is the reference's one-setting-at-a-time
template (generic_wrapper.py ``Wrapper``), which the comparison baselines
(``baselines/``) run on.
"""

from __future__ import annotations

import csv
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from multimodalautoencoder_tpu_torch.sweep import grid as grid_lib
from multimodalautoencoder_tpu_torch.utils import helpers


def get_save_prefix(results_path: str, classifier_name: str, filename: str,
                    wanted_label: Optional[str] = None,
                    replace: bool = False) -> str:
    """``<classifier>-<datafile>[-<label>]`` with '2'-suffix collision
    avoidance (generic_wrapper.py:187-203, :417-431).  ``filename`` may be
    a full path; only the basename enters the prefix."""
    filename = os.path.basename(filename)
    end = filename.find(".")
    prefix = classifier_name + "-" + (filename[:end] if end >= 0
                                      else filename)
    if wanted_label is not None:
        prefix += "-" + helpers.get_friendly_label_name(wanted_label)
    if not replace:
        while os.path.exists(os.path.join(results_path, prefix + ".csv")):
            prefix = prefix + "2"
    return prefix


def _cell_text(v: Any) -> str:
    """A value as pandas' ``to_csv`` writes it."""
    if v is None:
        return ""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


def _parse_cell(text: str) -> Any:
    """A CSV cell back to a value, as ``pd.read_csv`` infers it: empty is
    None (NaN), True/False are bools, then int, float, else the text."""
    if text == "":
        return None
    if text in ("True", "False"):
        return text == "True"
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def as_float(v: Any) -> float:
    """``pd.to_numeric(errors="coerce")`` of one cell."""
    if v is None or isinstance(v, str):
        try:
            return float(v)
        except (TypeError, ValueError):
            return float("nan")
    return float(v)


class ResultsLedger:
    """The durable sweep log: one row per tested setting.

    The reference contract: ``cont=True`` reloads the CSV and
    :meth:`already_done` skips settings whose full parameter combination
    already appears (generic_wrapper.py:104-109, :205-221); rows flush to
    CSV every ``save_every_nth`` appends (:287-288) and at :meth:`flush`.
    ``rows`` holds one dict per row, ``columns`` their order.
    """

    def __init__(self, results_path: str, save_prefix: str,
                 cont: bool = False, save_every_nth: int = 1):
        os.makedirs(results_path, exist_ok=True)
        self.path = os.path.join(results_path, save_prefix + ".csv")
        self.save_every_nth = save_every_nth
        self.rows: List[Dict[str, Any]] = []
        self.columns: List[str] = []
        if cont and os.path.exists(self.path):
            with open(self.path, newline="") as f:
                table = list(csv.reader(f))
            if table:
                self.columns = table[0][1:]
                self.rows = [dict(zip(self.columns,
                                      (_parse_cell(c) for c in r[1:])))
                             for r in table[1:]]
        self.started_from = len(self.rows)

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> List[Any]:
        return [r.get(name) for r in self.rows]

    def matching_rows(self, setting: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Rows where every (key, value) of ``setting`` matches.  Lists
        compare by str (the CSV round-trip form,
        generic_wrapper.py:213-217); numbers compare numerically like the
        reference's native ``==`` (:211), so int 0 matches a reloaded
        '0.0'; None matches an empty cell or 'None'."""
        mini = self.rows
        for key, val in setting.items():
            if key not in self.columns:
                return []
            if isinstance(val, (list, tuple)):
                want = str(list(val))
                mini = [r for r in mini if str(r.get(key)) == want]
            elif val is None:
                mini = [r for r in mini
                        if r.get(key) is None or str(r.get(key)) == "None"]
            elif isinstance(val, (int, float)) and not isinstance(val, bool):
                mini = [r for r in mini if as_float(r.get(key)) == float(val)]
            else:
                mini = [r for r in mini if str(r.get(key)) == str(val)]
            if not mini:
                return []
        return mini

    def already_done(self, setting: Dict[str, Any]) -> bool:
        """True iff ``setting``'s full parameter combination already
        appears in the ledger (generic_wrapper.py:205-221)."""
        return len(self.matching_rows(setting)) > 0

    def lookup(self, setting: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """First ledger row matching ``setting``, or None."""
        rows = self.matching_rows(setting)
        return rows[0] if rows else None

    def append(self, row: Dict[str, Any]) -> None:
        row = {k: (str(list(v)) if isinstance(v, (list, tuple)) else v)
               for k, v in row.items()}
        for k in row:
            if k not in self.columns:
                self.columns.append(k)
        self.rows.append(row)
        if len(self.rows) % self.save_every_nth == 0:
            self.flush()

    def flush(self) -> None:
        with open(self.path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + self.columns)
            for i, r in enumerate(self.rows):
                w.writerow([str(i)] + [_cell_text(r.get(c))
                                       for c in self.columns])

    def find_best_setting(self, optimize_for: str,
                          min_or_max: str = "max") -> Dict[str, Any]:
        """Row with the best value of ``optimize_for``
        (generic_wrapper.py:317-347), the first of ties; an all-NaN
        column degrades to the first row."""
        scores = np.asarray([as_float(v) for v in self.column(optimize_for)])
        if np.isnan(scores).all():
            return dict(self.rows[0])
        pick = np.nanargmin if min_or_max == "min" else np.nanargmax
        return dict(self.rows[int(pick(scores))])


class TimeEstimator:
    """Wall-clock ETA across settings (generic_wrapper.py:270-282,
    :305-315)."""

    def __init__(self, num_settings: int, started_from: int = 0):
        self.num_settings = num_settings
        self.started_from = started_from
        self.time_sum = 0.0
        self.num_done = 0

    def record(self, seconds: float, batch: int = 1) -> None:
        self.time_sum += seconds
        self.num_done += batch

    def summary(self) -> str:
        if self.num_done == 0:
            return "no timing data yet"
        remaining = self.num_settings - self.num_done - self.started_from
        avg = self.time_sum / self.num_done
        h, m, s = helpers.get_secs_mins_hours_from_secs(
            int(avg * max(remaining, 0)))
        return (f"{self.num_done} settings processed, {remaining} left; "
                f"~{h}h {m}m {s}s remaining")


class SerialSweep:
    """The reference's one-setting-at-a-time sweep (generic_wrapper.py
    ``Wrapper``), for models fitted one setting at a time.

    Subclasses implement :meth:`define_params` and
    :meth:`get_cross_validation_results` (and :meth:`test_on_test` for
    ``check_test``); :meth:`run` enumerates the grid, skips the settings
    a resumed ledger already holds, appends one row per setting, and
    picks the best.
    """

    def __init__(self, results_path: str, save_prefix: str,
                 optimize_for: str, min_or_max: str = "max",
                 cont: bool = False, check_test: bool = False,
                 save_results_every_nth: int = 1, verbose: bool = True):
        self.optimize_for = optimize_for
        self.min_or_max = min_or_max
        self.check_test = check_test
        self.verbose = verbose
        self.ledger = ResultsLedger(results_path, save_prefix, cont=cont,
                                    save_every_nth=save_results_every_nth)
        self.params: Dict[str, Sequence[Any]] = {}
        self.define_params()
        self.list_of_param_settings = self.trim_settings(
            grid_lib.enumerate_grid(self.params))
        self.num_settings = len(self.list_of_param_settings)

    # hooks ---------------------------------------------------------------
    def define_params(self) -> None:
        raise NotImplementedError

    def trim_settings(self, settings: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
        return settings

    def get_cross_validation_results(self, setting: Dict[str, Any]
                                     ) -> Dict[str, Any]:
        raise NotImplementedError

    def test_on_test(self, setting: Dict[str, Any]):
        raise NotImplementedError

    # engine --------------------------------------------------------------
    def sweep_all_parameters(self) -> None:
        est = TimeEstimator(self.num_settings, self.ledger.started_from)
        for setting in self.list_of_param_settings:
            if self.ledger.started_from and self.ledger.already_done(setting):
                continue
            t0 = time.time()
            self.ledger.append(self.get_cross_validation_results(
                dict(setting)))
            est.record(time.time() - t0)
            if self.verbose:
                print(est.summary())
                sys.stdout.flush()
        self.ledger.flush()

    def get_final_results(self):
        """(best ledger row, held-out scores or None)."""
        best = self.ledger.find_best_setting(self.optimize_for,
                                             self.min_or_max)
        if self.verbose:
            print(f"Best {self.optimize_for}: {best[self.optimize_for]}")
        if self.check_test:
            setting = grid_lib.convert_param_dict_for_use(best)
            return best, self.test_on_test(setting)
        return best, None

    def run(self):
        self.sweep_all_parameters()
        return self.get_final_results()


def nanmean(values) -> float:
    arr = np.asarray(values, dtype=float)
    if np.all(np.isnan(arr)):
        return float("nan")
    return float(np.nanmean(arr))
