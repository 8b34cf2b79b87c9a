"""The logistic-regression comparison baseline
(reference: comparison_algorithms/logistic_regression.py).

Counterpart of
``multimodalautoencoder_tpu/baselines/logistic_regression.py``: the grid
penalty x C (:26, :53-57), scikit-learn's ``LogisticRegression`` with the
liblinear solver on the host, imported at first use; without scikit-learn
the constructor raises an ImportError that names it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from multimodalautoencoder_tpu_torch.baselines.common import (
    ClassificationBaselineSweep, require_sklearn)

DEFAULT_PENALTIES = ("l1", "l2")
DEFAULT_C_VALS = (0.0001, 0.001, 0.01, 0.1, 1.0, 10.0, 100.0)


class LRSweep(ClassificationBaselineSweep):
    def __init__(self, data_loader,
                 penalties: Sequence[str] = DEFAULT_PENALTIES,
                 c_vals: Sequence[float] = DEFAULT_C_VALS,
                 classifier_name: str = "LR", **kwargs):
        require_sklearn("the logistic-regression baseline")
        self.penalties = list(penalties)
        self.c_vals = list(c_vals)
        super().__init__(data_loader, classifier_name=classifier_name,
                         **kwargs)

    def define_params(self) -> None:
        self.params = {"penalty": self.penalties, "C": self.c_vals}

    def fit(self, setting: Dict[str, Any], train_X, train_Y):
        from sklearn.linear_model import LogisticRegression

        # liblinear takes both l1 and l2 (sklearn wants the solver named
        # for l1)
        model = LogisticRegression(penalty=setting["penalty"],
                                   C=float(setting["C"]),
                                   solver="liblinear")
        model.fit(train_X, train_Y)
        return model

    def predict_model(self, model, X):
        return model.predict(X)
