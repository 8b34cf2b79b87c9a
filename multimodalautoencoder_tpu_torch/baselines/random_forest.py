"""The random-forest comparison baseline
(reference: comparison_algorithms/random_forest.py).

Counterpart of ``multimodalautoencoder_tpu/baselines/random_forest.py``:
the grid num_trees x criterion x max_depth x min_leaf (:26-28, :59-65),
scikit-learn's ``RandomForestClassifier`` on the host, imported at first
use; without scikit-learn the constructor raises an ImportError that
names it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from multimodalautoencoder_tpu_torch.baselines.common import (
    ClassificationBaselineSweep, require_sklearn)

DEFAULT_NUM_TREES = (10, 25, 40, 100)
DEFAULT_CRITERIA = ("gini", "entropy")
DEFAULT_MAX_DEPTHS = (None, 10, 30)
DEFAULT_MIN_LEAFS = (1, 3, 5)


class RFSweep(ClassificationBaselineSweep):
    def __init__(self, data_loader,
                 num_trees: Sequence[int] = DEFAULT_NUM_TREES,
                 criteria: Sequence[str] = DEFAULT_CRITERIA,
                 max_depths: Sequence = DEFAULT_MAX_DEPTHS,
                 min_leafs: Sequence[int] = DEFAULT_MIN_LEAFS,
                 classifier_name: str = "RF", **kwargs):
        require_sklearn("the random-forest baseline")
        self.num_trees = list(num_trees)
        self.criteria = list(criteria)
        self.max_depths = list(max_depths)
        self.min_leafs = list(min_leafs)
        super().__init__(data_loader, classifier_name=classifier_name,
                         **kwargs)

    def define_params(self) -> None:
        self.params = {"num_trees": self.num_trees,
                       "criterion": self.criteria,
                       "max_depth": self.max_depths,
                       "min_leaf": self.min_leafs}

    def fit(self, setting: Dict[str, Any], train_X, train_Y):
        from sklearn.ensemble import RandomForestClassifier

        depth = setting["max_depth"]
        # None round-trips through the results CSV as an empty cell, read
        # back as None (NaN in the JAX package's pandas ledger); both mean
        # no depth limit (generic_wrapper.py:223-244)
        if depth in (None, "None") or (isinstance(depth, float)
                                       and depth != depth):
            depth = None
        else:
            depth = int(depth)
        model = RandomForestClassifier(
            n_estimators=int(setting["num_trees"]),
            criterion=setting["criterion"], max_depth=depth,
            min_samples_leaf=int(setting["min_leaf"]))
        model.fit(train_X, train_Y)
        return model

    def predict_model(self, model, X):
        return model.predict(X)
