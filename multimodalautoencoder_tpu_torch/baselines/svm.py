"""The SVM comparison baseline (reference: comparison_algorithms/svm.py).

Counterpart of ``multimodalautoencoder_tpu/baselines/svm.py``: the grid
C x beta (kernel width, sklearn's gamma) x kernel (:27, :83-88), with the
redundant linear-kernel x beta settings trimmed (:67-81).  The caller's
loader converts {0,1} labels to {-1,1} (``labels_to_sign``, :56-65).  The
estimator is scikit-learn's ``SVC`` on the host, imported at first use;
without scikit-learn the constructor raises an ImportError that names it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from multimodalautoencoder_tpu_torch.baselines.common import (
    ClassificationBaselineSweep, require_sklearn)
from multimodalautoencoder_tpu_torch.sweep import grid as grid_lib

DEFAULT_C_VALS = (0.1, 1.0, 10.0, 100.0)
DEFAULT_BETA_VALS = (0.0001, 0.001, 0.01, 0.1, 1.0)
DEFAULT_KERNELS = ("linear", "rbf")


class SVMSweep(ClassificationBaselineSweep):
    def __init__(self, data_loader,
                 c_vals: Sequence[float] = DEFAULT_C_VALS,
                 beta_vals: Sequence[float] = DEFAULT_BETA_VALS,
                 kernels: Sequence[str] = DEFAULT_KERNELS,
                 classifier_name: str = "SVM", **kwargs):
        require_sklearn("the SVM baseline")
        self.c_vals = list(c_vals)
        self.beta_vals = list(beta_vals)
        self.kernels = list(kernels)
        super().__init__(data_loader, classifier_name=classifier_name,
                         **kwargs)

    def define_params(self) -> None:
        self.params = {"C": self.c_vals, "beta": self.beta_vals,
                       "kernel": self.kernels}

    def trim_settings(self, settings):
        return grid_lib.trim_linear_beta(settings)

    def fit(self, setting: Dict[str, Any], train_X, train_Y):
        from sklearn.svm import SVC

        model = SVC(C=float(setting["C"]), kernel=setting["kernel"],
                    gamma=float(setting["beta"]))
        model.fit(train_X, train_Y)
        return model

    def predict_model(self, model, X):
        return model.predict(X)
