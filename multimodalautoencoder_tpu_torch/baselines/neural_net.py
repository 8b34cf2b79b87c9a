"""The NN comparison baseline sweep, trained on the device.

Counterpart of ``multimodalautoencoder_tpu/baselines/neural_net.py``
(reference: comparison_algorithms/neural_net.py NNWrapper :407-630).  Grid:
architecture x dropout x weight_penalty x learning_rate x batch_size
(:410-412, :447-453), 5,000 training steps by default (:413).  Each fit
trains :mod:`..models.neural_net`'s MLP on ``device`` (default ``cuda``;
no fallback), seeded with ``seed``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.baselines.common import \
    ClassificationBaselineSweep
from multimodalautoencoder_tpu_torch.models import neural_net as nn

DEFAULT_ARCHS = ((300, 200, 100), (200, 100), (128, 64), (200, 100, 50))
DEFAULT_DROPOUTS = (0.5, 1.0)
DEFAULT_PENALTIES = (0.0, 0.01, 0.001, 0.0001)
DEFAULT_LRS = (0.001,)
DEFAULT_BATCHES = (100,)


class NNSweep(ClassificationBaselineSweep):
    def __init__(self, data_loader,
                 layer_sizes: Sequence[Sequence[int]] = DEFAULT_ARCHS,
                 dropout_probs: Sequence[float] = DEFAULT_DROPOUTS,
                 weight_penalties: Sequence[float] = DEFAULT_PENALTIES,
                 learning_rates: Sequence[float] = DEFAULT_LRS,
                 batch_sizes: Sequence[int] = DEFAULT_BATCHES,
                 num_steps: int = 5000, classifier_name: str = "NN",
                 seed: int = 0, record_every_nth: int = 0,
                 checkpoint_every_nth: int = 0,
                 checkpoint_dir: Optional[str] = None, device="cuda",
                 **kwargs):
        """``record_every_nth``: record (train_acc, val_acc) curves at this
        period during each fit (the reference records every
        output_every_nth steps, :224-241).  ``checkpoint_every_nth``: also
        save an npz checkpoint (and the curves so far) at this period to
        ``checkpoint_dir``, training in chunks between the saves (the
        reference's saver.save at every record step, :244).  Both default
        off (0)."""
        self.layer_sizes = [list(a) for a in layer_sizes]
        self.dropout_probs = list(dropout_probs)
        self.weight_penalties = list(weight_penalties)
        self.learning_rates = list(learning_rates)
        self.batch_sizes = list(batch_sizes)
        self.num_steps = num_steps
        self.seed = seed
        self.record_every_nth = int(record_every_nth)
        self.checkpoint_every_nth = int(checkpoint_every_nth)
        self.checkpoint_dir = checkpoint_dir
        self.device = torch.device(device)
        self.curves = None          # the last fit's {train_acc, val_acc}
        self._fit_counter = 0
        super().__init__(data_loader, classifier_name=classifier_name,
                         **kwargs)

    def define_params(self) -> None:
        self.params = {"architecture": self.layer_sizes,
                       "dropout_prob": self.dropout_probs,
                       "weight_penalty": self.weight_penalties,
                       "learning_rate": self.learning_rates,
                       "batch_size": self.batch_sizes}

    def _tensor(self, a, labels: bool = False) -> torch.Tensor:
        a = np.asarray(a, dtype=np.float32)
        if labels and a.ndim == 1:
            a = a[:, None]
        return torch.as_tensor(a, device=self.device)

    def fit(self, setting: Dict[str, Any], train_X, train_Y):
        tx, ty = self._tensor(train_X), self._tensor(train_Y, labels=True)
        cfg = nn.NNConfig(
            input_size=tx.shape[1],
            layer_sizes=tuple(setting["architecture"]),
            output_size=ty.shape[1],
            dropout_prob=float(setting["dropout_prob"]),
            weight_penalty=float(setting["weight_penalty"]),
            learning_rate=float(setting["learning_rate"]),
            batch_size=int(setting["batch_size"]),
            seed=self.seed)
        # record against the current fold's val split when there is one
        # (the reference records val accuracy mid-train, :226-241)
        dl = self.data_loader
        if getattr(dl, "val_X", None) is not None and len(dl.val_X):
            vx, vy = self._tensor(dl.val_X), self._tensor(dl.val_Y, True)
        else:
            vx, vy = tx[:1], ty[:1]
        state = nn.init_state(cfg, self.device)

        if self.checkpoint_every_nth > 0:
            # train in chunks of checkpoint_every_nth steps; the host saves
            # a checkpoint and the curves so far between them
            rec = min(self.record_every_nth or self.checkpoint_every_nth,
                      self.checkpoint_every_nth)
            ta_all, va_all = [], []
            done = 0
            self._fit_counter += 1
            name = f"nn_fit{self._fit_counter}"
            while done < self.num_steps:
                chunk = min(self.checkpoint_every_nth, self.num_steps - done)
                state, (ta, va) = nn.train(state, cfg, tx, ty, vx, vy,
                                           num_steps=chunk,
                                           record_every_nth=rec)
                ta_all.extend(ta.cpu().tolist())
                va_all.extend(va.cpu().tolist())
                done += chunk
                nn.save_model(self.checkpoint_dir or "nn_checkpoints",
                              f"{name}_step{done}", state.params, cfg,
                              curves={"train_acc": ta_all,
                                      "val_acc": va_all})
            self.curves = {"train_acc": ta_all, "val_acc": va_all}
        elif self.record_every_nth > 0:
            state, (ta, va) = nn.train(
                state, cfg, tx, ty, vx, vy, num_steps=self.num_steps,
                record_every_nth=self.record_every_nth)
            self.curves = {"train_acc": ta.cpu().numpy(),
                           "val_acc": va.cpu().numpy()}
        else:
            state, _ = nn.train(state, cfg, tx, ty, vx, vy,
                                num_steps=self.num_steps)
        return (state.params, cfg)

    def predict_model(self, model, X):
        params, cfg = model
        preds = nn.predict(params, cfg, self._tensor(X)).cpu().numpy()
        return preds[:, 0] if preds.shape[1] == 1 else preds
