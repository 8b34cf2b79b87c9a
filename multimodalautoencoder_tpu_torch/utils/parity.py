"""The parity tolerance band of the reference recipe.

Counterpart of ``multimodalautoencoder_tpu/utils/parity.py``.  The
reference's two scalar observables, the ones it optimizes and reports
itself, define "the same numbers":

1. the noisy-val reconstruction loss, the grid-search objective
   (multimodal_autoencoder.py:1019-1033, used at
   autoencoder_wrapper.py:198);
2. the per-modality masked-reconstruction RMSE, the paper's headline table
   (multimodal_autoencoder.py:1189-1216).

:func:`reference_recipe_observables` trains the reference recipe
(sigmoid-CE, lr 1e-3, 0-1 normalization, mask -1.0, decay 1000 / 0.95,
batch 20, Adam: autoencoder_wrapper.py:79-92) on the deterministic
synthetic fixture set, ``num_runs`` runs as one bucket of the port's grid
trainer, and returns both observables per run.  The stored band
(tests/fixtures/parity_band.json, derived from the JAX package's XLA runs,
PARITY.md) holds both backends: ``"xla"``, the plain trainer, and
``"pallas"``, the CUDA training kernel (its twin on the CPU).  Random
streams differ between packages and backends, so the parity is
distributional, never bitwise.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import numpy as np

FIXTURE_SEED = 7
FIXTURE_ROWS = 400
# bump when synthetic.write_csv's recipe changes: the cached fixture's
# name carries it, so a file from older code is never reused
FIXTURE_VERSION = 1
RECIPE_STEPS = 500
RECIPE_ARCH = (16, 8)


def _fixture_loader():
    """The synthetic fixture set through the whole DataLoader path
    (normalization and imputation included).  The cached CSV's name
    carries the version, seed and rows, and it is written atomically."""
    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.data.loader import DataLoader

    path = os.path.join(
        tempfile.gettempdir(),
        f"parity_fixture_v{FIXTURE_VERSION}_{FIXTURE_SEED}"
        f"_{FIXTURE_ROWS}.csv")
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(suffix=".csv", dir=tempfile.gettempdir())
        os.close(fd)
        synthetic.write_csv(tmp, num_rows=FIXTURE_ROWS, seed=FIXTURE_SEED)
        os.replace(tmp, path)
    return DataLoader(path, supervised=False, cross_validation=False,
                      suppress_output=True, normalize_and_fill=True,
                      normalization="between_0_and_1", fill_gaps_with=-1.0)


def reference_recipe_observables(backend: str = "xla", num_runs: int = 3,
                                 num_steps: int = RECIPE_STEPS,
                                 device="cuda",
                                 base_seed: int = 0) -> Dict[str, np.ndarray]:
    """Train the reference recipe ``num_runs`` times on ``device`` and
    return ``{"noisy_val_loss": (N,), "per_modality_rmse": (N, M)}``.

    The runs are the configs of one bucket with the same hyperparameters,
    trained by ``grid_trainer.train_grid_sharded`` seeded
    ``base_seed * 7919 + 13``: ``backend="pallas"`` puts them on the
    training kernel (each instance its own Philox seed), ``"xla"`` on the
    plain trainer.  The rows are independent repetitions."""
    import torch

    from multimodalautoencoder_tpu_torch.config import MMAEConfig, \
        TrainConfig
    from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
    from multimodalautoencoder_tpu_torch.ops import optim
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
    from multimodalautoencoder_tpu_torch.train import trainer

    dl = _fixture_loader()
    cfg = MMAEConfig(num_feats=dl.num_feats, layer_sizes=RECIPE_ARCH,
                     tie_weights=True, loss="sigmoid_cross_entropy",
                     normalization="between_0_and_1", mask_with=-1.0,
                     fill_missing_with=0.0, weight_initialization="normal",
                     activation="softsign").validate()
    tcfg = TrainConfig(learning_rate=1e-3, batch_size=20,
                       num_steps=num_steps, decay=True, decay_steps=1000,
                       decay_rate=0.95, clip_gradients=False)
    spec = NoiseSpec.build(cfg, dl.modality_table)
    device = torch.device(device)
    folded = gt.FoldedData.from_single_split(np.asarray(dl.train_X),
                                             np.asarray(dl.val_X), device)
    settings = [{"dropout_prob": 1.0, "weight_penalty": 0.0,
                 "activation_function": "softsign"}] * int(num_runs)
    hyper = gt.HyperStack.from_settings(settings, cfg, tcfg)
    params, losses = gt.train_grid_sharded(
        device, int(base_seed) * 7919 + 13, cfg, tcfg, spec, hyper, folded,
        num_steps, backend=backend)
    masks = torch.as_tensor(dl.modality_table.feature_masks())
    val_x = torch.as_tensor(np.asarray(dl.val_X, np.float32), device=device)
    rmse = [trainer.reconstruction_loss_per_modality(
        optim.tree_map(lambda t, r=r: t[r, 0], params), cfg, masks,
        val_x).cpu().numpy() for r in range(int(num_runs))]
    return {"noisy_val_loss": np.asarray(losses[:, 0].cpu(), np.float64),
            "per_modality_rmse": np.asarray(rmse, np.float64)}


def check_band(obs: Dict[str, np.ndarray], band: dict) -> list:
    """Return a list of violation strings (empty = all inside the band)."""
    problems = []
    lo, hi = band["noisy_val_loss"]
    for i, v in enumerate(obs["noisy_val_loss"]):
        if not (lo <= float(v) <= hi):
            problems.append(f"noisy_val_loss[seed {i}] = {v:.4f} "
                            f"outside [{lo:.4f}, {hi:.4f}]")
    for m, (mlo, mhi) in enumerate(band["per_modality_rmse"]):
        for i, v in enumerate(obs["per_modality_rmse"][:, m]):
            if not (mlo <= float(v) <= mhi):
                problems.append(
                    f"per_modality_rmse[seed {i}, modality {m}] = "
                    f"{v:.4f} outside [{mlo:.4f}, {mhi:.4f}]")
    return problems


def derive_band(observables: Dict[str, np.ndarray],
                rel_margin: float = 0.10,
                n_sigma: float = 6.0) -> dict:
    """Band = [min, max] widened by max(rel_margin * mean, n_sigma * std)
    per observable: generous enough for backend and hardware RNG
    variation, tight enough to catch objective regressions (a wrong loss
    term or a broken corruption path moves these observables more than
    10 %, and an untrained model's noisy-val loss already sits outside
    the band)."""
    def wide(vals):
        vals = np.asarray(vals, dtype=float)
        margin = max(rel_margin * abs(vals.mean()),
                     n_sigma * vals.std())
        return [float(vals.min() - margin), float(vals.max() + margin)]

    return {
        "noisy_val_loss": wide(observables["noisy_val_loss"]),
        "per_modality_rmse": [
            wide(observables["per_modality_rmse"][:, m])
            for m in range(observables["per_modality_rmse"].shape[1])],
    }
