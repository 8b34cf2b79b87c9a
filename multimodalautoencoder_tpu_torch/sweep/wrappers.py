"""The MMAE sweep and the two-phase classification sweep, on one device,
split over several, or sharded over processes.

Counterpart of ``MMAESweep`` (:154-725) and ``MMAEClassificationSweep``
(:728-1467) in ``multimodalautoencoder_tpu/sweep/wrappers.py``, the
capabilities of the reference's MMAEWrapper (autoencoder_wrapper.py
:27-385) and MMAEClassificationWrapper
(autoencoder_classification_wrapper.py:26-369).  Where the reference loops
settings x folds serially, the sweeps bucket the grid by shape
(``sweep/grid.py``) and train each bucket's configs x folds block at once
(``parallel/grid_trainer.py``: the hand-written CUDA kernels on a GPU, or
the plain trainers).  ``MMAESweep`` scores each bucket by its noisy-val
objective and the on-device embedding probe (``sweep/probe.py``); the
classification sweep pretrains each phase-1 family's unique MMAE settings
once (the JAX package's ``share_phase1=True`` default, PARITY.md), or with
``share_phase1=False`` retrains the MMAE for every setting as the reference
does (``grid_trainer.train_two_phase_sharded``), and runs its metric
battery batched on the device.  The ledger, resume and best-setting
contract is the reference's (``sweep/engine.py``).  ``check_test`` and
exporting a winner from an earlier generation of a resumed ledger retrain
one setting on fold 0 with the single-run trainer (``train/trainer.py``).

``probe="svm"`` scores the embeddings with the reference's host
scikit-learn SVC grid instead; scikit-learn is no dependency of the port,
and without it that probe raises an ImportError that names it.

``device`` is a device or a device list, the JAX package's mesh: each
bucket's instances are split over the devices (``parallel/mesh.py``,
``parallel/grid_trainer.py``).  ``process_shard=(i, n)`` sweeps only the
round-robin slice i of n of the grid into the ledger shard
``<prefix>.shard{i}of{n}`` and exports a shard-tagged winner, for
``parallel/multihost.py`` to merge and to pick the global winner from.
The JAX compile cache has no counterpart.
"""

from __future__ import annotations

import inspect
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
from multimodalautoencoder_tpu_torch.ops import cls_train_kernels
from multimodalautoencoder_tpu_torch.ops import metrics as metrics_lib
from multimodalautoencoder_tpu_torch.ops import optim
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
from multimodalautoencoder_tpu_torch.parallel import mesh, multihost
from multimodalautoencoder_tpu_torch.sweep import engine, grid as grid_lib
from multimodalautoencoder_tpu_torch.sweep import probe as probe_lib
from multimodalautoencoder_tpu_torch.train import trainer
from multimodalautoencoder_tpu_torch.utils import helpers

# autoencoder_wrapper.py:25
LABELS_TO_PREDICT = ["happiness", "health", "calmness"]
DEFAULT_NUM_CROSS_FOLDS = 5
METRIC_ORDER = ("acc", "auc", "f1", "precision", "recall")


def _arch_tuple(a) -> tuple:
    return tuple(a) if isinstance(a, (list, tuple)) else (a,)


def _metric_battery(preds: torch.Tensor, val_y: torch.Tensor,
                    val_n: torch.Tensor,
                    noisy: Optional[torch.Tensor]) -> torch.Tensor:
    """acc/auc/f1/precision/recall of every (config, fold, label) at once,
    with the noisy/clean val slices: the JAX package's
    ``_metric_battery_jit`` (:49-89) as batched torch.  ``preds`` (C, K,
    R, L), ``val_y`` (K, R, L), ``val_n`` (K,), ``noisy`` (K, R) bool or
    None.  Returns one (3, 5, C, K, L) tensor: slice axis [main, noisy,
    clean] (main three times without flags), metric axis
    :data:`METRIC_ORDER`."""
    R = val_y.shape[1]
    dev = preds.device
    valid = (torch.arange(R, device=dev).view(1, -1)
             < val_n.to(dev).view(-1, 1))                     # (K, R)
    p = preds.to(torch.float32).permute(0, 1, 3, 2)            # (C, K, L, R)
    y = val_y.to(dev, torch.float32).permute(0, 2, 1).unsqueeze(0)

    def stack(mask):
        m = metrics_lib.all_classification_metrics(p, y,
                                                   mask[:, None, :])
        return torch.stack([m[k] for k in METRIC_ORDER])      # (5, C, K, L)

    main = stack(valid)
    if noisy is None:
        return torch.stack([main, main, main])
    noisy = noisy.to(dev)
    return torch.stack([main, stack(valid & noisy), stack(valid & ~noisy)])


def _grid_setting_from_row(sweep, row: Dict[str, Any]) -> Dict[str, Any]:
    """The grid-setting subset of a ledger row (drops score/timing
    columns), keyed by the sweep's own grid axes."""
    keys = (set(sweep.list_of_param_settings[0])
            if sweep.list_of_param_settings else set(row))
    return {k: v for k, v in row.items() if k in keys}


def _sharded(settings, prefix: str, results_path: str, process_shard):
    """The settings and ledger prefix of ``process_shard`` = (i, n): the
    round-robin slice i of n and ``<prefix>.shard{i}of{n}``, or both
    unchanged without a shard."""
    if process_shard is None:
        return settings, prefix
    i, n = process_shard
    return (multihost.partition_settings(settings, i, n),
            multihost.shard_ledger_path(results_path, prefix, i, n))


def _export_best_checkpoint(sweep, *, base_name: str, step: int, resolve):
    """Checkpoint the ledger's winner (the persistence analog of the
    reference's save_model on the chosen setting,
    multimodal_autoencoder.py:766-800).  ``resolve(row, ledger_score) ->
    (setting, host params, cfg, score)`` decides between the parameters
    tracked in this process and a retrain; ``meta['extra']`` records the
    winning setting, its score, ``optimize_for`` and ``min_or_max``.
    Under ``process_shard`` = (i, n) the name is ``{base_name}.shard{i}of
    {n}``, so processes sharing a results directory never overwrite each
    other's slice winner and ``multihost.select_global_best_checkpoint``
    can pick the global one.  Returns the path (None on an empty
    ledger)."""
    from multimodalautoencoder_tpu_torch.train import checkpoint as ck

    if len(sweep.ledger) == 0:
        return None
    row = sweep.ledger.find_best_setting(sweep.optimize_for,
                                         sweep.min_or_max)
    ledger_score = engine.as_float(row.get(sweep.optimize_for))
    setting, host_params, cfg, score = resolve(row, ledger_score)
    if sweep.process_shard is not None:
        i, n = sweep.process_shard
        base_name = f"{base_name}.shard{i}of{n}"
    path = ck.save_checkpoint(
        os.path.dirname(sweep.ledger.path), base_name, host_params, cfg,
        step=step,
        extra={"setting": setting, "score": score,
               "optimize_for": sweep.optimize_for,
               "min_or_max": sweep.min_or_max})
    if sweep.verbose:
        print(f"saved best params ({sweep.optimize_for} {score:.4f}) -> "
              f"{path}")
    return path


class MMAESweep:
    """Grid search over MMAE hyperparameters, scored by noisy-val
    reconstruction loss, with the on-device embedding-quality probe: the
    capabilities of MMAEWrapper (autoencoder_wrapper.py:27-385), on
    ``device`` (a device or a device list)."""

    def __init__(self, data_loader, classification_data_loader=None,
                 layer_sizes: Sequence[Sequence[int]] = ((1000, 100),
                                                         (500, 100),
                                                         (300, 100)),
                 tie_weights: Sequence[bool] = (True, False),
                 dropout_probs: Sequence[float] = (1.0, 0.5),
                 weight_penalties: Sequence[float] = (0.0, 0.01, 0.001),
                 weight_initializers: Sequence[str] = ("normal",),
                 activation_funcs: Sequence[str] = ("softsign", "relu"),
                 test_variational: bool = True,
                 results_path: str = "results", classifier_name="MMAE",
                 cont: bool = False, check_test: bool = False,
                 num_cross_folds: int = DEFAULT_NUM_CROSS_FOLDS,
                 optimize_for: Optional[str] = None, min_or_max="min",
                 num_steps: int = 15000, batch_size: int = 20,
                 learning_rate: float = 1e-3,
                 clip_gradients: bool = False,
                 labels_to_predict: Optional[Sequence[str]] = None,
                 probe: Optional[str] = "device",
                 probe_rff_dim: int = 512,
                 svm_Cs: Sequence[float] = (1.0, 10.0, 100.0),
                 svm_gammas: Sequence[float] = (0.01, 0.001),
                 save_results_every_nth: int = 1, seed: int = 0,
                 verbose: bool = True, process_shard=None,
                 save_best_params: bool = False, backend: str = "auto",
                 optimizers: Optional[Sequence[str]] = None,
                 optimizer_state_dtype: str = "bfloat16", device="cuda"):
        """The JAX ``MMAESweep``'s arguments, ``device`` (a device or a
        device list, each bucket split over them) in place of its mesh.
        ``probe``: 'device' (default) scores embeddings with the
        random-Fourier ridge probe (``probe_rff_dim`` features),
        'device-exact' with the exact kernel ridge, 'svm' with the
        reference's host SVC grid (scikit-learn), None disables.
        ``backend``: 'auto' trains on the
        CUDA kernels where the shape family allows and the device is a
        GPU, the plain trainer otherwise; 'xla' / 'pallas' force.
        ``save_best_params`` checkpoints the best setting's fold-0
        parameters as ``best_mmae`` at the end of the sweep.
        ``check_test`` retrains the best setting on fold 0 and scores it on
        the test set (:meth:`test_on_test`).  ``process_shard``: an
        optional (process_index, process_count) that sweeps only this
        process's round-robin slice of the grid into a ledger shard
        (``parallel/multihost.py``)."""
        if probe not in (None, "device", "device-exact", "svm"):
            raise ValueError(f"unknown probe {probe!r}")
        if probe == "svm" and classification_data_loader is not None:
            from multimodalautoencoder_tpu_torch.baselines.common import \
                require_sklearn
            require_sklearn("probe='svm'")
        self.devices = mesh.as_devices(device)
        self.device = self.devices[0]
        self.process_shard = process_shard
        self.data_loader = data_loader
        self.cls_loader = classification_data_loader
        self.num_cross_folds = num_cross_folds
        self.check_test = check_test
        self.save_best_params = save_best_params
        self.backend = backend
        self._best_saved = None   # (loss, setting, host params, cfg)
        # wall clock per phase across buckets: 'train' = grid training and
        # its objectives, 'probe' = the embedding probe; the *_launch parts
        # enqueue, the *_wait parts wait for the device's results
        self.phase_seconds = {"train": 0.0, "probe": 0.0,
                              "train_launch": 0.0, "train_wait": 0.0,
                              "probe_launch": 0.0, "probe_wait": 0.0}
        self.probe = probe if classification_data_loader is not None \
            else None
        self.probe_rff_dim = int(probe_rff_dim)
        self.svm_Cs = svm_Cs
        self.svm_gammas = svm_gammas
        self.labels = list(labels_to_predict or LABELS_TO_PREDICT)
        self.verbose = verbose
        self.seed = seed

        # fixed recipe (autoencoder_wrapper.py:79-92); clipping off by
        # default (the reference's flag is inert, SURVEY 2.8.2), bf16 Adam
        # moments by default (the JAX sweep's performance mode)
        self.loss_func = "sigmoid_cross_entropy"
        self.base_cfg = MMAEConfig(
            num_feats=data_loader.num_feats, loss=self.loss_func,
            normalization="between_0_and_1", mask_with=-1.0,
            fill_missing_with=0.0)
        self.tcfg = TrainConfig(
            learning_rate=learning_rate, batch_size=batch_size,
            num_steps=num_steps, decay=True, decay_steps=1000,
            decay_rate=0.95, clip_gradients=clip_gradients,
            record_every_nth=max(num_steps // 10, 1), seed=seed,
            optimizer_state_dtype=optimizer_state_dtype)
        self.optimize_for = optimize_for or ("val_" + self.loss_func)
        self.min_or_max = min_or_max

        params = {
            "architecture": [list(a) for a in layer_sizes],
            "tie_weights": list(tie_weights),
            "dropout_prob": list(dropout_probs),
            "weight_penalty": list(weight_penalties),
            "weight_initialization": list(weight_initializers),
            "activation_function": list(activation_funcs),
            "variational": [False],
        }  # autoencoder_wrapper.py:127-136
        if optimizers is not None:
            # an optional swept optimizer axis, each value its own bucket
            params["optimizer"] = [str(o) for o in optimizers]
        settings = grid_lib.enumerate_grid(params)
        if test_variational:
            settings = grid_lib.add_extra_vae_params(settings)
        prefix = engine.get_save_prefix(
            results_path, classifier_name,
            getattr(data_loader, "filename", "data.csv"), replace=cont)
        settings, prefix = _sharded(settings, prefix, results_path,
                                    process_shard)
        self.list_of_param_settings = settings
        self.num_settings = len(settings)
        self.ledger = engine.ResultsLedger(
            results_path, prefix, cont=cont,
            save_every_nth=save_results_every_nth)

        self.spec = NoiseSpec.build(self.base_cfg.validate(),
                                    data_loader.modality_table)
        self.folded = gt.FoldedData.from_loader(data_loader, num_cross_folds,
                                                device=self.device)
        self._cls_folded = None
        self._cls_folds = None
        self.svm_probe_errors = 0   # SVC fits that raised (left at 0.0)

    @property
    def cls_folded(self):
        """The probe's stacked classification folds on the device, built
        on first use."""
        if self._cls_folded is None and self.cls_loader is not None:
            self._cls_folded = gt.FoldedData.from_loader(
                self.cls_loader, self.num_cross_folds, device=self.device,
                supervised=True,
                noisy_flags="logistics_noisy" in self.cls_loader.frame.columns)
        return self._cls_folded

    @property
    def cls_folds(self):
        """The SVM probe's host arrays of each classification fold
        (autoencoder_wrapper.py:202-226 embeds train, val, noisy-val and
        clean-val), built on first use."""
        if self._cls_folds is None and self.cls_loader is not None:
            self._cls_folds = [self._cls_fold_arrays(f)
                               for f in range(self.num_cross_folds)]
        return self._cls_folds

    def _cls_fold_arrays(self, fold: int):
        dl = self.cls_loader
        dl.set_to_cross_validation_fold(fold)

        def labels(y):
            return np.atleast_2d(np.asarray(y).T).T

        out = {"train_X": np.asarray(dl.train_X, np.float32),
               "train_Y": labels(dl.train_Y),
               "val_X": np.asarray(dl.val_X, np.float32),
               "val_Y": labels(dl.val_Y)}
        for part in ("noisy", "clean"):
            if dl.separate_noisy_data:
                x, y = getattr(dl, f"{part}_val_X"), getattr(
                    dl, f"{part}_val_Y")
            else:
                x, y = dl.val_X[:0], dl.val_Y[:0]
            out[f"{part}_X"] = np.asarray(x, np.float32)
            out[f"{part}_Y"] = labels(y)
        return out

    def _embed_configs(self, params_f, cfg: MMAEConfig, hyper,
                       x: np.ndarray) -> np.ndarray:
        """(C, rows, E) embeddings of ``x`` under each config's fold-f
        model, on the device; the VAE embeds with sampled z, as the
        reference's probe does (multimodal_autoencoder.py:372-375,
        autoencoder_wrapper.py:212-226)."""
        act_id = hyper.act_id[:params_f.enc_w[0].shape[0]].to(self.device)
        xt = torch.as_tensor(x, device=self.device).expand(
            len(act_id), *x.shape)
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed + 17)
        with torch.no_grad():
            emb = mmae.forward(params_f, cfg, xt, generator=generator,
                               keep_prob=1.0, train=False, sample=True,
                               act_id=act_id).embedding
        return emb.cpu().numpy()

    def _svm_probe_bucket(self, params, cfg: MMAEConfig, hyper,
                          num_configs: int):
        """The reference's RBF-SVM embedding probe
        (autoencoder_wrapper.py:202-284): per fold and label, fit the SVC
        (C, gamma) grid on each config's embedded train rows and keep the
        best (acc and auc together) on val / noisy-val / clean-val.  A fit
        that raises leaves its candidate out, as the reference prints and
        goes on (:258-259); ``svm_probe_errors`` counts them.  Returns the
        ledger rows of :meth:`_device_probe_rows`."""
        from sklearn.svm import SVC

        L, K = len(self.labels), self.num_cross_folds
        best = np.full((num_configs, K, L, 3, 2), np.nan)
        for f in range(K):
            data = self.cls_folds[f]
            params_f = optim.tree_map(lambda t: t[:num_configs, f], params)
            emb = {k: self._embed_configs(params_f, cfg, hyper,
                                          data[k + "_X"])
                   for k in ("train", "val", "noisy", "clean")
                   if len(data[k + "_X"]) > 0}
            for c in range(num_configs):
                for lab in range(min(L, data["train_Y"].shape[1])):
                    top = np.zeros((3, 2))
                    for C in self.svm_Cs:
                        for g in self.svm_gammas:
                            try:
                                svm = SVC(C=C, kernel="rbf", gamma=g)
                                svm.fit(emb["train"][c],
                                        data["train_Y"][:, lab])
                                for s, part in enumerate(("val", "noisy",
                                                          "clean")):
                                    self._best(svm, emb.get(part), c,
                                               data[part + "_Y"], lab,
                                               top[s])
                            except Exception as e:
                                self.svm_probe_errors += 1
                                if self.verbose:
                                    print("SVM probe error:", repr(e))
                    best[c, f, lab] = top
        return self._device_probe_rows(best, num_configs)

    @staticmethod
    def _best(svm, emb, c: int, Y, lab: int, top: np.ndarray) -> None:
        """svm_pred_best_result (autoencoder_wrapper.py:272-284): replace
        the [acc, auc] in ``top`` only when both improve."""
        if emb is None or len(Y) == 0:
            return
        m = metrics_lib.all_classification_metrics(
            torch.as_tensor(svm.predict(emb[c]), dtype=torch.float32),
            torch.as_tensor(Y[:, lab], dtype=torch.float32))
        acc, auc = float(m["acc"]), float(m["auc"])
        if acc > top[0] and auc > top[1]:
            top[:] = (acc, auc)

    def _cfg_for_bucket(self, setting: Dict[str, Any]) -> MMAEConfig:
        return self.base_cfg.replace(
            layer_sizes=_arch_tuple(setting["architecture"]),
            tie_weights=bool(setting.get("tie_weights", False)),
            variational=bool(setting.get("variational", False)),
            weight_initialization=setting.get("weight_initialization",
                                              "normal"),
        ).validate()

    def _device_probe_launch(self, params, cfg, hyper, num_configs: int,
                             seed: int) -> torch.Tensor:
        """The probe on the device (``sweep/probe.py``): 'device' is the
        random-Fourier primal ridge, 'device-exact' the exact (T, T)
        kernel ridge.  Returns the (C, K, L, 3, 2) tensor where it was
        computed; :meth:`_device_probe_rows` copies it to the host."""
        folded = self.cls_folded
        n_labels = min(len(self.labels),
                       int(folded.train_y.shape[-1])
                       if folded.train_y.dim() == 3 else 1)
        return probe_lib.probe_grid(
            seed, params, hyper.act_id[:num_configs], folded, cfg=cfg,
            Cs=tuple(float(c) for c in self.svm_Cs),
            gammas=tuple(float(g) for g in self.svm_gammas),
            num_labels=n_labels,
            rff_dim=None if self.probe == "device-exact"
            else self.probe_rff_dim)

    def _device_probe_rows(self, best, num_configs: int):
        """Per-config ledger columns from a (C, K, L, 3, 2) probe tensor
        (labels past the loader's stay NaN): per label and over all labels,
        the nanmean over folds of val / noisy / clean acc and auc, in the
        reference's column order (autoencoder_wrapper.py:324-341)."""
        best = np.asarray(torch.as_tensor(best).cpu(), np.float64)
        full = np.full(best.shape[:2] + (len(self.labels), 3, 2), np.nan)
        full[:, :, :best.shape[2]] = best
        names = [(s, m, f"svm_{sl}val_{metric}")
                 for s, sl in enumerate(("", "noisy_", "clean_"))
                 for m, metric in enumerate(("acc", "auc"))]
        rows = []
        for c in range(num_configs):
            row = {}
            for i, label in enumerate(self.labels):
                for s, m, name in names:
                    row[f"{name}_{label}"] = engine.nanmean(full[c, :, i, s, m])
            for s, m, name in names:
                row[name] = engine.nanmean(full[c, :, :, s, m])
            rows.append(row)
        return rows

    def _launch_bucket(self, bi: int, bucket):
        """Train one bucket and launch its probe.  The training kernels'
        launches are enqueued asynchronously, and nothing is copied to the
        host here, so the next bucket's host work overlaps this one's
        device work."""
        t0 = time.time()
        cfg = self._cfg_for_bucket(bucket[0])
        tcfg = self.tcfg
        if "optimizer" in bucket[0]:
            tcfg = tcfg.replace(optimizer=str(bucket[0]["optimizer"]))
        hyper = gt.HyperStack.from_settings(bucket, cfg, tcfg)
        # resolve 'auto' here so the ledger records what ran
        backend_used = gt.resolve_backend(self.backend, cfg, tcfg, self.spec,
                                          on_gpu=self.device.type == "cuda")
        params, losses = gt.train_grid_sharded(
            self.devices, cls_train_kernels.derive_seed(self.seed, 0, bi),
            cfg, tcfg, self.spec, hyper, self.folded, backend=backend_used)
        t_train = time.time()
        self.phase_seconds["train"] += t_train - t0
        self.phase_seconds["train_launch"] += t_train - t0
        probe_dev = None
        if self.probe in ("device", "device-exact"):
            probe_dev = self._device_probe_launch(
                params, cfg, hyper, len(bucket),
                cls_train_kernels.derive_seed(self.seed, 3, bi))
        now = time.time()
        self.phase_seconds["probe"] += now - t_train
        self.phase_seconds["probe_launch"] += now - t_train
        return {"bi": bi, "bucket": bucket, "launch_secs": now - t0,
                "cfg": cfg, "hyper": hyper, "params": params,
                "losses": losses, "backend_used": backend_used,
                "inst_steps": (len(bucket) * self.num_cross_folds
                               * tcfg.num_steps),
                "probe": probe_dev}

    def _finalize_bucket(self, st, est, num_buckets: int) -> None:
        """Copy one launched bucket's objectives and probe to the host and
        write its ledger rows.  Per-bucket time is the bucket's own
        (launch + finalize), not the wall span."""
        bucket = st["bucket"]
        t1 = time.time()
        losses = np.asarray(st["losses"].cpu(), np.float64)      # (C, K)
        self.phase_seconds["train"] += time.time() - t1
        self.phase_seconds["train_wait"] += time.time() - t1

        t2 = time.time()
        probe_rows = None
        if self.probe == "svm":
            probe_rows = self._svm_probe_bucket(
                st["params"], st["cfg"], st["hyper"], len(bucket))
        elif st["probe"] is not None:
            probe_rows = self._device_probe_rows(st["probe"], len(bucket))
        self.phase_seconds["probe"] += time.time() - t2
        self.phase_seconds["probe_wait"] += time.time() - t2

        mean_losses = losses.mean(axis=1)
        if self.save_best_params and not np.isnan(mean_losses).all():
            # NaN never wins, as in the ledger's find_best_setting
            c_best = int(np.nanargmin(mean_losses))
            if (self._best_saved is None
                    or mean_losses[c_best] < self._best_saved[0]):
                # fold 0 only; only the winner moves to the host
                host = optim.tree_map(lambda t: t[c_best, 0].cpu(),
                                      st["params"])
                self._best_saved = (float(mean_losses[c_best]),
                                    dict(bucket[c_best]), host, st["cfg"])

        bucket_secs = st["launch_secs"] + (time.time() - t1)
        rate = st["inst_steps"] / max(bucket_secs, 1e-9)
        for c, setting in enumerate(bucket):
            row = dict(setting)
            row[self.optimize_for] = float(mean_losses[c])
            if probe_rows is not None:
                row.update(probe_rows[c])
            row["time_per_setting_s"] = bucket_secs / len(bucket)
            row["backend_used"] = st["backend_used"]
            row["inst_steps_per_s"] = rate
            self.ledger.append(row)
        est.record(bucket_secs, batch=len(bucket))
        if self.verbose:
            print(f"bucket {st['bi'] + 1}/{num_buckets} "
                  f"({len(bucket)} settings x {self.num_cross_folds} "
                  f"folds): {bucket_secs:.1f}s; {est.summary()}")

    def sweep_all_parameters(self) -> None:
        pending = [s for s in self.list_of_param_settings
                   if not (self.ledger.started_from
                           and self.ledger.already_done(s))]
        buckets = grid_lib.bucket_settings(pending)
        est = engine.TimeEstimator(self.num_settings,
                                   self.ledger.started_from)
        inflight = None
        for bi, (_, bucket) in enumerate(buckets):
            try:
                st = self._launch_bucket(bi, bucket)
            except Exception:
                # persist the finished in-flight bucket before the error
                # propagates (the reference's durability contract)
                try:
                    if inflight is not None:
                        self._finalize_bucket(inflight, est, len(buckets))
                except Exception:
                    pass
                finally:
                    self.ledger.flush()
                raise
            if inflight is not None:
                self._finalize_bucket(inflight, est, len(buckets))
            inflight = st
        if inflight is not None:
            self._finalize_bucket(inflight, est, len(buckets))
        self.ledger.flush()
        if self.save_best_params:
            self.export_best_params()

    def export_best_params(self) -> Optional[str]:
        """Checkpoint the ledger winner's fold-0 parameters as
        ``best_mmae``.  The tracked winner (ranked by mean val loss) stands
        in only when the sweep optimizes that loss and the ledger's best
        is not strictly better; otherwise (a better row left by an earlier
        generation of a resumed ledger) the winner is retrained on fold
        0."""

        def resolve(row, ledger_score):
            use_tracked = (
                self._best_saved is not None
                and self.optimize_for == "val_" + self.loss_func
                and self.min_or_max == "min"
                # NaN comparisons are False: an all-NaN column falls back
                # to this run's tracked winner
                and not ledger_score < self._best_saved[0])
            if use_tracked:
                score, setting, host_params, cfg = self._best_saved
                cfg = cfg.replace(
                    dropout_prob=float(setting.get("dropout_prob", 1.0)),
                    weight_penalty=float(setting.get("weight_penalty", 0.0)),
                    activation=setting.get("activation_function",
                                           cfg.activation))
                return setting, host_params, cfg, score
            state, cfg, _ = self._retrain_fold0(row)
            return (_grid_setting_from_row(self, row),
                    optim.tree_map(lambda t: t.cpu(), state.params), cfg,
                    ledger_score)

        return _export_best_checkpoint(self, base_name="best_mmae",
                                       step=self.tcfg.num_steps,
                                       resolve=resolve)

    def find_best_setting(self, optimize_for=None, min_or_max=None):
        return self.ledger.find_best_setting(
            optimize_for or self.optimize_for,
            min_or_max or self.min_or_max)

    def retrain_cfg(self, setting: Dict[str, Any]) -> MMAEConfig:
        """The config a setting (or a whole ledger row) is retrained under:
        its bucket's shape with its dropout, penalty and activation."""
        setting = grid_lib.convert_param_dict_for_use(dict(setting))
        return self._cfg_for_bucket(setting).replace(
            dropout_prob=float(setting.get("dropout_prob", 1.0)),
            weight_penalty=float(setting.get("weight_penalty", 0.0)),
            activation=setting.get("activation_function", "softsign"))

    def _retrain_fold0(self, setting: Dict[str, Any]):
        """Train ``setting`` from scratch on fold 0 with the single-run
        trainer (the reference's single-setting recipe,
        autoencoder_wrapper.py:364-376), on ``device``.  Returns (trained
        TrainState, resolved cfg, fold-0 arrays on the device); accepts a
        whole ledger row (extra columns ignored)."""
        setting = grid_lib.convert_param_dict_for_use(dict(setting))
        cfg = self.retrain_cfg(setting)
        tcfg = self.tcfg
        if "optimizer" in setting:
            tcfg = tcfg.replace(optimizer=str(setting["optimizer"]))
        self.data_loader.set_to_cross_validation_fold(0)
        arr = self.data_loader.device_arrays(self.device)
        state = trainer.init_state(self.seed, cfg, tcfg, self.device)
        state, _ = trainer.train(state, cfg, tcfg, self.spec,
                                 arr["train_x"], arr["val_x"])
        return state, cfg, arr

    @staticmethod
    def test_score(params, cfg: MMAEConfig, test_x: torch.Tensor) -> float:
        """The report-scaled reconstruction loss of ``test_x``, without
        noise (``trainer.predict``)."""
        _, loss = trainer.predict(params, cfg, test_x)
        return float(loss)

    def test_on_test(self, setting: Dict[str, Any]) -> float:
        """Retrain ``setting`` on fold 0 and report its test-set loss
        (autoencoder_wrapper.py:364-376)."""
        state, cfg, arr = self._retrain_fold0(setting)
        return self.test_score(state.params, cfg, arr["test_x"])

    def run(self):
        """sweep -> (best setting, held-out test score or None without
        ``check_test``, best rows by svm_val_acc / svm_val_auc)
        (autoencoder_wrapper.py:378-385)."""
        self.sweep_all_parameters()
        best = self.find_best_setting()
        test_score = self.test_on_test(best) if self.check_test else None
        extras = {}
        for metric in ("svm_val_acc", "svm_val_auc"):
            if metric in self.ledger.columns:
                extras[metric] = self.find_best_setting(metric, "max")
        return best, test_score, extras


class MMAEClassificationSweep:
    """Two-phase grid search (MMAE denoising pretrain + classification
    head), the capabilities of MMAEClassificationWrapper
    (autoencoder_classification_wrapper.py:26-369), on ``device`` (a
    device or a device list)."""

    def __init__(self, data_loader, classification_data_loader,
                 mmae_layer_sizes=((1000, 100), (200, 100), (500, 100)),
                 classification_layer_sizes=((50, 20), (25, 10), (100, 50),
                                             (100,)),
                 tie_weights=(True, False),
                 mmae_dropout_probs=(1.0, 0.5),
                 mmae_weight_penalties=(0.01, 0.001),
                 weight_initializers=("normal",),
                 mmae_activation_funcs=("relu",),
                 mmae_test_variational=(True, False),
                 weight_penalties=(0.0, 0.001),
                 dropout_probs=(0.5, 1.0),
                 activation_funcs=("relu",),
                 classification_learning_rate: float = 1e-4,
                 classification_batch_size: int = 100,
                 classification_num_steps: int = 15000,
                 mmae_num_steps: int = 15000, mmae_batch_size: int = 20,
                 mmae_learning_rate: float = 1e-3,
                 wanted_label: Optional[str] = None,
                 results_path: str = "results",
                 classifier_name: str = "MMAE_NN_classifier",
                 cont: bool = False, check_test: bool = False,
                 num_cross_folds: int = DEFAULT_NUM_CROSS_FOLDS,
                 optimize_for: str = "val_acc", min_or_max: str = "max",
                 check_noisy_data: bool = True,
                 save_results_every_nth: int = 1, seed: int = 0,
                 verbose: bool = True, backend: str = "auto",
                 optimizer_state_dtype: str = "bfloat16",
                 share_phase1: bool = True,
                 compute_dtype: str = "float32",
                 save_best_params: bool = False, device="cuda",
                 process_shard=None):
        """``backend``: 'auto' trains both phases on the CUDA kernels where
        the shape family allows (``cls_train_kernels.supported_two_phase``)
        and the device is a GPU, the plain trainers otherwise; 'xla' /
        'pallas' force.  ``share_phase1`` (default True): pretrain each
        unique MMAE setting once per shape family and share it across the
        classifier settings that use it; False retrains the MMAE for every
        setting, as the reference does
        (autoencoder_classification_wrapper.py:195-227); with a
        ``process_shard`` the sharing is within this process's slice.
        ``save_best_params`` checkpoints the best setting's fold-0
        two-phase parameters at the end of the sweep, consumable by ``cli
        fill/embed --checkpoint``.  ``check_test`` retrains the best
        setting on fold 0 and scores it on the test set
        (:meth:`test_on_test`).  ``device``: a device or a device list,
        each bucket split over them.  ``process_shard``: an optional
        (process_index, process_count) that sweeps only this process's
        round-robin slice of the grid into a ledger shard
        (``parallel/multihost.py``)."""
        self.devices = mesh.as_devices(device)
        self.device = self.devices[0]
        self.process_shard = process_shard
        self.backend = backend
        self.share_phase1 = share_phase1
        self.save_best_params = save_best_params
        self._best_saved = None   # (signed score, setting, host params, cfg)
        self._families: Dict[tuple, dict] = {}
        # wall-clock per phase across buckets ('train' = both training
        # phases and the predictions; 'metrics' = the battery + rows)
        self.phase_seconds = {"train": 0.0, "metrics": 0.0}
        self.data_loader = data_loader
        self.cls_loader = classification_data_loader
        self.num_cross_folds = num_cross_folds
        self.check_test = check_test
        self.check_noisy_data = check_noisy_data
        self.wanted_label = wanted_label
        self.optimize_for = optimize_for
        self.min_or_max = min_or_max
        self.verbose = verbose
        self.seed = seed

        # single-label mode -> softmax head over 2 classes
        # (autoencoder_classification_wrapper.py:169-172,
        # multimodal_autoencoder.py:323-327)
        if wanted_label is not None:
            cls_loss, out_labels = "softmax", 2
        else:
            cls_loss = "sigmoid_cross_entropy"
            out_labels = classification_data_loader.num_labels or 2
        # compute_dtype is a phase-2 knob; phase 1 always computes f32
        self.base_cfg = MMAEConfig(
            num_feats=data_loader.num_feats, loss="sigmoid_cross_entropy",
            normalization="between_0_and_1", compute_dtype=compute_dtype,
            num_labels=out_labels, classification_loss=cls_loss)
        # neither training phase clips in the reference (§2.8.2, :443)
        self.tcfg = TrainConfig(
            learning_rate=mmae_learning_rate, batch_size=mmae_batch_size,
            num_steps=mmae_num_steps, clip_gradients=False,
            record_every_nth=max(mmae_num_steps // 10, 1), seed=seed,
            optimizer_state_dtype=optimizer_state_dtype)
        self.cls_tcfg = TrainConfig(
            learning_rate=classification_learning_rate,
            batch_size=classification_batch_size,
            num_steps=classification_num_steps, clip_gradients=False,
            record_every_nth=max(classification_num_steps // 10, 1),
            seed=seed, optimizer_state_dtype=optimizer_state_dtype)

        params = self._grid_params(
            mmae_layer_sizes, classification_layer_sizes, tie_weights,
            mmae_dropout_probs, mmae_weight_penalties, weight_initializers,
            mmae_activation_funcs, mmae_test_variational, weight_penalties,
            dropout_probs, activation_funcs)
        prefix = engine.get_save_prefix(
            results_path, classifier_name,
            getattr(classification_data_loader, "filename", "data.csv"),
            wanted_label=wanted_label, replace=cont)
        # the slice is cut before the phase-1 families are grouped, so
        # phase 1 is shared within this process's slice
        self.list_of_param_settings, prefix = _sharded(
            grid_lib.trim_vae_tied(grid_lib.enumerate_grid(params)), prefix,
            results_path, process_shard)
        self.num_settings = len(self.list_of_param_settings)
        self.ledger = engine.ResultsLedger(
            results_path, prefix, cont=cont,
            save_every_nth=save_results_every_nth)

        self.spec = NoiseSpec.build(self.base_cfg.validate(),
                                    data_loader.modality_table)
        self.unsup_folded = gt.FoldedData.from_loader(
            data_loader, num_cross_folds, device=self.device)
        self.sup_folded = gt.FoldedData.from_loader(
            classification_data_loader, num_cross_folds, device=self.device,
            supervised=True, noisy_flags=check_noisy_data)
        self.labels = (classification_data_loader.wanted_labels
                       or [wanted_label])

    @staticmethod
    def _grid_params(mmae_layer_sizes, classification_layer_sizes,
                     tie_weights, mmae_dropout_probs, mmae_weight_penalties,
                     weight_initializers, mmae_activation_funcs,
                     mmae_test_variational, weight_penalties, dropout_probs,
                     activation_funcs) -> Dict[str, list]:
        """The two-phase grid axes
        (autoencoder_classification_wrapper.py:127-140)."""
        return {
            "mmae_architecture": [list(a) for a in mmae_layer_sizes],
            "classification_layers": [list(a) for a in
                                      classification_layer_sizes],
            "tie_weights": list(tie_weights),
            "mmae_dropout_prob": list(mmae_dropout_probs),
            "mmae_weight_penalty": list(mmae_weight_penalties),
            "weight_initialization": list(weight_initializers),
            "mmae_activation_function": list(mmae_activation_funcs),
            "variational": list(mmae_test_variational),
            "weight_penalty": list(weight_penalties),
            "dropout_prob": list(dropout_probs),
            "activation_func": list(activation_funcs),
        }

    @classmethod
    def default_grid(cls):
        """The reference's default 576-setting grid and training constants
        from this constructor's defaults: (settings, num_cross_folds,
        mmae_num_steps, classification_num_steps)."""
        d = {k: p.default
             for k, p in inspect.signature(cls.__init__).parameters.items()
             if p.default is not inspect.Parameter.empty}
        params = cls._grid_params(
            d["mmae_layer_sizes"], d["classification_layer_sizes"],
            d["tie_weights"], d["mmae_dropout_probs"],
            d["mmae_weight_penalties"], d["weight_initializers"],
            d["mmae_activation_funcs"], d["mmae_test_variational"],
            d["weight_penalties"], d["dropout_probs"],
            d["activation_funcs"])
        settings = grid_lib.trim_vae_tied(grid_lib.enumerate_grid(params))
        return (settings, d["num_cross_folds"], d["mmae_num_steps"],
                d["classification_num_steps"])

    def _cfg_for_bucket(self, setting: Dict[str, Any]) -> MMAEConfig:
        return self.base_cfg.replace(
            layer_sizes=_arch_tuple(setting["mmae_architecture"]),
            classification_layer_sizes=_arch_tuple(
                setting["classification_layers"]),
            tie_weights=bool(setting.get("tie_weights", False)),
            variational=bool(setting.get("variational", False)),
            weight_initialization=setting.get("weight_initialization",
                                              "normal"),
        ).validate()

    def _metric_battery_launch(self, preds: torch.Tensor) -> torch.Tensor:
        """The whole metric battery on the device predictions, normalised
        to (C, K, R, L) / (K, R, L) (a single label keeps no axis)."""
        val_y = self.sup_folded.val_y
        if preds.dim() == 3:
            preds = preds.unsqueeze(-1)
        if val_y.dim() == 2:
            val_y = val_y.unsqueeze(-1)
        return _metric_battery(preds, val_y, self.sup_folded.val_n,
                               self.sup_folded.val_noisy)

    def _metric_rows(self, metrics_dev, num_configs: int):
        """Per-config metric columns from the battery's (3, 5, C, K, L)
        result: acc/auc/f1/precision/recall, per-label acc/auc and the
        noisy/clean slices, nanmean over folds
        (autoencoder_classification_wrapper.py:239-328,
        generic_wrapper.py:433-497)."""
        stacked = np.asarray(torch.as_tensor(metrics_dev).cpu())
        mi = {m: i for i, m in enumerate(METRIC_ORDER)}
        noisy = self.sup_folded.val_noisy
        rows = []
        for c in range(num_configs):
            per_label = {m: stacked[0, mi[m], c] for m in METRIC_ORDER}
            row = {}
            for name in per_label:
                row[f"val_{name}"] = engine.nanmean(per_label[name])
            for i, label in enumerate(self.labels):
                friendly = helpers.get_friendly_label_name(str(label))
                row[f"val_acc_{friendly}"] = engine.nanmean(
                    per_label["acc"][:, i])
                row[f"val_auc_{friendly}"] = engine.nanmean(
                    per_label["auc"][:, i])
            if noisy is not None:
                for k, s in (("noisy", 1), ("clean", 2)):
                    row[f"{k}_val_acc"] = engine.nanmean(
                        stacked[s, mi["acc"], c])
                    row[f"{k}_val_auc"] = engine.nanmean(
                        stacked[s, mi["auc"], c])
            rows.append(row)
        return rows

    @staticmethod
    def _mmae_subsetting(s: Dict[str, Any]) -> Dict[str, Any]:
        """The phase-1 (MMAE) hyperparameters of a two-phase setting."""
        return {"dropout_prob": s.get("mmae_dropout_prob", 1.0),
                "weight_penalty": s.get("mmae_weight_penalty", 0.0),
                "activation_function": s.get("mmae_activation_function",
                                             "relu")}

    @staticmethod
    def _family_key(setting: Dict[str, Any]) -> tuple:
        """Phase-1 shape-family key: settings sharing it have identical
        headless MMAE parameter shapes (the bucket key minus the
        classifier architecture)."""
        return (_arch_tuple(setting["mmae_architecture"]),
                bool(setting.get("tie_weights", False)),
                bool(setting.get("variational", False)),
                setting.get("weight_initialization", "normal"))

    @staticmethod
    def _p1_key(ms: Dict[str, Any]) -> tuple:
        return (float(ms["dropout_prob"]), float(ms["weight_penalty"]),
                str(ms["activation_function"]))

    def _prepare_families(self, buckets):
        """Group buckets by phase-1 family (first-seen family order) and
        list each family's unique MMAE sub-settings: its phase-1 stack is
        trained once and shared by all its buckets.  Every family shares,
        on one device or several: the JAX package's ``_share_family``
        (:1037-1060) unshares families on a multi-device mesh only because
        its shared Pallas phase 2 cannot run there, while the port's
        shared phase 2 splits over a device list like every other run."""
        order, fam_buckets = [], {}
        for kb in buckets:
            fk = self._family_key(kb[1][0])
            if fk not in fam_buckets:
                fam_buckets[fk] = []
                order.append(fk)
            fam_buckets[fk].append(kb)
        self._families = {}
        for fi, fk in enumerate(order):
            uniq, index = [], {}
            for _, bucket in fam_buckets[fk]:
                for s in bucket:
                    pk = self._p1_key(self._mmae_subsetting(s))
                    if pk not in index:
                        index[pk] = len(uniq)
                        uniq.append(self._mmae_subsetting(s))
            self._families[fk] = {
                "fi": fi, "uniq": uniq, "index": index,
                "remaining": len(fam_buckets[fk]), "launched": None}
        return [kb for fk in order for kb in fam_buckets[fk]]

    def _launch_bucket(self, bi: int, bucket):
        """Train one bucket's two phases and launch its metric battery on
        the device; nothing is copied to the host here.  With
        ``share_phase1`` the first bucket of a family also pretrains the
        family and each bucket runs phase 2 on its settings' pretrained
        rows; without it every setting pretrains its own MMAE.  The
        kernels' launches are enqueued asynchronously, so the next bucket's
        host work overlaps this one's device work."""
        t0 = time.time()
        cfg = self._cfg_for_bucket(bucket[0])
        mmae_settings = [self._mmae_subsetting(s) for s in bucket]
        hyper = gt.HyperStack.from_settings(mmae_settings, cfg, self.tcfg)
        chyper = gt.ClassifierHyperStack.from_settings(bucket, cfg)
        on_gpu = self.device.type == "cuda"
        seed = cls_train_kernels.derive_seed(self.seed, 0, bi)
        family = self._family_key(bucket[0])
        fam = self._families.get(family)
        K = self.num_cross_folds
        if fam is None:
            backend_used = gt.resolve_backend_two_phase(
                self.backend, cfg, self.tcfg, self.cls_tcfg, self.spec,
                on_gpu=on_gpu)
            params, losses, preds = gt.train_two_phase_sharded(
                self.devices, seed, cfg, self.tcfg, self.cls_tcfg, self.spec,
                hyper, chyper, self.unsup_folded, self.sup_folded,
                backend=backend_used)
            return self._launched(
                t0, bi, bucket, losses, None, backend_used,
                len(bucket) * K * (self.tcfg.num_steps
                                   + self.cls_tcfg.num_steps),
                None, params, preds)
        # resolve 'auto' per phase so the ledger records what ran
        p1_backend = gt.resolve_backend(
            self.backend, cls_train_kernels.phase1_cfg(cfg), self.tcfg,
            self.spec, on_gpu=on_gpu)
        p2_backend = gt.resolve_backend_two_phase(
            self.backend, cfg, self.tcfg, self.cls_tcfg, self.spec,
            on_gpu=on_gpu)
        backend_used = (p1_backend if p1_backend == p2_backend
                        else f"p1-{p1_backend}/p2-{p2_backend}")
        # rate denominator: this bucket's phase-2 steps, plus the family's
        # pretraining if this bucket launched it
        inst_steps = len(bucket) * K * self.cls_tcfg.num_steps
        if fam["launched"] is None:
            inst_steps += len(fam["uniq"]) * K * self.tcfg.num_steps
            hyper_u = gt.HyperStack.from_settings(fam["uniq"], cfg,
                                                  self.tcfg)
            fam["launched"] = gt.train_phase1_shared(
                self.devices,
                cls_train_kernels.derive_seed(self.seed, 1, fam["fi"]),
                cfg, self.tcfg, self.spec, hyper_u, self.unsup_folded,
                backend=p1_backend)
        params_u, losses = fam["launched"]
        p1_map = np.asarray(
            [fam["index"][self._p1_key(ms)] for ms in mmae_settings],
            np.int64)
        params, preds = gt.train_phase2_shared_sharded(
            self.devices, seed, cfg, self.tcfg, self.cls_tcfg, self.spec,
            params_u, p1_map, hyper, chyper, self.sup_folded,
            backend=p2_backend)
        return self._launched(t0, bi, bucket, losses, p1_map, backend_used,
                              inst_steps, family, params, preds)

    def _launched(self, t0, bi, bucket, losses, p1_map, backend_used,
                  inst_steps, family, params, preds):
        """Launch the metric battery on a trained bucket's predictions and
        return what :meth:`_finalize_bucket` needs."""
        t_train = time.time()
        self.phase_seconds["train"] += t_train - t0
        metrics_dev = self._metric_battery_launch(preds)
        now = time.time()
        self.phase_seconds["metrics"] += now - t_train
        return {"bi": bi, "bucket": bucket, "launch_secs": now - t0,
                "losses": losses, "p1_map": p1_map,
                "backend_used": backend_used, "inst_steps": inst_steps,
                "family": family,
                "params": params if self.save_best_params else None,
                "metrics": metrics_dev}

    def _export_cfg(self, setting: Dict[str, Any]) -> MMAEConfig:
        """The exported checkpoint's config: :meth:`retrain_cfg` with
        ``dropout_prob`` the phase-2 head keep probability (inert at
        inference), the config phase 2 trains under."""
        return self.retrain_cfg(setting).replace(
            dropout_prob=float(setting.get("dropout_prob", 1.0)))

    def _track_best(self, st, rows) -> None:
        """Keep the sweep-best setting's fold-0 two-phase parameters
        (MMAE stack + head) on the host, by ``optimize_for``; NaN scores
        never win."""
        sign = 1.0 if self.min_or_max == "max" else -1.0
        scores = np.asarray(
            [sign * float(r.get(self.optimize_for, np.nan)) for r in rows],
            np.float64)
        if np.all(np.isnan(scores)):
            return
        c_best = int(np.nanargmax(scores))
        if (self._best_saved is not None
                and not scores[c_best] > self._best_saved[0]):
            return
        host = optim.tree_map(lambda t: t[c_best, 0].cpu(), st["params"])
        setting = dict(st["bucket"][c_best])
        self._best_saved = (float(scores[c_best]), setting, host,
                            self._export_cfg(setting))

    def _finalize_bucket(self, st, est, num_buckets: int) -> None:
        """Copy one launched bucket's objectives and metrics to the host
        and write its ledger rows.  Per-bucket time is the bucket's own
        (launch + finalize), not the wall span."""
        bucket = st["bucket"]
        t1 = time.time()
        losses = np.asarray(st["losses"].cpu())
        if st["p1_map"] is not None:
            losses = losses[st["p1_map"]]                         # (C, K)
        self.phase_seconds["train"] += time.time() - t1

        t2 = time.time()
        metric_rows = self._metric_rows(st["metrics"], len(bucket))
        self.phase_seconds["metrics"] += time.time() - t2

        bucket_secs = st["launch_secs"] + (time.time() - t1)
        rate = st["inst_steps"] / max(bucket_secs, 1e-9)
        rows = []
        for c, setting in enumerate(bucket):
            row = dict(setting)
            row["val_mmae_loss"] = float(np.mean(losses[c]))
            row.update(metric_rows[c])
            row["time_per_setting_s"] = bucket_secs / len(bucket)
            row["backend_used"] = st["backend_used"]
            row["inst_steps_per_s"] = rate
            rows.append(row)
            self.ledger.append(row)
        if self.save_best_params and st.get("params") is not None:
            self._track_best(st, rows)
        est.record(bucket_secs, batch=len(bucket))
        # every bucket of a family launches before its last finalizes, so
        # the shared stack can go once every user is finalized
        fam = self._families.get(st["family"])
        if fam is not None:
            fam["remaining"] -= 1
            if fam["remaining"] <= 0:
                fam["launched"] = None
        if self.verbose:
            print(f"bucket {st['bi'] + 1}/{num_buckets} "
                  f"({len(bucket)} settings x {self.num_cross_folds} "
                  f"folds): {bucket_secs:.1f}s; {est.summary()}")

    def sweep_all_parameters(self) -> None:
        pending = [s for s in self.list_of_param_settings
                   if not (self.ledger.started_from
                           and self.ledger.already_done(s))]
        buckets = grid_lib.bucket_settings(pending)
        if self.share_phase1:
            buckets = self._prepare_families(buckets)
        else:
            self._families = {}
        est = engine.TimeEstimator(self.num_settings,
                                   self.ledger.started_from)
        inflight = None
        for bi, (_, bucket) in enumerate(buckets):
            try:
                st = self._launch_bucket(bi, bucket)
            except Exception:
                # persist the finished in-flight bucket before the error
                # propagates (the reference's durability contract)
                try:
                    if inflight is not None:
                        self._finalize_bucket(inflight, est, len(buckets))
                except Exception:
                    pass
                finally:
                    self.ledger.flush()
                raise
            if inflight is not None:
                self._finalize_bucket(inflight, est, len(buckets))
            inflight = st
        if inflight is not None:
            self._finalize_bucket(inflight, est, len(buckets))
        self.ledger.flush()
        if self.save_best_params:
            self.export_best_params()

    def export_best_params(self) -> Optional[str]:
        """Checkpoint the ledger winner's fold-0 two-phase parameters as
        ``best_mmae_cls``: the tracked winner of this process, or, where a
        resumed ledger holds a better row from an earlier generation, that
        setting retrained on fold 0."""

        def resolve(row, ledger_score):
            sign = 1.0 if self.min_or_max == "max" else -1.0
            # NaN comparisons are False: an all-NaN column falls back to
            # this run's tracked winner
            if (self._best_saved is not None
                    and not sign * ledger_score > self._best_saved[0]):
                signed, setting, host_params, cfg = self._best_saved
                return setting, host_params, cfg, sign * signed
            state2, cfg, _ = self._retrain_fold0(row)
            return (_grid_setting_from_row(self, row),
                    optim.tree_map(lambda t: t.cpu(), state2.params), cfg,
                    ledger_score)

        return _export_best_checkpoint(self, base_name="best_mmae_cls",
                                       step=self.cls_tcfg.num_steps,
                                       resolve=resolve)

    def retrain_cfg(self, setting: Dict[str, Any]) -> MMAEConfig:
        """The phase-1 config a setting (or a whole ledger row) is
        retrained under: the bucket's shape, the MMAE's dropout, penalty
        and activation, and the head's activation and penalty."""
        setting = grid_lib.convert_param_dict_for_use(dict(setting))
        return self._cfg_for_bucket(setting).replace(
            dropout_prob=float(setting.get("mmae_dropout_prob", 1.0)),
            weight_penalty=float(setting.get("mmae_weight_penalty", 0.0)),
            activation=setting.get("mmae_activation_function", "relu"),
            classification_activation=setting.get("activation_func"),
            classification_weight_penalty=float(
                setting.get("weight_penalty", 0.0)))

    def _retrain_fold0(self, setting: Dict[str, Any]):
        """Train both phases of ``setting`` from scratch on fold 0 with the
        single-run trainer (the reference's per-setting recipe,
        autoencoder_classification_wrapper.py:195-258), on ``device``.
        Returns (trained phase-2 TrainState, its cfg, the classification
        fold-0 arrays on the device); accepts a whole ledger row."""
        setting = grid_lib.convert_param_dict_for_use(dict(setting))
        cfg = self.retrain_cfg(setting)
        self.data_loader.set_to_cross_validation_fold(0)
        self.cls_loader.set_to_cross_validation_fold(0)
        arr = self.data_loader.device_arrays(self.device)
        cls_arr = self.cls_loader.device_arrays(self.device)
        state = trainer.init_state(self.seed, cfg, self.tcfg, self.device)
        state, _ = trainer.train(state, cfg, self.tcfg, self.spec,
                                 arr["train_x"], arr["val_x"])
        # phase 2 trains under the setting's head keep probability
        # ('dropout_prob'), as the grid path does, with fresh f32 Adam
        # slots (the JAX package's opt_init without a state dtype)
        cfg2 = self._export_cfg(setting)
        cls_tcfg = self.cls_tcfg
        state2 = trainer.state_for_params(
            state.params, cls_tcfg.replace(optimizer_state_dtype="float32"),
            state.generator)
        state2, _ = trainer.train_classification(
            state2, cfg2, cls_tcfg, self.spec, cls_arr["train_x"],
            cls_arr["train_y"], cls_arr["val_x"], cls_arr["val_y"])
        return state2, cfg2, cls_arr

    def test_metrics(self, params, cfg: MMAEConfig) -> Dict[str, float]:
        """The metric battery of ``params`` on the classification test
        set, with its noisy / clean slices where the loader has them."""
        def metrics(X, Y):
            x = torch.as_tensor(np.asarray(X), dtype=torch.float32,
                                device=self.device)
            preds = trainer.classification_predictions(
                params, cfg, x,
                torch.Generator(device=self.device).manual_seed(1))
            y = torch.as_tensor(np.asarray(Y, dtype=float).reshape(-1),
                                dtype=torch.float32, device=self.device)
            m = metrics_lib.all_classification_metrics(
                preds.reshape(-1).to(torch.float32), y)
            return {k: float(v) for k, v in m.items()}

        loader = self.cls_loader
        result = {f"test_{k}": v
                  for k, v in metrics(loader.test_X, loader.test_Y).items()}
        if self.check_noisy_data and "logistics_noisy" in \
                loader.frame.columns:
            for name, X_s, Y_s in (
                    ("noisy", loader.noisy_test_X, loader.noisy_test_Y),
                    ("clean", loader.clean_test_X, loader.clean_test_Y)):
                if len(X_s) == 0:
                    continue
                m = metrics(X_s, Y_s)
                result[f"{name}_test_acc"] = m["acc"]
                result[f"{name}_test_auc"] = m["auc"]
        return result

    def test_on_test(self, setting: Dict[str, Any]) -> Dict[str, float]:
        """Held-out test evaluation of a setting: retrain both phases on
        fold 0, predict the classification test set, and run the full
        metric battery with the noisy / clean slices.  The reference's
        automated test path is broken (a NameError at
        autoencoder_classification_wrapper.py:369, SURVEY §2.8.6); this is
        its intent."""
        state2, cfg, _ = self._retrain_fold0(setting)
        return self.test_metrics(state2.params, cfg)

    def get_final_results(self):
        """Best settings by val_acc / noisy_val_acc / clean_val_acc
        (generic_wrapper.py:514-522), as ledger row dicts, and with
        ``check_test`` the best val_acc setting's test metrics under
        ``"test"``."""
        out = {}
        for metric in ("val_acc", "noisy_val_acc", "clean_val_acc"):
            if metric in self.ledger.columns:
                out[metric] = self.ledger.find_best_setting(metric, "max")
        if self.check_test and "val_acc" in out:
            out["test"] = self.test_on_test(out["val_acc"])
        return out

    def run(self):
        self.sweep_all_parameters()
        return self.get_final_results()
