"""Config-parallel grid training, phase 1 (unsupervised), on one device.

Counterpart of the phase-1 half of
``multimodalautoencoder_tpu/parallel/grid_trainer.py``.  The reference
trains one (setting, fold) at a time (generic_wrapper.py:253-254,
:298-300); here a whole shape bucket trains at once:

- per-config hyperparameters (lr, keep_prob, weight_penalty, act_id) are
  stacked into tensors (:class:`HyperStack`);
- ragged CV folds are padded into a :class:`FoldedData` stack with
  valid-row counts; batches are drawn in [0, n_valid);
- instances = configs x folds, a leading batch axis of every tensor.

Two backends, as in the JAX package: ``"pallas"``, the hand-written CUDA
training kernels (``ops/train_kernels.py``, the Pallas kernel's
semantics), and ``"xla"``, :func:`train_grid`, batched eager PyTorch with
autograd (the XLA trainer's semantics).  Both end in the same noisy-val
objective (multimodal_autoencoder.py:1019-1033).  One device: the mesh of
the JAX package (multi-chip sharding) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import (
    NoiseSpec, add_noise_to_batch)
from multimodalautoencoder_tpu_torch.ops import optim, train_kernels

# activation-key aliases (sweep ledgers use activation_function, the
# reference ctor uses activation_func)
_ACT_KEYS = ("activation_function", "activation_func", "activation")


def _pick(s: Dict[str, Any], names, default):
    for n in names:
        if n in s:
            return s[n]
    return default


def resolve_backend(backend: str, cfg: MMAEConfig, tcfg: TrainConfig,
                    spec: NoiseSpec, on_gpu: Optional[bool] = None) -> str:
    """Resolve ``"auto"`` as :func:`train_grid_sharded` does: the training
    kernels (``"pallas"``) on a GPU when (cfg, tcfg, spec) is in their
    family (``train_kernels.supported``), else the plain trainer
    (``"xla"``).  ``on_gpu`` defaults to whether CUDA is available."""
    if backend != "auto":
        return backend
    if on_gpu is None:
        on_gpu = torch.cuda.is_available()
    return ("pallas" if on_gpu and train_kernels.supported(cfg, tcfg, spec)
            else "xla")


@dataclasses.dataclass(frozen=True)
class HyperStack:
    """Per-config hyperparameters of a bucket, one row per config."""

    lr: torch.Tensor               # (C,) float32
    keep_prob: torch.Tensor        # (C,) float32
    weight_penalty: torch.Tensor   # (C,) float32
    act_id: torch.Tensor           # (C,) int32

    @classmethod
    def from_settings(cls, settings: Sequence[Dict[str, Any]],
                      cfg: MMAEConfig, tcfg: TrainConfig) -> "HyperStack":
        """From sweep setting dicts, falling back to cfg/tcfg defaults
        (the searched keys of autoencoder_wrapper.py:127-136):
        learning_rate, dropout_prob, weight_penalty and
        activation/activation_func/activation_function."""
        lr, kp, wp, act = [], [], [], []
        for s in settings:
            lr.append(float(s.get("learning_rate", tcfg.learning_rate)))
            kp.append(float(s.get("dropout_prob", cfg.dropout_prob)))
            wp.append(float(s.get("weight_penalty", cfg.weight_penalty)))
            act.append(mmae.activation_id(_pick(s, _ACT_KEYS,
                                                cfg.activation)))
        return cls(lr=torch.tensor(lr, dtype=torch.float32),
                   keep_prob=torch.tensor(kp, dtype=torch.float32),
                   weight_penalty=torch.tensor(wp, dtype=torch.float32),
                   act_id=torch.tensor(act, dtype=torch.int32))

    @property
    def num_configs(self) -> int:
        return int(self.lr.shape[0])


@dataclasses.dataclass(frozen=True)
class FoldedData:
    """CV folds padded to common shapes, with valid-row counts.  Fold f's
    train set is every non-Test row outside fold f, its val set fold f
    (data_funcs.py:278-308); arrays are padded with zero rows to the
    largest fold and ``*_n`` holds the true counts."""

    train_x: torch.Tensor   # (K, max_train, F) float32
    train_n: torch.Tensor   # (K,) int32
    val_x: torch.Tensor     # (K, max_val, F) float32
    val_n: torch.Tensor     # (K,) int32

    @property
    def num_folds(self) -> int:
        return int(self.train_x.shape[0])

    @classmethod
    def from_loader(cls, loader, num_folds: int,
                    device="cuda") -> "FoldedData":
        """Every fold of a cross-validation ``DataLoader``."""
        tx, vx = [], []
        for f in range(num_folds):
            a, _, b, _ = loader.get_cross_val_data_for_fold(f)
            tx.append(a)
            vx.append(b)
        return cls.from_ragged(tx, vx, device)

    @classmethod
    def from_single_split(cls, train_x, val_x, device="cuda"
                          ) -> "FoldedData":
        """Non-CV case: one 'fold', the fixed Train/Val split."""
        return cls.from_ragged([train_x], [val_x], device)

    @classmethod
    def from_ragged(cls, train_list, val_list, device="cuda"
                    ) -> "FoldedData":
        def pad_stack(mats):
            mx = max(m.shape[0] for m in mats)
            out = np.zeros((len(mats), mx) + tuple(mats[0].shape[1:]),
                           dtype=np.float32)
            for i, m in enumerate(mats):
                out[i, :m.shape[0]] = m
            return torch.as_tensor(out, device=device)

        def counts(mats):
            return torch.tensor([m.shape[0] for m in mats],
                                dtype=torch.int32, device=device)

        return cls(train_x=pad_stack(train_list), train_n=counts(train_list),
                   val_x=pad_stack(val_list), val_n=counts(val_list))

    def to(self, device) -> "FoldedData":
        return FoldedData(*(t.to(device) for t in
                            (self.train_x, self.train_n, self.val_x,
                             self.val_n)))


def train_grid(seed: int, cfg: MMAEConfig, tcfg: TrainConfig,
               spec: NoiseSpec, hyper: HyperStack, folded: FoldedData,
               num_steps: Optional[int] = None,
               params0: Optional[mmae.MMAEParams] = None):
    """Train every (config, fold) instance of one bucket with the plain
    backend: all N = C * K instances as one batch of eager PyTorch, with
    autograd and ``optim`` (the XLA trainer's step,
    ``_train_one_instance`` :258-318: indices uniform in [0, n_valid),
    ``add_noise_to_batch``, dropout, ``total_loss``, decayed lr, the
    optimizer).  Returns ``(params, losses)`` with leading (C, K) axes.

    ``seed`` seeds one CPU generator that draws, in order, the initial
    parameters (unless ``params0``, leading (C, K) axes, is given), every
    step's batch, noise and dropout, and the objective's noise."""
    cfg = cfg.validate()
    num_steps = tcfg.num_steps if num_steps is None else int(num_steps)
    C, K = hyper.num_configs, folded.num_folds
    N = C * K
    dev = folded.train_x.device
    g = torch.Generator().manual_seed(int(seed))
    if params0 is None:
        params0 = train_kernels.init_grid_params(g, cfg, C, K)
    params = optim.tree_map(
        lambda t: t.reshape((N,) + tuple(t.shape[2:])).to(
            dev, torch.float32, copy=True), params0)
    state = optim.opt_init(tcfg.optimizer, params,
                           optim.state_dtype(tcfg.optimizer_state_dtype))
    clip = tcfg.clip_norm if tcfg.clip_gradients else None
    lr0 = hyper.lr.repeat_interleave(K).to(dev)
    keep = hyper.keep_prob.repeat_interleave(K).to(dev)
    wpen = hyper.weight_penalty.repeat_interleave(K).to(dev)
    act = hyper.act_id.repeat_interleave(K).to(dev)
    fold = torch.arange(K, device=dev).repeat(C).view(-1, 1)
    n_valid = folded.train_n.to(dev).repeat(C).view(-1, 1)

    for step in range(num_steps):
        u = torch.rand((N, tcfg.batch_size), generator=g).to(dev)
        idx = torch.minimum((u * n_valid).long(), n_valid - 1)
        x = folded.train_x[fold, idx]
        noisy = add_noise_to_batch(g, x, spec)
        leaves = [t.detach().requires_grad_()
                  for t in optim.tree_leaves(params)]
        it = iter(leaves)
        p = optim.tree_map(lambda _: next(it), params)
        loss, _ = mmae.total_loss(p, cfg, noisy, x, generator=g,
                                  keep_prob=keep, train=True,
                                  weight_penalty=wpen, act_id=act)
        grads_list = torch.autograd.grad(loss.sum(), leaves)
        it = iter(grads_list)
        grads = optim.tree_map(lambda _: next(it), params)
        if tcfg.decay and not tcfg.faithful_inert_decay:
            lr = optim.exponential_decay(lr0, step, tcfg.decay_steps,
                                         tcfg.decay_rate,
                                         tcfg.decay_staircase)
        else:
            lr = lr0
        with torch.no_grad():
            params, state = optim.opt_update(tcfg.optimizer, grads, state,
                                             params, lr, clip_norm=clip,
                                             batch_dims=1)

    params = optim.tree_map(
        lambda t: t.reshape((C, K) + tuple(t.shape[1:])), params)
    return params, train_kernels.noisy_val_losses(params, cfg, spec, hyper,
                                                  folded, g)


def train_grid_sharded(device, seed: int, cfg: MMAEConfig,
                       tcfg: TrainConfig, spec: NoiseSpec,
                       hyper: HyperStack, folded: FoldedData,
                       num_steps: Optional[int] = None,
                       backend: str = "auto",
                       params0: Optional[mmae.MMAEParams] = None):
    """Train a bucket on ``device`` (the JAX package's mesh, on one
    device).  ``backend``: ``"pallas"`` (the CUDA training kernels; raises
    ``ValueError`` outside their family), ``"xla"`` (:func:`train_grid`),
    or ``"auto"`` (:func:`resolve_backend` for that device).  Returns
    ``(params, losses)`` with leading (C, K) axes."""
    device = torch.device(device)
    folded = folded.to(device)
    backend = resolve_backend(backend, cfg, tcfg, spec,
                              on_gpu=device.type == "cuda")
    if backend == "pallas":
        return train_kernels.train_grid_pallas(seed, cfg, tcfg, spec, hyper,
                                               folded, num_steps, params0)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r} "
                         "('auto', 'pallas' or 'xla')")
    return train_grid(seed, cfg, tcfg, spec, hyper, folded, num_steps,
                      params0)
