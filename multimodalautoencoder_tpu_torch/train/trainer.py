"""Single-run MMAE training and inference, on one device.

Counterpart of ``multimodalautoencoder_tpu/train/trainer.py``.  The
reference's ``train()`` (multimodal_autoencoder.py:549-590) is a host loop:
sample a batch, corrupt it, run the TF1 graph once per step.  The JAX package
makes a whole run one jitted ``lax.scan``; here a run is a step function
and an evaluation that work in place on the run's tensors, driven by
``ops/step_graph.run``: on the card captured once as CUDA graphs and
replayed, on the CPU called in a Python loop.

- batches are drawn with ``torch.randint`` from the device-resident train
  set (uniform with replacement, as ``np.random.choice`` at
  data_funcs.py:167);
- corruption is ``models/corruption.add_noise_to_batch``;
- records happen at steps 0, R, 2R, ... *before* the update at that step
  (:574-590), so a run of N steps gives ``ceil(N / R)`` curve entries in
  both phases.  Losses stay on the device through the run; each call
  copies its curves to the host once.

Randomness: where the JAX state carries a PRNG key, :class:`TrainState`
carries a ``torch.Generator`` on the state's device, and every draw of a
step comes from it in a fixed order: batch indices, corruption, then
dropout and the VAE's eps.  The generator is advanced in place, so a state
is consumed by the step that takes it.  The draws differ from the JAX
package's; with one training row, no corruption and keep probability 1 the
two trainers take the same steps (tests/test_torch_trainer.py,
tests/test_torch_step_graph.py).

:func:`train` and :func:`train_classification` leave the tensors of the
state they are given as they were (the generator excepted) and return a
new state.  The step functions ending in ``_`` (:func:`unsupervised_step_`,
:func:`classification_step_`) update a state's own tensors in place;
:func:`unsupervised_step` and :func:`classification_step` are their
functional forms.

With ``MMAEConfig.use_pallas`` every encoder and decoder layer runs
through ``ops/dense_kernels.fused_dense`` (the CUDA kernel on a GPU,
differentiable through its autograd Function), as ``models/mmae.py``
routes it in the JAX package (:210-243).

The optimizer is Adam with working exponential LR decay and global-norm
clipping (the reference configures both but they are inert, SURVEY.md
§2.8.1-2); ``TrainConfig.faithful_inert_decay`` / ``clip_gradients=False``
restore the reference's behaviour.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.models import losses as losses_lib
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import (
    NoiseSpec, add_noise_to_batch)
from multimodalautoencoder_tpu_torch.ops import optim, step_graph
from multimodalautoencoder_tpu_torch.ops.cls_train_kernels import derive_seed


class TrainState(NamedTuple):
    params: mmae.MMAEParams
    opt_state: Any
    step: torch.Tensor             # int32 scalar on the state's device
    generator: torch.Generator     # on the state's device, advanced in place


class Curves(NamedTuple):
    """Recorded loss curves, the reference's train_loss/val_loss lists
    (multimodal_autoencoder.py:240-241), one entry per record period, as
    host arrays."""
    train_loss: np.ndarray
    val_loss: np.ndarray


class ClassificationCurves(NamedTuple):
    train_loss: np.ndarray
    train_acc: np.ndarray
    val_loss: np.ndarray
    val_acc: np.ndarray


def learning_rate_schedule(tcfg: TrainConfig, device=None
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The LR schedule as a function of the step counter: tf.train.
    exponential_decay semantics (multimodal_autoencoder.py:357-361), unless
    decay is off or ``faithful_inert_decay`` reproduces the reference's
    never-incremented global_step (SURVEY.md §2.8.1).  Its constants are f32
    tensors on ``device``, filled there once for a run, so that neither the
    set-up nor a step copies from the host.  (The JAX version's ``lr0``
    override serves its vmapped sweeps.)"""
    lr0 = torch.full((), tcfg.learning_rate, dtype=torch.float32,
                     device=device)
    if not tcfg.decay or tcfg.faithful_inert_decay:
        return lambda step: lr0
    rate = torch.full((), tcfg.decay_rate, dtype=torch.float32,
                      device=device)
    return lambda step: optim.exponential_decay(
        lr0, step, tcfg.decay_steps, rate, tcfg.decay_staircase)


def learning_rate_at(tcfg: TrainConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: an f32 tensor on ``step``'s
    device."""
    device = step.device if isinstance(step, torch.Tensor) else None
    return learning_rate_schedule(tcfg, device)(step)


def _state_dtype(tcfg: TrainConfig):
    return optim.state_dtype(tcfg.optimizer_state_dtype)


def init_state(seed: int, cfg: MMAEConfig, tcfg: TrainConfig,
               device="cuda") -> TrainState:
    """Fresh parameters and optimizer state on ``device``.  The parameters
    are drawn from a generator seeded by ``(seed, tcfg.seed, 0)``, the
    run's draws from one seeded by ``(seed, tcfg.seed, 1)``, as the JAX
    package folds ``tcfg.seed`` into its key and splits it in two."""
    device = torch.device(device)
    k_init = torch.Generator(device=device).manual_seed(
        derive_seed(seed, tcfg.seed, 0))
    k_run = torch.Generator(device=device).manual_seed(
        derive_seed(seed, tcfg.seed, 1))
    params = mmae.init(cfg, generator=k_init, device=device)
    return state_for_params(params, tcfg, k_run)


def state_for_params(params: mmae.MMAEParams, tcfg: TrainConfig,
                     generator: torch.Generator) -> TrainState:
    """A fresh TrainState around existing parameters: optimizer slots at
    step 0 in the configured ``optimizer_state_dtype``.  The one place
    resumed and phase-2 states are built, so they never differ from
    :func:`init_state`'s."""
    device = optim.tree_leaves(params)[0].device
    return TrainState(params=params,
                      opt_state=optim.opt_init(tcfg.optimizer, params,
                                               _state_dtype(tcfg)),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      generator=generator)


def _sample_rows(generator: torch.Generator, n: int, size: int,
                 device) -> torch.Tensor:
    """``size`` row indices uniform in [0, n), with replacement
    (data_funcs.py:161-168)."""
    return torch.randint(0, n, (size,), generator=generator,
                         device=generator.device).to(device)


def _grads(loss_fn, params: mmae.MMAEParams) -> Tuple[torch.Tensor, Any]:
    """(loss, d loss / d params) as a tree like ``params``; zeros where the
    loss does not reach a leaf (the decoder in phase 2)."""
    with torch.enable_grad():
        live = optim.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(live)
        leaves = optim.tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, grads)])
    return loss.detach(), optim.tree_map(lambda _: next(it), params)


def clone_state(state: TrainState) -> TrainState:
    """A state with copies of ``state``'s tensors and the same
    generator."""
    return TrainState(optim.tree_map(torch.clone, state.params),
                      optim.tree_map(torch.clone, state.opt_state),
                      state.step.clone(), state.generator)


def _apply_update_(state: TrainState, grads, tcfg: TrainConfig,
                   lr: Callable) -> None:
    """The optimizer's update and ``step + 1``, written into ``state``'s
    own tensors; ``lr`` is the run's :func:`learning_rate_schedule`."""
    clip = tcfg.clip_norm if tcfg.clip_gradients else None
    with torch.no_grad():
        optim.opt_update(tcfg.optimizer, grads, state.opt_state,
                         state.params, lr(state.step), clip_norm=clip,
                         inplace=True)
        state.step.add_(1)


def unsupervised_step_(state: TrainState, cfg: MMAEConfig,
                       tcfg: TrainConfig, spec: NoiseSpec,
                       train_x: torch.Tensor,
                       lr: Optional[Callable] = None) -> torch.Tensor:
    """One denoising step (multimodal_autoencoder.py:566-590) in place:
    the update goes into ``state``'s tensors and its generator advances;
    returns the loss.  ``lr`` defaults to a schedule built for this step.
    (The JAX step's per-config ``hyper`` overrides serve its vmapped
    sweeps; the port's sweeps train on ``parallel/grid_trainer.py``
    instead.)"""
    lr = lr or learning_rate_schedule(tcfg, state.step.device)
    g = state.generator
    x = train_x[_sample_rows(g, train_x.shape[0], tcfg.batch_size,
                             train_x.device)]
    noisy = add_noise_to_batch(g, x, spec)

    def loss_fn(params):
        loss, _ = mmae.total_loss(params, cfg, noisy, x, generator=g,
                                  keep_prob=cfg.dropout_prob, train=True)
        return loss

    loss, grads = _grads(loss_fn, state.params)
    _apply_update_(state, grads, tcfg, lr)
    return loss


def unsupervised_step(state: TrainState, cfg: MMAEConfig, tcfg: TrainConfig,
                      spec: NoiseSpec, train_x: torch.Tensor
                      ) -> Tuple[TrainState, torch.Tensor]:
    """:func:`unsupervised_step_` on a copy of ``state``: (new state,
    loss); ``state``'s tensors stay as they were."""
    state = clone_state(state)
    return state, unsupervised_step_(state, cfg, tcfg, spec, train_x)


@torch.no_grad()
def evaluate_reconstruction(params: mmae.MMAEParams, cfg: MMAEConfig,
                            spec: NoiseSpec, x: torch.Tensor,
                            generator: torch.Generator,
                            add_noise: bool = True) -> torch.Tensor:
    """Report-scaled reconstruction loss, optionally with fresh corruption:
    get_performance_on_data[_with_noise] (multimodal_autoencoder.py
    :1005-1033)."""
    noisy = add_noise_to_batch(generator, x, spec) if add_noise else x
    _, aux = mmae.total_loss(params, cfg, noisy, x, generator=generator)
    return losses_lib.report_scale(cfg.loss, aux["recon_loss"], x.shape[0])


def _eval_batches(state: TrainState, tcfg: TrainConfig,
                  train_n: int, val_n: int, device):
    """Row indices of one record's train batch and val batch (the val
    batch is ``eval_batch_size`` rows, :704-737)."""
    g = state.generator
    t_idx = _sample_rows(g, train_n, tcfg.batch_size, device)
    v_idx = _sample_rows(g, max(val_n, 1),
                         min(tcfg.eval_batch_size, max(val_n, 1)), device)
    return t_idx, v_idx


def _eval_period(state: TrainState, cfg: MMAEConfig, tcfg: TrainConfig,
                 spec: NoiseSpec, train_x: torch.Tensor, val_x: torch.Tensor
                 ) -> torch.Tensor:
    """The per-record evaluation (multimodal_autoencoder.py:704-737): the
    loss of a fresh noisy train batch and of a fresh noisy val batch, both
    without dropout, as one (2,) tensor."""
    t_idx, v_idx = _eval_batches(state, tcfg, train_x.shape[0],
                                 val_x.shape[0], train_x.device)
    g = state.generator
    return torch.stack((
        evaluate_reconstruction(state.params, cfg, spec, train_x[t_idx], g),
        evaluate_reconstruction(state.params, cfg, spec, val_x[v_idx], g)))


def _host_columns(records, k: int) -> list:
    """Per-record (k,) device tensors as k host arrays (one copy)."""
    if not records:
        return [np.zeros((0,), np.float32) for _ in range(k)]
    table = torch.stack(records).cpu().numpy()
    return [np.ascontiguousarray(table[:, i]) for i in range(k)]


def train(state: TrainState, cfg: MMAEConfig, tcfg: TrainConfig,
          spec: NoiseSpec, train_x: torch.Tensor, val_x: torch.Tensor,
          num_steps: Optional[int] = None) -> Tuple[TrainState, Curves]:
    """``num_steps`` denoising steps, recording the curves every
    ``record_every_nth`` steps before that step's update (:574-590).  On
    the card the step and the evaluation replay CUDA graphs
    (``ops/step_graph.run``)."""
    cfg = cfg.validate()
    num_steps = tcfg.num_steps if num_steps is None else num_steps
    spec = spec.to(train_x.device)
    state = clone_state(state)
    lr = learning_rate_schedule(tcfg, state.step.device)
    records = step_graph.run(
        lambda: unsupervised_step_(state, cfg, tcfg, spec, train_x, lr),
        lambda: _eval_period(state, cfg, tcfg, spec, train_x, val_x),
        num_steps, range(0, num_steps, tcfg.record_every_nth),
        state.generator, train_x.device)
    return state, Curves(*_host_columns(records, 2))


# ---------------------------------------------------------------------------
# Phase 2: supervised classification training (train_classification,
# multimodal_autoencoder.py:606-647).
# ---------------------------------------------------------------------------

def classification_step_(state: TrainState, cfg: MMAEConfig,
                         tcfg: TrainConfig, spec: NoiseSpec,
                         train_x: torch.Tensor, train_y: torch.Tensor,
                         lr: Optional[Callable] = None) -> torch.Tensor:
    """One supervised step in place: noisy batch -> classification loss ->
    Adam; returns the loss.  Gradients flow into the encoder (the
    reference's ``minimize`` spans every upstream variable, :443); the
    decoder's are zero."""
    lr = lr or learning_rate_schedule(tcfg, state.step.device)
    g = state.generator
    idx = _sample_rows(g, train_x.shape[0], tcfg.batch_size, train_x.device)
    x, y = train_x[idx], train_y[idx]
    noisy = add_noise_to_batch(g, x, spec)

    def loss_fn(params):
        loss, _ = mmae.classification_total_loss(
            params, cfg, noisy, y, generator=g, keep_prob=cfg.dropout_prob,
            train=True)
        return loss

    loss, grads = _grads(loss_fn, state.params)
    _apply_update_(state, grads, tcfg, lr)
    return loss


def classification_step(state: TrainState, cfg: MMAEConfig,
                        tcfg: TrainConfig, spec: NoiseSpec,
                        train_x: torch.Tensor, train_y: torch.Tensor
                        ) -> Tuple[TrainState, torch.Tensor]:
    """:func:`classification_step_` on a copy of ``state``: (new state,
    loss)."""
    state = clone_state(state)
    return state, classification_step_(state, cfg, tcfg, spec, train_x,
                                       train_y)


@torch.no_grad()
def evaluate_classification(params: mmae.MMAEParams, cfg: MMAEConfig,
                            x: torch.Tensor, y: torch.Tensor,
                            generator: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) without noise or dropout: the val side of
    evaluate_classification_performance (:754-762)."""
    loss, aux = mmae.classification_total_loss(params, cfg, x, y,
                                               generator=generator)
    acc = torch.mean((aux["predictions"] == y.to(torch.int32))
                     .to(torch.float32))
    return loss, acc


def _eval_classification(state: TrainState, cfg: MMAEConfig,
                         tcfg: TrainConfig, train_x: torch.Tensor,
                         train_y: torch.Tensor, val_x: torch.Tensor,
                         val_y: torch.Tensor) -> torch.Tensor:
    """A phase-2 record: (train loss, train acc, val loss, val acc) of a
    fresh train batch and val batch, without noise or dropout."""
    t_idx, v_idx = _eval_batches(state, tcfg, train_x.shape[0],
                                 val_x.shape[0], train_x.device)
    g = state.generator
    return torch.stack((
        *evaluate_classification(state.params, cfg, train_x[t_idx],
                                 train_y[t_idx], g),
        *evaluate_classification(state.params, cfg, val_x[v_idx],
                                 val_y[v_idx], g)))


def train_classification(state: TrainState, cfg: MMAEConfig,
                         tcfg: TrainConfig, spec: NoiseSpec,
                         train_x: torch.Tensor, train_y: torch.Tensor,
                         val_x: torch.Tensor, val_y: torch.Tensor,
                         num_steps: Optional[int] = None
                         ) -> Tuple[TrainState, ClassificationCurves]:
    """The phase-2 loop with accuracy recording (:606-647); records and
    runs as :func:`train` does."""
    cfg = cfg.validate()
    num_steps = tcfg.num_steps if num_steps is None else num_steps
    spec = spec.to(train_x.device)
    state = clone_state(state)
    lr = learning_rate_schedule(tcfg, state.step.device)
    records = step_graph.run(
        lambda: classification_step_(state, cfg, tcfg, spec, train_x,
                                     train_y, lr),
        lambda: _eval_classification(state, cfg, tcfg, train_x, train_y,
                                     val_x, val_y),
        num_steps, range(0, num_steps, tcfg.record_every_nth),
        state.generator, train_x.device)
    return state, ClassificationCurves(*_host_columns(records, 4))


# ---------------------------------------------------------------------------
# Inference (multimodal_autoencoder.py:932-950, 1035-1045, 1062-1080,
# 1189-1216).  Where the JAX package takes a PRNG key (the VAE's eval-time
# sampling, corruption), these take a generator.
# ---------------------------------------------------------------------------

@torch.no_grad()
def predict(params: mmae.MMAEParams, cfg: MMAEConfig, x: torch.Tensor,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reconstruction, report-scaled loss) with no noise or dropout
    (:932-950).  For sigmoid-CE the reconstruction is sigmoid(logits)."""
    cfg = cfg.validate()
    _, aux = mmae.total_loss(params, cfg, x, x, generator=generator)
    loss = losses_lib.report_scale(cfg.loss, aux["recon_loss"], x.shape[0])
    return aux["outputs"].recon, loss


@torch.no_grad()
def get_embedding(params: mmae.MMAEParams, cfg: MMAEConfig, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  add_noise: bool = False,
                  spec: Optional[NoiseSpec] = None) -> torch.Tensor:
    """Embedding of X, optionally after corruption by ``spec``
    (:1062-1080).  For the VAE this is the *sampled* z, as in the
    reference graph (:372-375)."""
    cfg = cfg.validate()
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    if add_noise:
        x = add_noise_to_batch(generator, x, spec)
    return mmae.forward(params, cfg, x, generator=generator).embedding


@torch.no_grad()
def reconstruction_loss_per_modality(params: mmae.MMAEParams,
                                     cfg: MMAEConfig,
                                     modality_masks: torch.Tensor,
                                     x: torch.Tensor,
                                     generator: Optional[torch.Generator]
                                     = None) -> torch.Tensor:
    """Per-modality masked-reconstruction RMSE (:1189-1216): for each
    modality, blank its span to -1.0, reconstruct, and take the RMSE over
    that span only.  ``modality_masks`` is (num_modalities, num_feats)
    bool; returns (num_modalities,)."""
    cfg = cfg.validate()
    out = []
    for mask in modality_masks.to(x.device):
        noisy = torch.where(mask, torch.full_like(x, -1.0), x)
        recon, _ = predict(params, cfg, noisy, generator)
        se = torch.where(mask, torch.square(x - recon), 0.0)
        out.append(torch.sqrt(se.sum() / (mask.sum() * x.shape[0])))
    return torch.stack(out)


@torch.no_grad()
def classification_predictions(params: mmae.MMAEParams, cfg: MMAEConfig,
                               x: torch.Tensor,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """Class predictions on X (multimodal_autoencoder.py:1035-1045):
    per-label sigmoid rounding, or argmax for softmax."""
    cfg = cfg.validate()
    out = mmae.forward(params, cfg, x, generator=generator)
    logits = mmae.classify(params, cfg, out.embedding)
    return losses_lib.classification_predictions(cfg.classification_loss,
                                                 logits)
