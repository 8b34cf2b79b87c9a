"""Config-parallel grid training, both phases of the two-phase sweep, on
one device or split over several.

Counterpart of ``multimodalautoencoder_tpu/parallel/grid_trainer.py``.  The reference
trains one (setting, fold) at a time (generic_wrapper.py:253-254,
:298-300); here a whole shape bucket trains at once:

- per-config hyperparameters (lr, keep_prob, weight_penalty, act_id) are
  stacked into tensors (:class:`HyperStack`);
- ragged CV folds are padded into a :class:`FoldedData` stack with
  valid-row counts; batches are drawn in [0, n_valid);
- instances = configs x folds, a leading batch axis of every tensor.

Two backends, as in the JAX package: ``"pallas"``, the hand-written CUDA
training kernels (``ops/train_kernels.py`` for phase 1, with its depth >= 3
family in ``ops/train_deep_kernels.py``, ``ops/cls_train_kernels.py`` for
phase 2; the Pallas kernels' semantics),
and ``"xla"``, :func:`train_grid` and :func:`train_classification_grid`,
batched eager PyTorch with autograd (the XLA trainers' semantics).  Phase 1
ends in the noisy-val objective (multimodal_autoencoder.py:1019-1033),
phase 2 in val predictions; both evaluators are shared by the backends.

The JAX package's mesh argument is a device or a device list here
(``parallel/mesh.py``).  With several devices the ``"pallas"`` backend
draws the bucket's run state whole (the instances' Philox seeds, initial
parameters and fold ids), splits the instance axis into contiguous
chunks, one per device, runs each chunk on its device from its own host
thread (the kernels on a GPU, the twin on the CPU) and gathers the
chunks onto the first device before the evaluators.  Each instance's
Philox key is its own seed, so on the card every instance ends bit for
bit as on one device.  The CPU twin matches to the last bit where an
instance's rows fill whole vectors: PyTorch evaluates exp, tanh and
sigmoid on a tensor's scalar tail with other code than on its vector
lanes, and a cut can move an instance between the two.  The ``"xla"``
backend draws every instance's randomness from one
generator in sequence, so its instance axis does not split: it trains
the whole bucket on the first device.
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
from multimodalautoencoder_tpu_torch.ops import cls_train_kernels, \
    optim, train_kernels
from multimodalautoencoder_tpu_torch.parallel import mesh
from multimodalautoencoder_tpu_torch.utils import profiling

# activation-key aliases (sweep ledgers use activation_function, the
# reference ctor uses activation_func)
_ACT_KEYS = ("activation_function", "activation_func", "activation")


def _pick(s: Dict[str, Any], names, default):
    for n in names:
        if n in s:
            return s[n]
    return default


def resolve_backend_two_phase(backend: str, cfg: MMAEConfig,
                              tcfg: TrainConfig, cls_tcfg: TrainConfig,
                              spec: NoiseSpec,
                              on_gpu: Optional[bool] = None) -> str:
    """Resolve ``"auto"`` for the two-phase paths as the JAX package does
    (``resolve_backend_two_phase`` :86-106, on one device): the kernels of
    both phases (``"pallas"``) on a GPU when the configuration is in
    ``cls_train_kernels.supported_two_phase``, else the plain trainers
    (``"xla"``).  ``on_gpu`` defaults to whether CUDA is available."""
    if backend != "auto":
        return backend
    if on_gpu is None:
        on_gpu = torch.cuda.is_available()
    return ("pallas" if on_gpu and cls_train_kernels.supported_two_phase(
        cfg, tcfg, cls_tcfg, spec) else "xla")


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
class ClassifierHyperStack:
    """Per-config hyperparameters of the phase-2 classification head
    (autoencoder_classification_wrapper.py:43, :173-179)."""

    keep_prob: torch.Tensor        # (C,) float32
    weight_penalty: torch.Tensor   # (C,) float32
    cls_act_id: torch.Tensor       # (C,) int32

    @classmethod
    def from_settings(cls, settings: Sequence[Dict[str, Any]],
                      cfg: MMAEConfig) -> "ClassifierHyperStack":
        kp, wp, act = [], [], []
        default_act = cfg.classification_activation or cfg.activation
        for s in settings:
            kp.append(float(s.get("dropout_prob", cfg.dropout_prob)))
            wp.append(float(s.get("weight_penalty",
                                  cfg.classification_weight_penalty)))
            act.append(mmae.activation_id(_pick(s, _ACT_KEYS, default_act)))
        return cls(keep_prob=torch.tensor(kp, dtype=torch.float32),
                   weight_penalty=torch.tensor(wp, dtype=torch.float32),
                   cls_act_id=torch.tensor(act, dtype=torch.int32))

    @property
    def num_configs(self) -> int:
        return int(self.keep_prob.shape[0])


@dataclasses.dataclass(frozen=True)
class FoldedData:
    """CV folds padded to common shapes, with valid-row counts.  Fold f's
    train set is every non-Test row outside fold f, its val set fold f
    (data_funcs.py:278-308); arrays are padded with zero rows to the
    largest fold and ``*_n`` holds the true counts.  Supervised folds
    carry their labels, (K, rows, L) or (K, rows) for one label, and
    ``val_noisy`` the val rows' ``logistics_noisy`` flags."""

    train_x: torch.Tensor   # (K, max_train, F) float32
    train_n: torch.Tensor   # (K,) int32
    val_x: torch.Tensor     # (K, max_val, F) float32
    val_n: torch.Tensor     # (K,) int32
    train_y: Optional[torch.Tensor] = None   # float32
    val_y: Optional[torch.Tensor] = None     # float32
    val_noisy: Optional[torch.Tensor] = None  # (K, max_val) bool

    @property
    def num_folds(self) -> int:
        return int(self.train_x.shape[0])

    @classmethod
    def from_loader(cls, loader, num_folds: int, device="cuda",
                    supervised: bool = False,
                    noisy_flags: bool = False) -> "FoldedData":
        """Every fold of a cross-validation ``DataLoader``, with its labels
        when ``supervised`` and its val rows' noisy flags when
        ``noisy_flags``."""
        tx, vx, ty, vy, vn = [], [], [], [], []
        for f in range(num_folds):
            a, ay, b, by = loader.get_cross_val_data_for_fold(f)
            tx.append(a)
            vx.append(b)
            ty.append(ay)
            vy.append(by)
            if noisy_flags:
                vn.append(loader.get_cross_val_noisy_flags_for_fold(f))
        return cls.from_ragged(tx, vx, device,
                               train_y_list=ty if supervised else None,
                               val_y_list=vy if supervised else None,
                               val_noisy_list=vn if noisy_flags else None)

    @classmethod
    def from_single_split(cls, train_x, val_x, device="cuda"
                          ) -> "FoldedData":
        """Non-CV case: one 'fold', the fixed Train/Val split."""
        return cls.from_ragged([train_x], [val_x], device)

    @classmethod
    def from_ragged(cls, train_list, val_list, device="cuda",
                    train_y_list=None, val_y_list=None,
                    val_noisy_list=None) -> "FoldedData":
        def pad_stack(mats, dtype=np.float32):
            mats = [np.asarray(m) for m in mats]
            mx = max(m.shape[0] for m in mats)
            out = np.zeros((len(mats), mx) + tuple(mats[0].shape[1:]),
                           dtype=dtype)
            for i, m in enumerate(mats):
                out[i, :m.shape[0]] = m
            return torch.as_tensor(out, device=device)

        def counts(mats):
            return torch.tensor([m.shape[0] for m in mats],
                                dtype=torch.int32, device=device)

        return cls(train_x=pad_stack(train_list), train_n=counts(train_list),
                   val_x=pad_stack(val_list), val_n=counts(val_list),
                   train_y=(pad_stack(train_y_list) if train_y_list
                            else None),
                   val_y=pad_stack(val_y_list) if val_y_list else None,
                   val_noisy=(pad_stack(val_noisy_list, bool)
                              if val_noisy_list else None))

    def to(self, device) -> "FoldedData":
        return FoldedData(*(None if t is None else t.to(device) for t in
                            (self.train_x, self.train_n, self.val_x,
                             self.val_n, self.train_y, self.val_y,
                             self.val_noisy)))


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
    """Train a bucket on ``device``, a device or a device list (the JAX
    package's mesh).  ``backend``: ``"pallas"`` (the CUDA training
    kernels, split over the devices; raises ``ValueError`` outside their
    family), ``"xla"`` (:func:`train_grid` on the first device), or
    ``"auto"`` (:func:`resolve_backend` for those devices).  Returns
    ``(params, losses)`` with leading (C, K) axes on the first device.
    The call is one ``mmae.entry`` span (``utils/profiling.span``)."""
    devices = mesh.as_devices(device)
    backend = resolve_backend(backend, cfg, tcfg, spec,
                              on_gpu=devices[0].type == "cuda")
    with profiling.span("mmae.entry"):
        with profiling.span("mmae.prepare"):
            folded = folded.to(devices[0])
        if backend == "pallas":
            return train_kernels.train_grid_pallas(
                seed, cfg, tcfg, spec, hyper, folded, num_steps, params0,
                devices)
        if backend != "xla":
            raise ValueError(f"unknown backend {backend!r} "
                             "('auto', 'pallas' or 'xla')")
        return train_grid(seed, cfg, tcfg, spec, hyper, folded, num_steps,
                          params0)


# ------------------------------------------------------------- phase 2

def _grad_leaves(loss: torch.Tensor, leaves):
    """d loss.sum() / d leaf for every leaf; zeros where the loss does not
    reach a leaf (the decoder in phase 2)."""
    grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


def train_classification_grid(seed: int, cfg: MMAEConfig, tcfg: TrainConfig,
                              spec: NoiseSpec, params_stacked,
                              hyper: HyperStack,
                              chyper: ClassifierHyperStack,
                              folded: FoldedData,
                              num_steps: Optional[int] = None):
    """Phase 2 of every (config, fold) instance with the plain backend, all
    N = C * K instances as one batch of eager PyTorch with autograd: the
    XLA trainer's step (``_train_classification_instance`` :467-520:
    indices uniform in [0, n_valid), ``add_noise_to_batch``, dropout at the
    head's keep probability, ``classification_total_loss``, the optimizer
    over every parameter at the constant lr).  ``params_stacked`` carries
    phase 1's parameters and fresh heads with leading (C, K) axes.  Returns
    ``(params, val predictions)`` with leading (C, K) axes.  ``seed``
    seeds one CPU generator that draws every step's batch, noise and
    dropout, then the VAE's evaluation eps."""
    cfg = cfg.validate()
    num_steps = tcfg.num_steps if num_steps is None else int(num_steps)
    C, K = hyper.num_configs, folded.num_folds
    N = C * K
    dev = folded.train_x.device
    g = torch.Generator().manual_seed(int(seed))
    params = optim.tree_map(
        lambda t: t.reshape((N,) + tuple(t.shape[2:])).to(
            dev, torch.float32, copy=True), params_stacked)
    state = optim.opt_init(tcfg.optimizer, params,
                           optim.state_dtype(tcfg.optimizer_state_dtype))
    clip = tcfg.clip_norm if tcfg.clip_gradients else None
    keep = chyper.keep_prob.repeat_interleave(K).to(dev)
    wpen = chyper.weight_penalty.repeat_interleave(K).to(dev)
    cact = chyper.cls_act_id.repeat_interleave(K).to(dev)
    eact = hyper.act_id.repeat_interleave(K).to(dev)
    fold = torch.arange(K, device=dev).repeat(C).view(-1, 1)
    n_valid = folded.train_n.to(dev).repeat(C).view(-1, 1)

    for _ in range(num_steps):
        u = torch.rand((N, tcfg.batch_size), generator=g).to(dev)
        idx = torch.minimum((u * n_valid).long(), n_valid - 1)
        x, y = folded.train_x[fold, idx], folded.train_y[fold, idx]
        noisy = add_noise_to_batch(g, x, spec)
        leaves = [t.detach().requires_grad_()
                  for t in optim.tree_leaves(params)]
        it = iter(leaves)
        p = optim.tree_map(lambda _: next(it), params)
        loss, _ = mmae.classification_total_loss(
            p, cfg, noisy, y, generator=g, keep_prob=keep, train=True,
            weight_penalty=wpen, enc_act_id=eact, cls_act_id=cact)
        it = iter(_grad_leaves(loss, leaves))
        grads = optim.tree_map(lambda _: next(it), params)
        with torch.no_grad():
            params, state = optim.opt_update(tcfg.optimizer, grads, state,
                                             params, tcfg.learning_rate,
                                             clip_norm=clip, batch_dims=1)

    params = optim.tree_map(
        lambda t: t.reshape((C, K) + tuple(t.shape[1:])), params)
    return params, cls_train_kernels.val_predictions(params, cfg, hyper,
                                                     chyper, folded, g)


def attach_fresh_heads(generator: torch.Generator, cfg: MMAEConfig,
                       params_headless: mmae.MMAEParams) -> mmae.MMAEParams:
    """Fresh per-(config, fold) classification heads on a headless
    phase-1 stack with leading (C, K) axes (the reference re-initializes
    the head before phase 2: set_classification_params ->
    rebuild_reinitialize, multimodal_autoencoder.py:898-930)."""
    C, K = params_headless.enc_b[0].shape[:2]
    dev = params_headless.enc_b[0].device
    cls_w, cls_b = cls_train_kernels.init_heads(generator, cfg, C, K)
    return params_headless._replace(
        cls_w=tuple(t.to(dev) for t in cls_w),
        cls_b=tuple(t.to(dev) for t in cls_b))


def _gather_configs(params_u: mmae.MMAEParams, p1_map) -> mmae.MMAEParams:
    """Every leaf's leading (config) axis gathered by ``p1_map``."""
    idx = torch.as_tensor(np.asarray(p1_map, dtype=np.int64))
    return optim.tree_map(lambda t: t[idx.to(t.device)], params_u)


def train_classification_dedup_grid(seed: int, cfg: MMAEConfig,
                                    tcfg: TrainConfig, spec: NoiseSpec,
                                    params_u, p1_map,
                                    hyper: HyperStack,
                                    chyper: ClassifierHyperStack,
                                    folded: FoldedData,
                                    num_steps: Optional[int] = None):
    """Phase 2 on a deduplicated phase-1 stack: gather the headless
    (U, K, ...) parameters by ``p1_map`` onto the config axis, attach
    fresh heads (drawn from a generator seeded ``seed``) and train every
    (config, fold) instance with :func:`train_classification_grid` (seeded
    ``cls_train_kernels.derive_seed(seed, 2)``).  Settings sharing their
    MMAE hyperparameters are statistically identical pretraining runs, so
    the sweep pretrains each once (PARITY.md)."""
    cfg = cfg.validate()
    headed = attach_fresh_heads(torch.Generator().manual_seed(int(seed)),
                                cfg, _gather_configs(params_u, p1_map))
    return train_classification_grid(
        cls_train_kernels.derive_seed(seed, 2), cfg, tcfg, spec, headed,
        hyper, chyper, folded, num_steps)


def train_phase1_shared(device, seed: int, cfg: MMAEConfig,
                        tcfg: TrainConfig, spec: NoiseSpec,
                        hyper_u: HyperStack, unsup_folded: FoldedData,
                        num_steps: Optional[int] = None,
                        backend: str = "auto"):
    """Phase 1 for a family of two-phase buckets: only the unique MMAE
    settings (U configs), once, on the headless f32 view
    ``cls_train_kernels.phase1_cfg``, the MMAE the reference pretrains
    before attaching the head; every classifier bucket of the family then
    shares the (U, K, ...) stack through :func:`train_phase2_shared_sharded`
    (the reference retrains the MMAE for all 576 settings though only 36
    pretraining runs are distinct, autoencoder_classification_wrapper.py
    :195-227)."""
    return train_grid_sharded(device, seed, cls_train_kernels.phase1_cfg(cfg),
                              tcfg, spec, hyper_u, unsup_folded, num_steps,
                              backend)


def train_phase2_shared_sharded(device, seed: int, cfg: MMAEConfig,
                                tcfg: TrainConfig, cls_tcfg: TrainConfig,
                                spec: NoiseSpec, params_u, p1_map,
                                hyper: HyperStack,
                                chyper: ClassifierHyperStack,
                                sup_folded: FoldedData,
                                cls_num_steps: Optional[int] = None,
                                backend: str = "auto"):
    """Phase 2 of a bucket on shared phase-1 results: ``params_u`` is the
    headless (U, K, ...) stack of :func:`train_phase1_shared`, ``p1_map``
    the (C,) phase-1 row of each of the bucket's settings.  ``"pallas"``
    gathers and runs ``cls_train_kernels.phase2_pallas`` (seed ``seed``),
    split over ``device`` when it is a list; ``"xla"``
    :func:`train_classification_dedup_grid` on the first device.  Returns
    ``(params, preds)`` with leading (C, K) axes.  The call is one
    ``mmae.entry`` span."""
    devices = mesh.as_devices(device)
    backend = resolve_backend_two_phase(backend, cfg, tcfg, cls_tcfg, spec,
                                        on_gpu=devices[0].type == "cuda")
    if backend == "pallas" and not cls_train_kernels.supported_two_phase(
            cfg, tcfg, cls_tcfg, spec):
        raise ValueError("configuration outside the two-phase kernels'"
                         " family; use the plain grid trainer")
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r} "
                         "('auto', 'pallas' or 'xla')")
    with profiling.span("mmae.entry"):
        with profiling.span("mmae.prepare"):
            sup_folded = sup_folded.to(devices[0])
            params_u = optim.tree_map(lambda t: t.to(devices[0]), params_u)
            if backend == "pallas":
                params1 = _gather_configs(params_u, p1_map)
        if backend == "pallas":
            return cls_train_kernels.phase2_pallas(
                seed, cfg, cls_tcfg, spec, params1, hyper, chyper,
                sup_folded, cls_num_steps, devices=devices)
        return train_classification_dedup_grid(
            seed, cfg, cls_tcfg, spec, params_u, p1_map, hyper, chyper,
            sup_folded, cls_num_steps)


@torch.no_grad()
def embed_grid(params_stacked: mmae.MMAEParams, cfg: MMAEConfig,
               hyper: HyperStack, x: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sample: bool = False) -> torch.Tensor:
    """Embeddings of ``x`` (rows, F) under every (config, fold) trained
    model of a stack with leading (C, K) axes: (C, K, rows, E), on the
    parameters' device.  ``sample=False`` gives the deterministic mu even
    for the VAE; with ``sample`` the VAE's z draws its eps from
    ``generator`` (a fresh one seeded 0 when None, where the JAX package
    takes a key).  The reference embeds with the sampled z
    (:1062-1080)."""
    cfg = cfg.validate()
    first = optim.tree_leaves(params_stacked)[0]
    C, K = int(first.shape[0]), int(first.shape[1])
    flat = optim.tree_map(
        lambda t: t.reshape((C * K,) + tuple(t.shape[2:])), params_stacked)
    act = hyper.act_id.repeat_interleave(K).to(first.device)
    out = mmae.forward(flat, cfg, x.to(first.device), generator=generator,
                       sample=sample, act_id=act)
    emb = out.embedding
    return emb.reshape((C, K) + tuple(emb.shape[-2:]))


def train_two_phase_sharded(device, seed: int, cfg: MMAEConfig,
                            tcfg: TrainConfig, cls_tcfg: TrainConfig,
                            spec: NoiseSpec, hyper: HyperStack,
                            chyper: ClassifierHyperStack,
                            unsup_folded: FoldedData,
                            sup_folded: FoldedData,
                            num_steps: Optional[int] = None,
                            cls_num_steps: Optional[int] = None,
                            backend: str = "auto"):
    """Both phases of a bucket on ``device`` (a device or a device list),
    every setting pretraining its own MMAE as the reference does (the
    sweep shares phase 1 instead: :func:`train_phase1_shared`).
    ``"pallas"``: ``cls_train_kernels.train_two_phase_pallas``, split over
    the devices; ``"xla"``: :func:`train_grid`
    on the headless f32 view (seed ``derive_seed(seed, 1)``), fresh heads
    and :func:`train_classification_grid`.  Returns ``(params, losses,
    preds)`` with leading (C, K) axes: phase-1 noisy-val objectives and
    phase-2 val predictions (autoencoder_classification_wrapper.py
    :195-237).  The call is one ``mmae.entry`` span."""
    devices = mesh.as_devices(device)
    backend = resolve_backend_two_phase(backend, cfg, tcfg, cls_tcfg, spec,
                                        on_gpu=devices[0].type == "cuda")
    C = hyper.num_configs
    with profiling.span("mmae.entry"):
        with profiling.span("mmae.prepare"):
            unsup_folded = unsup_folded.to(devices[0])
            sup_folded = sup_folded.to(devices[0])
        if backend == "pallas":
            return cls_train_kernels.train_two_phase_pallas(
                seed, cfg, tcfg, cls_tcfg, spec, hyper, chyper,
                unsup_folded, sup_folded, num_steps, cls_num_steps,
                devices=devices)
        if backend != "xla":
            raise ValueError(f"unknown backend {backend!r} "
                             "('auto', 'pallas' or 'xla')")
        params1, losses = train_grid(cls_train_kernels.derive_seed(seed, 1),
                                     cls_train_kernels.phase1_cfg(cfg), tcfg,
                                     spec, hyper, unsup_folded, num_steps)
        params, preds = train_classification_dedup_grid(
            cls_train_kernels.derive_seed(seed, 2), cfg, cls_tcfg, spec,
            params1, np.arange(C), hyper, chyper, sup_folded, cls_num_steps)
        return params, losses, preds
