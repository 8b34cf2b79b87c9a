"""The depth-2 grid-training run: hand-written CUDA kernels and their plain
PyTorch twin.

Counterpart of ``multimodalautoencoder_tpu/ops/train_kernel.py`` for its
depth-2 family: ``train_grid_pallas`` -> ``_pipeline`` -> the Pallas kernel
``_train_kernel`` (:274-586, ``pallas_call`` :1071), which trains every
(config, fold) instance of a shape bucket for S steps.  Here:

- :func:`train_grid_pallas` is the pipeline: per-instance initial
  parameters, corruption tables, per-instance scalars, the run, and the
  noisy-val objective (``_noisy_val_losses``, shared with the plain grid
  trainer);
- :func:`train_grid_kernel` launches the CUDA kernels of
  ``csrc/train_kernel.cu`` (built with nvcc for sm_90a at first use, one
  ctypes call per run; the S-step loop runs in C);
- :func:`train_grid_kernel_reference` is their plain twin: the same math,
  the same Philox random numbers (``ops/philox.py``) and the same
  semantics, step by step.  CPU tensors take the twin; CUDA tensors take
  the kernels or raise.

Semantics are the Pallas kernel's, not the XLA trainer's (ROADMAP Queue 3
"Kernel vs XLA randomness"): element corruption is Bernoulli at the
marginal rate ``elem_p = 1-(1-1/F)^k`` (:886-890) instead of k draws with
replacement; Adam with bf16 moments stores them rounded but updates the
weight with this step's unrounded f32 values (:358-363); the VAE's KL is
taken on the sampled z; the decay is always smooth.

What bounds it (:func:`step_bound`): each step streams every parameter
and both Adam moments in and out, 16 B per parameter with bf16 moments
and 24 B with f32, against about 40 FLOP per weight element (three
products of depth B = 20 and the weight gradient); at the H100's 3.35 TB/s
and 67 TFLOP/s of f32 CUDA-core work, bytes bound it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import (
    NoiseSpec, add_noise_to_batch)
from multimodalautoencoder_tpu_torch.ops import dense_kernels, masking, \
    optim, philox
from multimodalautoencoder_tpu_torch.ops.cuda_library import (CSRC_DIR,
                                                              NvccLibrary)
from multimodalautoencoder_tpu_torch.utils import profiling

SOURCE = os.path.join(CSRC_DIR, "train_kernel.cu")
HEADERS = (os.path.join(CSRC_DIR, "philox.cuh"),
           os.path.join(CSRC_DIR, "train_common.cuh"))
LIBRARY = "libtrain_kernel.so"  # in cuda_library.build_dir()

# The kernel's parameter slots (csrc/train_kernel.cu ``Slot``), each
# (N, rows, cols) or (N, cols); None where the bucket has no such tensor.
SLOTS = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4", "wv", "bv")
# Workspace buffers (``Buf``), each (N, B, width); width by name.
BUFFERS = ("x", "xn", "a1d", "gf1", "mu", "lv", "eps", "z2", "a3d", "gf3",
           "g4", "g3", "gz", "glv", "g1")
# Launch types of one step (``Prof``), for per-type CUDA-event timing; the
# grouped update is "weight_grad_adam".
LAUNCH_TYPES = ("sample_corrupt", "forward_products", "vae_elementwise",
                "backward_products", "weight_grad_adam", "bias_grad_adam")
# A step's products in launch order (csrc/train_kernel.cu ``Runner::step``;
# "lv" only for a VAE) and their most (``MAX_PRODUCTS``).
PRODUCT_NAMES = ("z1", "lv", "mu", "z3", "z4", "g3", "gz", "g1")
MAX_PRODUCTS = len(PRODUCT_NAMES)
# update_group_kernel's descriptor table (train_common.cuh ``UPD_SLOTS``)
UPD_SLOTS = 66

# H100 SXM published peaks (NVIDIA's H100 datasheet): HBM bytes/s and
# f32 CUDA-core FLOP/s, the denominators of :func:`step_bound`.
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# The deepest encoder the deep family takes (csrc/train_deep_kernel.cu
# ``MAX_DEPTH``).
MAX_DEPTH = 16


class TrainArgs(ctypes.Structure):
    """``struct TrainArgs`` of csrc/train_kernel.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "n_inst", "batch", "feats", "h1", "h2", "n_types", "max_rows",
            "tied", "variational", "bf16_moments", "decay")]
        + [("panel", ctypes.c_int * MAX_PRODUCTS),
           ("tile_tx", ctypes.c_int * len(SLOTS)),
           ("n_items", ctypes.c_int), ("n_weight_items", ctypes.c_int),
           ("upd_ring", ctypes.c_int * len(SLOTS))]
        + [(n, ctypes.c_int) for n in ("upd_depth", "upd_lfloats",
                                       "upd_rfloats", "upd_rbufs",
                                       "upd_stage")]
        + [(n, ctypes.c_float) for n in (
            "elem_p", "mask_value", "decay_steps", "decay_rate")]
        + [(n, ctypes.c_void_p) for n in (
            "seeds", "fold", "n_valid", "lr", "keep", "wpen", "act",
            "train", "type_table", "cum", "items", "upd_desc")]
        + [("param", ctypes.c_void_p * len(SLOTS)),
           ("m", ctypes.c_void_p * len(SLOTS)),
           ("v", ctypes.c_void_p * len(SLOTS)),
           ("ws", ctypes.c_void_p * len(BUFFERS))])


class TrainLibrary(NvccLibrary):
    """``csrc/train_kernel.cu`` built and bound.  ``launches`` counts the
    training kernels' launches, ``probe_launches`` the generator check's."""

    def __init__(self):
        super().__init__(SOURCE, LIBRARY, HEADERS)
        self.probe_launches = 0

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.mmae_train_run.restype = ctypes.c_int
        lib.mmae_train_run.argtypes = [
            ctypes.POINTER(TrainArgs), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.philox_probe_launch.restype = ctypes.c_int
        lib.philox_probe_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_void_p]
        lib.empty_launch.restype = ctypes.c_int
        lib.empty_launch.argtypes = [ctypes.c_void_p]
        lib.train_kernel_error_string.restype = ctypes.c_char_p
        lib.train_kernel_error_string.argtypes = [ctypes.c_int]

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.load().train_kernel_error_string(err).decode()
            raise RuntimeError(f"{what} failed: {msg} ({err})")


KERNELS = TrainLibrary()


def launches_per_step(tied: bool, variational: bool) -> int:
    """Kernel launches of one training step of ``mmae_train_run``, kernel
    3's at depth 2 (``train_deep_kernels.launches_per_step``): sample +
    corrupt, 4 forward and 3 backward products and one grouped update, 9
    in all; a VAE adds the log-sigma product and two elementwise passes,
    12."""
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels

    return train_deep_kernels.launches_per_step(2, tied, variational)


# ----------------------------------------------------------- the plan

def product_plan(dims, tied: bool, variational: bool, n_inst: int,
                 batch: int, sms: Optional[int] = None
                 ) -> List[Dict[str, object]]:
    """Every product of one step of ``n_inst`` instances in
    ``Runner::step``'s launch order (:data:`PRODUCT_NAMES`): kernel 3's
    plan at depth 2 (``train_deep_kernels.product_plan``: launch type,
    epilogue, ``ncol``, ``K`` (+ ``K2``), K-major B, the panel width of
    ``panel_width`` and the grid), named as kernel 2 names them.  ``dims``
    is (F, H1, H2)."""
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk

    plan = pdk.product_plan(tuple(dims), tied, variational, n_inst, batch,
                            pdk.H100_SMS if sms is None else sms)
    names = [n for n in PRODUCT_NAMES if variational or n != "lv"]
    for p, name in zip(plan, names):
        p["name"] = name
    return plan


def update_tensors(dims, tied: bool, variational: bool):
    """The grouped update's tensors by kernel 2's slots (:data:`SLOTS`):
    weights as (slot, rows, cols), biases as (slot, cols)."""
    F, H1, H2 = dims
    weights = [(0, F, H1), (2, H1, H2)]
    if not tied:
        weights += [(4, H2, H1), (6, H1, F)]
    if variational:
        weights.append((8, H1, H2))
    biases = [(1, H1), (3, H2), (5, H1), (7, F)] \
        + ([(9, H2)] if variational else [])
    return weights, biases


@functools.lru_cache(maxsize=32)
def run_plan(dims, tied: bool, variational: bool, n_inst: int, batch: int,
             sms: int, moment_bytes: int = 2,
             misaligned: Tuple[int, ...] = ()):
    """A run's plan, made once a shape: each product's panel width
    (:func:`product_plan`, ``MAX_PRODUCTS`` ints), the update's work list
    over kernel 2's slots (``train_deep_kernels.work_list``, a CPU
    tensor), its weight items, each weight slot's tile threads across and
    the update's ring (``train_deep_kernels.update_plan``, with
    ``moment_bytes`` a moment and the ``misaligned`` slots in place)."""
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk

    panels = [0] * MAX_PRODUCTS
    for i, p in enumerate(product_plan(dims, tied, variational, n_inst,
                                       batch, sms)):
        panels[i] = p["panel"]
    items, n_weight, tile_tx, ring = pdk.update_plan(
        *update_tensors(dims, tied, variational), n_inst, batch,
        moment_bytes, misaligned, (0, 2) if tied else ())
    return (tuple(panels), torch.from_numpy(items), n_weight,
            tuple(tile_tx.items()), ring)


# --------------------------------------------------------------- family

def supported(cfg: MMAEConfig, tcfg: TrainConfig, spec: NoiseSpec) -> bool:
    """Is (cfg, tcfg, spec) in the kernels' family?  The common gates of
    ``train_kernel.supported`` (:188-213): sigmoid-CE, no classification
    head, Adam, intelligent noise or at most one dropped modality, no
    clipping; then depth 2 (these kernels) or depth 3 up to
    :data:`MAX_DEPTH` (the deep family, ``ops/train_deep_kernels.py``);
    depth 1 belongs to the plain trainer.  No memory budget: device
    memory holds every bucket whose parameters and moments fit it, where
    the JAX package refuses shapes that do not fit VMEM (``vmem_bytes``,
    ``vmem_bytes_deep``)."""
    cfg = cfg.validate()
    return (cfg.loss == "sigmoid_cross_entropy"
            and cfg.classification_layer_sizes is None
            and tcfg.optimizer == "adam"
            and (spec.intelligent or spec.num_modalities_to_drop <= 1)
            and not tcfg.clip_gradients
            and 2 <= len(cfg.layer_sizes) <= MAX_DEPTH)


def element_drop_rate(num_feats: int, spec: NoiseSpec) -> float:
    """Bernoulli zeroing rate with the reference's marginal rate
    1-(1-1/F)^k of k draws with replacement (:886-890)."""
    k = spec.num_element_drops
    return float(1.0 - (1.0 - 1.0 / num_feats) ** k) if k else 0.0


def corruption_tables(spec: NoiseSpec, num_feats: int):
    """(T, F) float32 modality-set masks and their (T,) float32 cumulative
    probabilities (:981-997): the intelligent-noise sets, or each single
    modality uniformly, or one empty set."""
    if spec.intelligent:
        masks = spec.type_masks.to(torch.float32)
        probs = torch.exp(spec.type_log_probs.to(torch.float32))
    elif spec.num_modalities_to_drop == 1:
        masks = spec.modality_masks.to(torch.float32)
        probs = torch.full((masks.shape[0],), 1.0 / masks.shape[0])
    else:
        masks = torch.zeros((1, num_feats))
        probs = torch.ones((1,))
    return masks, torch.cumsum(probs / torch.sum(probs), dim=0)


def step_bound(cfg: MMAEConfig, n_inst: int, batch: int,
               bf16_moments: bool) -> Dict[str, float]:
    """The least time one training step of ``n_inst`` instances could take
    on an H100: the larger of its bytes over the memory rate and its
    operations over the f32 CUDA-core rate.  Bytes: every parameter read
    and written (8 B), both Adam moments read and written (8 B bf16, 16 B
    f32), the sampled batch rows read once.  Operations: 2 per
    multiply-add of the step's products, 10 per parameter for Adam."""
    cfg = cfg.validate()
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    tied, vae = cfg.tie_weights, cfg.variational
    weights = F * H1 + H1 * H2 + (0 if tied else H2 * H1 + H1 * F) \
        + (H1 * H2 if vae else 0)
    params = weights + 2 * H1 + H2 + F + (H2 if vae else 0)
    # forward z1, mu, z3, z4 (+ lv); backward g3, gz, g1 (+ the Wv term)
    macs = batch * (2 * (F * H1 + H1 * H2) + F * H1 + 2 * H1 * H2
                    + (2 * H1 * H2 if vae else 0))
    # weight gradients: one product per weight tensor, two per tied one,
    # so tied and untied both take 2 B (F H1 + H1 H2), the VAE one more
    macs += batch * (2 * (F * H1 + H1 * H2) + (H1 * H2 if vae else 0))
    flop = n_inst * (2.0 * macs + 10.0 * params)
    nbytes = n_inst * (params * (16 if bf16_moments else 24)
                       + 4.0 * batch * F)
    return _bound(nbytes, flop)


def _bound(nbytes: float, flop: float) -> Dict[str, float]:
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_flop = flop / H100_F32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "flop": flop, "bound_ms": max(t_bytes, t_flop),
            "bound_by": "bytes" if t_bytes >= t_flop else "operations"}


def launch_type_bounds(cfg: MMAEConfig, n_inst: int, batch: int,
                       bf16_moments: bool) -> Dict[str, Dict[str, float]]:
    """:func:`step_bound` split by launch type (:data:`LAUNCH_TYPES`),
    each counting its own inputs once and outputs once: weights for every
    product group that reads them, the (N, B, width) activations between
    launches, 12 integer operations per Philox round for the draws."""
    cfg = cfg.validate()
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    tied, vae = cfg.tie_weights, cfg.variational
    N, B = n_inst, batch
    big = F * H1 + H1 * H2            # one copy of the encoder weights
    weights = big * (1 if tied else 2) + (H1 * H2 if vae else 0)
    biases = 2 * H1 + H2 + F + (H2 if vae else 0)
    act = 4.0 * N * B                 # bytes per unit of activation width
    philox_ops = 10 * 12
    moment = 8 if bf16_moments else 16
    return {
        "sample_corrupt": _bound(act * 3 * F,
                                 N * B * (F + 2) * philox_ops),
        "forward_products": _bound(
            4.0 * N * (weights + biases) + act * (2 * F + 4 * H1 + 2 * H2),
            N * (2.0 * B * (2 * big + (H1 * H2 if vae else 0))
                 + B * 2 * H1 * philox_ops)),
        "vae_elementwise": _bound(act * H2 * 10 if vae else 0.0,
                                  N * B * H2 * 40.0 if vae else 0.0),
        "backward_products": _bound(
            4.0 * N * weights + act * (F + 5 * H1 + 3 * H2),
            N * 2.0 * B * (F * H1 + 2 * H1 * H2
                           + (H1 * H2 if vae else 0))),
        "weight_grad_adam": _bound(
            N * weights * (8.0 + moment) + act * (2 * F + 4 * H1 + 3 * H2),
            N * (2.0 * B * (2 * big + (H1 * H2 if vae else 0))
                 + 10.0 * weights)),
        "bias_grad_adam": _bound(N * biases * (8.0 + moment)
                                 + act * (F + 2 * H1 + 2 * H2),
                                 N * (B + 10.0) * biases),
    }


def launch_bounds(cfg: MMAEConfig, n_inst: int, batch: int,
                  bf16_moments: bool, sms: Optional[int] = None
                  ) -> List[Dict[str, object]]:
    """Each launch of one step over ``n_inst`` instances in launch order,
    with its own bound (``train_deep_kernels.launch_rows`` over
    :func:`product_plan` and :func:`launch_type_bounds`): the sample and
    the VAE passes split their types' rows, the grouped update is the
    weight- and bias-update rows together, and each product reads its
    own weight, bias and input and writes its outputs once."""
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk

    cfg = cfg.validate()
    dims = (cfg.num_feats,) + tuple(cfg.layer_sizes)
    plan = product_plan(dims, cfg.tie_weights, cfg.variational, n_inst,
                        batch, sms)
    return pdk.launch_rows(plan, launch_type_bounds(cfg, n_inst, batch,
                                                    bf16_moments),
                           2, cfg.variational, n_inst, batch)


# ----------------------------------------------------------------- state

@dataclasses.dataclass
class GridRun:
    """One bucket's training state and inputs, flat over N = C * K
    instances (instance ``c * K + k`` is config c on fold k), all on one
    device.  The runners update ``params``, ``m`` and ``v`` in place."""

    tied: bool
    variational: bool
    bf16_moments: bool
    decay: bool
    decay_steps: float
    decay_rate: float
    elem_p: float
    mask_value: float
    batch: int
    seeds: torch.Tensor        # (N,) int32, the Philox key words
    fold: torch.Tensor         # (N,) int32
    n_valid: torch.Tensor      # (N,) int32 train rows of the fold
    lr: torch.Tensor           # (N,) float32
    keep: torch.Tensor         # (N,) float32 keep probability
    wpen: torch.Tensor         # (N,) float32 L2 weight penalty
    act: torch.Tensor          # (N,) int32 activation id
    train: torch.Tensor        # (K, max_rows, F) float32 fold train rows
    type_table: torch.Tensor   # (T, F) float32
    cum: torch.Tensor          # (T,) float32
    params: List[Optional[torch.Tensor]]
    m: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]

    @property
    def n_inst(self) -> int:
        return int(self.seeds.shape[0])

    @property
    def dims(self):
        """(F, H1, H2)."""
        w1, w2 = self.params[0], self.params[2]
        return int(w1.shape[1]), int(w1.shape[2]), int(w2.shape[2])

    def clone(self) -> "GridRun":
        """An independent copy."""
        def cp(t):
            return None if t is None else t.clone()
        out = dataclasses.replace(self)
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, torch.Tensor):
                setattr(out, f.name, cp(val))
            elif isinstance(val, list):
                setattr(out, f.name, [cp(t) for t in val])
        return out

    def grid_params(self, C: int, K: int) -> mmae.MMAEParams:
        """The parameters as an MMAEParams with leading (C, K) axes."""
        def un(t):
            return None if t is None else t.reshape((C, K) + t.shape[1:])
        w1, b1, w2, b2, w3, b3, w4, b4, wv, bv = (un(t) for t in self.params)
        return mmae.MMAEParams(
            enc_w=(w1, w2), enc_b=(b1, b2),
            dec_w=() if self.tied else (w3, w4), dec_b=(b3, b4),
            var_w=wv, var_b=bv, cls_w=(), cls_b=())


def init_grid_params(generator: torch.Generator, cfg: MMAEConfig, C: int,
                     K: int) -> mmae.MMAEParams:
    """Initial parameters of every (config, fold) instance, each from
    ``mmae.init`` on the CPU generator, stacked to leading (C, K) axes."""
    with profiling.span("mmae.init_params"):
        insts = [mmae.init(cfg, generator=generator, device="cpu")
                 for _ in range(C * K)]
        return optim.tree_map(
            lambda *leaves: torch.stack(leaves).reshape(
                (C, K) + leaves[0].shape), *insts)


def prepare_run(generator: torch.Generator, cfg: MMAEConfig,
                tcfg: TrainConfig, spec: NoiseSpec, hyper, folded,
                params0: mmae.MMAEParams) -> GridRun:
    """The kernels' inputs for a bucket (:938-1011 without the padding):
    per-instance Philox seeds from ``generator``, fold ids, row counts and
    hyperparameters, the fold data, the corruption tables, ``params0``
    (leading (C, K) axes) flattened to (N, ...), and zero moments.  Lives
    on the device of ``folded``."""
    cfg = cfg.validate()
    p = params0
    w3, w4 = (p.dec_w if p.dec_w else (None, None))
    run = prepare_flat(GridRun, generator, cfg, tcfg, spec, hyper, folded,
                       [p.enc_w[0], p.enc_b[0], p.enc_w[1], p.enc_b[1], w3,
                        p.dec_b[0], w4, p.dec_b[1], p.var_w, p.var_b])
    if run.params[0].shape[1:] != (cfg.num_feats, cfg.layer_sizes[0]):
        raise ValueError(f"params0 W1 has shape {tuple(run.params[0].shape)}"
                         f", the config implies (N, {cfg.num_feats}, "
                         f"{cfg.layer_sizes[0]})")
    return run


def prepare_flat(run_cls, generator: torch.Generator, cfg: MMAEConfig,
                 tcfg: TrainConfig, spec: NoiseSpec, hyper, folded,
                 params: List[Optional[torch.Tensor]], **fields):
    """A ``run_cls`` (:class:`GridRun` or a subclass) over the flat
    parameter list ``params`` (leading (C, K) axes, None where a slot is
    absent), in that list's order; ``fields`` fills the subclass's own
    fields.  The Philox seeds are the first draw from ``generator``."""
    F = cfg.num_feats
    C, K = hyper.num_configs, folded.num_folds
    N = C * K
    dev = folded.train_x.device
    seeds = torch.randint(0, 2 ** 31 - 1, (N,), generator=generator,
                          device=generator.device).to(dev, torch.int32)
    mdt = torch.bfloat16 if tcfg.optimizer_state_dtype == "bfloat16" \
        else torch.float32
    if tcfg.optimizer_state_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unknown optimizer_state_dtype "
                         f"{tcfg.optimizer_state_dtype!r}")

    def flat(t):
        if t is None:
            return None
        return t.reshape((N,) + tuple(t.shape[2:])).to(
            dev, torch.float32).contiguous()

    params = [flat(t) for t in params]
    table, cum = corruption_tables(spec, F)

    def per_inst(t, dtype):
        return t.to(dev, dtype)

    return run_cls(
        tied=bool(cfg.tie_weights), variational=bool(cfg.variational),
        bf16_moments=mdt == torch.bfloat16,
        decay=bool(tcfg.decay and not tcfg.faithful_inert_decay),
        decay_steps=float(tcfg.decay_steps),
        decay_rate=float(tcfg.decay_rate),
        elem_p=element_drop_rate(F, spec), mask_value=float(cfg.mask_with),
        batch=int(tcfg.batch_size), seeds=seeds,
        fold=torch.arange(K, dtype=torch.int32).repeat(C).to(dev),
        n_valid=per_inst(folded.train_n.repeat(C), torch.int32),
        lr=per_inst(hyper.lr.repeat_interleave(K), torch.float32),
        keep=per_inst(hyper.keep_prob.repeat_interleave(K), torch.float32),
        wpen=per_inst(hyper.weight_penalty.repeat_interleave(K),
                      torch.float32),
        act=per_inst(hyper.act_id.repeat_interleave(K), torch.int32),
        train=folded.train_x.to(dev, torch.float32).contiguous(),
        type_table=table.to(dev).contiguous(), cum=cum.to(dev).contiguous(),
        params=params,
        m=[None if t is None else torch.zeros(t.shape, dtype=mdt, device=dev)
           for t in params],
        v=[None if t is None else torch.zeros(t.shape, dtype=mdt, device=dev)
           for t in params],
        **fields)


# ------------------------------------------------------------- the twin

def _activation_switch(z: torch.Tensor, act: torch.Tensor):
    """(act(z), act'(z)) with the activation chosen per instance (the
    kernel's ``act_fn``/``act_grad``; config.ACTIVATIONS order)."""
    a = act.to(torch.int64).reshape((-1,) + (1,) * (z.dim() - 1))
    t = torch.tanh(z)
    s = 1.0 / (1.0 + torch.abs(z))
    sig = 1.0 / (1.0 + torch.exp(-z))
    one, zero = torch.ones_like(z), torch.zeros_like(z)
    val = torch.where(a == 1, dense_kernels.activate(z, "relu"), z)
    val = torch.where(a == 2, t, val)
    val = torch.where(a == 3, dense_kernels.activate(z, "softsign"), val)
    val = torch.where(a == 4, dense_kernels.activate(z, "softplus"), val)
    grad = torch.where(a == 1, torch.where(z > 0, one, zero), one)
    grad = torch.where(a == 2, 1.0 - t * t, grad)
    grad = torch.where(a == 3, s * s, grad)
    grad = torch.where(a == 4, sig, grad)
    return val, grad


def _dropout_factor(run: GridRun, purpose: int, step: int,
                    shape) -> torch.Tensor:
    """1/keep where the (step, row, col) uniform is below keep, else 0."""
    dev = run.seeds.device
    rows = torch.arange(shape[1], device=dev).view(1, -1, 1)
    cols = torch.arange(shape[2], device=dev).view(1, 1, -1)
    u = philox.uniform(philox.bits(run.seeds.to(torch.int64).view(-1, 1, 1),
                                   purpose, step, rows, cols))
    keep = run.keep.view(-1, 1, 1)
    return torch.where(u < keep, 1.0 / keep, torch.zeros((), device=dev))


def vae_eps(seeds: torch.Tensor, step: int, batch: int,
            width: int, purpose: int = philox.EPS) -> torch.Tensor:
    """The (N, batch, width) standard normals the VAE draws at ``step``
    (Box-Muller from the first two words of counter (step, row, col, 0))."""
    dev = seeds.device
    rows = torch.arange(batch, device=dev).view(1, -1, 1)
    cols = torch.arange(width, device=dev).view(1, 1, -1)
    w = philox.philox4x32(step, rows, cols, 0,
                          seeds.to(torch.int64).view(-1, 1, 1), purpose)
    return philox.normal(w[0], w[1])


def sample_batch(run: GridRun, step: int):
    """Step ``step``'s clean batch ``x`` and its corruption ``xn``, (N, B,
    F): rows uniform with replacement in [0, n_valid), a modality set from
    the cumulative probabilities (none past the last), Bernoulli element
    zeros at ``elem_p``, then the set's span overwritten with
    ``mask_value``."""
    dev = run.seeds.device
    seeds = run.seeds.to(torch.int64).view(-1, 1)
    b = torch.arange(run.batch, device=dev).view(1, -1)
    rows = philox.index_below(philox.bits(seeds, philox.ROW, step, b, 0),
                              run.n_valid.to(torch.int64).view(-1, 1))
    x = run.train[run.fold.to(torch.int64).view(-1, 1), rows]
    u_type = philox.uniform(philox.bits(seeds, philox.TYPE, step, b, 0))
    types = (u_type.unsqueeze(-1) >= run.cum).sum(dim=-1)
    table = torch.cat([run.type_table,
                       torch.zeros_like(run.type_table[:1])])
    masked = table[types] > 0
    xn = x
    if run.elem_p > 0:
        F = x.shape[-1]
        f = torch.arange(F, device=dev).view(1, 1, -1)
        u = philox.uniform(philox.bits(seeds.view(-1, 1, 1), philox.ELEM,
                                       step, b.view(1, -1, 1), f))
        elem_p = torch.tensor(run.elem_p, dtype=torch.float32, device=dev)
        xn = torch.where(u < elem_p, torch.zeros((), device=dev), xn)
    xn = torch.where(masked, torch.tensor(run.mask_value, device=dev), xn)
    return x, xn


def _adam_scalars(run: GridRun, step: int, eps: float = ADAM_EPS):
    """Per-instance (alpha, es2) of step ``step`` in the rsqrt form:
    alpha = lr_s sqrt(bc2) / bc1, es2 = bc2 eps^2, bias corrections at count
    step + 1, lr_s = lr0 rate^(step / decay_steps) (float32 throughout)."""
    dev = run.lr.device
    f32 = dict(dtype=torch.float32, device=dev)
    cf = torch.tensor(float(step + 1), **f32)
    bc1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, **f32), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, **f32), cf)
    lr = run.lr
    if run.decay:
        lr = lr * torch.pow(torch.tensor(run.decay_rate, **f32),
                            torch.tensor(float(step), **f32)
                            / run.decay_steps)
    return lr * torch.sqrt(bc2) / bc1, bc2 * (eps * eps)


def _adam(run: GridRun, slot: int, grad: torch.Tensor, alpha, es2) -> None:
    """rsqrt Adam on one slot; moments stored in their dtype, the weight
    updated with the unrounded f32 values (train_kernel.py:358-363)."""
    w, m, v = run.params[slot], run.m[slot], run.v[slot]
    shape = (-1,) + (1,) * (w.dim() - 1)
    mn = ADAM_B1 * m.float() + (1.0 - ADAM_B1) * grad
    vn = ADAM_B2 * v.float() + (1.0 - ADAM_B2) * grad * grad
    run.m[slot] = mn.to(m.dtype)
    run.v[slot] = vn.to(v.dtype)
    run.params[slot] = w - (alpha.view(shape) * mn) * torch.rsqrt(
        vn + es2)


def _twin_step(run: GridRun, step: int) -> None:
    W1, B1, W2, B2, W3, B3, W4, B4, WV, BV = run.params
    Bsz = run.batch
    x, xn = sample_batch(run, step)
    if run.tied:
        W3, W4 = W2.transpose(1, 2), W1.transpose(1, 2)

    # forward (train_kernel.py:408-438)
    z1 = xn @ W1 + B1.unsqueeze(1)
    d1 = _dropout_factor(run, philox.DROP1, step, z1.shape)
    act1, grad1 = _activation_switch(z1, run.act)
    a1d, gf1 = act1 * d1, d1 * grad1
    mu = a1d @ W2 + B2.unsqueeze(1)
    if run.variational:
        lv = a1d @ WV + BV.unsqueeze(1)
        eps = vae_eps(run.seeds, step, Bsz, mu.shape[2])
        z2 = mu + eps * torch.exp(lv)
    else:
        z2 = mu
    z3 = z2 @ W3 + B3.unsqueeze(1)
    d3 = _dropout_factor(run, philox.DROP3, step, z3.shape)
    act3, grad3 = _activation_switch(z3, run.act)
    a3d, gf3 = act3 * d3, d3 * grad3
    z4 = a3d @ W4 + B4.unsqueeze(1)

    # backward (:440-463); the target is the clean x, -1 gaps included
    g4 = 1.0 / (1.0 + torch.exp(-z4)) - x
    g3 = (g4 @ W4.transpose(1, 2)) * gf3
    gz = g3 @ W3.transpose(1, 2)
    glv = None
    if run.variational:
        # KL on the sampled z (:402-406): dz += z / B, dlv by the chain
        gz = gz + z2 * (1.0 / Bsz)
        glv = gz * eps * torch.exp(lv) + (torch.exp(2.0 * lv) - 1.0) \
            * (1.0 / Bsz)
    g1_pre = gz @ W2.transpose(1, 2)
    if run.variational:
        g1_pre = g1_pre + glv @ WV.transpose(1, 2)
    g1 = g1_pre * gf1

    # weight gradients + L2 (doubled for tied weights) + Adam (:465-577)
    alpha, es2 = _adam_scalars(run, step)
    pen = (2.0 if run.tied else 1.0) * run.wpen

    def l2(w):
        return pen.view(-1, 1, 1) * w

    def tr(t):
        return t.transpose(1, 2)

    if run.tied:
        _adam(run, 0, tr(xn) @ g1 + tr(g4) @ a3d + l2(W1), alpha, es2)
        _adam(run, 2, tr(a1d) @ gz + tr(g3) @ z2 + l2(W2), alpha, es2)
    else:
        _adam(run, 0, tr(xn) @ g1 + l2(W1), alpha, es2)
        _adam(run, 2, tr(a1d) @ gz + l2(W2), alpha, es2)
        _adam(run, 4, tr(z2) @ g3 + l2(W3), alpha, es2)
        _adam(run, 6, tr(a3d) @ g4 + l2(W4), alpha, es2)
    if run.variational:
        _adam(run, 8, tr(a1d) @ glv + l2(WV), alpha, es2)
        _adam(run, 9, glv.sum(dim=1), alpha, es2)
    for slot, g in ((1, g1), (3, gz), (5, g3), (7, g4)):
        _adam(run, slot, g.sum(dim=1), alpha, es2)


def train_grid_kernel_reference(run: GridRun, first_step: int,
                                num_steps: int) -> None:
    """The kernels' plain twin: steps [first_step, first_step + num_steps)
    of the bucket, in plain PyTorch on ``run``'s device (products by
    ``torch.matmul``), with the same Philox draws, so sampling, corruption
    and dropout are bit-identical to the kernels'."""
    with torch.no_grad():
        for step in range(first_step, first_step + num_steps):
            _twin_step(run, step)


# ----------------------------------------------------------- the kernels

def _check_cuda_run(run: GridRun) -> torch.device:
    dev = run.seeds.device
    if dev.type != "cuda":
        raise ValueError(f"the training kernels run on cuda, not {dev}")
    want = {"seeds": torch.int32, "fold": torch.int32,
            "n_valid": torch.int32, "act": torch.int32,
            "lr": torch.float32, "keep": torch.float32,
            "wpen": torch.float32, "train": torch.float32,
            "type_table": torch.float32, "cum": torch.float32}
    for name, dtype in want.items():
        t = getattr(run, name)
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"GridRun.{name}: need a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    mdt = torch.bfloat16 if run.bf16_moments else torch.float32
    for name, group, dtype in (("params", run.params, torch.float32),
                               ("m", run.m, mdt), ("v", run.v, mdt)):
        for slot, t in zip(SLOTS, group):
            if t is None:
                continue
            if t.dtype != dtype or t.device != dev or not t.is_contiguous():
                raise ValueError(f"GridRun.{name}[{slot}]: need a "
                                 f"contiguous {dtype} tensor on {dev}")
    if not run.tied and (run.params[4] is None or run.params[6] is None):
        raise ValueError("an untied run needs W3 and W4")
    if run.variational and (run.params[8] is None or run.params[9] is None):
        raise ValueError("a VAE run needs Wv and bv")
    return dev


def train_grid_kernel(run: GridRun, first_step: int, num_steps: int,
                      profile: Optional[Dict[str, float]] = None,
                      launch_ms: Optional[List[float]] = None) -> None:
    """Steps [first_step, first_step + num_steps) by the CUDA kernels, in
    place on ``run``'s tensors, on the current stream; one ctypes call
    whose C loop enqueues every launch.  With ``profile`` (a dict) every
    launch is timed with CUDA events and each launch type's milliseconds
    are added to it, and with ``launch_ms`` too (a list) each launch's, in
    launch order, over the steps (this synchronises once a step)."""
    dev = _check_cuda_run(run)
    if num_steps <= 0:
        return
    from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk

    with profiling.span("mmae.plan"):
        lib = KERNELS.load()
        N, B = run.n_inst, run.batch
        F, H1, H2 = run.dims
        tied, vae = bool(run.tied), bool(run.variational)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        mbytes = 2 if run.bf16_moments else 4
        weights, _ = update_tensors((F, H1, H2), tied, vae)
        panels, items, n_weight, tile_tx, ring = run_plan(
            (F, H1, H2), tied, vae, N, B, sms, mbytes, pdk.misaligned_slots(
                [(s, run.params[s], run.m[s], run.v[s])
                 for s, _, _ in weights]))
        items_dev = items.to(dev)
        desc = torch.empty(UPD_SLOTS * pdk.DESC_BYTES, dtype=torch.uint8,
                           device=dev)
        width = {"x": F, "xn": F, "g4": F, "mu": H2, "lv": H2, "eps": H2,
                 "z2": H2, "gz": H2, "glv": H2}
        ws = [torch.empty((N, B, width.get(name, H1)), dtype=torch.float32,
                          device=dev) for name in BUFFERS]

        def ptr(t):
            return None if t is None else t.data_ptr()

        args = TrainArgs(
            n_inst=N, batch=B, feats=F, h1=H1, h2=H2,
            n_types=int(run.type_table.shape[0]),
            max_rows=int(run.train.shape[1]), tied=int(tied),
            variational=int(vae), bf16_moments=int(run.bf16_moments),
            decay=int(run.decay), n_items=len(items), n_weight_items=n_weight,
            elem_p=run.elem_p,
            mask_value=run.mask_value, decay_steps=run.decay_steps,
            decay_rate=run.decay_rate, seeds=ptr(run.seeds),
            fold=ptr(run.fold), n_valid=ptr(run.n_valid), lr=ptr(run.lr),
            keep=ptr(run.keep), wpen=ptr(run.wpen), act=ptr(run.act),
            train=ptr(run.train), type_table=ptr(run.type_table),
            cum=ptr(run.cum), items=items_dev.data_ptr(),
            upd_desc=desc.data_ptr())
        for i, pw in enumerate(panels):
            args.panel[i] = pw
        pdk.set_update_args(args, tile_tx, ring)
        for i in range(len(SLOTS)):
            args.param[i] = ptr(run.params[i])
            args.m[i] = ptr(run.m[i])
            args.v[i] = ptr(run.v[i])
        for i, t in enumerate(ws):
            args.ws[i] = t.data_ptr()
        launches = ctypes.c_longlong(0)
        timed = profile is not None or launch_ms is not None
        prof = (ctypes.c_float * len(LAUNCH_TYPES))() if timed else None
        each = (ctypes.c_float * pdk.MAX_EVENTS)() if timed else None

        def arg(buf):
            return None if buf is None else ctypes.cast(buf, ctypes.c_void_p)

    with profiling.span("mmae.enqueue") as sp, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mmae_train_run(ctypes.byref(args), int(first_step),
                                 int(num_steps), ctypes.byref(launches),
                                 arg(prof), arg(each), stream)
        sp.count(launches=launches.value,
                 upd_ring_items=ring.ring_items * num_steps,
                 upd_fallback_items=ring.fallback_items * num_steps)
    KERNELS.count(launches.value)
    KERNELS.check(err, "mmae_train_run")
    if profile is not None:
        for name, ms in zip(LAUNCH_TYPES, prof):
            profile[name] = profile.get(name, 0.0) + float(ms)
    if launch_ms is not None:
        per_step = launches_per_step(tied, vae)
        launch_ms.extend([0.0] * (per_step - len(launch_ms)))
        for i in range(per_step):
            launch_ms[i] += float(each[i])


def empty_launch(device="cuda") -> None:
    """One launch of an empty kernel at the probe's launch shape on the
    current stream (``csrc/train_kernel.cu`` ``empty_kernel``): timed on
    the device beside :func:`philox_probe`, the floor one launch costs.
    Counted nowhere: it computes nothing."""
    device = torch.device(device)
    lib = KERNELS.load()
    with torch.cuda.device(device):
        KERNELS.check(lib.empty_launch(
            torch.cuda.current_stream(device).cuda_stream), "empty_launch")


def philox_probe(seed: int = 7, device="cuda") -> torch.Tensor:
    """(8, 128) float32 uniforms of the in-kernel generator check
    (tests_tpu/test_hardware.py:28-40): row 2i + d is draw d of counter i.
    On a CUDA device one launch of the probe kernel; on the CPU
    ``philox.probe_uniforms``."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox.probe_uniforms(seed)
    if device.type != "cuda":
        raise ValueError(f"philox_probe runs on cuda or cpu, not {device}")
    lib = KERNELS.load()
    out = torch.empty((8, 128), dtype=torch.float32, device=device)
    launches = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = lib.philox_probe_launch(
            out.data_ptr(), int(seed), ctypes.byref(launches),
            torch.cuda.current_stream(device).cuda_stream)
    KERNELS.probe_launches += launches.value
    KERNELS.check(err, "philox_probe_launch")
    return out


# ---------------------------------------------------- split over devices

# Fields of a run that every instance reads whole: the fold data and the
# corruption tables.  Every other tensor of a run has the instance axis
# first.
SHARED_FIELDS = ("train", "labels", "type_table", "cum")


def split_run(run, devices) -> list:
    """``run`` (a :class:`GridRun`, a subclass or a ``ClsRun``) cut into
    contiguous chunks of its instance axis, chunk i on ``devices[i]``
    (``parallel/mesh.split_leading_axis``), the shared fields copied whole
    to each device; empty chunks are left out.  Every instance keeps its
    Philox seed, so on the card a chunk's steps give each of its
    instances what the whole run gives it."""
    from multimodalautoencoder_tpu_torch.parallel import mesh

    parts = {}
    for f in dataclasses.fields(run):
        val = getattr(run, f.name)
        if f.name in SHARED_FIELDS:
            parts[f.name] = [val.to(d) for d in devices]
        elif isinstance(val, (torch.Tensor, list)):
            parts[f.name] = mesh.split_leading_axis(val, devices)
    return [dataclasses.replace(run, **{k: v[i] for k, v in parts.items()})
            for i, (lo, hi) in enumerate(mesh.chunk_bounds(run.n_inst,
                                                           len(devices)))
            if hi > lo]


def run_steps(run, num_steps: int, twin, kernels, devices=None) -> None:
    """Steps [0, num_steps) of ``run``, in place: ``kernels`` where the
    run lies on a GPU, ``twin`` on the CPU.  With more than one device in
    ``devices`` the instance axis is split (:func:`split_run`), each chunk
    runs on its device from its own host thread (the ctypes calls and the
    twin's torch operations release the interpreter lock), and the
    parameters and moments are gathered back onto the run's device."""
    def one(chunk):
        (twin if chunk.seeds.device.type == "cpu" else kernels)(
            chunk, 0, num_steps)
        return chunk

    if devices is None or len(devices) <= 1:
        one(run)
        return
    from multimodalautoencoder_tpu_torch.parallel import mesh

    chunks = split_run(run, devices)
    with ThreadPoolExecutor(len(chunks)) as pool:
        done = [f.result() for f in [pool.submit(one, c) for c in chunks]]
    for name in ("params", "m", "v"):
        setattr(run, name, mesh.gather_leading_axis(
            [getattr(c, name) for c in done], run.seeds.device))


# ------------------------------------------------------------- pipeline

def noisy_val_losses(params: mmae.MMAEParams, cfg: MMAEConfig,
                     spec: NoiseSpec, hyper, folded,
                     generator: torch.Generator) -> torch.Tensor:
    """(C, K) objective on trained parameters: a fresh corruption of each
    fold's whole val set, the masked reconstruction loss over its valid
    rows, report-scaled (get_performance_on_data_with_noise,
    multimodal_autoencoder.py:1019-1033; ``_noisy_val_losses``
    :1125-1154).  Shared by both backends; plain PyTorch."""
    cfg = cfg.validate()
    C, K = hyper.num_configs, folded.num_folds
    N = C * K
    vx, vn = folded.val_x, folded.val_n
    rows = vx.shape[1]
    x = vx.unsqueeze(0).expand((C,) + tuple(vx.shape)).reshape(
        (N,) + tuple(vx.shape[1:]))
    with torch.no_grad():
        flat = optim.tree_map(
            lambda t: t.reshape((N,) + tuple(t.shape[2:])).to(vx.device),
            params)
        noisy = add_noise_to_batch(generator, x, spec)
        out = mmae.forward(flat, cfg, noisy, generator=generator,
                           keep_prob=1.0, train=False,
                           act_id=hyper.act_id.repeat_interleave(K))
        row_valid = (torch.arange(rows, device=vx.device).view(1, -1)
                     < vn.to(vx.device).repeat(C).view(-1, 1))
        loss = masking.masked_reconstruction_loss(cfg.loss, out.decoded, x,
                                                  row_valid)
        loss = masking.masked_report_scale(cfg.loss, loss, row_valid, rows)
    return loss.reshape(C, K)


def train_grid_pallas(seed: int, cfg: MMAEConfig, tcfg: TrainConfig,
                      spec: NoiseSpec, hyper, folded,
                      num_steps: Optional[int] = None,
                      params0: Optional[mmae.MMAEParams] = None,
                      devices=None):
    """Train every (config, fold) instance of a bucket; the counterpart of
    ``train_kernel.train_grid_pallas`` (:846).  Depth >= 3 goes to the
    deep family, ``train_deep_kernels.train_deep_pallas``, as ``_pipeline``
    dispatches (:916-921).

    Returns ``(params, losses)`` with leading (C, K) axes, as the plain
    ``grid_trainer.train_grid`` does.  Runs where ``folded`` lies: the
    CUDA kernels on a GPU, the twin on the CPU.  ``seed`` seeds one CPU
    generator that draws, in order, the initial parameters (unless
    ``params0``, leading (C, K) axes, is given), the instances' Philox
    seeds, and the objective's noise; so a seed gives the same run on
    either device.  With several ``devices`` (the first holding
    ``folded``) the run is drawn whole, split over them by
    :func:`run_steps` and gathered before the objective, so every
    instance ends as it does on one device (on the CPU twin to the last
    bit of a few exp / tanh evaluations: ``parallel/grid_trainer.py``).
    Raises ``ValueError`` outside :func:`supported`."""
    cfg = cfg.validate()
    if not supported(cfg, tcfg, spec):
        raise ValueError("configuration outside the training kernels' "
                         "family; use the plain grid trainer")
    if len(cfg.layer_sizes) > 2:
        # imported here: the deep module builds on this one
        from multimodalautoencoder_tpu_torch.ops import train_deep_kernels
        return train_deep_kernels.train_deep_pallas(
            seed, cfg, tcfg, spec, hyper, folded, num_steps, params0,
            devices)
    num_steps = tcfg.num_steps if num_steps is None else int(num_steps)
    C, K = hyper.num_configs, folded.num_folds
    with profiling.span("mmae.prepare"):
        generator = torch.Generator().manual_seed(int(seed))
        if params0 is None:
            params0 = init_grid_params(generator, cfg, C, K)
        run = prepare_run(generator, cfg, tcfg, spec, hyper, folded, params0)
    run_steps(run, num_steps, train_grid_kernel_reference, train_grid_kernel,
              devices)
    with profiling.span("mmae.evaluate"):
        params = run.grid_params(C, K)
        return params, noisy_val_losses(params, cfg, spec, hyper, folded,
                                        generator)
