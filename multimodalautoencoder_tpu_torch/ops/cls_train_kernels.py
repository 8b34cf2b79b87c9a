"""The two-phase classification run: phase 1 on the depth-2 training
kernels, phase 2 on hand-written CUDA kernels, and their plain twin.

Counterpart of the two-phase half of
``multimodalautoencoder_tpu/ops/train_kernel.py``: ``train_two_phase_pallas``
(:1728) -> ``_phase2_body`` (:1864-2118) -> the Pallas kernel
``_cls_train_kernel`` (:1439-1725, ``pallas_call`` :2044), which trains the
encoder and a fresh classification head of every (config, fold) instance
of a bucket for S steps.  Here:

- :func:`train_two_phase_pallas` runs phase 1 through
  ``train_kernels.train_grid_pallas`` and phase 2 through
  :func:`phase2_pallas`: fresh heads, corruption tables, labels beside the
  features, per-instance scalars, the run, then predictions on the padded
  fold-val set by the plain evaluator :func:`val_predictions`, shared with
  the plain trainer;
- :func:`train_cls_kernel` launches the CUDA kernels of
  ``csrc/cls_train_kernel.cu`` (built with nvcc for sm_90a at first use,
  one ctypes call per run; the S-step loop runs in C);
- :func:`train_cls_kernel_reference` is their plain twin: the same math
  and the same Philox bits, step by step.  CPU tensors take the twin;
  CUDA tensors take the kernels or raise.

Semantics are the Pallas kernel's: rows uniform in the fold's valid rows
with their labels (single-label ints as one-hot), Bernoulli element
zeroing at ``elem_p`` then the modality-set mask; the head's keep
probability drives the encoder's layer-1 dropout too (:1587); head gates
from :func:`cls_gates` (the last layer gated in faithful mode); the
sigmoid-CE gradient ``(sig - y) / (B L)`` or softmax ``(p - onehot) / B``;
L2 on the head's weights only; rsqrt Adam at a constant lr; bf16 moments
stored rounded while the weight takes the unrounded values; with
``compute_dtype="bfloat16"`` every product operand (backward cotangents
included) rounded to bf16 with f32 sums.  The decoder passes through.

No memory budget: the JAX predicate refuses shapes whose moments do not
fit VMEM (``cls_vmem_bytes``, ``needs_cls_streaming``); every moment here
lives in device memory, so :func:`supported_two_phase` differs from it
only there.  What bounds a step: :func:`cls_step_bound`; each launch:
:func:`cls_launch_bounds`.  The host plans each run once: every product's
panel and thread tile (:func:`cls_product_plan`) and the grouped update's
work list and ring (``train_deep_kernels.update_plan``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.models import losses as losses_lib
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
from multimodalautoencoder_tpu_torch.ops import dense_kernels, optim, \
    philox, train_deep_kernels, train_kernels
from multimodalautoencoder_tpu_torch.ops.cuda_library import (CSRC_DIR,
                                                              NvccLibrary)
from multimodalautoencoder_tpu_torch.utils import profiling

SOURCE = os.path.join(CSRC_DIR, "cls_train_kernel.cu")
HEADERS = (os.path.join(CSRC_DIR, "philox.cuh"),
           os.path.join(CSRC_DIR, "train_common.cuh"))
LIBRARY = "libcls_train_kernel.so"  # in cuda_library.build_dir()

# The kernel's parameter slots (csrc/cls_train_kernel.cu ``Slot``), each
# (N, rows, cols) or (N, cols); None where the bucket has no such tensor.
SLOTS = ("w1", "b1", "w2", "b2", "wv", "bv", "c1", "cb1", "c2", "cb2", "c3",
         "cb3")
# Workspace buffers (``Buf``), each (N, B, width).
BUFFERS = ("xn", "y", "a1d", "gf1", "mu", "lv", "eps", "emb", "h1", "h2",
           "h3", "gfh1", "gfh2", "gfh3", "gc1", "gc2", "gc3", "gemb", "glv",
           "g1")
# Launch types of one step (``Prof``), for per-type CUDA-event timing; the
# grouped update of every weight and bias is ``weight_grad_adam``, and
# ``bias_grad_adam`` has no launch of its own.
LAUNCH_TYPES = ("sample_corrupt", "forward_products", "elementwise",
                "backward_products", "weight_grad_adam", "bias_grad_adam")
MAX_LABELS = 128      # the Pallas kernel's one lane tile of labels
# csrc/cls_train_kernel.cu ``MAX_PRODUCTS``: a step's products at most
MAX_PRODUCTS = 12
# train_common.cuh's gemm_tile_kernel, the products at a batch above
# train_deep_kernels.BATCH_ROWS: a thread owns TILE_ROWS rows x 8 or 4
# columns, a block up to TILE_BLOCK_ROWS rows (the whole batch of 100) and
# a panel of at most TILE_MAX_PANEL columns, staged TILE_K deep in
# TILE_STAGES slices
TILE_ROWS = 8
TILE_COLS = (8, 4)
TILE_BLOCK_ROWS = 104
TILE_MAX_PANEL = 128
TILE_MAX_THREADS = 208
TILE_K = 16
TILE_STAGES = 4


class ClsArgs(ctypes.Structure):
    """``struct ClsArgs`` of csrc/cls_train_kernel.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "n_inst", "batch", "feats", "h1", "h2", "n_labels", "n_types",
            "max_rows", "n_cls")]
        + [("dims", ctypes.c_int * 4), ("gates", ctypes.c_int * 3)]
        + [(n, ctypes.c_int) for n in (
            "variational", "softmax", "bf16_moments", "bf16_ops")]
        + [("panel", ctypes.c_int * MAX_PRODUCTS),
           ("tile_cols", ctypes.c_int * MAX_PRODUCTS),
           ("tile_tx", ctypes.c_int * len(SLOTS)),
           ("n_items", ctypes.c_int), ("n_weight_items", ctypes.c_int),
           ("upd_ring", ctypes.c_int * len(SLOTS))]
        + [(n, ctypes.c_int) for n in ("upd_depth", "upd_lfloats",
                                       "upd_rfloats", "upd_rbufs",
                                       "upd_stage")]
        + [(n, ctypes.c_float) for n in ("elem_p", "mask_value",
                                         "adam_eps")]
        + [(n, ctypes.c_void_p) for n in (
            "seeds", "fold", "n_valid", "lr", "keep", "wpen", "eact", "cact",
            "train", "labels", "type_table", "cum", "items", "upd_desc")]
        + [("param", ctypes.c_void_p * len(SLOTS)),
           ("m", ctypes.c_void_p * len(SLOTS)),
           ("v", ctypes.c_void_p * len(SLOTS)),
           ("ws", ctypes.c_void_p * len(BUFFERS))])


class ClsLibrary(NvccLibrary):
    """``csrc/cls_train_kernel.cu`` built and bound; ``launches`` counts
    its kernels' launches."""

    def __init__(self):
        super().__init__(SOURCE, LIBRARY, HEADERS)

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.mmae_cls_train_run.restype = ctypes.c_int
        lib.mmae_cls_train_run.argtypes = [
            ctypes.POINTER(ClsArgs), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.cls_train_kernel_error_string.restype = ctypes.c_char_p
        lib.cls_train_kernel_error_string.argtypes = [ctypes.c_int]

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.load().cls_train_kernel_error_string(err).decode()
            raise RuntimeError(f"{what} failed: {msg} ({err})")


KERNELS = ClsLibrary()


def launches_per_step(n_cls: int, variational: bool) -> int:
    """Kernel launches of one phase-2 step: sample, 2 + n_cls forward
    products, the loss gradient, n_cls + 1 backward products and one
    grouped update of every weight and bias; a VAE adds the log-sigma
    product and two elementwise passes.  12 for the validation bucket
    (n_cls = 3), 15 for its VAE."""
    return 6 + 2 * n_cls + (3 if variational else 0)


def derive_seed(seed: int, *words: int) -> int:
    """A 31-bit seed derived from ``seed`` and ``words`` (numpy's
    SeedSequence), so sub-runs of one seed draw independent streams."""
    return int(np.random.SeedSequence([int(seed), *map(int, words)])
               .generate_state(1)[0] >> 1)


# --------------------------------------------------------------- family

def phase1_cfg(cfg: MMAEConfig) -> MMAEConfig:
    """The headless phase-1 view of a two-phase config, pinned to f32
    products: ``compute_dtype`` is a phase-2 knob (:1394-1403)."""
    return cfg.replace(classification_layer_sizes=None,
                       compute_dtype="float32").validate()


def cls_dims(cfg: MMAEConfig) -> List[int]:
    """The head's widths [H2, c1, ..., L] (``_cls_dims`` without the lane
    padding)."""
    return ([cfg.embedding_size] + list(cfg.classification_layer_sizes)
            + [cfg.num_labels])


def cls_gates(cfg: MMAEConfig) -> Tuple[bool, ...]:
    """Per head layer, whether activation and dropout apply (``_cls_gates``
    :1428-1436, as ``mmae.classify``): the faithful mode reproduces the
    reference's ``len(decode_weights)`` gate (multimodal_autoencoder.py
    :533), the fixed mode gates every layer but the last."""
    n_cls = len(cls_dims(cfg)) - 1
    limit = (len(cfg.layer_sizes) - 1 if cfg.faithful_classify_gate
             else n_cls - 1)
    return tuple(j < limit for j in range(n_cls))


def supported_two_phase(cfg: MMAEConfig, tcfg: TrainConfig,
                        cls_tcfg: TrainConfig, spec: NoiseSpec) -> bool:
    """Is the two-phase configuration in the kernels' family (both
    phases)?  The gates of ``train_kernel.supported_two_phase``
    (:1406-1425) without its VMEM budget: a head of at most 2 hidden
    layers on a depth-2 encoder in phase 1's family, sigmoid-CE or softmax,
    at most 128 labels, Adam without clipping in phase 2."""
    cfg = cfg.validate()
    if cfg.classification_layer_sizes is None or len(cfg.layer_sizes) != 2:
        return False
    return (train_kernels.supported(phase1_cfg(cfg), tcfg, spec)
            and len(cfg.classification_layer_sizes) <= 2
            and cfg.classification_loss in ("sigmoid_cross_entropy",
                                            "softmax")
            and cfg.num_labels <= MAX_LABELS
            and cls_tcfg.optimizer == "adam"
            and not cls_tcfg.clip_gradients)


def cls_step_bound(cfg: MMAEConfig, n_inst: int, batch: int,
                   bf16_moments: bool) -> Dict[str, float]:
    """The least time one phase-2 step of ``n_inst`` instances could take
    on an H100: the larger of its bytes over the memory rate and its
    operations over the f32 CUDA-core rate.  Bytes: every trained parameter
    read and written (8 B), both Adam moments read and written (8 B bf16,
    16 B f32), the sampled rows and labels read once.  Operations: 2 per
    multiply-add of the step's products (forward, backward data, weight
    gradients), 10 per parameter for Adam."""
    cfg = cfg.validate()
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    vae = cfg.variational
    dims = cls_dims(cfg)
    head = sum(dims[j] * dims[j + 1] for j in range(len(dims) - 1))
    enc = F * H1 + H1 * H2 + (H1 * H2 if vae else 0)
    params = enc + head + H1 + H2 + (H2 if vae else 0) + sum(dims[1:])
    # forward, backward data (the head and g1; not into xn) and weight
    # gradients: each weight's product once in each
    macs = batch * (enc + head                       # forward
                    + head + H1 * H2 * (2 if vae else 1)   # backward
                    + enc + head)                    # weight gradients
    flop = n_inst * (2.0 * macs + 10.0 * params)
    nbytes = n_inst * (params * (16 if bf16_moments else 24)
                       + 4.0 * batch * (F + cfg.num_labels))
    return train_kernels._bound(nbytes, flop)


def cls_launch_type_bounds(cfg: MMAEConfig, n_inst: int, batch: int,
                           bf16_moments: bool
                           ) -> Dict[str, Dict[str, float]]:
    """:func:`cls_step_bound` split by launch type (:data:`LAUNCH_TYPES`),
    each counting the weights it reads, the (N, B, width) activations it
    reads from other types once and the ones it writes once, and its
    operations; 12 integer operations per Philox round for the draws,
    which only the gated layers make."""
    cfg = cfg.validate()
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    vae = cfg.variational
    N, B, L = n_inst, batch, cfg.num_labels
    dims = cls_dims(cfg)
    head = sum(dims[j] * dims[j + 1] for j in range(len(dims) - 1))
    enc = F * H1 + H1 * H2 + (H1 * H2 if vae else 0)
    weights = enc + head
    emb = H2 * (2 if vae else 1)      # mu (+ lv)
    biases = H1 + emb + sum(dims[1:])
    outs, ins = sum(dims[1:]), sum(dims[:-1])
    # the outputs of the gated head layers: they alone draw dropout bits
    # and write a gate factor
    gated = sum(d for d, g in zip(dims[1:], cls_gates(cfg)) if g)
    act = 4.0 * N * B                 # bytes per unit of activation width
    philox_ops = PHILOX_OPS
    moment = 8 if bf16_moments else 16
    bound = train_kernels._bound
    return {
        # train rows and labels in, xn and y out
        "sample_corrupt": bound(act * 2 * (F + L),
                                N * B * (F + 2) * philox_ops),
        # xn in; a, d act' of layer 1, mu (+ lv), each head layer's output
        # and a gated layer's gate factor out
        "forward_products": bound(
            4.0 * N * (weights + biases) + act * (F + 2 * H1 + emb + outs
                                                  + gated),
            N * (2.0 * B * weights + B * (H1 + gated) * philox_ops)),
        # the loss gradient (and the VAE's sample and glv)
        "elementwise": bound(act * (3 * L + (6 * H2 if vae else 0)),
                             N * B * (20 * L + (40 * H2 if vae else 0))),
        # each head layer's gradient and gate factor in, the gradients
        # below it and g1 out
        "backward_products": bound(
            4.0 * N * (head + H1 * emb) + act * (2 * outs + ins + 2 * H1),
            N * 2.0 * B * (head + H1 * emb)),
        # every layer's input and gradient in
        "weight_grad_adam": bound(
            N * weights * (8.0 + moment)
            + act * (F + 2 * H1 + emb + ins + outs),
            N * (2.0 * B * weights + 10.0 * weights)),
        "bias_grad_adam": bound(N * biases * (8.0 + moment)
                                + act * (H1 + emb + outs),
                                N * (B + 10.0) * biases),
    }


# 12 integer operations per Philox round, 10 rounds a draw
PHILOX_OPS = 10 * 12


def cls_launch_bounds(cfg: MMAEConfig, n_inst: int, batch: int,
                      bf16_moments: bool,
                      sms: int = train_deep_kernels.H100_SMS
                      ) -> List[Dict[str, object]]:
    """Each launch of one phase-2 step in launch order, with its own bound
    (``train_deep_kernels.deep_launch_bounds`` for kernel 4): a product
    reads its weight(s), bias and input once and writes its outputs once,
    so the products' bytes sum to more than :func:`cls_launch_type_bounds`'
    rows, which count activations made and used inside a type once; their
    operations sum to the rows'.  The sample is its type's row, the loss
    gradient and the VAE's two passes split the elementwise row, and the
    grouped update is the weight- and bias-update rows together.  Products
    carry :func:`cls_product_plan`'s fields."""
    cfg = cfg.validate()
    F, (H1, H2) = cfg.num_feats, cfg.layer_sizes
    vae, L = cfg.variational, cfg.num_labels
    N, B = n_inst, batch
    types = cls_launch_type_bounds(cfg, n_inst, batch, bf16_moments)
    bound = train_kernels._bound
    act = 4.0 * N * B

    def product(p):
        k = p["K"] + p["K2"]
        outs = 2 if p["epi"] == "act_drop" else 1
        reads = 1 if p["epi"] == "mul" else 0
        has_bias = p["epi"] in ("act_drop", "bias")
        nbytes = 4.0 * N * (k * p["ncol"] + (p["ncol"] if has_bias else 0)
                            + B * (k + (outs + reads) * p["ncol"]))
        flop = N * (2.0 * B * p["ncol"] * k
                    + (B * p["ncol"] * PHILOX_OPS
                       if p["epi"] == "act_drop" else 0))
        return dict(p, **bound(nbytes, flop))

    plan = cls_product_plan(F, H1, cls_dims(cfg), cls_gates(cfg), vae,
                            n_inst, batch, sms)
    enc = 3 if vae else 2                 # encode 1, encode 2 (+ lv head)
    fwd = enc + len(cls_dims(cfg)) - 1    # ... and the head
    elem = dict(type="elementwise")
    out = [dict({"name": "sample", "type": "sample_corrupt"},
                **types["sample_corrupt"])]
    out += [product(p) for p in plan[:enc]]
    if vae:
        out.append(dict(elem, name="vae sample",
                        **bound(act * 3 * H2, N * B * 20.0 * H2)))
    out += [product(p) for p in plan[enc:fwd]]
    out.append(dict(elem, name="loss grad",
                    **bound(act * 3 * L, N * B * 20.0 * L)))
    out += [product(p) for p in plan[fwd:-1]]
    if vae:
        out.append(dict(elem, name="vae grad",
                        **bound(act * 3 * H2, N * B * 20.0 * H2)))
    out.append(product(plan[-1]))
    w, b = types["weight_grad_adam"], types["bias_grad_adam"]
    out.append(dict({"name": "update", "type": "weight_grad_adam"},
                    **bound(w["bytes"] + b["bytes"], w["flop"] + b["flop"])))
    return out


# ----------------------------------------------------------- the plan

def tile_thread_rows(batch: int) -> int:
    """gemm_tile_kernel's thread rows: a row block of up to
    TILE_BLOCK_ROWS batch rows in TILE_ROWS-row thread tiles (13 at batch
    100, the last 4 of their 104 rows idle; a batch of 128 takes two row
    blocks)."""
    return -(-min(batch, TILE_BLOCK_ROWS) // TILE_ROWS)


def tile_panel(ncol: int, n_inst: int, batch: int,
               sms: int = train_deep_kernels.H100_SMS) -> Tuple[int, int]:
    """(panel width, columns a thread) of a gemm_tile_kernel product of
    ``ncol`` columns over ``n_inst`` instances.  8 x 8 thread tiles over
    the fewest panels of at most TILE_MAX_PANEL columns, each the multiple
    of 8 that leaves the fewest columns idle (1000 columns in 8 panels of
    128, 500 in 4 of 128, 200 in 2 of 104, 100 in 1 of 104: one block an
    instance beat two of 52 columns on 8 x 4 tiles on an H100).  A
    narrower output takes 8 x 4 tiles over panels of at most half the
    width (multiples of 4), narrowed until the blocks are at least the
    card's SMs or a panel is two thread columns wide (over 80 instances:
    50 columns in 2 panels of 28, 20 in 2 of 12, 3 in 1 of 8)."""
    row_blocks = -(-batch // TILE_BLOCK_ROWS)
    panels = -(-ncol // TILE_MAX_PANEL)
    pw = 8 * -(-ncol // (8 * panels))
    if pw >= TILE_MAX_PANEL // 2:
        return pw, 8
    cols = 4
    panels = max(panels, -(-ncol // (TILE_MAX_PANEL // 2)))
    while True:
        pw = max(2 * cols, 4 * -(-ncol // (4 * panels)))
        if n_inst * row_blocks * -(-ncol // pw) >= sms or pw == 2 * cols:
            return pw, cols
        panels += 1


def cls_product_plan(feats: int, h1: int, dims: Sequence[int],
                     gates: Sequence[bool], variational: bool, n_inst: int,
                     batch: int, sms: int = train_deep_kernels.H100_SMS
                     ) -> List[Dict[str, object]]:
    """Every product of one phase-2 step in ``ClsRunner::step``'s launch
    order: name, launch type, epilogue, columns ``ncol``, depth ``K`` (+
    ``K2`` of the second pair), whether B is read K-major (a W^T view), the
    kernel (``batch``: gemm_batch_kernel at a batch of at most
    ``train_deep_kernels.BATCH_ROWS``, its panel from ``panel_width``;
    else ``tile``: gemm_tile_kernel, panel and thread tile from
    :func:`tile_panel`), the panel width, the columns a thread owns, the
    threads and dynamic shared memory of a block, and the grid."""
    H2, nc = dims[0], len(dims) - 1
    out = []

    def add(name, kind, epi, ncol, K, kmajor, K2=0):
        if batch <= train_deep_kernels.BATCH_ROWS:
            pw, cols = train_deep_kernels.panel_width(ncol, n_inst, batch,
                                                      sms), 4
            ty = -(-batch // 2)
            threads = 32 * (-(-(pw // 4) * ty // 32) + 1)
            rows, smem, kernel = train_deep_kernels.BATCH_ROWS, 0, "batch"
        else:
            pw, cols = tile_panel(ncol, n_inst, batch, sms)
            ty = tile_thread_rows(batch)
            threads = ty * (pw // cols)
            rows, kernel = TILE_BLOCK_ROWS, "tile"
            smem = TILE_STAGES * 4 * (
                TILE_K * (TILE_ROWS * ty + 4)
                + (pw * (TILE_K + 4) if kmajor else TILE_K * pw))
        out.append({"name": name, "type": kind, "epi": epi, "ncol": ncol,
                    "K": K, "K2": K2, "kmajor": kmajor, "kernel": kernel,
                    "panel": pw, "cols": cols, "threads": threads,
                    "smem": smem,
                    "grid": (-(-ncol // pw), -(-batch // rows), n_inst)})

    fwd, bwd = "forward_products", "backward_products"
    add("encode 1", fwd, "act_drop", h1, feats, False)
    add("encode 2", fwd, "bias", H2, h1, False)
    if variational:
        add("lv head", fwd, "bias", H2, h1, False)
    for j in range(nc):
        add(f"head {j}", fwd, "act_drop" if gates[j] else "bias",
            dims[j + 1], dims[j], False)
    for j in range(nc - 1, -1, -1):
        add(f"head {j} grad", bwd,
            "mul" if j > 0 and gates[j - 1] else "none", dims[j],
            dims[j + 1], True)
    add("g1", bwd, "mul", h1, H2, True, H2 if variational else 0)
    return out


def cls_update_tensors(feats: int, h1: int, dims: Sequence[int],
                       variational: bool
                       ) -> Tuple[List[Tuple[int, int, int]],
                                  List[Tuple[int, int]], Dict[int, float]]:
    """The grouped update's tensors by :data:`SLOTS` index: weights as
    (slot, rows, cols), biases as (slot, cols), and each weight's L2
    factor (0 on the encoder, 1 on the head, :1645 of the JAX package)."""
    H2, nc = dims[0], len(dims) - 1
    weights = [(0, feats, h1), (2, h1, H2)]
    biases = [(1, h1), (3, H2)]
    if variational:
        weights.append((4, h1, H2))
        biases.append((5, H2))
    weights += [(6 + 2 * j, dims[j], dims[j + 1]) for j in range(nc)]
    biases += [(7 + 2 * j, dims[j + 1]) for j in range(nc)]
    pen = {slot: (1.0 if slot >= 6 else 0.0) for slot, _, _ in weights}
    return weights, biases, pen


def cls_update_work_list(feats: int, h1: int, dims: Sequence[int],
                         variational: bool, n_inst: int
                         ) -> Tuple[np.ndarray, int, Dict[int, int]]:
    """update_group_kernel's work list of a phase-2 step:
    ``train_deep_kernels.work_list`` over :func:`cls_update_tensors`
    (items, weight items, tile threads across by slot)."""
    weights, biases, _ = cls_update_tensors(feats, h1, dims, variational)
    return train_deep_kernels.work_list(weights, biases, n_inst)


@functools.lru_cache(maxsize=32)
def _run_plan(feats: int, h1: int, dims: Tuple[int, ...],
              gates: Tuple[bool, ...], variational: bool, n_inst: int,
              batch: int, sms: int, moment_bytes: int = 2,
              misaligned: Tuple[int, ...] = ()):
    """A run's plan, made once a shape: each product's panel width and
    thread columns, the update's work list (a CPU tensor), its weight
    items, tile widths and ring (``train_deep_kernels.update_plan``)."""
    plan = cls_product_plan(feats, h1, dims, gates, variational, n_inst,
                            batch, sms)
    weights, biases, _ = cls_update_tensors(feats, h1, dims, variational)
    items, n_weight, tile_tx, ring = train_deep_kernels.update_plan(
        weights, biases, n_inst, batch, moment_bytes, misaligned)
    return (tuple(p["panel"] for p in plan), tuple(p["cols"] for p in plan),
            torch.from_numpy(items), n_weight, tuple(tile_tx.items()), ring)


# ----------------------------------------------------------------- state

@dataclasses.dataclass
class ClsRun:
    """One bucket's phase-2 state and inputs, flat over N = C * K
    instances (instance ``c * K + k`` is config c on fold k), all on one
    device.  The runners update ``params``, ``m`` and ``v`` in place."""

    variational: bool
    softmax: bool
    bf16_moments: bool
    bf16_ops: bool
    elem_p: float
    mask_value: float
    adam_eps: float
    batch: int
    gates: Tuple[bool, ...]
    dims: Tuple[int, ...]      # head widths [H2, ..., L]
    seeds: torch.Tensor        # (N,) int32, the Philox key words
    fold: torch.Tensor         # (N,) int32
    n_valid: torch.Tensor      # (N,) int32 train rows of the fold
    lr: torch.Tensor           # (N,) float32
    keep: torch.Tensor         # (N,) float32 the head's keep probability
    wpen: torch.Tensor         # (N,) float32 L2 of the head's weights
    eact: torch.Tensor         # (N,) int32 encoder activation id
    cact: torch.Tensor         # (N,) int32 head activation id
    train: torch.Tensor        # (K, max_rows, F) float32 fold train rows
    labels: torch.Tensor       # (K, max_rows, L) float32
    type_table: torch.Tensor   # (T, F) float32
    cum: torch.Tensor          # (T,) float32
    params: List[Optional[torch.Tensor]]
    m: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]

    @property
    def n_inst(self) -> int:
        return int(self.seeds.shape[0])

    @property
    def n_cls(self) -> int:
        return len(self.dims) - 1

    clone = train_kernels.GridRun.clone

    def grid_params(self, C: int, K: int,
                    params1: mmae.MMAEParams) -> mmae.MMAEParams:
        """The parameters as an MMAEParams with leading (C, K) axes; the
        decoder is phase 1's (``params1``), which phase 2 leaves as it
        is."""
        def un(t):
            return None if t is None else t.reshape((C, K) + t.shape[1:])
        w1, b1, w2, b2, wv, bv = (un(t) for t in self.params[:6])
        head = [un(t) for t in self.params[6:6 + 2 * self.n_cls]]
        return mmae.MMAEParams(
            enc_w=(w1, w2), enc_b=(b1, b2), dec_w=params1.dec_w,
            dec_b=params1.dec_b, var_w=wv, var_b=bv,
            cls_w=tuple(head[0::2]), cls_b=tuple(head[1::2]))


def init_heads(generator: torch.Generator, cfg: MMAEConfig, C: int,
               K: int):
    """Fresh heads of every (config, fold) instance, each from
    ``mmae.init_head`` on the CPU generator, as (cls_w, cls_b) with leading
    (C, K) axes."""
    with profiling.span("mmae.init_params"):
        insts = [mmae.init_head(cfg, generator, "cpu")
                 for _ in range(C * K)]
        return tuple(tuple(torch.stack([h[part][j] for h in insts]).reshape(
            (C, K) + tuple(insts[0][part][j].shape))
            for j in range(len(insts[0][part]))) for part in (0, 1))


def label_table(train_y: torch.Tensor, num_labels: int) -> torch.Tensor:
    """Fold labels as (K, rows, L) float32: single-label ints one-hot
    (:1964-1966), label matrices as they are."""
    if train_y is None:
        raise ValueError("two-phase training needs supervised folds")
    if train_y.dim() == 2:
        return torch.nn.functional.one_hot(train_y.long(),
                                           num_labels).to(torch.float32)
    return train_y.to(torch.float32)


def prepare_cls_run(generator: torch.Generator, cfg: MMAEConfig,
                    cls_tcfg: TrainConfig, spec: NoiseSpec, hyper, chyper,
                    folded, params1: mmae.MMAEParams, head0,
                    adam_eps: float = 1e-8) -> ClsRun:
    """The phase-2 kernels' inputs for a bucket: per-instance Philox seeds
    from ``generator``, fold ids, row counts and hyperparameters (the
    encoder's activation from ``hyper``, the head's keep probability,
    penalty and activation from ``chyper``, the constant phase-2 lr), the
    fold rows and labels, the corruption tables, phase 1's encoder
    (``params1``) and ``head0`` (leading (C, K) axes) flattened to (N, ...),
    and zero moments.  Lives on the device of ``folded``."""
    cfg = cfg.validate()
    C, K = hyper.num_configs, folded.num_folds
    N = C * K
    dev = folded.train_x.device
    seeds = torch.randint(0, 2 ** 31 - 1, (N,), generator=generator,
                          device=generator.device).to(dev, torch.int32)
    mdt = optim.state_dtype(cls_tcfg.optimizer_state_dtype) or torch.float32

    def flat(t):
        if t is None:
            return None
        return t.reshape((N,) + tuple(t.shape[2:])).to(
            dev, torch.float32).contiguous()

    p = params1
    dims = cls_dims(cfg)
    cls_w, cls_b = head0
    head = []
    for j in range(3):
        head += ([flat(cls_w[j]), flat(cls_b[j])] if j < len(dims) - 1
                 else [None, None])
    params = [flat(t) for t in (p.enc_w[0], p.enc_b[0], p.enc_w[1],
                                p.enc_b[1], p.var_w, p.var_b)] + head
    for j in range(len(dims) - 1):
        if tuple(params[6 + 2 * j].shape[1:]) != (dims[j], dims[j + 1]):
            raise ValueError(f"head layer {j} has shape "
                             f"{tuple(params[6 + 2 * j].shape)}, the config"
                             f" implies (N, {dims[j]}, {dims[j + 1]})")
    table, cum = train_kernels.corruption_tables(spec, cfg.num_feats)

    def per_inst(t, dtype):
        return t.repeat_interleave(K).to(dev, dtype)

    return ClsRun(
        variational=bool(cfg.variational),
        softmax=cfg.classification_loss == "softmax",
        bf16_moments=mdt == torch.bfloat16,
        bf16_ops=cfg.compute_dtype == "bfloat16",
        elem_p=train_kernels.element_drop_rate(cfg.num_feats, spec),
        mask_value=float(cfg.mask_with), adam_eps=float(adam_eps),
        batch=int(cls_tcfg.batch_size), gates=cls_gates(cfg),
        dims=tuple(dims), seeds=seeds,
        fold=torch.arange(K, dtype=torch.int32).repeat(C).to(dev),
        n_valid=folded.train_n.repeat(C).to(dev, torch.int32),
        lr=torch.full((N,), float(cls_tcfg.learning_rate),
                      dtype=torch.float32, device=dev),
        keep=per_inst(chyper.keep_prob, torch.float32),
        wpen=per_inst(chyper.weight_penalty, torch.float32),
        eact=per_inst(hyper.act_id, torch.int32),
        cact=per_inst(chyper.cls_act_id, torch.int32),
        train=folded.train_x.to(dev, torch.float32).contiguous(),
        labels=label_table(folded.train_y, cfg.num_labels).to(
            dev).contiguous(),
        type_table=table.to(dev).contiguous(), cum=cum.to(dev).contiguous(),
        params=params,
        m=[None if t is None else torch.zeros(t.shape, dtype=mdt, device=dev)
           for t in params],
        v=[None if t is None else torch.zeros(t.shape, dtype=mdt, device=dev)
           for t in params])


# ------------------------------------------------------------- the twin

def sample_cls_batch(run: ClsRun, step: int):
    """Step ``step``'s corrupted batch ``xn`` (N, B, F) and its labels
    ``y`` (N, B, L): rows uniform with replacement in [0, n_valid), a
    modality set from the cumulative probabilities (none past the last),
    Bernoulli element zeros at ``elem_p``, then the set's span overwritten
    with ``mask_value``."""
    dev = run.seeds.device
    seeds = run.seeds.to(torch.int64).view(-1, 1)
    b = torch.arange(run.batch, device=dev).view(1, -1)
    rows = philox.index_below(philox.bits(seeds, philox.CLS_ROW, step, b, 0),
                              run.n_valid.to(torch.int64).view(-1, 1))
    fold = run.fold.to(torch.int64).view(-1, 1)
    x, y = run.train[fold, rows], run.labels[fold, rows]
    u_type = philox.uniform(philox.bits(seeds, philox.CLS_TYPE, step, b, 0))
    types = (u_type.unsqueeze(-1) >= run.cum).sum(dim=-1)
    table = torch.cat([run.type_table,
                       torch.zeros_like(run.type_table[:1])])
    xn = x
    if run.elem_p > 0:
        f = torch.arange(x.shape[-1], device=dev).view(1, 1, -1)
        u = philox.uniform(philox.bits(seeds.view(-1, 1, 1), philox.CLS_ELEM,
                                       step, b.view(1, -1, 1), f))
        elem_p = torch.tensor(run.elem_p, dtype=torch.float32, device=dev)
        xn = torch.where(u < elem_p, torch.zeros((), device=dev), xn)
    xn = torch.where(table[types] > 0,
                     torch.tensor(run.mask_value, device=dev), xn)
    return xn, y


def _adam_scalars(run: ClsRun, step: int):
    """Per-instance (alpha, es2) of step ``step`` in the rsqrt form at the
    constant phase-2 lr: alpha = lr sqrt(bc2) / bc1, es2 = bc2 eps^2, bias
    corrections at count step + 1 (float32)."""
    f32 = dict(dtype=torch.float32, device=run.lr.device)
    cf = torch.tensor(float(step + 1), **f32)
    bc1 = 1.0 - torch.pow(torch.tensor(train_kernels.ADAM_B1, **f32), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(train_kernels.ADAM_B2, **f32), cf)
    eps2 = torch.tensor(run.adam_eps, **f32) ** 2
    return run.lr * torch.sqrt(bc2) / bc1, bc2 * eps2


def _twin_step(run: ClsRun, step: int) -> None:
    W1, B1, W2, B2, WV, BV = run.params[:6]
    Bsz, nc = run.batch, run.n_cls

    def mm(a, b):
        if run.bf16_ops:
            a, b = (dense_kernels.round_to_bf16(t) for t in (a, b))
        return a @ b

    def tr(t):
        return t.transpose(1, 2)

    xn, y = sample_cls_batch(run, step)
    # encoder (:1582-1596): the head's keep drives layer 1's dropout
    z1 = mm(xn, W1) + B1.unsqueeze(1)
    d1 = train_kernels._dropout_factor(run, philox.CLS_DROP1, step, z1.shape)
    act1, grad1 = train_kernels._activation_switch(z1, run.eact)
    a1d, gf1 = act1 * d1, d1 * grad1
    mu = mm(a1d, W2) + B2.unsqueeze(1)
    if run.variational:
        lv = mm(a1d, WV) + BV.unsqueeze(1)
        eps = train_kernels.vae_eps(run.seeds, step, Bsz, mu.shape[2],
                                    philox.CLS_EPS)
        emb = mu + eps * torch.exp(lv)
    else:
        emb = mu

    # head (:1598-1616)
    hs, gfs = [emb], [None]
    for j in range(nc):
        zc = mm(hs[j], run.params[6 + 2 * j]) \
            + run.params[7 + 2 * j].unsqueeze(1)
        if run.gates[j]:
            d = train_kernels._dropout_factor(
                run, philox.CLS_HEAD_DROP + j, step, zc.shape)
            act, grad = train_kernels._activation_switch(zc, run.cact)
            hs.append(act * d)
            gfs.append(d * grad)
        else:
            hs.append(zc)
            gfs.append(None)

    # loss gradient at the last pre-activation (:1618-1628)
    logits = hs[nc]
    if run.softmax:
        g = (torch.softmax(logits, dim=-1) - y) / Bsz
    else:
        g = (torch.sigmoid(logits) - y) / (Bsz * y.shape[-1])
    if run.gates[nc - 1]:
        g = g * gfs[nc]
    gcs = [None] * (nc + 1)
    gcs[nc] = g
    # backward down the head with the weights before this step's update
    for j in range(nc - 1, -1, -1):
        g = mm(gcs[j + 1], tr(run.params[6 + 2 * j]))
        if j > 0:
            gcs[j] = g * gfs[j] if run.gates[j - 1] else g
    gemb = g
    g1_pre = mm(gemb, tr(W2))
    glv = None
    if run.variational:
        glv = gemb * eps * torch.exp(lv)        # no KL in phase 2
        g1_pre = g1_pre + mm(glv, tr(WV))
    g1 = g1_pre * gf1

    # weight gradients + Adam; L2 on the head's weights only (:1641-1717)
    alpha, es2 = _adam_scalars(run, step)
    adam = train_kernels._adam
    adam(run, 0, mm(tr(xn), g1), alpha, es2)
    adam(run, 2, mm(tr(a1d), gemb), alpha, es2)
    if run.variational:
        adam(run, 4, mm(tr(a1d), glv), alpha, es2)
    for j in range(nc):
        w = run.params[6 + 2 * j]
        adam(run, 6 + 2 * j, mm(tr(hs[j]), gcs[j + 1])
             + run.wpen.view(-1, 1, 1) * w, alpha, es2)
    adam(run, 1, g1.sum(dim=1), alpha, es2)
    adam(run, 3, gemb.sum(dim=1), alpha, es2)
    if run.variational:
        adam(run, 5, glv.sum(dim=1), alpha, es2)
    for j in range(nc):
        adam(run, 7 + 2 * j, gcs[j + 1].sum(dim=1), alpha, es2)


def train_cls_kernel_reference(run: ClsRun, first_step: int,
                               num_steps: int) -> None:
    """The phase-2 kernels' plain twin: steps [first_step, first_step +
    num_steps) in plain PyTorch on ``run``'s device, with the same Philox
    draws, so sampling, corruption and dropout are bit-identical to the
    kernels'."""
    with torch.no_grad():
        for step in range(first_step, first_step + num_steps):
            _twin_step(run, step)


# ----------------------------------------------------------- the kernels

def _check_cuda_run(run: ClsRun) -> torch.device:
    dev = run.seeds.device
    if dev.type != "cuda":
        raise ValueError(f"the phase-2 kernels run on cuda, not {dev}")
    want = {"seeds": torch.int32, "fold": torch.int32,
            "n_valid": torch.int32, "eact": torch.int32,
            "cact": torch.int32, "lr": torch.float32, "keep": torch.float32,
            "wpen": torch.float32, "train": torch.float32,
            "labels": torch.float32, "type_table": torch.float32,
            "cum": torch.float32}
    for name, dtype in want.items():
        t = getattr(run, name)
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"ClsRun.{name}: need a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    mdt = torch.bfloat16 if run.bf16_moments else torch.float32
    for name, group, dtype in (("params", run.params, torch.float32),
                               ("m", run.m, mdt), ("v", run.v, mdt)):
        for slot, t in zip(SLOTS, group):
            if t is None:
                continue
            if t.dtype != dtype or t.device != dev or not t.is_contiguous():
                raise ValueError(f"ClsRun.{name}[{slot}]: need a "
                                 f"contiguous {dtype} tensor on {dev}")
    if not 1 <= run.n_cls <= 3 or run.dims[-1] > MAX_LABELS:
        raise ValueError(f"head widths {run.dims} outside the kernels' "
                         "family (1-3 layers, at most 128 labels)")
    if run.variational and (run.params[4] is None or run.params[5] is None):
        raise ValueError("a VAE run needs Wv and bv")
    return dev


def train_cls_kernel(run: ClsRun, first_step: int, num_steps: int,
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
    with profiling.span("mmae.plan"):
        lib = KERNELS.load()
        N, B = run.n_inst, run.batch
        F, H1 = (int(s) for s in run.params[0].shape[1:])
        H2, L = run.dims[0], run.dims[-1]
        dims = list(run.dims) + [1] * (4 - len(run.dims))
        width = {"xn": F, "y": L, "a1d": H1, "gf1": H1, "g1": H1,
                 "h1": dims[1], "gfh1": dims[1], "gc1": dims[1],
                 "h2": dims[2], "gfh2": dims[2], "gc2": dims[2],
                 "h3": dims[3], "gfh3": dims[3], "gc3": dims[3]}
        ws = [torch.empty((N, B, width.get(name, H2)), dtype=torch.float32,
                          device=dev) for name in BUFFERS]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        mbytes = 2 if run.bf16_moments else 4
        weights, _, _ = cls_update_tensors(F, H1, run.dims, run.variational)
        panels, cols, items, n_weight, tile_tx, ring = _run_plan(
            F, H1, tuple(run.dims), tuple(run.gates), bool(run.variational), N,
            B, sms, mbytes, train_deep_kernels.misaligned_slots(
                [(s, run.params[s], run.m[s], run.v[s])
                 for s, _, _ in weights]))
        items_dev = items.to(dev)
        desc = torch.empty(train_deep_kernels.NSLOT
                           * train_deep_kernels.DESC_BYTES, dtype=torch.uint8,
                           device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        args = ClsArgs(
            n_inst=N, batch=B, feats=F, h1=H1, h2=H2, n_labels=L,
            n_types=int(run.type_table.shape[0]),
            max_rows=int(run.train.shape[1]), n_cls=run.n_cls,
            variational=int(run.variational), softmax=int(run.softmax),
            bf16_moments=int(run.bf16_moments), bf16_ops=int(run.bf16_ops),
            n_items=len(items), n_weight_items=n_weight,
            elem_p=run.elem_p, mask_value=run.mask_value,
            adam_eps=run.adam_eps,
            seeds=ptr(run.seeds), fold=ptr(run.fold), n_valid=ptr(run.n_valid),
            lr=ptr(run.lr), keep=ptr(run.keep), wpen=ptr(run.wpen),
            eact=ptr(run.eact), cact=ptr(run.cact), train=ptr(run.train),
            labels=ptr(run.labels), type_table=ptr(run.type_table),
            cum=ptr(run.cum), items=items_dev.data_ptr(),
            upd_desc=desc.data_ptr())
        for i, d in enumerate(dims):
            args.dims[i] = d
        for j, gate in enumerate(run.gates):
            args.gates[j] = int(gate)
        for i, (pw, tc) in enumerate(zip(panels, cols)):
            args.panel[i] = pw
            args.tile_cols[i] = tc
        train_deep_kernels.set_update_args(args, tile_tx, ring)
        for i in range(len(SLOTS)):
            args.param[i] = ptr(run.params[i])
            args.m[i] = ptr(run.m[i])
            args.v[i] = ptr(run.v[i])
        for i, t in enumerate(ws):
            args.ws[i] = t.data_ptr()
        launches = ctypes.c_longlong(0)
        timed = profile is not None or launch_ms is not None
        prof = (ctypes.c_float * len(LAUNCH_TYPES))() if timed else None
        each = (ctypes.c_float * train_deep_kernels.MAX_EVENTS)() if timed \
            else None

        def arg(buf):
            return None if buf is None else ctypes.cast(buf, ctypes.c_void_p)

    with profiling.span("mmae.enqueue") as sp, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mmae_cls_train_run(ctypes.byref(args), int(first_step),
                                     int(num_steps), ctypes.byref(launches),
                                     arg(prof), arg(each), stream)
        sp.count(launches=launches.value,
                 upd_ring_items=ring.ring_items * num_steps,
                 upd_fallback_items=ring.fallback_items * num_steps)
    KERNELS.count(launches.value)
    KERNELS.check(err, "mmae_cls_train_run")
    if profile is not None:
        for name, ms in zip(LAUNCH_TYPES, prof):
            profile[name] = profile.get(name, 0.0) + float(ms)
    if launch_ms is not None:
        per_step = launches_per_step(run.n_cls, run.variational)
        launch_ms.extend([0.0] * (per_step - len(launch_ms)))
        for i in range(per_step):
            launch_ms[i] += float(each[i])


# ------------------------------------------------------------- pipeline

def val_predictions(params: mmae.MMAEParams, cfg: MMAEConfig, hyper, chyper,
                    folded, generator: torch.Generator) -> torch.Tensor:
    """Predictions of every (config, fold) instance on its fold's padded
    val set, no noise and no dropout (get_classification_predictions,
    multimodal_autoencoder.py:1035-1045); a VAE samples its embedding
    with eps from ``generator`` (:372-375).  (C, K, rows, L) int32, or
    (C, K, rows) for softmax.  Shared by both backends; plain PyTorch."""
    cfg = cfg.validate()
    C, K = hyper.num_configs, folded.num_folds
    N = C * K
    vx = folded.val_x
    x = vx.unsqueeze(0).expand((C,) + tuple(vx.shape)).reshape(
        (N,) + tuple(vx.shape[1:]))
    with torch.no_grad():
        flat = optim.tree_map(
            lambda t: t.reshape((N,) + tuple(t.shape[2:])).to(vx.device),
            params)
        mu, log_var = mmae.encode(flat, cfg, x, train=False,
                                  act_id=hyper.act_id.repeat_interleave(K))
        emb = mu
        if cfg.variational:
            emb = mu + mmae._rand(torch.randn, mu, generator) \
                * torch.exp(log_var)
        logits = mmae.classify(flat, cfg, emb, train=False,
                               act_id=chyper.cls_act_id.repeat_interleave(K))
        preds = losses_lib.classification_predictions(
            cfg.classification_loss, logits)
    return preds.reshape((C, K) + tuple(preds.shape[1:]))


def phase2_pallas(seed: int, cfg: MMAEConfig, cls_tcfg: TrainConfig,
                  spec: NoiseSpec, params1: mmae.MMAEParams, hyper, chyper,
                  folded, cls_num_steps: Optional[int] = None,
                  head0=None, adam_eps: float = 1e-8, devices=None):
    """Phase 2 of a bucket on phase 1's parameters ``params1`` (leading
    (C, K) axes): the counterpart of ``_phase2_body``.  ``seed`` seeds one
    CPU generator that draws, in order, the fresh heads (unless ``head0``,
    (cls_w, cls_b) with leading (C, K) axes, is given), the instances'
    Philox seeds and the VAE's evaluation eps.  Runs where ``folded``
    lies: the CUDA kernels on a GPU, the twin on the CPU; with several
    ``devices`` split over them (``train_kernels.run_steps``) and
    gathered before the predictions.  Returns ``(params, preds)``."""
    cfg = cfg.validate()
    steps = cls_tcfg.num_steps if cls_num_steps is None \
        else int(cls_num_steps)
    C, K = hyper.num_configs, folded.num_folds
    with profiling.span("mmae.prepare"):
        g = torch.Generator().manual_seed(int(seed))
        if head0 is None:
            head0 = init_heads(g, cfg, C, K)
        run = prepare_cls_run(g, cfg, cls_tcfg, spec, hyper, chyper, folded,
                              params1, head0, adam_eps)
    train_kernels.run_steps(run, steps, train_cls_kernel_reference,
                            train_cls_kernel, devices)
    with profiling.span("mmae.evaluate"):
        params = run.grid_params(C, K, params1)
        return params, val_predictions(params, cfg, hyper, chyper, folded,
                                       g)


def train_two_phase_pallas(seed: int, cfg: MMAEConfig, tcfg: TrainConfig,
                           cls_tcfg: TrainConfig, spec: NoiseSpec, hyper,
                           chyper, unsup_folded, sup_folded,
                           num_steps: Optional[int] = None,
                           cls_num_steps: Optional[int] = None,
                           params0: Optional[mmae.MMAEParams] = None,
                           head0=None, adam_eps: float = 1e-8,
                           devices=None):
    """Both phases of a bucket on the kernels; the counterpart of
    ``train_kernel.train_two_phase_pallas`` (:1728).  Phase 1 is
    ``train_kernels.train_grid_pallas`` on :func:`phase1_cfg` (seed
    ``derive_seed(seed, 1)``, initial parameters ``params0``), phase 2
    :func:`phase2_pallas` (seed ``derive_seed(seed, 2)``, heads ``head0``).
    Returns ``(params, losses, preds)`` with leading (C, K) axes: phase-1
    noisy-val objectives and phase-2 val predictions.  ``adam_eps`` is
    phase 2's; ``devices`` splits both phases' runs as
    ``train_kernels.run_steps`` does.  Raises ``ValueError`` outside
    :func:`supported_two_phase`."""
    cfg = cfg.validate()
    if not supported_two_phase(cfg, tcfg, cls_tcfg, spec):
        raise ValueError("configuration outside the two-phase kernels' "
                         "family; use the plain grid trainer")
    params1, losses = train_kernels.train_grid_pallas(
        derive_seed(seed, 1), phase1_cfg(cfg), tcfg, spec, hyper,
        unsup_folded, num_steps, params0, devices)
    params, preds = phase2_pallas(derive_seed(seed, 2), cfg, cls_tcfg, spec,
                                  params1, hyper, chyper, sup_folded,
                                  cls_num_steps, head0, adam_eps, devices)
    return params, losses, preds
