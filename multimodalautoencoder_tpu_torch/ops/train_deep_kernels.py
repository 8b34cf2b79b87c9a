"""The depth >= 3 grid-training run: hand-written CUDA kernels and their
plain PyTorch twin.

Counterpart of the deep family of ``multimodalautoencoder_tpu/ops/
train_kernel.py``: ``_pipeline_deep`` (:1157-1322) -> the Pallas kernel
``_train_kernel_deep`` (:589-843, ``pallas_call`` :1279), kernel 2's math
over L encode and L decode layers, DAE and VAE, with every moment resident
(no streaming).  ``train_kernels.train_grid_pallas`` dispatches here by
depth, as ``_pipeline`` does (:916-921).  Here:

- :func:`train_deep_pallas` is the pipeline: initial parameters, the run,
  the noisy-val objective shared with every backend;
- :func:`train_deep_kernel` launches the CUDA kernels of
  ``csrc/train_deep_kernel.cu`` (built with nvcc for sm_90a at first use,
  one ctypes call per run; the S-step loop runs in C);
- :func:`train_deep_kernel_reference` is their plain twin: the same math
  and the same Philox bits, step by step.  CPU tensors take the twin;
  CUDA tensors take the kernels or raise.

Semantics are the Pallas kernel's, as for depth 2 (``ops/train_kernels``):
activation and dropout on every layer but the linear embedding and the
logits; the VAE's log-sigma head on the last hidden activation and its KL
on the sampled z; tied decode weights accumulating their gradient
transposed into the encode weight with the L2 doubled, the VAE's ``wv``
penalised once.  Sampling and corruption draw from the depth-2 purposes;
layer k of the 2L-layer chain drops out with ``philox.DEEP_DROP + k`` and
the VAE draws eps from ``philox.DEEP_EPS``.

Parameters, moments and the runner's lists follow the Pallas contract
order (:595-596, :1192-1213): ``encW(L), decW(L, untied only), encB(L),
decB(L), wv, bv``.  What bounds a step: :func:`deep_step_bound`; each
launch: :func:`deep_launch_bounds`.  The host plans each run once: every
product's panel width (:func:`product_plan`) and the grouped update's
work list and ring (:func:`update_plan`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
from multimodalautoencoder_tpu_torch.ops import philox, train_kernels
from multimodalautoencoder_tpu_torch.ops.cuda_library import (CSRC_DIR,
                                                              NvccLibrary)
from multimodalautoencoder_tpu_torch.ops.train_kernels import (
    LAUNCH_TYPES, MAX_DEPTH, GridRun)
from multimodalautoencoder_tpu_torch.utils import profiling

SOURCE = os.path.join(CSRC_DIR, "train_deep_kernel.cu")
HEADERS = train_kernels.HEADERS
LIBRARY = "libtrain_deep_kernel.so"  # in cuda_library.build_dir()

# csrc/train_deep_kernel.cu ``Slot``: encode weights at [0, MAX_DEPTH),
# decode weights at [MAX_DEPTH, 2 MAX_DEPTH), then their biases, wv, bv.
ENC_W, DEC_W, ENC_B, DEC_B = (i * MAX_DEPTH for i in range(4))
WV, BV = 4 * MAX_DEPTH, 4 * MAX_DEPTH + 1
NSLOT = 4 * MAX_DEPTH + 2
# ``Buf``: six single buffers, then six per-layer groups of MAX_DEPTH.
SINGLE_BUFFERS = ("x", "xn", "lv", "eps", "z", "glv")
LAYER_BUFFERS = ("enc_out", "enc_gf", "enc_g", "dec_out", "dec_gf", "dec_g")
NBUF = len(SINGLE_BUFFERS) + len(LAYER_BUFFERS) * MAX_DEPTH
# the launcher times at most this many launches of one step
# (train_common.cuh ``Launcher::MAX_EVENTS`` less two)
MAX_PROFILED_LAUNCHES = 46
MAX_EVENTS = 48
# csrc/train_deep_kernel.cu ``MAX_PRODUCTS``: a step's products at most
MAX_PRODUCTS = 4 * MAX_DEPTH
# train_common.cuh's gemm_batch_kernel: panel widths and the rows a block
# holds
PANEL_WIDTHS = (64, 32, 16)
BATCH_ROWS = 24
# update_group_kernel: update threads a block, rows of a thread's
# elements, bias columns an item, bytes of one tensor's descriptor
# (``UpdTensor``, at most)
UPDATE_THREADS = 256
UPDATE_ROWS = 4
BIAS_COLS = 256
DESC_BYTES = 128
H100_SMS = 132
# its ring path (train_common.cuh): the batch it takes at most (WBK; a
# larger batch takes the in-place path), its stages at most
# (UPD_DEPTH_MAX) and the widest tile, wider tensors split into strips
UPDATE_RING_MAX_BATCH = 32
UPDATE_MAX_DEPTH = 6
UPDATE_STRIP_COLS = 512
# shared memory of an H100 block at most, and the update's static tables
# (UPD_SLOTS descriptors and the ring's barriers) with room to spare
BLOCK_SHARED_BYTES = 232448
UPDATE_STATIC_BYTES = 6144

class DeepArgs(ctypes.Structure):
    """``struct DeepArgs`` of csrc/train_deep_kernel.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "n_inst", "batch", "depth", "n_types", "max_rows", "tied",
            "variational", "bf16_moments", "decay")]
        + [("dims", ctypes.c_int * (MAX_DEPTH + 1)),
           ("panel", ctypes.c_int * MAX_PRODUCTS),
           ("tile_tx", ctypes.c_int * NSLOT),
           ("n_items", ctypes.c_int), ("n_weight_items", ctypes.c_int),
           ("upd_ring", ctypes.c_int * NSLOT)]
        + [(n, ctypes.c_int) for n in ("upd_depth", "upd_lfloats",
                                       "upd_rfloats", "upd_rbufs",
                                       "upd_stage")]
        + [(n, ctypes.c_float) for n in (
            "elem_p", "mask_value", "decay_steps", "decay_rate",
            "adam_eps2")]
        + [(n, ctypes.c_void_p) for n in (
            "seeds", "fold", "n_valid", "lr", "keep", "wpen", "act",
            "train", "type_table", "cum", "items", "upd_desc")]
        + [("param", ctypes.c_void_p * NSLOT),
           ("m", ctypes.c_void_p * NSLOT),
           ("v", ctypes.c_void_p * NSLOT),
           ("ws", ctypes.c_void_p * NBUF)])


class DeepLibrary(NvccLibrary):
    """``csrc/train_deep_kernel.cu`` built and bound; ``launches`` counts
    its kernels' launches."""

    def __init__(self):
        super().__init__(SOURCE, LIBRARY, HEADERS)

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.mmae_deep_train_run.restype = ctypes.c_int
        lib.mmae_deep_train_run.argtypes = [
            ctypes.POINTER(DeepArgs), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.deep_train_kernel_error_string.restype = ctypes.c_char_p
        lib.deep_train_kernel_error_string.argtypes = [ctypes.c_int]

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.load().deep_train_kernel_error_string(err).decode()
            raise RuntimeError(f"{what} failed: {msg} ({err})")


KERNELS = DeepLibrary()


def launches_per_step(depth: int, tied: bool, variational: bool) -> int:
    """Kernel launches of one step of ``mmae_deep_train_run``: sample +
    corrupt, 2L forward and 2L - 1 backward products, and one grouped
    update of every weight and bias (whether tied or not); a VAE adds the
    log-sigma product and two elementwise passes.  13 for a tied depth-3
    step, 16 for a depth-3 VAE."""
    del tied   # a tied step updates fewer tensors in the same launch
    return 1 + 2 * depth + 2 * depth - 1 + 1 + (3 if variational else 0)


# ----------------------------------------------------------- the plan

def panel_width(ncol: int, n_inst: int, batch: int,
                sms: int = H100_SMS) -> int:
    """gemm_batch_kernel's panel width for a product of ``ncol`` columns
    over ``n_inst`` instances: the widest of :data:`PANEL_WIDTHS`, no wider
    than ``ncol`` needs, that gives at least two blocks an SM; with none,
    the narrowest.  A block's time does not depend on its width (each
    thread sums the same 2 x 4 elements over K), so a narrower panel only
    spreads a launch over more SMs, and its ring is sized to the panel."""
    row_blocks = -(-batch // BATCH_ROWS)
    fits = [w for w in PANEL_WIDTHS if w < 2 * ncol or w == PANEL_WIDTHS[-1]]
    for w in fits:
        if n_inst * row_blocks * -(-ncol // w) >= 2 * sms:
            return w
    return fits[-1]


def product_plan(sizes: Sequence[int], tied: bool, variational: bool,
                 n_inst: int, batch: int, sms: int = H100_SMS
                 ) -> List[Dict[str, object]]:
    """Every product of one step in ``DeepRunner::step``'s launch order:
    name, launch type, epilogue, columns ``ncol``, depth ``K`` (+ ``K2``
    of the second pair), whether B is read K-major (a W^T view), the panel
    width and the grid."""
    d = list(sizes)
    L = len(d) - 1
    out = []

    def add(name, kind, epi, ncol, K, kmajor, K2=0):
        pw = panel_width(ncol, n_inst, batch, sms)
        out.append({"name": name, "type": kind, "epi": epi, "ncol": ncol,
                    "K": K, "K2": K2, "kmajor": kmajor, "panel": pw,
                    "grid": (-(-ncol // pw), -(-batch // BATCH_ROWS),
                             n_inst)})

    fwd, bwd = "forward_products", "backward_products"
    for i in range(L):
        if variational and i == L - 1:
            add("lv head", fwd, "bias", d[L], d[L - 1], False)
        add(f"encode {i}", fwd, "act_drop" if i < L - 1 else "bias",
            d[i + 1], d[i], False)
    for j in range(L):
        add(f"decode {j}", fwd, "act_drop" if j < L - 1 else "logit_grad",
            d[L - j - 1], d[L - j], tied)
    for j in range(L - 2, -1, -1):
        add(f"decode {j} grad", bwd, "mul", d[L - j - 1], d[L - j - 2],
            not tied)
    add("gz", bwd, "none", d[L], d[L - 1], not tied)
    for i in range(L - 2, -1, -1):
        add(f"encode {i} grad", bwd, "mul", d[i + 1], d[i + 2], True,
            d[L] if variational and i == L - 2 else 0)
    return out


def update_tile_threads(cols: int, ring: bool = False) -> int:
    """update_group_kernel's threads across a weight tile of ``cols``
    columns.  In-place path: 16 unless the columns end in a partial 64,
    up to 128 columns, where one tile spans them.  Ring path: one tile
    spans the columns up to UPDATE_STRIP_COLS; a wider tensor splits into
    strips of equal width rounded up to 8 columns (1000: 504).  At least
    8 threads."""
    if ring:
        strips = -(-cols // UPDATE_STRIP_COLS)
        width = -(-cols // strips)
        if strips > 1:
            width = -(-width // 8) * 8
        return max(8, -(-width // 4))
    if cols > 128 or cols % 64 == 0:
        return 16
    return max(8, -(-cols // 4))


def update_tile(tx: int, ring: bool = False) -> Tuple[int, int]:
    """(rows, columns) of an update tile with ``tx`` threads across: each
    thread owns UPDATE_ROWS x 4 elements over 256 / tx thread rows,
    rounded down to even on the in-place path (64 x 64 at tx = 16, 40 x
    100 at tx = 25; ring path: 8 x 504 at tx = 126, 12 x 300 at 75)."""
    ty = UPDATE_THREADS // tx
    return UPDATE_ROWS * (ty if ring else ty & ~1), 4 * tx


def update_tensors(sizes: Sequence[int], tied: bool, variational: bool
                   ) -> Tuple[List[Tuple[int, int, int]],
                              List[Tuple[int, int]]]:
    """The grouped update's tensors: weights as (slot, rows, cols), biases
    as (slot, cols), each in slot order."""
    d = list(sizes)
    L = len(d) - 1
    weights = [(ENC_W + i, d[i], d[i + 1]) for i in range(L)]
    if not tied:
        weights += [(DEC_W + j, d[L - j], d[L - j - 1]) for j in range(L)]
    if variational:
        weights.append((WV, d[L - 1], d[L]))
    biases = ([(ENC_B + i, d[i + 1]) for i in range(L)]
              + [(DEC_B + j, d[L - j - 1]) for j in range(L)]
              + ([(BV, d[L])] if variational else []))
    return weights, biases


def update_work_list(sizes: Sequence[int], tied: bool, variational: bool,
                     n_inst: int, ring: bool = False
                     ) -> Tuple[np.ndarray, int, Dict[int, int]]:
    """update_group_kernel's work list of a deep step:
    :func:`work_list` over :func:`update_tensors`."""
    return work_list(*update_tensors(sizes, tied, variational), n_inst, ring)


def work_list(weights: Sequence[Tuple[int, int, int]],
              biases: Sequence[Tuple[int, int]], n_inst: int,
              ring: bool = False
              ) -> Tuple[np.ndarray, int, Dict[int, int]]:
    """update_group_kernel's work list over ``weights`` (slot, rows, cols)
    and ``biases`` (slot, cols): (items, weight items, tile threads across
    by slot).  Items are (slot, instance, row 0, column 0) int32 rows:
    every weight tile of every instance, the largest tensors first, then
    every bias's :data:`BIAS_COLS`-column chunks, the widest first.  An
    instance's tiles run row by row on the in-place path; on the ring
    path (``ring``) strip by strip, down each strip, so a block's
    contiguous share walks down a strip."""
    tile_tx = {slot: update_tile_threads(C, ring) for slot, _, C in weights}

    def block(slot, r0, c0):
        """Every instance's (slot, n, r0, c0) over the given tile
        corners, instance by instance."""
        n = np.repeat(np.arange(n_inst), len(r0))
        return np.column_stack([np.full(len(n), slot), n,
                                np.tile(r0, n_inst), np.tile(c0, n_inst)])

    rows = []
    for slot, R, C in sorted(weights, key=lambda w: -w[1] * w[2]):
        tr, tc = update_tile(tile_tx[slot], ring)
        r0, c0 = np.meshgrid(np.arange(0, R, tr), np.arange(0, C, tc),
                             indexing="xy" if ring else "ij")
        rows.append(block(slot, r0.ravel(), c0.ravel()))
    n_weight = sum(len(r) for r in rows)
    for slot, C in sorted(biases, key=lambda b: -b[1]):
        c0 = np.arange(0, C, BIAS_COLS)
        rows.append(block(slot, np.zeros_like(c0), c0))
    items = np.concatenate(rows).astype(np.int32)
    return items, n_weight, tile_tx


class UpdateRing(NamedTuple):
    """update_group_kernel's ring for one run (:func:`update_ring`)."""

    ring: Tuple[int, ...]   # weight slots whose W, m, v take bulk copies
    ring_items: int         # weight items of those slots a step
    fallback_items: int     # weight items that read W, m, v in place
    depth: int              # stages of the ring (0: the in-place path)
    l_floats: int           # a stage's layer inputs: pairs x B x tile rows
    r_floats: int           # a strip's gradients: pairs x B x tile columns
    r_bufs: int             # buffers of a strip's gradients
    stage_bytes: int        # a stage's W, m, v: the largest ring tile's


def ring_fits(rows: int, cols: int, tx: int, moment_bytes: int) -> bool:
    """Whether the ring's bulk copies take a (rows, cols) weight with
    ``tx`` threads across (``upd_ring_fits``): columns a multiple of 4 and
    every copy's offset and bytes on 16: rows of cols x moment bytes on
    16, or one tile spanning the rows (tile rows even) over an even number
    of rows, as the bf16 moment rows of 1000, 600 and 200 B of the 500-,
    300- and 100-column weights need."""
    if rows <= 0 or cols % 4:
        return False
    rows16 = cols * moment_bytes % 16 == 0
    if 4 * tx < cols:   # strips: a copy a row
        return rows16 and 4 * tx * moment_bytes % 16 == 0
    return rows16 or rows % 2 == 0


def ring_depth(l_floats: int, r_floats: int, r_bufs: int,
               stage_bytes: int) -> int:
    """Stages of W, m, v and layer inputs that one block an SM holds
    beside ``r_bufs`` strip buffers, at most UPDATE_MAX_DEPTH."""
    room = BLOCK_SHARED_BYTES - UPDATE_STATIC_BYTES - 4 * r_floats * r_bufs
    return max(0, min(UPDATE_MAX_DEPTH, room // (stage_bytes
                                                 + 4 * l_floats)))


def update_ring(weights: Sequence[Tuple[int, int, int]], items: np.ndarray,
                n_weight: int, tile_tx: Dict[int, int], batch: int,
                moment_bytes: int, misaligned: Sequence[int] = (),
                paired: Sequence[int] = ()) -> UpdateRing:
    """update_group_kernel's ring over the ring-path work list ``items``
    of ``weights`` (slot, rows, cols; the ``paired`` slots sum two product
    pairs), from what the host sees.  A weight takes bulk copies where
    :func:`ring_fits` and no pointer is in ``misaligned``; any other reads
    its W, m and v in place.  Shared memory holds the widest strip's
    gradients and as many stages of the largest ring tile's W, m, v and
    the tallest tile's layer inputs as fit (:func:`ring_depth`); the
    gradients take two buffers, so a strip's are staged while the last
    strip is summed, where that still leaves three stages.  Depth 0 (the
    in-place path) where the batch exceeds UPDATE_RING_MAX_BATCH or two
    stages do not fit."""
    if batch > UPDATE_RING_MAX_BATCH:
        return UpdateRing((), 0, n_weight, 0, 0, 0, 0, 0)
    bad = set(misaligned)
    ring = tuple(sorted(slot for slot, R, C in weights if slot not in bad
                        and ring_fits(R, C, tile_tx[slot], moment_bytes)))
    ring_items = int(np.isin(items[:n_weight, 0], ring).sum())
    pairs = {slot: 2 if slot in paired else 1 for slot, _, _ in weights}
    tiles = {slot: update_tile(tile_tx[slot], True) for slot, _, _ in weights}
    l_floats = max(pairs[s] * batch * tr for s, (tr, _) in tiles.items())
    r_floats = max(pairs[s] * batch * tc for s, (_, tc) in tiles.items())
    stage = max([tiles[slot][0] * min(tiles[slot][1], C)
                 * (4 + 2 * moment_bytes)
                 for slot, _, C in weights if slot in ring] + [16])
    r_bufs = 2 if ring_depth(l_floats, r_floats, 2, stage) >= 3 else 1
    depth = ring_depth(l_floats, r_floats, r_bufs, stage)
    if depth < 2:
        return UpdateRing((), 0, n_weight, 0, 0, 0, 0, 0)
    return UpdateRing(ring, ring_items, n_weight - ring_items, depth,
                      l_floats, r_floats, r_bufs, stage)


def update_plan(weights: Sequence[Tuple[int, int, int]],
                biases: Sequence[Tuple[int, int]], n_inst: int, batch: int,
                moment_bytes: int, misaligned: Sequence[int] = (),
                paired: Sequence[int] = ()):
    """The update's work list and ring for one run: the ring path's
    (:func:`work_list` with ``ring``, :func:`update_ring`) where it takes
    the run, else the in-place path's with a ring of depth 0."""
    items, n_weight, tile_tx = work_list(weights, biases, n_inst, True)
    ring = update_ring(weights, items, n_weight, tile_tx, batch,
                       moment_bytes, misaligned, paired)
    if not ring.depth:
        items, n_weight, tile_tx = work_list(weights, biases, n_inst)
        ring = ring._replace(fallback_items=n_weight)
    return items, n_weight, tile_tx, ring


def misaligned_slots(tensors) -> Tuple[int, ...]:
    """The slots of ``tensors`` ((slot, W, m, v) tensors) whose W, m or v
    does not start on 16 bytes: where the ring's bulk copies cannot read
    them."""
    return tuple(slot for slot, w, m, v in tensors
                 if w.data_ptr() % 16 or m.data_ptr() % 16
                 or v.data_ptr() % 16)


def set_update_args(args, tile_tx, ring: UpdateRing) -> None:
    """The update's plan into a run's ctypes arguments (``DeepArgs``,
    ``TrainArgs`` or ``ClsArgs``)."""
    for slot, tx in tile_tx:
        args.tile_tx[slot] = tx
    for slot in ring.ring:
        args.upd_ring[slot] = 1
    args.upd_depth, args.upd_lfloats = ring.depth, ring.l_floats
    args.upd_rfloats, args.upd_rbufs = ring.r_floats, ring.r_bufs
    args.upd_stage = ring.stage_bytes


@functools.lru_cache(maxsize=32)
def _run_plan(sizes: Tuple[int, ...], tied: bool, variational: bool,
              n_inst: int, batch: int, sms: int, moment_bytes: int = 2,
              misaligned: Tuple[int, ...] = ()):
    """A run's plan, made once a shape: the products' panel widths, the
    update's work list (a CPU tensor), its weight items, tile widths and
    ring (:func:`update_plan`)."""
    plan = product_plan(sizes, tied, variational, n_inst, batch, sms)
    items, n_weight, tile_tx, ring = update_plan(
        *update_tensors(sizes, tied, variational), n_inst, batch,
        moment_bytes, misaligned,
        [ENC_W + i for i in range(len(sizes) - 1)] if tied else ())
    return (tuple(p["panel"] for p in plan), torch.from_numpy(items),
            n_weight, tuple(tile_tx.items()), ring)


# ------------------------------------------------------------- bounds

def _widths(cfg: MMAEConfig) -> List[int]:
    """[F, H1, ..., HL]."""
    return [cfg.num_feats] + list(cfg.layer_sizes)


def deep_step_bound(cfg: MMAEConfig, n_inst: int, batch: int,
                    bf16_moments: bool) -> Dict[str, float]:
    """``train_kernels.step_bound`` over L layers: the least time one step
    of ``n_inst`` instances could take on an H100, the larger of its bytes
    over the memory rate and its operations over the f32 CUDA-core rate.
    Bytes: every parameter read and written (8 B), both Adam moments read
    and written (8 B bf16, 16 B f32), the sampled rows read once.
    Operations: 2 per multiply-add of the step's products, 10 per
    parameter for Adam.  At L = 2 it equals ``step_bound``."""
    cfg = cfg.validate()
    d = _widths(cfg)
    L = len(d) - 1
    S = sum(d[i] * d[i + 1] for i in range(L))    # one copy of the weights
    head = d[L - 1] * d[L] if cfg.variational else 0
    weights = S * (1 if cfg.tie_weights else 2) + head
    params = weights + sum(d[1:]) + sum(d[:-1]) + (d[L] if head else 0)
    # forward: every layer of both halves (+ lv); backward data: the
    # decode chain down to gz, the encode chain down to layer 1's input
    # gradient (not into xn) (+ the wv term); weight gradients: one
    # product per weight tensor, two per tied one (+ wv's)
    macs = batch * (2 * S + head
                    + S + S - d[0] * d[1] + head
                    + 2 * S + head)
    flop = n_inst * (2.0 * macs + 10.0 * params)
    nbytes = n_inst * (params * (16 if bf16_moments else 24)
                       + 4.0 * batch * d[0])
    return train_kernels._bound(nbytes, flop)


def deep_launch_type_bounds(cfg: MMAEConfig, n_inst: int, batch: int,
                            bf16_moments: bool
                            ) -> Dict[str, Dict[str, float]]:
    """:func:`deep_step_bound` split by launch type
    (``train_kernels.LAUNCH_TYPES``).  Each type counts the weights it
    reads, the (N, B, width) activations it reads from other types once
    and the ones it writes once, and its operations; 12 integer operations
    per Philox round for the draws."""
    cfg = cfg.validate()
    d = _widths(cfg)
    L = len(d) - 1
    N, B = n_inst, batch
    vae = cfg.variational
    S = sum(d[i] * d[i + 1] for i in range(L))
    head = d[L - 1] * d[L] if vae else 0
    weights = S * (1 if cfg.tie_weights else 2) + head
    biases = sum(d[1:]) + sum(d[:-1]) + (d[L] if vae else 0)
    hidden = 2 * sum(d[1:L])          # hidden widths of both halves
    act = 4.0 * N * B                 # bytes per unit of activation width
    philox_ops = 10 * 12
    moment = 8 if bf16_moments else 16
    # every layer's gradient at its pre-activation: both halves' widths
    grads = sum(d[1:]) + sum(d[:-1])
    return {
        "sample_corrupt": train_kernels._bound(
            act * 3 * d[0], N * B * (d[0] + 2) * philox_ops),
        "forward_products": train_kernels._bound(
            # xn, x in; a, d act' of every hidden layer, mu (+ lv) and the
            # logit gradient out
            4.0 * N * (weights + biases)
            + act * (3 * d[0] + 2 * hidden + d[L] * (2 if vae else 1)),
            N * (2.0 * B * (2 * S + head) + B * hidden * philox_ops)),
        "vae_elementwise": train_kernels._bound(
            act * d[L] * 10 if vae else 0.0,
            N * B * d[L] * 40.0 if vae else 0.0),
        "backward_products": train_kernels._bound(
            # the logit gradient and d act' in, every other gradient out
            4.0 * N * weights + act * (d[0] + hidden + grads - d[0]
                                       + (d[L] if vae else 0)),
            N * 2.0 * B * (2 * S - d[0] * d[1] + head)),
        "weight_grad_adam": train_kernels._bound(
            # every layer's input and gradient in (+ glv)
            N * weights * (8.0 + moment)
            + act * (d[0] + hidden + d[L] + grads + (d[L] if vae else 0)),
            N * (2.0 * B * (2 * S + head) + 10.0 * weights)),
        "bias_grad_adam": train_kernels._bound(
            N * biases * (8.0 + moment) + act * (grads
                                                 + (d[L] if vae else 0)),
            N * (B + 10.0) * biases),
    }


def deep_launch_bounds(cfg: MMAEConfig, n_inst: int, batch: int,
                       bf16_moments: bool, sms: int = H100_SMS
                       ) -> List[Dict[str, object]]:
    """Each launch of one step in launch order, with its own bound:
    :func:`launch_rows` over :func:`product_plan` and
    :func:`deep_launch_type_bounds`."""
    cfg = cfg.validate()
    d = _widths(cfg)
    plan = product_plan(d, cfg.tie_weights, cfg.variational, n_inst, batch,
                        sms)
    return launch_rows(plan, deep_launch_type_bounds(cfg, n_inst, batch,
                                                     bf16_moments),
                       len(d) - 1, cfg.variational, n_inst, batch)


def launch_rows(plan: List[Dict[str, object]],
                types: Dict[str, Dict[str, float]], depth: int,
                variational: bool, n_inst: int, batch: int
                ) -> List[Dict[str, object]]:
    """Each launch of a step of ``depth`` layers in launch order, with its
    own bound, from the step's product plan and its launch types' bounds:
    a product reads its weight(s), bias and input once and writes its
    outputs once (so a tied weight counts in both of its products, and the
    products' sum exceeds the forward and backward type rows, which count
    each weight once); the sample and the VAE passes split their types'
    rows; the grouped update is the weight- and bias-update rows
    together.  Products carry the plan's fields."""
    L, N, B, vae = depth, n_inst, batch, variational
    philox_ops = 10 * 12
    bound = train_kernels._bound

    def product(p):
        k = p["K"] + p["K2"]
        outs = {"act_drop": 2, "bias": 1, "logit_grad": 1, "mul": 1,
                "none": 1}[p["epi"]]
        reads = 1 if p["epi"] in ("logit_grad", "mul") else 0
        has_bias = p["epi"] in ("act_drop", "bias", "logit_grad")
        nbytes = 4.0 * N * (k * p["ncol"] + (p["ncol"] if has_bias else 0)
                            + B * (k + (outs + reads) * p["ncol"]))
        flop = N * (2.0 * B * p["ncol"] * k
                    + (B * p["ncol"] * philox_ops
                       if p["epi"] == "act_drop" else 0))
        return dict(p, **bound(nbytes, flop))

    def share(name, kind, frac_bytes, frac_flop):
        t = types[kind]
        return dict({"name": name, "type": kind},
                    **bound(t["bytes"] * frac_bytes, t["flop"] * frac_flop))

    n_fwd = L + (1 if vae else 0)
    out = [share("sample", "sample_corrupt", 1.0, 1.0)]
    out += [product(p) for p in plan[:n_fwd]]
    if vae:
        out.append(share("vae sample", "vae_elementwise", 0.4, 0.5))
    out += [product(p) for p in plan[n_fwd:n_fwd + L + L]]
    if vae:
        out.append(share("vae grad", "vae_elementwise", 0.6, 0.5))
    out += [product(p) for p in plan[n_fwd + L + L:]]
    w, b = types["weight_grad_adam"], types["bias_grad_adam"]
    out.append(dict({"name": "update", "type": "weight_grad_adam"},
                    **bound(w["bytes"] + b["bytes"], w["flop"] + b["flop"])))
    return out


# ----------------------------------------------------------------- state

@dataclasses.dataclass
class DeepGridRun(GridRun):
    """One depth >= 3 bucket's state: :class:`GridRun`'s fields, with
    ``params``, ``m`` and ``v`` in the Pallas contract order ``encW(L),
    decW(L, untied only), encB(L), decB(L), wv, bv (VAE only)``, the
    widths ``sizes`` = (F, H1, ..., HL), and Adam's eps (the sweep's 1e-8;
    checks raise it to put Adam in its linear regime)."""

    sizes: Tuple[int, ...] = ()
    adam_eps: float = train_kernels.ADAM_EPS

    @property
    def depth(self) -> int:
        return len(self.sizes) - 1

    @property
    def dims(self):
        return self.sizes

    def layout(self) -> Dict[str, int]:
        """Position of each group's first entry in the contract order."""
        L = self.depth
        n_w = L if self.tied else 2 * L
        return {"enc_w": 0, "dec_w": L, "enc_b": n_w, "dec_b": n_w + L,
                "wv": n_w + 2 * L}

    def c_slots(self) -> List[int]:
        """The C ``Slot`` of each entry of ``params``."""
        L = self.depth
        slots = [ENC_W + i for i in range(L)]
        if not self.tied:
            slots += [DEC_W + j for j in range(L)]
        slots += [ENC_B + i for i in range(L)] + [DEC_B + j for j in range(L)]
        if self.variational:
            slots += [WV, BV]
        return slots

    def grid_params(self, C: int, K: int) -> mmae.MMAEParams:
        """The parameters as an MMAEParams with leading (C, K) axes."""
        def un(t):
            return t.reshape((C, K) + t.shape[1:])
        L, at = self.depth, self.layout()
        p = [un(t) for t in self.params]
        return mmae.MMAEParams(
            enc_w=tuple(p[:L]),
            dec_w=() if self.tied else tuple(p[L:2 * L]),
            enc_b=tuple(p[at["enc_b"]:at["enc_b"] + L]),
            dec_b=tuple(p[at["dec_b"]:at["dec_b"] + L]),
            var_w=p[at["wv"]] if self.variational else None,
            var_b=p[at["wv"] + 1] if self.variational else None,
            cls_w=(), cls_b=())


def prepare_deep_run(generator: torch.Generator, cfg: MMAEConfig,
                     tcfg: TrainConfig, spec: NoiseSpec, hyper, folded,
                     params0: mmae.MMAEParams,
                     adam_eps: float = train_kernels.ADAM_EPS
                     ) -> DeepGridRun:
    """The kernels' inputs for a depth >= 3 bucket (``_pipeline_deep``
    :1176-1246 without the padding): per-instance Philox seeds from
    ``generator``, fold ids, row counts and hyperparameters, the fold
    data, the corruption tables, ``params0`` (leading (C, K) axes) in the
    contract order flattened to (N, ...), and zero moments.  Lives on the
    device of ``folded``."""
    cfg = cfg.validate()
    p = params0
    flat = (list(p.enc_w) + list(p.dec_w) + list(p.enc_b) + list(p.dec_b)
            + ([p.var_w, p.var_b] if cfg.variational else []))
    run = train_kernels.prepare_flat(
        DeepGridRun, generator, cfg, tcfg, spec, hyper, folded, flat,
        sizes=tuple(_widths(cfg)), adam_eps=float(adam_eps))
    d = run.sizes
    for li, w in enumerate(run.params[:run.depth]):
        if tuple(w.shape[1:]) != (d[li], d[li + 1]):
            raise ValueError(f"params0 encode weight {li} has shape "
                             f"{tuple(w.shape)}, the config implies "
                             f"(N, {d[li]}, {d[li + 1]})")
    return run


# ------------------------------------------------------------- the twin

def _twin_step(run: DeepGridRun, step: int) -> None:
    L, d = run.depth, run.sizes
    Bsz, vae = run.batch, run.variational
    at = run.layout()
    P = run.params
    enc_w = P[:L]
    dec_w = ([enc_w[L - 1 - j].transpose(1, 2) for j in range(L)]
             if run.tied else P[L:2 * L])
    enc_b = P[at["enc_b"]:at["enc_b"] + L]
    dec_b = P[at["dec_b"]:at["dec_b"] + L]
    wv, bv = (P[at["wv"]], P[at["wv"] + 1]) if vae else (None, None)

    def tr(t):
        return t.transpose(1, 2)

    def hidden(z, layer):
        """(act(z) * drop, drop * act'(z)) of chain layer ``layer``."""
        drop = train_kernels._dropout_factor(run, philox.DEEP_DROP + layer,
                                             step, z.shape)
        val, grad = train_kernels._activation_switch(z, run.act)
        return val * drop, drop * grad

    x, xn = train_kernels.sample_batch(run, step)
    # forward (train_kernel.py:714-759): hs[i] is encode layer i's input
    hs, gf_enc = [xn], []
    lv = eps = None
    for li in range(L):
        if vae and li == L - 1:
            # the log-sigma head off the last hidden activation (:720-724)
            lv = hs[li] @ wv + bv.unsqueeze(1)
        z = hs[li] @ enc_w[li] + enc_b[li].unsqueeze(1)
        if li < L - 1:
            h, gf = hidden(z, li)
            gf_enc.append(gf)
        elif vae:
            eps = train_kernels.vae_eps(run.seeds, step, Bsz, d[L],
                                        philox.DEEP_EPS)
            h = z + eps * torch.exp(lv)
        else:
            h = z
        hs.append(h)
    gs, gf_dec = [hs[L]], []          # gs[j] is decode layer j's input
    for lj in range(L - 1):
        h, gf = hidden(gs[lj] @ dec_w[lj] + dec_b[lj].unsqueeze(1), L + lj)
        gs.append(h)
        gf_dec.append(gf)
    logits = gs[L - 1] @ dec_w[L - 1] + dec_b[L - 1].unsqueeze(1)

    # backward (:761-789); the target is the clean x, -1 gaps included
    dec_g = [None] * L
    dec_g[L - 1] = 1.0 / (1.0 + torch.exp(-logits)) - x
    for lj in range(L - 2, -1, -1):
        dec_g[lj] = (dec_g[lj + 1] @ tr(dec_w[lj + 1])) * gf_dec[lj]
    gz = dec_g[0] @ tr(dec_w[0])
    glv = None
    if vae:
        # KL on the sampled z: dz += z / B, dlv by the chain (:772-779)
        gz = gz + hs[L] * (1.0 / Bsz)
        glv = gz * eps * torch.exp(lv) + (torch.exp(2.0 * lv) - 1.0) \
            * (1.0 / Bsz)
    enc_g = [None] * L
    enc_g[L - 1] = gz
    for li in range(L - 2, -1, -1):
        up = enc_g[li + 1] @ tr(enc_w[li + 1])
        if vae and li == L - 2:
            up = up + glv @ tr(wv)
        enc_g[li] = up * gf_enc[li]

    # weight gradients + L2 + Adam (:791-835)
    alpha, es2 = train_kernels._adam_scalars(run, step, run.adam_eps)
    wpen = run.wpen.view(-1, 1, 1)
    pen = (2.0 if run.tied else 1.0) * wpen
    adam = train_kernels._adam
    for li in range(L):
        grad = tr(hs[li]) @ enc_g[li] + pen * enc_w[li]
        if run.tied:
            # decode layer L-1-li uses W_li^T: its gradient, transposed
            j0 = L - 1 - li
            grad = grad + tr(dec_g[j0]) @ gs[j0]
        adam(run, li, grad, alpha, es2)
    if not run.tied:
        for lj in range(L):
            adam(run, L + lj, tr(gs[lj]) @ dec_g[lj] + wpen * dec_w[lj],
                 alpha, es2)
    if vae:
        # wv is never tied: its L2 is not doubled (:821-828)
        adam(run, at["wv"], tr(hs[L - 1]) @ glv + wpen * wv, alpha, es2)
        adam(run, at["wv"] + 1, glv.sum(dim=1), alpha, es2)
    for li in range(L):
        adam(run, at["enc_b"] + li, enc_g[li].sum(dim=1), alpha, es2)
        adam(run, at["dec_b"] + li, dec_g[li].sum(dim=1), alpha, es2)


def train_deep_kernel_reference(run: DeepGridRun, first_step: int,
                                num_steps: int) -> None:
    """The deep kernels' plain twin: steps [first_step, first_step +
    num_steps) in plain PyTorch on ``run``'s device, with the same Philox
    draws, so sampling, corruption and dropout are bit-identical to the
    kernels'."""
    with torch.no_grad():
        for step in range(first_step, first_step + num_steps):
            _twin_step(run, step)


# ----------------------------------------------------------- the kernels

def _check_cuda_run(run: DeepGridRun) -> torch.device:
    dev = run.seeds.device
    if dev.type != "cuda":
        raise ValueError(f"the deep training kernels run on cuda, not {dev}")
    if not 2 <= run.depth <= MAX_DEPTH:
        raise ValueError(f"depth {run.depth} outside [2, {MAX_DEPTH}]")
    want = {"seeds": torch.int32, "fold": torch.int32,
            "n_valid": torch.int32, "act": torch.int32,
            "lr": torch.float32, "keep": torch.float32,
            "wpen": torch.float32, "train": torch.float32,
            "type_table": torch.float32, "cum": torch.float32}
    for name, dtype in want.items():
        t = getattr(run, name)
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"DeepGridRun.{name}: need a contiguous {dtype}"
                             f" tensor on {dev}, got {t.dtype} on {t.device}")
    if len(run.params) != len(run.c_slots()):
        raise ValueError(f"{len(run.params)} parameters where the layout "
                         f"has {len(run.c_slots())}")
    mdt = torch.bfloat16 if run.bf16_moments else torch.float32
    for name, group, dtype in (("params", run.params, torch.float32),
                               ("m", run.m, mdt), ("v", run.v, mdt)):
        for i, t in enumerate(group):
            if t.dtype != dtype or t.device != dev or not t.is_contiguous():
                raise ValueError(f"DeepGridRun.{name}[{i}]: need a "
                                 f"contiguous {dtype} tensor on {dev}")
    return dev


def _workspace(run: DeepGridRun, dev) -> Dict[Tuple[str, int], torch.Tensor]:
    """The (N, B, width) buffers the run needs, keyed (group, layer):
    every layer's output, gate factor d * act'(z) and gradient at its
    pre-activation, where the layer has them (the logits are never
    stored: their gradient is the last decode product's epilogue)."""
    N, B, L, d = run.n_inst, run.batch, run.depth, run.sizes
    want = {("x", 0): d[0], ("xn", 0): d[0]}
    if run.variational:
        for name in ("lv", "eps", "z", "glv"):
            want[(name, 0)] = d[L]
    for i in range(L):
        want[("enc_out", i)] = want[("enc_g", i)] = d[i + 1]
        want[("dec_g", i)] = d[L - i - 1]
        if i < L - 1:
            want[("enc_gf", i)] = d[i + 1]
            want[("dec_out", i)] = want[("dec_gf", i)] = d[L - i - 1]
    return {k: torch.empty((N, B, w), dtype=torch.float32, device=dev)
            for k, w in want.items()}


def _buffer_index(name: str, layer: int) -> int:
    if name in SINGLE_BUFFERS:
        return SINGLE_BUFFERS.index(name)
    return (len(SINGLE_BUFFERS) + LAYER_BUFFERS.index(name) * MAX_DEPTH
            + layer)


def train_deep_kernel(run: DeepGridRun, first_step: int, num_steps: int,
                      profile: Optional[Dict[str, float]] = None,
                      launch_ms: Optional[List[float]] = None) -> None:
    """Steps [first_step, first_step + num_steps) by the CUDA kernels, in
    place on ``run``'s tensors, on the current stream; one ctypes call
    whose C loop enqueues every launch.  With ``profile`` (a dict) every
    launch is timed with CUDA events and each launch type's milliseconds
    are added to it, and with ``launch_ms`` too (a list) each launch's, in
    launch order, over the steps (this synchronises once a step; at most
    :data:`MAX_PROFILED_LAUNCHES` launches a step)."""
    dev = _check_cuda_run(run)
    if num_steps <= 0:
        return
    per_step = launches_per_step(run.depth, run.tied, run.variational)
    if (profile is not None or launch_ms is not None) \
            and per_step > MAX_PROFILED_LAUNCHES:
        raise ValueError("too many launches a step to profile")
    with profiling.span("mmae.plan"):
        lib = KERNELS.load()
        ws = _workspace(run, dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        mbytes = 2 if run.bf16_moments else 4
        weights, _ = update_tensors(run.sizes, run.tied, run.variational)
        by_slot = dict(zip(run.c_slots(), zip(run.params, run.m, run.v)))
        panels, items, n_weight, tile_tx, ring = _run_plan(
            tuple(run.sizes), bool(run.tied), bool(run.variational),
            run.n_inst, run.batch, sms, mbytes, misaligned_slots(
                [(s,) + by_slot[s] for s, _, _ in weights]))
        items_dev = items.to(dev)
        desc = torch.empty(NSLOT * DESC_BYTES, dtype=torch.uint8, device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        args = DeepArgs(
            n_inst=run.n_inst, batch=run.batch, depth=run.depth,
            n_types=int(run.type_table.shape[0]),
            max_rows=int(run.train.shape[1]), tied=int(run.tied),
            variational=int(run.variational),
            bf16_moments=int(run.bf16_moments), decay=int(run.decay),
            elem_p=run.elem_p, mask_value=run.mask_value,
            decay_steps=run.decay_steps, decay_rate=run.decay_rate,
            adam_eps2=run.adam_eps * run.adam_eps, seeds=ptr(run.seeds),
            fold=ptr(run.fold), n_valid=ptr(run.n_valid),
            lr=ptr(run.lr), keep=ptr(run.keep), wpen=ptr(run.wpen),
            act=ptr(run.act), train=ptr(run.train),
            type_table=ptr(run.type_table), cum=ptr(run.cum),
            n_items=len(items), n_weight_items=n_weight,
            items=items_dev.data_ptr(), upd_desc=desc.data_ptr())
        for i, w in enumerate(run.sizes):
            args.dims[i] = w
        for i, pw in enumerate(panels):
            args.panel[i] = pw
        set_update_args(args, tile_tx, ring)
        for i, slot in enumerate(run.c_slots()):
            args.param[slot] = ptr(run.params[i])
            args.m[slot] = ptr(run.m[i])
            args.v[slot] = ptr(run.v[i])
        for (name, layer), t in ws.items():
            args.ws[_buffer_index(name, layer)] = t.data_ptr()
        launches = ctypes.c_longlong(0)
        timed = profile is not None or launch_ms is not None
        prof = (ctypes.c_float * len(LAUNCH_TYPES))() if timed else None
        each = (ctypes.c_float * MAX_EVENTS)() if timed else None

        def arg(buf):
            return None if buf is None else ctypes.cast(buf, ctypes.c_void_p)

    with profiling.span("mmae.enqueue") as sp, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mmae_deep_train_run(ctypes.byref(args), int(first_step),
                                      int(num_steps), ctypes.byref(launches),
                                      arg(prof), arg(each), stream)
        sp.count(launches=launches.value,
                 upd_ring_items=ring.ring_items * num_steps,
                 upd_fallback_items=ring.fallback_items * num_steps)
    KERNELS.count(launches.value)
    KERNELS.check(err, "mmae_deep_train_run")
    if profile is not None:
        for name, ms in zip(LAUNCH_TYPES, prof):
            profile[name] = profile.get(name, 0.0) + float(ms)
    if launch_ms is not None:
        launch_ms.extend([0.0] * (per_step - len(launch_ms)))
        for i in range(per_step):
            launch_ms[i] += float(each[i])


# ------------------------------------------------------------- pipeline

def train_deep_pallas(seed: int, cfg: MMAEConfig, tcfg: TrainConfig,
                      spec: NoiseSpec, hyper, folded,
                      num_steps: Optional[int] = None,
                      params0: Optional[mmae.MMAEParams] = None,
                      devices=None):
    """Train every (config, fold) instance of a depth >= 3 bucket; the
    counterpart of ``_pipeline_deep``, with ``train_kernels.
    train_grid_pallas``'s contract: ``seed`` seeds one CPU generator that
    draws, in order, the initial parameters (unless ``params0``), the
    instances' Philox seeds and the objective's noise; the CUDA kernels on
    a GPU, the twin on the CPU, split over several ``devices`` as there.
    Returns ``(params, losses)`` with leading (C, K) axes."""
    cfg = cfg.validate()
    if not (3 <= len(cfg.layer_sizes) <= MAX_DEPTH
            and train_kernels.supported(cfg, tcfg, spec)):
        raise ValueError("configuration outside the deep training kernels'"
                         " family; use the plain grid trainer")
    num_steps = tcfg.num_steps if num_steps is None else int(num_steps)
    C, K = hyper.num_configs, folded.num_folds
    with profiling.span("mmae.prepare"):
        generator = torch.Generator().manual_seed(int(seed))
        if params0 is None:
            params0 = train_kernels.init_grid_params(generator, cfg, C, K)
        run = prepare_deep_run(generator, cfg, tcfg, spec, hyper, folded,
                               params0)
    train_kernels.run_steps(run, num_steps, train_deep_kernel_reference,
                            train_deep_kernel, devices)
    with profiling.span("mmae.evaluate"):
        params = run.grid_params(C, K)
        return params, train_kernels.noisy_val_losses(
            params, cfg, spec, hyper, folded, generator)
