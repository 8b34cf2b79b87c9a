"""Fused dense layer ``act(x @ w + b)``: the CUDA kernel and its plain twin.

Counterpart of ``multimodalautoencoder_tpu/ops/pallas_kernels.py``.  The
Pallas TPU kernel there (``_kernel``, behind ``fused_dense``) becomes the
hand-written CUDA C++ kernel in ``csrc/fused_dense.cu``: f32 operands as
exact f32 FMAs in k order on the CUDA cores, on 16 x 64 tiles for at most
``FFMA_MAX_ROWS`` rows (training and evaluation batches) and on 128 x 128
tiles of 8 x 8 register tiles for more (serving); bf16 operands on
``mma.sync``.  (f32 serving ran as 3xTF32 on ``wgmma`` until its error,
within 5e-6 of f64, was found to lean toward zero: the tensor cores cut
every instruction's sum toward zero.)  This module builds it, binds it and
dispatches to it:

- on a CUDA tensor, :func:`fused_dense` launches the kernel or raises.  A
  failed build or launch is an error, never a fallback;
- on a CPU tensor it runs :func:`fused_dense_reference`, the plain PyTorch
  version of the same math, which the tests hold against the JAX package.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``cuda_library.build_dir()``.

Trainable: :func:`fused_dense` is a ``torch.autograd.Function`` on both
devices, the counterpart of the Pallas version's custom VJP (``_fwd`` /
``_bwd``, pallas_kernels.py:101-136).  The forward is the kernel (or the
plain version on the CPU) and saves ``(x, w, b, out)``; the backward takes
the activation's derivative from ``out`` and forms ``dx = gz w^T``, ``dw =
x^T gz``, ``db = sum(gz)`` with ``torch.matmul`` in f32, whatever ``bf16``
is, as the JAX VJP does.  The single-run trainer (``train/trainer.py``)
reaches it with ``MMAEConfig.use_pallas``; the grid trainer never does: an
``act_id`` turns ``use_pallas`` off.

Captured: the trainer's step and evaluation replay CUDA graphs on the card
(``ops/step_graph.py``), and the launcher records into them as it launches
on the current stream.  Its one-time queries (the device's SM count, the
shared-memory limit raised with ``cudaFuncSetAttribute``) are cached at a
kernel's first launch, which the graph route's eager warm-up makes; the
cluster launch (``cudaLaunchKernelEx``) is captured as any launch.  A
launch recorded into a graph counts in ``KERNELS.launches`` at each replay
(``NvccLibrary.count``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import torch

from multimodalautoencoder_tpu_torch.config import ACTIVATIONS
from multimodalautoencoder_tpu_torch.ops.cuda_library import (CSRC_DIR,
                                                              NVCC_FLAGS,
                                                              NvccLibrary)

SOURCE = os.path.join(CSRC_DIR, "fused_dense.cu")
LIBRARY = "libfused_dense.so"  # in cuda_library.build_dir()

# f32 operands with at most this many rows take the small-tile FFMA
# kernel, more rows the 128 x 128 one (FFMA_MAX_ROWS in csrc/fused_dense.cu)
FFMA_MAX_ROWS = 256

# Activation id passed to the kernel = position in config.ACTIVATIONS.
ACTIVATION_IDS = {name: i for i, name in enumerate(ACTIVATIONS)}

_ACT_FNS = {
    "linear": lambda z: z,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "softsign": lambda z: z / (1.0 + z.abs()),
    "softplus": lambda z: torch.log1p(torch.exp(-z.abs())) + torch.relu(z),
}
assert set(_ACT_FNS) == set(ACTIVATIONS)


def activate(z: torch.Tensor, activation: str) -> torch.Tensor:
    """The kernel's activations (pallas_kernels._ACT_FNS) in plain
    PyTorch; ``max(z, 0)`` keeps NaN, as ``jnp.maximum`` does."""
    return _ACT_FNS[activation](z)


def round_to_bf16(t: torch.Tensor) -> torch.Tensor:
    """Each element rounded to bfloat16 (nearest even) and held as f32 —
    the operand policy of ``mmae.mxu_dot`` with ``bf16``."""
    return t.to(torch.bfloat16).to(torch.float32)


def fused_dense_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          activation: str = "linear",
                          bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch ``act(x @ w + b)``: f32 products and sums; with
    ``bf16`` the operands are rounded to bf16 first."""
    if bf16:
        x, w = round_to_bf16(x), round_to_bf16(w)
    return activate(x @ w + b, activation)


class CudaLibrary(NvccLibrary):
    """``csrc/fused_dense.cu`` built and bound (see
    :class:`cuda_library.NvccLibrary`)."""

    def __init__(self, source: str = SOURCE, library: str = LIBRARY):
        super().__init__(source, library)

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.fused_dense_launch.restype = ctypes.c_int
        lib.fused_dense_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        lib.fused_dense_error_string.restype = ctypes.c_char_p
        lib.fused_dense_error_string.argtypes = [ctypes.c_int]

    def fused_dense(self, x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, out: torch.Tensor, act_id: int,
                    bf16: bool) -> None:
        """Launch the kernel on the current stream into ``out``; raises
        on a launch error."""
        lib = self.load()
        m, k = x.shape
        n = w.shape[1]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_dense_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, n, k, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
            act_id, int(bf16), stream)
        if err != 0:
            raise RuntimeError(
                "fused_dense kernel launch failed: "
                f"{lib.fused_dense_error_string(err).decode()} ({err})")
        self.count(1)


KERNELS = CudaLibrary()


def _check_cuda_operands(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> None:
    for name, t, dim in (("x", x, 2), ("w", w, 2), ("b", b, 1)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_dense: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_dense: {name} is on {t.device}, "
                             f"x on {x.device}")
        if t.dim() != dim:
            raise ValueError(f"fused_dense: {name} must be {dim}-D, got "
                             f"shape {tuple(t.shape)}")
    if w.shape[0] != x.shape[1] or b.shape[0] != w.shape[1]:
        raise ValueError(f"fused_dense: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)} do not chain")
    if b.stride(0) != 1:
        raise ValueError("fused_dense: b must be contiguous")
    if max(x.shape[0], x.shape[1], w.shape[1]) >= 2 ** 31:
        raise ValueError("fused_dense: the kernel takes 32-bit sizes")


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             activation: str, bf16: bool) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return fused_dense_reference(x, w, b, activation, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense runs on cuda or cpu, not {x.device}")
    _check_cuda_operands(x, w, b)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        KERNELS.fused_dense(x, w, b, out, ACTIVATION_IDS[activation], bf16)
    return out


def activation_grad(g: torch.Tensor, out: torch.Tensor,
                    activation: str) -> torch.Tensor:
    """``g`` times the activation's derivative, written in terms of its
    output ``out`` (pallas_kernels._bwd, :109-124)."""
    if activation == "linear":
        return g
    if activation == "relu":
        return g * (out > 0)
    if activation == "tanh":
        return g * (1.0 - out * out)
    if activation == "softsign":
        # out = z / (1 + |z|)  ->  dz = (1 - |out|)^2
        return g * torch.square(1.0 - out.abs())
    if activation == "softplus":
        # out = log(1 + e^z)  ->  sigmoid(z) = 1 - e^-out
        return g * (1.0 - torch.exp(-out))
    raise ValueError(f"unknown activation {activation!r}")


class FusedDense(torch.autograd.Function):
    """``act(x @ w + b)`` with the Pallas version's VJP: the forward saves
    ``(x, w, b, out)``; the backward is plain f32 products on the saved
    operands (not their bf16 roundings), as ``_bwd`` is plain XLA."""

    @staticmethod
    def forward(ctx, x, w, b, activation: str, bf16: bool):
        out = _forward(x, w, b, activation, bf16)
        ctx.save_for_backward(x, w, b, out)
        ctx.activation = activation
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, _, out = ctx.saved_tensors
        gz = activation_grad(g, out, ctx.activation)
        dx = gz @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ gz if ctx.needs_input_grad[1] else None
        db = gz.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                activation: str = "linear",
                bf16: bool = False) -> torch.Tensor:
    """``act(x @ w + b)``; x (M, K), w (K, N), b (N,) -> (M, N) f32.

    On CUDA tensors one launch of the CUDA kernel; ``x`` and ``w`` may be
    strided views (the tied decoder passes ``w.T``, and its gradient flows
    back through the view).  On CPU tensors the plain version.  Either way
    differentiable through :class:`FusedDense`."""
    if activation not in ACTIVATION_IDS:
        raise ValueError(f"unknown activation {activation!r}")
    return FusedDense.apply(x, w, b, activation, bool(bf16))


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor], activation: str,
              final_activation: Optional[str] = None,
              bf16: bool = False) -> torch.Tensor:
    """Chain of fused dense layers: ``activation`` on all but the last
    layer, ``final_activation`` (default linear) on the last — the MMAE
    encode/decode shape (multimodal_autoencoder.py:461-475, :507-518)."""
    h = x
    n = len(weights)
    for i in range(n):
        act = activation if i < n - 1 else (final_activation or "linear")
        h = fused_dense(h, weights[i], biases[i], act, bf16)
    return h
