"""The least time a training step could take on one H100: frozen copies of
the port's ``ops/train_kernels.step_bound``, ``ops/cls_train_kernels.
cls_step_bound`` and ``ops/train_deep_kernels.deep_step_bound``, taking
plain widths instead of the port's configuration objects.

A bound is the larger of the step's device-memory bytes over the memory
rate and its operations over the f32 CUDA-core rate (``peaks``).  Bytes:
every trained parameter read and written (8 B), both Adam moments read and
written (8 B in bf16, 16 B in f32), the sampled rows (and labels) read
once.  Operations: 2 per multiply-add of the step's products, 10 per
parameter for Adam.  Later versions of the program may change their own
copies; these stay as they are, so a cell reads the same work whatever
implements it.
"""

from __future__ import annotations

from typing import Dict, Sequence

from bench_port.yardstick import peaks


def bound(nbytes: float, flop: float) -> Dict[str, float]:
    """``{"bytes", "flop", "bound_s", "bound_by"}`` of a step."""
    t_bytes = nbytes / peaks.H100_HBM_BYTES_PER_S
    t_flop = flop / peaks.H100_F32_FLOP_PER_S
    return {"bytes": float(nbytes), "flop": float(flop),
            "bound_s": max(t_bytes, t_flop),
            "bound_by": "bytes" if t_bytes >= t_flop else "operations"}


def step_bound(feats: int, h1: int, h2: int, tied: bool, variational: bool,
               n_inst: int, batch: int, bf16_moments: bool
               ) -> Dict[str, float]:
    """One depth-2 MMAE training step (phase 1) of ``n_inst`` instances."""
    F, H1, H2, vae = feats, h1, h2, variational
    weights = F * H1 + H1 * H2 + (0 if tied else H2 * H1 + H1 * F) \
        + (H1 * H2 if vae else 0)
    params = weights + 2 * H1 + H2 + F + (H2 if vae else 0)
    # forward z1, mu, z3, z4 (+ lv); backward g3, gz, g1 (+ the Wv term)
    macs = batch * (2 * (F * H1 + H1 * H2) + F * H1 + 2 * H1 * H2
                    + (2 * H1 * H2 if vae else 0))
    # weight gradients: one product per weight tensor, two per tied one
    macs += batch * (2 * (F * H1 + H1 * H2) + (H1 * H2 if vae else 0))
    flop = n_inst * (2.0 * macs + 10.0 * params)
    nbytes = n_inst * (params * (16 if bf16_moments else 24)
                       + 4.0 * batch * F)
    return bound(nbytes, flop)


def cls_step_bound(feats: int, h1: int, h2: int, head: Sequence[int],
                   n_labels: int, variational: bool, n_inst: int,
                   batch: int, bf16_moments: bool) -> Dict[str, float]:
    """One phase-2 step (encoder and classification head) of ``n_inst``
    instances; ``head`` is the head's hidden widths."""
    F, H1, H2, vae = feats, h1, h2, variational
    dims = [H2] + list(head) + [n_labels]
    hd = sum(dims[j] * dims[j + 1] for j in range(len(dims) - 1))
    enc = F * H1 + H1 * H2 + (H1 * H2 if vae else 0)
    params = enc + hd + H1 + H2 + (H2 if vae else 0) + sum(dims[1:])
    # forward, backward data (the head and g1; not into xn) and weight
    # gradients: each weight's product once in each
    macs = batch * (enc + hd
                    + hd + H1 * H2 * (2 if vae else 1)
                    + enc + hd)
    flop = n_inst * (2.0 * macs + 10.0 * params)
    nbytes = n_inst * (params * (16 if bf16_moments else 24)
                       + 4.0 * batch * (F + n_labels))
    return bound(nbytes, flop)


def deep_step_bound(widths: Sequence[int], tied: bool, variational: bool,
                    n_inst: int, batch: int, bf16_moments: bool
                    ) -> Dict[str, float]:
    """One MMAE step of any depth; ``widths`` is [F, H1, ..., HL].  At
    depth 2 it equals :func:`step_bound`."""
    d = list(widths)
    L = len(d) - 1
    S = sum(d[i] * d[i + 1] for i in range(L))
    head = d[L - 1] * d[L] if variational else 0
    weights = S * (1 if tied else 2) + head
    params = weights + sum(d[1:]) + sum(d[:-1]) + (d[L] if head else 0)
    macs = batch * (2 * S + head
                    + S + S - d[0] * d[1] + head
                    + 2 * S + head)
    flop = n_inst * (2.0 * macs + 10.0 * params)
    nbytes = n_inst * (params * (16 if bf16_moments else 24)
                       + 4.0 * batch * d[0])
    return bound(nbytes, flop)
