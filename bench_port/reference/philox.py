"""Philox4x32-10 draw schedule of the port's training kernels, frozen.

A copy of the port's ``ops/philox.py`` (its counter-based generator and
its purposes), so the reference draws the same rows, corruption, dropout
and VAE noise as the program without importing it.  Keys are (instance
seed, purpose); counters are (step, row, column, draw).  A row index in
``[0, n)`` is ``(bits * n) >> 32``; a uniform in ``[0, 1)`` is ``(bits >>
8) * 2**-24``.  Values are uint32 held in int64 tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10

# Purposes (the second key word) — one stream per kind of draw.  Phase 2
# (the classification run) has its own; head layer j's dropout draws from
# CLS_HEAD_DROP + j (j < 3).  The depth >= 3 run samples and corrupts with ROW,
# ELEM and TYPE, draws the VAE's eps from DEEP_EPS, and layer k of its
# 2L-layer chain (encode layers 0..L-1, then decode layers L..2L-1) its
# dropout from DEEP_DROP + k.
ROW, ELEM, TYPE, DROP1, DROP3, EPS, PROBE = range(7)
CLS_ROW, CLS_ELEM, CLS_TYPE, CLS_DROP1, CLS_EPS, CLS_HEAD_DROP = range(7, 13)
DEEP_EPS, DEEP_DROP = 15, 16


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product ``m * c``."""
    a = m * (c & 0xFFFF)                    # < 2**48
    b = m * (c >> 16)                       # < 2**48
    t = a + ((b & 0xFFFF) << 16)            # < 2**49
    return (b >> 16) + (t >> 32), t & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1).

    Arguments are int64 tensors (or ints) holding uint32 values and
    broadcast against each other; returns the four output words."""
    ref = next(v for v in (c0, c1, c2, c3, k0, k1)
               if isinstance(v, torch.Tensor))

    def as_t(v):
        return torch.as_tensor(v, dtype=torch.int64, device=ref.device)

    c0, c1, c2, c3, k0, k1 = (as_t(v) & MASK32
                              for v in (c0, c1, c2, c3, k0, k1))
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits(seed, purpose: int, step, row, col, draw=0) -> torch.Tensor:
    """The first output word of the stream (seed, purpose) at counter
    (step, row, col, draw), broadcast over the arguments."""
    return philox4x32(step, row, col, draw, seed, purpose)[0]


def uniform(b: torch.Tensor) -> torch.Tensor:
    """float32 uniform in [0, 1) from the top 24 bits of ``b``."""
    return (b >> 8).to(torch.float32) * (2.0 ** -24)


def index_below(b: torch.Tensor, n) -> torch.Tensor:
    """Row index in ``[0, n)``: ``(b * n) >> 32`` (n < 2**31)."""
    return (b * torch.as_tensor(n, dtype=torch.int64, device=b.device)) >> 32


def normal(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Standard normal by Box-Muller from two words, as the kernels
    compute it: ``sqrt(-2 log(u1 + 1e-12)) * cos(2 pi u2)`` in float32."""
    u1, u2 = uniform(w0), uniform(w1)
    r = torch.sqrt(-2.0 * torch.log(u1 + 1e-12))
    return r * torch.cos((2.0 * 3.14159265358979323846) * u2)
