"""Pieces both reference phases share: the precision of the products, the
activations, Adam with moments stored in their dtype, the corruption
tables, the objective's noise, and the CPU draws the program makes from
a call's seed (its instance keys, fresh heads and evaluation noise).

Plain PyTorch and numpy; nothing of the program is imported.  The
semantics are those of the port's training kernels (the Pallas kernels'),
written down from their description in the program's docstrings:
Bernoulli element zeros at the marginal rate ``1-(1-1/F)^k``, a modality
set per row from the intelligent-noise probabilities, dropout and rows
from Philox (``philox.py``), Adam in the rsqrt form whose update uses this
step's unrounded moments while the stored ones are rounded to their dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ACTIVATIONS = ("linear", "relu", "tanh", "softsign", "softplus")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Each float32 element rounded to nearest even at 10 mantissa bits,
    held as float32: what a TF32 product reads."""
    b = t.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = (b + 0x0FFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """``a @ b`` in ``prec``: "f32", as the configurations state (TF32 off
    in the backend, :func:`f32_products`), or "tf32", each operand rounded
    to TF32's 10-bit mantissa: the check's control."""
    if prec == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif prec != "f32":
        raise ValueError(f"unknown precision {prec!r}")
    return a @ b


def f32_products() -> None:
    """Turn TF32 off for float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def activation_id(name: str) -> int:
    return ACTIVATIONS.index(name)


def activate(z: torch.Tensor, name: str) -> torch.Tensor:
    if name == "linear":
        return z
    if name == "relu":
        return torch.relu(z)
    if name == "tanh":
        return torch.tanh(z)
    if name == "softsign":
        return z / (1.0 + z.abs())
    if name == "softplus":
        return torch.log1p(torch.exp(-z.abs())) + torch.relu(z)
    raise ValueError(f"unknown activation {name!r}")


def activate_per_instance(z: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """The activation each instance of a (N, ...) stack selects."""
    a = act.to(z.device).reshape((-1,) + (1,) * (z.dim() - 1))
    out = z
    for i, name in enumerate(ACTIVATIONS[1:], start=1):
        out = torch.where(a == i, activate(z, name), out)
    return out


def act_and_grad(z: torch.Tensor, act: torch.Tensor):
    """(act(z), act'(z)) per instance, as the training step takes them."""
    a = act.to(torch.int64).reshape((-1,) + (1,) * (z.dim() - 1))
    t = torch.tanh(z)
    s = 1.0 / (1.0 + torch.abs(z))
    sig = 1.0 / (1.0 + torch.exp(-z))
    one, zero = torch.ones_like(z), torch.zeros_like(z)
    val = torch.where(a == 1, activate(z, "relu"), z)
    val = torch.where(a == 2, t, val)
    val = torch.where(a == 3, activate(z, "softsign"), val)
    val = torch.where(a == 4, activate(z, "softplus"), val)
    grad = torch.where(a == 1, torch.where(z > 0, one, zero), one)
    grad = torch.where(a == 2, 1.0 - t * t, grad)
    grad = torch.where(a == 3, s * s, grad)
    grad = torch.where(a == 4, sig, grad)
    return val, grad


# ------------------------------------------------------------- the noise

class Noise:
    """The corruption a configuration states: the modality spans, the
    intelligent-noise sets with their probabilities, the element zeros a
    row takes and the value masked spans hold."""

    def __init__(self, widths: Sequence[int], names: Sequence[str],
                 noise_types: Sequence[Sequence[str]],
                 percentages: Sequence[float], element_dropout_frac: float,
                 mask_with: float):
        F = int(sum(widths))
        starts = np.concatenate([[0], np.cumsum(widths)]).astype(int)
        mod = np.zeros((len(widths), F), dtype=bool)
        for m in range(len(widths)):
            mod[m, starts[m]:starts[m + 1]] = True
        types = np.zeros((len(noise_types), F), dtype=bool)
        for t, group in enumerate(noise_types):
            for name in group:
                types[t] |= mod[list(names).index(name)]
        self.num_feats = F
        self.type_masks = torch.as_tensor(types)
        self.log_probs = torch.log(torch.as_tensor(
            np.asarray(percentages, dtype=np.float32)))
        self.num_element_drops = int(F * element_dropout_frac)
        self.mask_with = float(mask_with)

    @property
    def elem_p(self) -> float:
        """Bernoulli zeroing rate of the training step: the marginal rate
        of k draws with replacement."""
        k, F = self.num_element_drops, self.num_feats
        return float(1.0 - (1.0 - 1.0 / F) ** k) if k else 0.0

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, F) float32 set masks and (T,) float32 cumulative
        probabilities of the training step."""
        probs = torch.exp(self.log_probs.to(torch.float32))
        cum = torch.cumsum(probs / torch.sum(probs), dim=0)
        return (self.type_masks.to(torch.float32).to(device),
                cum.to(device))

    def corrupt(self, g: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """The objective's corruption of a (N, rows, F) batch from the CPU
        generator ``g``: k feature indices a row with replacement zeroed,
        then one intelligent-noise set a row overwritten with
        ``mask_with``."""
        lead, F = tuple(x.shape[:-1]), x.shape[-1]
        dev = x.device
        if self.num_element_drops > 0:
            idx = torch.randint(0, F, lead + (self.num_element_drops,),
                                generator=g, device=g.device).to(dev)
            zero = torch.zeros(lead + (F,), dtype=torch.bool, device=dev)
            zero.scatter_(-1, idx, True)
            x = torch.where(zero, torch.zeros((), dtype=x.dtype, device=dev),
                            x)
        probs = torch.exp(self.log_probs.to(torch.float64))
        n = int(np.prod(lead))
        t = torch.multinomial(probs, max(n, 2), replacement=True,
                              generator=g)[:n]
        mask = self.type_masks.to(dev)[t.reshape(lead).to(dev)]
        return torch.where(mask, torch.full((), self.mask_with,
                                            dtype=x.dtype, device=dev), x)


# ---------------------------------------------------------- CPU draws

def instance_keys(g: torch.Generator, n: int) -> torch.Tensor:
    """The (n,) Philox key words a run draws first from its generator."""
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=g)


def truncated_normal(g: torch.Generator, shape) -> torch.Tensor:
    """A 'normal' initial weight: a normal truncated at 2 sigma with
    stddev 1/sqrt(fan_in), by the inverse CDF of a CPU uniform."""
    fan_in = shape[0]
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=g)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * u)
                                      - 1.0)
    return z.clamp(-2.0, 2.0) / math.sqrt(fan_in)


def fresh_heads(g: torch.Generator, dims: Sequence[int], n: int):
    """Each of ``n`` instances' fresh head, in instance order: the weights
    of every layer from :func:`truncated_normal`, biases 0.1.  Returns
    [(W (n, in, out), b (n, out)) per layer]."""
    per = [[truncated_normal(g, (dims[j], dims[j + 1]))
            for j in range(len(dims) - 1)] for _ in range(n)]
    return [(torch.stack([p[j] for p in per]),
             torch.full((n, dims[j + 1]), 0.1))
            for j in range(len(dims) - 1)]


# ------------------------------------------------------------------ Adam

def adam_scalars(lr: torch.Tensor, step: int, decay: Optional[Tuple[float,
                                                                    float]],
                 eps: float = ADAM_EPS):
    """Per-instance (alpha, es2) of step ``step`` (0-based) in the rsqrt
    form: alpha = lr_s sqrt(bc2) / bc1, es2 = bc2 eps^2, bias corrections
    at count step + 1, lr_s = lr rate^(step / decay_steps) with ``decay``
    = (decay_steps, rate), float32 throughout."""
    f32 = dict(dtype=torch.float32, device=lr.device)
    cf = torch.tensor(float(step + 1), **f32)
    bc1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, **f32), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, **f32), cf)
    if decay is not None:
        steps, rate = decay
        lr = lr * torch.pow(torch.tensor(rate, **f32),
                            torch.tensor(float(step), **f32) / steps)
    eps2 = torch.tensor(eps, **f32) ** 2
    return lr * torch.sqrt(bc2) / bc1, bc2 * eps2


def adam(params: List, m: List, v: List, slot: int, grad: torch.Tensor,
         alpha, es2) -> None:
    """One Adam step of ``params[slot]``: the moments stored in their
    dtype, the weight moved by this step's unrounded f32 moments."""
    w = params[slot]
    shape = (-1,) + (1,) * (w.dim() - 1)
    mn = ADAM_B1 * m[slot].float() + (1.0 - ADAM_B1) * grad
    vn = ADAM_B2 * v[slot].float() + (1.0 - ADAM_B2) * grad * grad
    m[slot] = mn.to(m[slot].dtype)
    v[slot] = vn.to(v[slot].dtype)
    params[slot] = w - (alpha.view(shape) * mn) * torch.rsqrt(vn + es2)


def dropout_factor(seeds: torch.Tensor, keep: torch.Tensor, purpose: int,
                   step: int, shape) -> torch.Tensor:
    """1/keep where the (step, row, col) uniform is below keep, else 0."""
    from bench_port.reference import philox

    dev = seeds.device
    rows = torch.arange(shape[1], device=dev).view(1, -1, 1)
    cols = torch.arange(shape[2], device=dev).view(1, 1, -1)
    u = philox.uniform(philox.bits(seeds.to(torch.int64).view(-1, 1, 1),
                                   purpose, step, rows, cols))
    k = keep.view(-1, 1, 1)
    return torch.where(u < k, 1.0 / k, torch.zeros((), device=dev))


def vae_eps(seeds: torch.Tensor, step: int, batch: int, width: int,
            purpose: int) -> torch.Tensor:
    """(N, batch, width) standard normals by Box-Muller from the first two
    words of counter (step, row, col, 0)."""
    from bench_port.reference import philox

    dev = seeds.device
    rows = torch.arange(batch, device=dev).view(1, -1, 1)
    cols = torch.arange(width, device=dev).view(1, 1, -1)
    w = philox.philox4x32(step, rows, cols, 0,
                          seeds.to(torch.int64).view(-1, 1, 1), purpose)
    return philox.normal(w[0], w[1])


def sample_rows(seeds: torch.Tensor, n_valid: torch.Tensor, batch: int,
                step: int, purposes: Tuple[int, int, int], cum: torch.Tensor,
                elem_p: float):
    """Step ``step``'s row indices (N, B), each row's modality-set index
    (N, B; T means none) and a function of F giving the (N, B, F)
    element-zero mask (None without element zeros); ``purposes`` are the
    (row, element, set) streams."""
    from bench_port.reference import philox

    dev = seeds.device
    s = seeds.to(torch.int64).view(-1, 1)
    b = torch.arange(batch, device=dev).view(1, -1)
    rows = philox.index_below(philox.bits(s, purposes[0], step, b, 0),
                              n_valid.to(torch.int64).view(-1, 1))
    u_type = philox.uniform(philox.bits(s, purposes[2], step, b, 0))
    types = (u_type.unsqueeze(-1) >= cum).sum(dim=-1)

    def elem_zero(F: int) -> Optional[torch.Tensor]:
        if elem_p <= 0:
            return None
        f = torch.arange(F, device=dev).view(1, 1, -1)
        u = philox.uniform(philox.bits(s.view(-1, 1, 1), purposes[1], step,
                                       b.view(1, -1, 1), f))
        return u < torch.tensor(elem_p, dtype=torch.float32, device=dev)

    return rows, types, elem_zero


def corrupt_rows(x: torch.Tensor, types: torch.Tensor, table: torch.Tensor,
                 zero: Optional[torch.Tensor], mask_value: float
                 ) -> torch.Tensor:
    """The training step's corruption: element zeros, then the row's set
    (none past the last) overwritten with ``mask_value``."""
    dev = x.device
    full = torch.cat([table, torch.zeros_like(table[:1])])
    xn = x
    if zero is not None:
        xn = torch.where(zero, torch.zeros((), device=dev), xn)
    return torch.where(full[types] > 0, torch.tensor(mask_value, device=dev),
                       xn)


def pad_folds(mats: Sequence[np.ndarray], device) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Ragged folds stacked to (K, max_rows, ...) with zero rows, and the
    (K,) row counts."""
    mx = max(m.shape[0] for m in mats)
    out = np.zeros((len(mats), mx) + tuple(mats[0].shape[1:]),
                   dtype=np.float32)
    for i, m in enumerate(mats):
        out[i, :m.shape[0]] = m
    return (torch.as_tensor(out, device=device),
            torch.tensor([m.shape[0] for m in mats], dtype=torch.int64,
                         device=device))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-instance norm of every (N, ...) tensor, in float64: (N,)."""
    return {k: t.double().flatten(1).norm(dim=1) for k, t in tensors.items()}
