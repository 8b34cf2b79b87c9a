"""The numbers that decide ``correct``, and their limits.

A training call is judged on its first three steps (the program's and the
reference's readings of the same call, ``entries/*.py``):

- ``loss_gap``: the relative gap between the program's loss and the
  reference's, instance by instance at each of the three steps (phase 1:
  the entry's own noisy-val objective; phase 2: the val classification
  loss of the entry's parameters);
- ``grad_gap``: the first gradient as the optimizer holds it, its first
  moment after one step, leaf by leaf;
- ``change_gap``: each leaf's change over the three steps, leaving out
  leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone);

each taken at the ``Q`` quantile over a bucket's instances or leaves and
then the worst over steps and buckets.  The answers are checked one by
one:

- ``obj_miss`` (phase 1): the entry's objective after three steps against
  the objective the reference reads off the entry's own parameters;
- ``pred_miss`` (phase 2): the entry's val predictions that disagree with
  its own parameters' logits, counting only logits farther than
  ``PRED_MARGIN`` from the boundary.

A leaf is one tensor of one instance.  A leaf's gap is the gap between
the two norms, not the norm of the difference, over the larger of the
reference's norm of that leaf and the median leaf's.  The worst leaf
(``Q`` = 1) is not compared: relu pre-activations within rounding of 0
take the other branch in one of the two, which moves one small leaf of
one instance by up to 6e-3 on a sound run (PERF.md).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch

Q = 0.95                # the compared quantile over instances and leaves
PRED_MARGIN = 1e-4      # logits nearer the boundary than this are excused
QUIET_GRAD = 1e-3       # leaves below this share of the median gradient


def _stack(norms: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([norms[k].double() for k in sorted(norms)])


def quantile(t: torch.Tensor, q: float = Q) -> float:
    """``t``'s ``q`` quantile; infinite when ``t`` holds a non-finite
    value."""
    t = t.double().flatten()
    if t.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(t).all()):
        return math.inf
    return float(torch.quantile(t, q))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              include: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every leaf's gap of norms (``include`` masks leaves in
    ``sorted(ref)`` x instance order); infinite where the two hold
    different leaves."""
    if set(prog) != set(ref) or any(prog[k].shape != ref[k].shape
                                    for k in ref):
        return torch.full((1,), math.inf)
    p, r = _stack(prog), _stack(ref)
    gap = (p - r).abs() / torch.maximum(r, r.flatten().median())
    return gap[include] if include is not None else gap.flatten()


def moved(g1: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Leaves whose reference gradient is at least ``QUIET_GRAD`` of the
    median leaf's."""
    g = _stack(g1)
    return g >= QUIET_GRAD * g.flatten().median()


def _rel(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    if prog.shape != ref.shape:
        return torch.full((1,), math.inf)
    prog, ref = prog.double(), ref.double()
    return (prog - ref).abs() / ref.abs().clamp_min(1e-300)


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest relative gap."""
    return quantile(_rel(prog, ref), 1.0)


def training_numbers(prog: dict, ref: dict, loss: str, q: float = Q
                     ) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of one call at the
    ``q`` quantile (and ``obj_miss`` where the call has an objective)."""
    losses = _rel(prog[loss], ref[loss])
    out = {"loss_gap": max(quantile(row, q) for row in
                           losses.reshape(losses.shape[0], -1)),
           "grad_gap": quantile(leaf_gaps(prog["m1"], ref["m1"]), q),
           "change_gap": quantile(leaf_gaps(prog["d3"], ref["d3"],
                                            moved(ref["g1"])), q)}
    if "obj_self" in prog:
        out["obj_miss"] = rel_gap(prog["obj"][-1], prog["obj_self"])
    return out


def variants(prog: dict, ref: dict, loss: str) -> Dict[str, float]:
    """The three gaps at their largest, 95th and 90th percentile and
    median: the readings the compared quantile was chosen from."""
    out = {}
    for tag, q in (("max", 1.0), ("q95", 0.95), ("q90", 0.9),
                   ("median", 0.5)):
        for k, v in training_numbers(prog, ref, loss, q).items():
            out[k if k == "obj_miss" else f"{k}.{tag}"] = v
    return out


def val_loss(logits: torch.Tensor, y: torch.Tensor, n_val: torch.Tensor,
             C: int) -> torch.Tensor:
    """(N,) sigmoid cross entropy of every instance's val logits (N, rows,
    L) against its fold's labels (K, rows, L), averaged over its valid
    rows and the labels, in float64."""
    N, rows = logits.shape[:2]
    z = logits.double()
    t = y.double().unsqueeze(0).expand((C,) + tuple(y.shape)).reshape(
        z.shape)
    valid = (torch.arange(rows, device=z.device).view(1, -1)
             < n_val.to(z.device).repeat(C).view(-1, 1))
    bce = torch.relu(z) - z * t + torch.log1p(torch.exp(-z.abs()))
    bce = bce * valid.unsqueeze(-1)
    return (bce.sum(dim=(1, 2))
            / (valid.sum(dim=1).clamp_min(1) * z.shape[-1])).cpu()


def pred_miss(preds: torch.Tensor, logits: torch.Tensor,
              n_val: torch.Tensor, C: int) -> float:
    """How many valid predictions disagree with the sign of their logit,
    among logits at least ``PRED_MARGIN`` from 0."""
    preds = preds.reshape(logits.shape).to(torch.int64)
    rows = logits.shape[1]
    valid = (torch.arange(rows).view(1, -1)
             < n_val.repeat(C).view(-1, 1)).unsqueeze(-1)
    want = (logits > 0).to(torch.int64)
    clear = logits.abs() >= PRED_MARGIN
    return float(((preds != want) & clear & valid).sum())


def worst(rows: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            v = float(v)
            out[k] = v if math.isnan(v) else max(out.get(k, -math.inf), v)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]
            ) -> (bool, Dict[str, dict]):
    """Each number beside its limit; correct when every limited one is
    finite and within its limit (a number the limits do not name is
    shown but not held)."""
    shown, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        v = numbers.get(name, math.nan)
        lim = limits.get(name, {}).get("limit")
        # JSON has no inf or nan: a non-finite reading is shown as text
        shown[name] = {"value": v if math.isfinite(v) else repr(v),
                       "limit": lim}
        if lim is not None and not (math.isfinite(v) and v <= lim):
            ok = False
    return ok, shown


def report_lines(shown: Dict[str, dict]) -> List[str]:
    return [f"check {name} {d['value']!r} limit {d['limit']!r}"
            for name, d in shown.items()]
