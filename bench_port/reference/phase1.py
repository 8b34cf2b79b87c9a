"""Plain reference of a phase-1 call: a depth-2 MMAE bucket trained from
given initial parameters, then scored by the noisy-val objective.

It follows what ``train_grid_sharded(..., backend="pallas")`` states it
computes for each (setting, fold) instance ``n = c * K + k``: the call's
CPU generator, seeded with the call's seed, draws the instances' Philox
keys first and the objective's noise last; each step samples B rows of
fold k's training rows with replacement, corrupts them, runs the
encoder and decoder with dropout, takes the gradient of the summed
sigmoid cross entropy against the clean rows (the -1 gaps included), the
L2 penalty (doubled on tied weights) and, for a VAE, the KL term on the
sampled z, and moves every parameter by Adam with the decaying lr.  The
objective corrupts each fold's whole val set once, runs the model without
dropout (a VAE samples z) and sums the cross entropy over the valid rows,
divided by their number.  Products run in ``prec``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from bench_port.reference import common, philox

SLOTS = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4", "wv", "bv")


@dataclasses.dataclass
class Run:
    """One bucket's state, flat over its N = C * K instances."""

    tied: bool
    vae: bool
    decay: Optional[tuple]
    elem_p: float
    mask_value: float
    batch: int
    seeds: torch.Tensor
    fold: torch.Tensor
    n_valid: torch.Tensor
    lr: torch.Tensor
    keep: torch.Tensor
    wpen: torch.Tensor
    act: torch.Tensor
    train: torch.Tensor
    table: torch.Tensor
    cum: torch.Tensor
    params: List[Optional[torch.Tensor]]
    m: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]


def start(seed: int, p0: Dict[str, torch.Tensor], settings, K: int,
          train: torch.Tensor, n_train: torch.Tensor, noise: common.Noise,
          recipe: dict, tied: bool, vae: bool, device) -> Run:
    """A call's state: ``p0`` maps each slot to its (N, ...) initial
    tensor (the tied decoder's weights absent), ``settings`` holds each
    setting's lr, keep probability, penalty and activation."""
    g = torch.Generator().manual_seed(int(seed))
    C = len(settings)
    N = C * K
    seeds = common.instance_keys(g, N).to(device)

    def per_inst(key, dtype):
        vals = [settings[n // K][key] for n in range(N)]
        return torch.tensor(vals, dtype=dtype, device=device)

    mdt = torch.bfloat16 if recipe["moments"] == "bfloat16" else \
        torch.float32
    params = [None if p0.get(s) is None else
              p0[s].to(device, torch.float32).clone() for s in SLOTS]
    table, cum = noise.tables(device)
    return Run(
        tied=tied, vae=vae,
        decay=((float(recipe["decay_steps"]), float(recipe["decay_rate"]))
               if recipe["decay"] else None),
        elem_p=noise.elem_p, mask_value=noise.mask_with,
        batch=int(recipe["batch_size"]), seeds=seeds,
        fold=torch.arange(K, device=device).repeat(C),
        n_valid=n_train.to(device).repeat(C),
        lr=per_inst("learning_rate", torch.float32),
        keep=per_inst("dropout_prob", torch.float32),
        wpen=per_inst("weight_penalty", torch.float32),
        act=torch.tensor([common.activation_id(settings[n // K]["activation"])
                          for n in range(N)], device=device),
        train=train.to(device), table=table, cum=cum, params=params,
        m=[None if p is None else torch.zeros(p.shape, dtype=mdt,
                                              device=device) for p in params],
        v=[None if p is None else torch.zeros(p.shape, dtype=mdt,
                                              device=device) for p in params])


def step(run: Run, step_i: int, prec: str = "f32",
         fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Step ``step_i`` in place; returns each trained slot's gradient.
    ``fault="half_batch"`` leaves the second half of the batch out and
    doubles the first (the mean over the rest), for the check's faults."""
    W1, B1, W2, B2, W3, B3, W4, B4, WV, BV = run.params
    Bsz = run.batch

    def mm(a, b):
        return common.mm(a, b, prec)

    def tr(t):
        return t.transpose(1, 2)

    rows, types, elem_zero = common.sample_rows(
        run.seeds, run.n_valid, Bsz, step_i,
        (philox.ROW, philox.ELEM, philox.TYPE), run.cum, run.elem_p)
    x = run.train[run.fold.view(-1, 1), rows]
    xn = common.corrupt_rows(x, types, run.table, elem_zero(x.shape[-1]),
                             run.mask_value)
    if run.tied:
        W3, W4 = tr(W2), tr(W1)
    rw = torch.ones((1, Bsz, 1), device=x.device)
    if fault == "half_batch":
        rw[:, :Bsz // 2] = 2.0
        rw[:, Bsz // 2:] = 0.0

    z1 = mm(xn, W1) + B1.unsqueeze(1)
    d1 = common.dropout_factor(run.seeds, run.keep, philox.DROP1, step_i,
                               z1.shape)
    act1, grad1 = common.act_and_grad(z1, run.act)
    a1d, gf1 = act1 * d1, d1 * grad1
    mu = mm(a1d, W2) + B2.unsqueeze(1)
    if run.vae:
        lv = mm(a1d, WV) + BV.unsqueeze(1)
        eps = common.vae_eps(run.seeds, step_i, Bsz, mu.shape[2],
                             philox.EPS)
        z2 = mu + eps * torch.exp(lv)
    else:
        z2 = mu
    z3 = mm(z2, W3) + B3.unsqueeze(1)
    d3 = common.dropout_factor(run.seeds, run.keep, philox.DROP3, step_i,
                               z3.shape)
    act3, grad3 = common.act_and_grad(z3, run.act)
    a3d, gf3 = act3 * d3, d3 * grad3
    z4 = mm(a3d, W4) + B4.unsqueeze(1)

    g4 = (1.0 / (1.0 + torch.exp(-z4)) - x) * rw
    g3 = mm(g4, tr(W4)) * gf3
    gz = mm(g3, tr(W3))
    glv = None
    if run.vae:
        gz = gz + z2 * (1.0 / Bsz) * rw
        glv = gz * eps * torch.exp(lv) \
            + (torch.exp(2.0 * lv) - 1.0) * (1.0 / Bsz) * rw
    g1_pre = mm(gz, tr(W2))
    if run.vae:
        g1_pre = g1_pre + mm(glv, tr(WV))
    g1 = g1_pre * gf1

    alpha, es2 = common.adam_scalars(run.lr, step_i, run.decay)
    pen = (2.0 if run.tied else 1.0) * run.wpen

    def l2(w):
        return pen.view(-1, 1, 1) * w

    grads = {}
    if run.tied:
        grads["w1"] = mm(tr(xn), g1) + mm(tr(g4), a3d) + l2(W1)
        grads["w2"] = mm(tr(a1d), gz) + mm(tr(g3), z2) + l2(W2)
    else:
        grads["w1"] = mm(tr(xn), g1) + l2(W1)
        grads["w2"] = mm(tr(a1d), gz) + l2(W2)
        grads["w3"] = mm(tr(z2), g3) + l2(W3)
        grads["w4"] = mm(tr(a3d), g4) + l2(W4)
    if run.vae:
        grads["wv"] = mm(tr(a1d), glv) + l2(WV)
        grads["bv"] = glv.sum(dim=1)
    for name, g in (("b1", g1), ("b2", gz), ("b3", g3), ("b4", g4)):
        grads[name] = g.sum(dim=1)
    for name in SLOTS:
        if name in grads:
            common.adam(run.params, run.m, run.v, SLOTS.index(name),
                        grads[name], alpha, es2)
    return grads


def objective(run: Run, seed: int, val: torch.Tensor, n_val: torch.Tensor,
              noise: common.Noise, C: int, K: int,
              prec: str = "f32") -> torch.Tensor:
    """(C, K) noisy-val objective of the run's parameters, drawing its
    noise from the call's generator after the instance keys."""
    g = torch.Generator().manual_seed(int(seed))
    common.instance_keys(g, C * K)
    N = C * K
    dev = val.device
    rows = val.shape[1]
    x = val.unsqueeze(0).expand((C,) + tuple(val.shape)).reshape(
        (N,) + tuple(val.shape[1:]))
    p = dict(zip(SLOTS, run.params))
    with torch.no_grad():
        noisy = noise.corrupt(g, x)
        a1 = common.activate_per_instance(
            common.mm(noisy, p["w1"], prec) + p["b1"].unsqueeze(1), run.act)
        mu = common.mm(a1, p["w2"], prec) + p["b2"].unsqueeze(1)
        emb = mu
        if run.vae:
            lv = common.mm(a1, p["wv"], prec) + p["bv"].unsqueeze(1)
            eps = torch.randn(mu.shape, generator=g).to(dev)
            emb = mu + eps * torch.exp(lv)
        w3 = p["w2"].transpose(1, 2) if run.tied else p["w3"]
        w4 = p["w1"].transpose(1, 2) if run.tied else p["w4"]
        a3 = common.activate_per_instance(
            common.mm(emb, w3, prec) + p["b3"].unsqueeze(1), run.act)
        z = common.mm(a3, w4, prec) + p["b4"].unsqueeze(1)
        valid = (torch.arange(rows, device=dev).view(1, -1)
                 < n_val.to(dev).repeat(C).view(-1, 1))
        m = valid.to(z.dtype).unsqueeze(-1)
        bce = torch.relu(z) - z * x + torch.log1p(torch.exp(-z.abs()))
        loss = torch.sum(bce * m, dim=(-2, -1))
        loss = loss / torch.clamp(valid.to(torch.float32).sum(dim=-1), min=1)
    return loss.reshape(C, K)


def trained(run: Run) -> Dict[str, torch.Tensor]:
    """The trained slots by name."""
    return {s: t for s, t in zip(SLOTS, run.params) if t is not None}


def moments(run: Run) -> Dict[str, torch.Tensor]:
    """The first moment of every trained slot, as stored."""
    return {s: t for s, t in zip(SLOTS, run.m) if t is not None}
