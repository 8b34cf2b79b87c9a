"""Plain reference of a phase-2 call: a classification bucket trained on
phase-1 encoders, then its val predictions.

It follows what ``train_phase2_shared_sharded(..., backend="pallas")``
states it computes for each (setting, fold) instance ``n = c * K + k``:
the encoder of the setting's phase-1 row (``p1_map``) on fold k; the
call's CPU generator, seeded with the call's seed, draws every
instance's fresh head (truncated normals, biases 0.1), then the Philox
keys, then the VAE's evaluation noise.  Each step samples B labelled rows
of fold k with replacement, corrupts them, runs the encoder (dropout at
the head's keep probability) and the head (activation and dropout on its
first layer only, as the reference's gate on the decoder's depth does),
takes the gradient of the sigmoid cross entropy averaged over rows and
labels plus L2 on the head's weights, through the encoder (no KL), and
moves encoder and head by Adam at the constant lr.  Products run in
``prec``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench_port.reference import common, philox

SLOTS = ("w1", "b1", "w2", "b2", "wv", "bv", "c1", "cb1", "c2", "cb2", "c3",
         "cb3")


@dataclasses.dataclass
class Run:
    vae: bool
    elem_p: float
    mask_value: float
    batch: int
    gates: Tuple[bool, ...]
    dims: Tuple[int, ...]
    seeds: torch.Tensor
    fold: torch.Tensor
    n_valid: torch.Tensor
    lr: torch.Tensor
    keep: torch.Tensor
    wpen: torch.Tensor
    eact: torch.Tensor
    cact: torch.Tensor
    train: torch.Tensor
    labels: torch.Tensor
    table: torch.Tensor
    cum: torch.Tensor
    params: List[Optional[torch.Tensor]]
    m: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]
    eval_eps: Optional[torch.Tensor] = None

    @property
    def n_cls(self) -> int:
        return len(self.dims) - 1


def head_gates(n_layers: int, encoder_depth: int) -> Tuple[bool, ...]:
    """Which head layers take activation and dropout: those below the
    encoder's depth minus one (the reference's gate)."""
    return tuple(j < encoder_depth - 1 for j in range(n_layers))


def start(seed: int, encoder: Dict[str, torch.Tensor], settings, K: int,
          train: torch.Tensor, labels: torch.Tensor, n_train: torch.Tensor,
          noise: common.Noise, recipe: dict, dims: Sequence[int], vae: bool,
          val_rows: int, device) -> Run:
    """A call's state: ``encoder`` maps w1, b1, w2, b2 (wv, bv) to the
    (N, ...) phase-1 tensors each instance starts from; ``dims`` is the
    head's [H2, ..., L]; ``settings`` holds each setting's head keep
    probability, head penalty and the two activations."""
    g = torch.Generator().manual_seed(int(seed))
    C = len(settings)
    N = C * K
    heads = common.fresh_heads(g, dims, N)
    seeds = common.instance_keys(g, N).to(device)

    def per_inst(key, dtype):
        return torch.tensor([settings[n // K][key] for n in range(N)],
                            dtype=dtype, device=device)

    mdt = torch.bfloat16 if recipe["moments"] == "bfloat16" else \
        torch.float32
    params: List[Optional[torch.Tensor]] = [
        None if encoder.get(s) is None else
        encoder[s].to(device, torch.float32).clone() for s in SLOTS[:6]]
    for j in range(3):
        if j < len(heads):
            params += [heads[j][0].to(device), heads[j][1].to(device)]
        else:
            params += [None, None]
    table, cum = noise.tables(device)
    eval_eps = None
    if vae:
        eval_eps = torch.randn((N, val_rows, dims[0]), generator=g).to(device)
    return Run(
        vae=vae, elem_p=noise.elem_p, mask_value=noise.mask_with,
        batch=int(recipe["batch_size"]),
        gates=head_gates(len(dims) - 1, int(recipe["encoder_depth"])),
        dims=tuple(dims), seeds=seeds,
        fold=torch.arange(K, device=device).repeat(C),
        n_valid=n_train.to(device).repeat(C),
        lr=torch.full((N,), float(recipe["learning_rate"]),
                      dtype=torch.float32, device=device),
        keep=per_inst("dropout_prob", torch.float32),
        wpen=per_inst("weight_penalty", torch.float32),
        eact=torch.tensor([common.activation_id(s["mmae_activation"])
                           for s in settings for _ in range(K)],
                          device=device),
        cact=torch.tensor([common.activation_id(s["activation"])
                           for s in settings for _ in range(K)],
                          device=device),
        train=train.to(device), labels=labels.to(device), table=table,
        cum=cum, params=params,
        m=[None if p is None else torch.zeros(p.shape, dtype=mdt,
                                              device=device) for p in params],
        v=[None if p is None else torch.zeros(p.shape, dtype=mdt,
                                              device=device) for p in params],
        eval_eps=eval_eps)


def step(run: Run, step_i: int, prec: str = "f32",
         fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Step ``step_i`` in place; returns each trained slot's gradient.
    ``fault="half_batch"`` as in ``phase1.step``."""
    W1, B1, W2, B2, WV, BV = run.params[:6]
    Bsz, nc = run.batch, run.n_cls

    def mm(a, b):
        return common.mm(a, b, prec)

    def tr(t):
        return t.transpose(1, 2)

    rows, types, elem_zero = common.sample_rows(
        run.seeds, run.n_valid, Bsz, step_i,
        (philox.CLS_ROW, philox.CLS_ELEM, philox.CLS_TYPE), run.cum,
        run.elem_p)
    fold = run.fold.view(-1, 1)
    x, y = run.train[fold, rows], run.labels[fold, rows]
    xn = common.corrupt_rows(x, types, run.table, elem_zero(x.shape[-1]),
                             run.mask_value)
    rw = torch.ones((1, Bsz, 1), device=x.device)
    if fault == "half_batch":
        rw[:, :Bsz // 2] = 2.0
        rw[:, Bsz // 2:] = 0.0

    z1 = mm(xn, W1) + B1.unsqueeze(1)
    d1 = common.dropout_factor(run.seeds, run.keep, philox.CLS_DROP1,
                               step_i, z1.shape)
    act1, grad1 = common.act_and_grad(z1, run.eact)
    a1d, gf1 = act1 * d1, d1 * grad1
    mu = mm(a1d, W2) + B2.unsqueeze(1)
    if run.vae:
        lv = mm(a1d, WV) + BV.unsqueeze(1)
        eps = common.vae_eps(run.seeds, step_i, Bsz, mu.shape[2],
                             philox.CLS_EPS)
        emb = mu + eps * torch.exp(lv)
    else:
        emb = mu

    hs, gfs = [emb], [None]
    for j in range(nc):
        zc = mm(hs[j], run.params[6 + 2 * j]) \
            + run.params[7 + 2 * j].unsqueeze(1)
        if run.gates[j]:
            d = common.dropout_factor(run.seeds, run.keep,
                                      philox.CLS_HEAD_DROP + j, step_i,
                                      zc.shape)
            act, grad = common.act_and_grad(zc, run.cact)
            hs.append(act * d)
            gfs.append(d * grad)
        else:
            hs.append(zc)
            gfs.append(None)

    g = (torch.sigmoid(hs[nc]) - y) / (Bsz * y.shape[-1]) * rw
    if run.gates[nc - 1]:
        g = g * gfs[nc]
    gcs: List[Optional[torch.Tensor]] = [None] * (nc + 1)
    gcs[nc] = g
    for j in range(nc - 1, -1, -1):
        g = mm(gcs[j + 1], tr(run.params[6 + 2 * j]))
        if j > 0:
            gcs[j] = g * gfs[j] if run.gates[j - 1] else g
    gemb = g
    g1_pre = mm(gemb, tr(W2))
    glv = None
    if run.vae:
        glv = gemb * eps * torch.exp(lv)
        g1_pre = g1_pre + mm(glv, tr(WV))
    g1 = g1_pre * gf1

    alpha, es2 = common.adam_scalars(run.lr, step_i, None)
    grads = {"w1": mm(tr(xn), g1), "w2": mm(tr(a1d), gemb),
             "b1": g1.sum(dim=1), "b2": gemb.sum(dim=1)}
    if run.vae:
        grads["wv"] = mm(tr(a1d), glv)
        grads["bv"] = glv.sum(dim=1)
    for j in range(nc):
        w = run.params[6 + 2 * j]
        grads[SLOTS[6 + 2 * j]] = mm(tr(hs[j]), gcs[j + 1]) \
            + run.wpen.view(-1, 1, 1) * w
        grads[SLOTS[7 + 2 * j]] = gcs[j + 1].sum(dim=1)
    for name in SLOTS:
        if name in grads:
            common.adam(run.params, run.m, run.v, SLOTS.index(name),
                        grads[name], alpha, es2)
    return grads


def val_logits(params: Dict[str, torch.Tensor], run: Run, val: torch.Tensor,
               C: int, prec: str = "f32") -> torch.Tensor:
    """(N, rows, L) logits of every instance on its fold's padded val
    rows: no noise, no dropout; a VAE samples its embedding with the
    call's evaluation noise."""
    N = params["w1"].shape[0]
    x = val.unsqueeze(0).expand((C,) + tuple(val.shape)).reshape(
        (N,) + tuple(val.shape[1:]))
    with torch.no_grad():
        a1 = common.activate_per_instance(
            common.mm(x, params["w1"], prec) + params["b1"].unsqueeze(1),
            run.eact)
        h = common.mm(a1, params["w2"], prec) + params["b2"].unsqueeze(1)
        if run.vae:
            lv = common.mm(a1, params["wv"], prec) \
                + params["bv"].unsqueeze(1)
            h = h + run.eval_eps * torch.exp(lv)
        for j in range(run.n_cls):
            h = common.mm(h, params[SLOTS[6 + 2 * j]], prec) \
                + params[SLOTS[7 + 2 * j]].unsqueeze(1)
            if run.gates[j]:
                h = common.activate_per_instance(h, run.cact)
    return h


def predictions(logits: torch.Tensor) -> torch.Tensor:
    """Each label's probability rounded half to even, int32."""
    return torch.round(1.0 / (1.0 + torch.exp(-logits))).to(torch.int32)


def trained(run: Run) -> Dict[str, torch.Tensor]:
    return {s: t for s, t in zip(SLOTS, run.params) if t is not None}


def moments(run: Run) -> Dict[str, torch.Tensor]:
    return {s: t for s, t in zip(SLOTS, run.m) if t is not None}
