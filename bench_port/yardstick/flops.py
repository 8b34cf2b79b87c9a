"""Useful floating-point work of one instance-step: frozen copies of the
port's ``utils/flops.train_step_flops`` and ``cls_train_step_flops``
(themselves copied from the JAX package), taking plain widths.

``mxu`` is the products' FLOPs (forward, backward data and weight
gradients, 2 per multiply-add), with nothing recomputed and no Adam: the
numerator of ``mfu_f32``.  ``vpu`` is an estimate of the elementwise work
and is not used by any metric.
"""

from __future__ import annotations

from typing import Dict, Sequence


def train_step_flops(feats: int, h1: int, h2: int, tied: bool,
                     variational: bool, batch: int) -> Dict[str, float]:
    """One phase-1 step of one (setting, fold) instance."""
    B, F, H1, H2 = batch, feats, h1, h2
    # forward x@W1, a1@W2, z2@W3, a3@W4 (+ a1@Wv)
    fwd = 2 * B * (F * H1 + H1 * H2 + H2 * H1 + H1 * F)
    # backward data g4@W4^T, g3@W3^T, g2@W2^T (+ glv@Wv^T)
    bwd_data = 2 * B * (F * H1 + H1 * H2 + H2 * H1)
    # weight gradients (tied weights take four products into two tensors)
    bwd_w = 2 * B * (F * H1 + H1 * H2 + H2 * H1 + H1 * F)
    if variational:
        fwd += 2 * B * H1 * H2
        bwd_data += 2 * B * H2 * H1
        bwd_w += 2 * B * H1 * H2
    mxu = float(fwd + bwd_data + bwd_w)
    w_elems = F * H1 + H1 * H2
    if not tied:
        w_elems += H2 * H1 + H1 * F
    if variational:
        w_elems += H1 * H2
    adam_elems = w_elems + 2 * H1 + H2 + F + (H2 if variational else 0)
    vpu = float(12.0 * B * (F + H1 + H2) + 11.0 * adam_elems)
    return {"mxu": mxu, "vpu": vpu, "total": mxu + vpu,
            "adam_elems": float(adam_elems)}


def cls_train_step_flops(feats: int, h1: int, h2: int, head: Sequence[int],
                         n_labels: int, variational: bool, batch: int
                         ) -> Dict[str, float]:
    """One phase-2 step of one instance: encoder forward, the head's
    forward, backward through the head and the encoder, weight
    gradients; the decoder never runs."""
    B, F, H1, H2 = batch, feats, h1, h2
    dims = [H2] + list(head) + [n_labels]
    fwd = 2 * B * (F * H1 + H1 * H2)
    if variational:
        fwd += 2 * B * H1 * H2
    hd = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    fwd += 2 * B * hd
    bwd = 2 * B * (2 * hd) + 2 * B * (H1 * H2 + F * H1 + H1 * H2)
    if variational:
        bwd += 2 * B * (2 * H1 * H2)
    mxu = float(fwd + bwd)
    w_elems = F * H1 + H1 * H2 + hd + (H1 * H2 if variational else 0)
    b_elems = H1 + H2 + sum(dims[1:]) + (H2 if variational else 0)
    adam_elems = w_elems + b_elems
    vpu = float(10.0 * B * (F + H1 + H2 + sum(dims[1:]))
                + 11.0 * adam_elems)
    return {"mxu": mxu, "vpu": vpu, "total": mxu + vpu,
            "adam_elems": float(adam_elems)}
