"""Helpers the entry adapters share: the configuration's corruption for
the reference, initial parameters drawn on the device, and the program's
parameter tuples as dicts of (instance, tensor) leaves."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench_port.reference import common


def noise_of(doc: dict, study) -> common.Noise:
    m = doc["model"]
    return common.Noise(study.widths, study.names, m["noise_types"],
                        m["noise_type_percentages"],
                        m["element_dropout_frac"], m["mask_with"])


def draw_params(gen: torch.Generator, F: int, H1: int, H2: int, tied: bool,
                vae: bool, lead, device) -> Dict[str, torch.Tensor]:
    """Initial parameters of a stack with leading axes ``lead``, one
    draw a tensor on the device: normals with stddev 1/sqrt(fan_in)
    clamped at 2 sigma, biases 0.1."""
    def w(i, o):
        t = torch.randn(tuple(lead) + (i, o), generator=gen, device=device)
        return t.clamp_(-2.0, 2.0).mul_(1.0 / float(np.sqrt(i)))

    def b(o):
        return torch.full(tuple(lead) + (o,), 0.1, device=device)

    p = {"w1": w(F, H1), "b1": b(H1), "w2": w(H1, H2), "b2": b(H2),
         "b3": b(H1), "b4": b(F)}
    if not tied:
        p["w3"], p["w4"] = w(H2, H1), w(H1, F)
    if vae:
        p["wv"], p["bv"] = w(H1, H2), b(H2)
    return p


def as_mmae_params(p: Dict[str, torch.Tensor]):
    from multimodalautoencoder_tpu_torch.models import mmae

    return mmae.MMAEParams(
        enc_w=(p["w1"], p["w2"]), enc_b=(p["b1"], p["b2"]),
        dec_w=(p["w3"], p["w4"]) if "w3" in p else (),
        dec_b=(p["b3"], p["b4"]), var_w=p.get("wv"), var_b=p.get("bv"),
        cls_w=(), cls_b=())


def from_mmae_params(params) -> Dict[str, torch.Tensor]:
    out = {"w1": params.enc_w[0], "w2": params.enc_w[1],
           "b1": params.enc_b[0], "b2": params.enc_b[1],
           "b3": params.dec_b[0], "b4": params.dec_b[1]}
    if params.dec_w:
        out["w3"], out["w4"] = params.dec_w
    if params.var_w is not None:
        out["wv"], out["bv"] = params.var_w, params.var_b
    return out


def flat(p: Dict[str, torch.Tensor], N: int) -> Dict[str, torch.Tensor]:
    return {k: t.reshape((N,) + tuple(t.shape[2:])) for k, t in p.items()}
