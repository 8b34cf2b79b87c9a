"""On-device embedding-quality probe.

Counterpart of ``multimodalautoencoder_tpu/sweep/probe.py`` (:49-203).
The reference probes each trained MMAE's embedding by fitting RBF-SVMs (C x
gamma grid, 3 labels) on the embedded classification data and keeping the
best (acc AND auc) per label on val / noisy-val / clean-val
(autoencoder_wrapper.py:202-284).  This module computes the probe where
the parameters are, as an RBF ridge classifier (least-squares SVM) with
the same best-(acc AND auc) tracking, in one of two modes:

- ``rff_dim=D`` (the sweep's default, D = 512): the RBF kernel
  approximated by D random Fourier features and the primal (D, D) ridge
  system solved;
- ``rff_dim=None``: the exact (T, T) kernel-ridge dual.

Ridge with lambda = 1/(2C) is the least-squares analog of SVC(C); probe
values compare with libsvm's in distribution, not bit for bit. It is plain
PyTorch (``torch.linalg.cholesky`` and ``torch.cholesky_solve``), as the
JAX package leaves it to XLA: no Pallas kernel stands behind it.  Configs
run one after another and each config's folds and labels as one batch,
the JAX package's ``lax.map`` over configs with the folds vmapped.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.ops import metrics as metrics_lib
from multimodalautoencoder_tpu_torch.ops import optim


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (..., rows_a, rows_b): one product plus
    the rank-1 terms, clamped at 0."""
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    d2 = a2.unsqueeze(-1) + b2.unsqueeze(-2) - 2.0 * (a @ b.transpose(-2, -1))
    return d2.clamp(min=0.0)


def _ridge_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the symmetric positive definite systems ``a x = rhs``
    (``jax.scipy.linalg.solve(assume_a="pos")``).  A system that is not
    positive definite (a diverged instance's NaN embedding) gives NaN
    scores, whose predictions are all 0, as in the JAX package, rather
    than an error."""
    factor, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(rhs.unsqueeze(-1), factor).squeeze(-1)


def _best_update(best: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Keep a candidate (..., 3, 2) [acc, auc] per slice only where both
    acc and auc beat the incumbent (svm_pred_best_result, :272-284); NaN
    never wins."""
    better = ((cand[..., 0] > best[..., 0])
              & (cand[..., 1] > best[..., 1])).unsqueeze(-1)
    return torch.where(better, cand, best)


def _probe_instance(params, act_id, tx, tn, ty, vx, vn, vy, vnoisy, *,
                    cfg: MMAEConfig, Cs: Sequence[float],
                    gammas: Sequence[float], rff_dim: Optional[int],
                    generator: torch.Generator, rff=None) -> torch.Tensor:
    """One config's probe on its K folds at once -> (K, L, 3, 2) best
    [acc, auc] for the val / noisy-val / clean-val slices.

    ``params`` has a leading K axis; ``act_id`` is (K,); ``tx`` (K, T, F)
    with ``tn`` (K,) valid rows and labels ``ty`` (K, T, L); ``vx``, ``vn``,
    ``vy`` likewise for the val rows, ``vnoisy`` (K, V) their noisy flags.
    The VAE embeds with z sampled from ``generator``, as the reference's
    probe does (:80-85, multimodal_autoencoder.py:372-375).  With
    ``rff_dim``, ``rff`` = (W (K, E, D), b (K, D)) are the directions and
    phases (drawn from ``generator`` when None): phi_g(x) = sqrt(2/D)
    cos(sqrt(2 g) x W + b)."""
    K, T, _ = tx.shape
    V = vx.shape[1]
    dev = tx.device
    with torch.no_grad():
        emb_tr = mmae.forward(params, cfg, tx, generator=generator,
                              keep_prob=1.0, train=False, sample=True,
                              act_id=act_id).embedding
        emb_va = mmae.forward(params, cfg, vx, generator=generator,
                              keep_prob=1.0, train=False, sample=True,
                              act_id=act_id).embedding
    t_valid = torch.arange(T, device=dev).view(1, -1) < tn.view(-1, 1)
    v_valid = torch.arange(V, device=dev).view(1, -1) < vn.view(-1, 1)
    # labels leading: (K, L, rows)
    y_tr = ty.permute(0, 2, 1).contiguous()
    y_va = vy.permute(0, 2, 1).contiguous()
    m = (t_valid.unsqueeze(1) & torch.isfinite(y_tr)).to(torch.float32)
    # signed targets on valid rows; invalid rows decouple (their kernel
    # row and column are zeroed and their diagonal is 1, so alpha_i = 0)
    ys = (2.0 * torch.where(m > 0, y_tr, torch.zeros_like(y_tr)) - 1.0) * m
    vm = v_valid.unsqueeze(1) & torch.isfinite(y_va)
    noisy = vnoisy.unsqueeze(1)
    slices = (vm, vm & noisy, vm & ~noisy)
    y_va_f = torch.where(torch.isfinite(y_va), y_va, torch.zeros_like(y_va))
    if rff_dim is None:
        d2_tr = _sqdist(emb_tr, emb_tr).unsqueeze(1)        # (K, 1, T, T)
        d2_va = _sqdist(emb_va, emb_tr).unsqueeze(1)        # (K, 1, V, T)
    else:
        if rff is None:
            E = emb_tr.shape[-1]
            W = torch.randn((K, E, rff_dim), generator=generator,
                            device=generator.device).to(dev)
            b = (torch.rand((K, rff_dim), generator=generator,
                            device=generator.device) * (2.0 * math.pi)).to(dev)
        else:
            W, b = (t.to(dev, torch.float32) for t in rff)
        proj_tr, proj_va = emb_tr @ W, emb_va @ W
        scale = math.sqrt(2.0 / rff_dim)
    best = torch.zeros(y_tr.shape[:2] + (3, 2), device=dev)
    for g in gammas:
        if rff_dim is None:
            k_tr = torch.exp(-g * d2_tr) * (m.unsqueeze(-1) * m.unsqueeze(-2))
            k_va = torch.exp(-g * d2_va)
        else:
            root = math.sqrt(2.0 * g)
            ph_tr = scale * torch.cos(root * proj_tr + b.unsqueeze(1))
            ph_va = scale * torch.cos(root * proj_va + b.unsqueeze(1))
            ph_m = ph_tr.unsqueeze(1) * m.unsqueeze(-1)     # (K, L, T, D)
            gram = ph_m.transpose(-2, -1) @ ph_m
            rhs = (ph_m.transpose(-2, -1) @ ys.unsqueeze(-1)).squeeze(-1)
        for c_reg in Cs:
            lam = 1.0 / (2.0 * c_reg)
            if rff_dim is None:
                a = k_tr + torch.diag_embed((1.0 - m) + lam * m)
                alpha = _ridge_solve(a, ys)
                scores = (k_va @ alpha.unsqueeze(-1)).squeeze(-1)
            else:
                a = gram + lam * torch.eye(rff_dim, device=dev)
                beta = _ridge_solve(a, rhs)
                scores = (ph_va.unsqueeze(1) @ beta.unsqueeze(-1)).squeeze(-1)
            preds = (scores > 0).to(torch.float32)
            cand = torch.stack([torch.stack(
                [metrics_lib.binary_accuracy(preds, y_va_f, sl),
                 metrics_lib.roc_auc(preds, y_va_f, sl)], -1)
                for sl in slices], -2)                      # (K, L, 3, 2)
            best = _best_update(best, cand)
    return best


def probe_grid(seed: int, params_stacked, act_ids: torch.Tensor, folded, *,
               cfg: MMAEConfig, Cs: Tuple[float, ...],
               gammas: Tuple[float, ...], num_labels: int,
               rff_dim: Optional[int] = None, rff=None) -> torch.Tensor:
    """Probe every (config, fold) instance of a trained bucket.

    ``params_stacked``: (C, K, ...) parameters from the grid trainer;
    ``act_ids``: (C,); ``folded``: the supervised classification
    ``FoldedData`` (labels, optional ``val_noisy``).  ``seed`` seeds the
    CPU generator that draws each config's VAE eps and random-Fourier
    directions in turn; ``rff`` = (W (C, K, E, D), b (C, K, D)) replaces
    the directions.  Returns (C, K, L, 3, 2): [val, noisy, clean] x
    [acc, auc] best metrics, on the device of ``folded``.  ``rff_dim``:
    None = the exact (T, T) kernel ridge; D = the D-feature primal."""
    cfg = cfg.validate()
    C = int(act_ids.shape[0])
    K = folded.num_folds
    dev = folded.train_x.device
    ty, vy = folded.train_y, folded.val_y
    if ty.dim() == 2:                  # single label -> (rows, 1)
        ty, vy = ty.unsqueeze(-1), vy.unsqueeze(-1)
    ty, vy = ty[..., :num_labels], vy[..., :num_labels]
    vnoisy = (folded.val_noisy if folded.val_noisy is not None
              else torch.zeros(folded.val_x.shape[:2], dtype=torch.bool,
                               device=dev))
    generator = torch.Generator().manual_seed(int(seed))
    out = []
    for c in range(C):
        p_c = optim.tree_map(lambda t: t[c].to(dev), params_stacked)
        out.append(_probe_instance(
            p_c, act_ids[c].to(dev).repeat(K), folded.train_x,
            folded.train_n.to(dev), ty.to(dev, torch.float32), folded.val_x,
            folded.val_n.to(dev), vy.to(dev, torch.float32), vnoisy.to(dev),
            cfg=cfg, Cs=Cs, gammas=gammas, rff_dim=rff_dim,
            generator=generator,
            rff=None if rff is None else (rff[0][c], rff[1][c])))
    return torch.stack(out)
