"""Reconstruction and classification losses, faithful to the reference.

Counterpart of ``multimodalautoencoder_tpu/models/losses.py``.  Every
reduction runs over the last two axes
(rows, features) of a batch, so a stack of instances ``(N, rows, F)``
gets one loss per instance, as ``vmap`` gives in the JAX package.
Reference semantics (multimodal_autoencoder.py :380-408):

- ``mean_squared``: RMSE over the *whole batch tensor* (:382-384).
- ``cross_entropy``: ``-sum(x * log(recon))`` on the raw decoder output
  (:385-386).
- ``sigmoid_cross_entropy``: *summed* sigmoid BCE on logits (:387-389).
- Entropy-family losses are divided by the batch size for *reporting only*
  (:733-735, :948-949) — see :func:`report_scale`.
- ``tf.nn.l2_loss`` is ``sum(w^2)/2`` — mirrored in :func:`l2`.
"""

from __future__ import annotations

from typing import Sequence

import torch


_LAST2 = (-2, -1)


def l2(w: torch.Tensor) -> torch.Tensor:
    """TF-style l2_loss: sum(w**2) / 2 over the last two axes (a weight
    matrix, or each of a stack of them)."""
    return torch.sum(torch.square(w), dim=_LAST2) / 2.0


def sigmoid_bce_with_logits(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """Elementwise, numerically-stable sigmoid cross entropy
    (== tf.nn.sigmoid_cross_entropy_with_logits)."""
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def reconstruction_loss(loss_name: str, decoded: torch.Tensor,
                        true_x: torch.Tensor) -> torch.Tensor:
    """Reconstruction loss of a (rows, F) batch (one per instance of a
    stack); for sigmoid-CE ``decoded`` are logits."""
    if loss_name == "mean_squared":
        return torch.sqrt(torch.mean(torch.square(decoded - true_x),
                                     dim=_LAST2))
    if loss_name == "cross_entropy":
        return -torch.sum(true_x * torch.log(decoded), dim=_LAST2)
    if loss_name == "sigmoid_cross_entropy":
        return torch.sum(sigmoid_bce_with_logits(decoded, true_x),
                         dim=_LAST2)
    raise ValueError(f"unknown loss {loss_name!r}")


def kl_divergence_rows(z_or_mu: torch.Tensor,
                       log_var: torch.Tensor) -> torch.Tensor:
    """Per-row KL term, exactly the reference formula
    ``-0.5 * sum(1 + 2*log_var - z^2 - exp(2*log_var))`` (:402-405); the
    reference's ``log_var`` is log(sigma), as its sampling uses it."""
    return -0.5 * torch.sum(
        1.0 + 2.0 * log_var - torch.square(z_or_mu)
        - torch.exp(2.0 * log_var), dim=-1)


def weight_regularization(penalty,
                          weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """``penalty * sum(l2(w))`` over the given weight list (:392-397).
    ``penalty`` is a float or, for a stack of instances, an (N,) tensor."""
    if len(weights) == 0:
        return torch.zeros(())
    return penalty * sum(l2(w) for w in weights)


def report_scale(loss_name: str, loss: torch.Tensor,
                 batch_rows: int) -> torch.Tensor:
    """Divide entropy-family losses by batch size for reporting (:733-735)."""
    if "entropy" in loss_name:
        return loss / batch_rows
    return loss


def classification_loss(loss_name: str, logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean classification loss of a (rows, L) batch, one per instance of
    a stack (multimodal_autoencoder.py:431-438): sigmoid-CE averages over
    rows and labels; softmax is the sparse cross entropy of (rows,)
    integer labels, averaged over rows."""
    if loss_name == "sigmoid_cross_entropy":
        return torch.mean(sigmoid_bce_with_logits(logits, labels),
                          dim=_LAST2)
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long().unsqueeze(-1))[..., 0]
    return -torch.mean(picked, dim=-1)


def classification_predictions(loss_name: str,
                               logits: torch.Tensor) -> torch.Tensor:
    """The reference's prediction rule (:446-450): sigmoid-CE rounds each
    label's probability (half to even, as ``jnp.round``); softmax takes
    the argmax.  int32."""
    probs = 1.0 / (1.0 + torch.exp(-logits))
    if loss_name == "sigmoid_cross_entropy":
        return torch.round(probs).to(torch.int32)
    return torch.argmax(probs, dim=-1).to(torch.int32)
