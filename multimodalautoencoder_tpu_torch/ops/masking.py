"""Row-masked reconstruction losses and the missing-modality fill.

Counterpart of ``multimodalautoencoder_tpu/ops/masking.py``.
Config-parallel sweeps stack ragged CV folds into padded arrays; loss
reductions must then count only valid rows.  These equal
:mod:`..models.losses` when every row is valid.  Reductions run over the
last two axes, so a stack of instances ``(N, rows, F)`` with masks
``(N, rows)`` gets one loss per instance.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodalautoencoder_tpu_torch.models import losses as losses_lib

_LAST2 = (-2, -1)


def masked_reconstruction_loss(loss_name: str, decoded: torch.Tensor,
                               true_x: torch.Tensor,
                               row_valid: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Reference loss formulas with invalid rows excluded.

    mean_squared = sqrt(mean over valid elements); entropy losses = sum
    over valid rows (the reference sums over the whole tensor,
    multimodal_autoencoder.py:382-389)."""
    if row_valid is None:
        return losses_lib.reconstruction_loss(loss_name, decoded, true_x)
    m = row_valid.to(decoded.dtype).unsqueeze(-1)
    if loss_name == "mean_squared":
        se = torch.square(decoded - true_x) * m
        denom = torch.clamp(torch.sum(m, dim=_LAST2) * decoded.shape[-1],
                            min=1)
        return torch.sqrt(torch.sum(se, dim=_LAST2) / denom)
    if loss_name == "cross_entropy":
        return -torch.sum(true_x * torch.log(decoded) * m, dim=_LAST2)
    if loss_name == "sigmoid_cross_entropy":
        return torch.sum(losses_lib.sigmoid_bce_with_logits(decoded, true_x)
                         * m, dim=_LAST2)
    raise ValueError(f"unknown loss {loss_name!r}")


def masked_report_scale(loss_name: str, loss: torch.Tensor,
                        row_valid: Optional[torch.Tensor],
                        num_rows) -> torch.Tensor:
    """Entropy losses divide by the number of REAL rows for reporting
    (multimodal_autoencoder.py:733-735)."""
    if "entropy" not in loss_name:
        return loss
    if row_valid is None:
        return loss / num_rows
    n = torch.clamp(torch.sum(row_valid.to(torch.float32), dim=-1), min=1)
    return loss / n


def missing_modality_matrix(x: torch.Tensor, modality_masks: torch.Tensor,
                            mask_value: float = -1.0) -> torch.Tensor:
    """(rows, num_modalities) bool: modality m is missing in row r iff its
    span sums to ``mask_value`` times its width (data_funcs.py:366-381)."""
    mm = modality_masks.to(device=x.device, dtype=x.dtype)    # (M, F)
    span_sums = x @ mm.T                                       # (rows, M)
    widths = torch.sum(mm, dim=1)                              # (M,)
    return span_sums == mask_value * widths


def fill_missing_with_reconstruction(x: torch.Tensor, recon: torch.Tensor,
                                     modality_masks: torch.Tensor,
                                     mask_value: float = -1.0
                                     ) -> torch.Tensor:
    """Overwrite only the missing modalities' entries with the
    reconstruction: the device-side core of fill_df_with_reconstruction
    (data_funcs.py:310-364)."""
    missing = missing_modality_matrix(x, modality_masks, mask_value)
    feat_missing = (missing.to(torch.float32)
                    @ modality_masks.to(device=x.device,
                                        dtype=torch.float32)) > 0
    return torch.where(feat_missing, recon, x)
