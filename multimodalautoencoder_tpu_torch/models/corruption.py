"""Structured corruption (denoising-autoencoder noise) on tensors.

Counterpart of ``multimodalautoencoder_tpu/models/corruption.py``, with its
(XLA-path) semantics.  The reference corrupts each batch row by row
(multimodal_autoencoder.py:668-702): (a) zero ``k = int(F *
element_dropout_frac)`` features drawn *with replacement*, then (b) blank
whole modalities, either by a categorical draw over the "intelligent noise"
modality sets (:200-206, :686-695) or by ``num_modalities_to_drop`` uniform
draws of single modalities (:696-700).  Masking writes ``mask_with`` over
the chosen spans and so overwrites element zeros there (:649-666).

The training kernels (``ops/train_kernels.py``) follow the Pallas kernel's
semantics instead: Bernoulli zeroing at the marginal rate ``1-(1-1/F)^k``.
Draws come from a ``torch.Generator`` on its own device and are moved to
the batch's device, so a seed gives the same noise on the CPU and the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """Tables driving corruption.

    type_masks:      (num_types, F) bool: features of each intelligent-noise
                     modality set (a union of modalities).
    type_log_probs:  (num_types,) float32: log of the sets' probabilities.
    modality_masks:  (num_modalities, F) bool: features of each modality,
                     used in uniform-drop mode.
    """

    type_masks: torch.Tensor
    type_log_probs: torch.Tensor
    modality_masks: torch.Tensor
    mask_with: float
    num_element_drops: int          # int(F * element_dropout_frac)
    num_modalities_to_drop: int
    intelligent: bool

    @classmethod
    def build(cls, cfg: MMAEConfig, table: ModalityTable) -> "NoiseSpec":
        cfg = cfg.validate()
        if cfg.intelligent_noise:
            type_masks = table.noise_type_masks(cfg.noise_types)
            probs = np.asarray(cfg.noise_type_percentages, dtype=np.float32)
        else:
            # single no-op type; uniform mode uses modality_masks instead
            type_masks = np.zeros((1, table.num_feats), dtype=bool)
            probs = np.ones((1,), dtype=np.float32)
        return cls(
            type_masks=torch.as_tensor(type_masks),
            type_log_probs=torch.log(torch.as_tensor(probs)),
            modality_masks=torch.as_tensor(table.feature_masks()),
            mask_with=float(cfg.mask_with),
            num_element_drops=int(table.num_feats * cfg.element_dropout_frac),
            num_modalities_to_drop=cfg.num_modalities_to_drop,
            intelligent=bool(cfg.intelligent_noise),
        )

    def to(self, device) -> "NoiseSpec":
        """The same spec with its tables on ``device``, so that corrupting
        a batch there copies nothing from the host."""
        return dataclasses.replace(
            self, type_masks=self.type_masks.to(device),
            type_log_probs=self.type_log_probs.to(device),
            modality_masks=self.modality_masks.to(device))


def add_noise_to_batch(generator: Optional[torch.Generator], x: torch.Tensor,
                       spec: NoiseSpec,
                       forced_type_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Corrupt a (..., rows, F) batch; every row draws its own noise.

    ``forced_type_mask``: optional (F,) bool mask applied to every row in
    place of the sampled modality drop (the reference's ``missing_modes``
    argument, :691-692)."""
    g = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    lead, num_feats = tuple(x.shape[:-1]), x.shape[-1]
    dev = x.device

    # (a) k features per row, drawn with replacement like np.random.choice
    # (:682): collisions make the zeroed share at most k / F
    if spec.num_element_drops > 0:
        idx = torch.randint(0, num_feats, lead + (spec.num_element_drops,),
                            generator=g, device=g.device).to(dev)
        zero = torch.zeros(lead + (num_feats,), dtype=torch.bool, device=dev)
        zero.scatter_(-1, idx, True)
        x = torch.where(zero, torch.zeros((), dtype=x.dtype, device=dev), x)

    # (b) whole modalities
    if forced_type_mask is not None:
        mod_mask = forced_type_mask.to(dev).expand(x.shape)
    elif spec.intelligent:
        probs = torch.exp(spec.type_log_probs.to(torch.float64))
        n = int(np.prod(lead)) if lead else 1
        # at least two draws: torch's one-draw path reads the
        # probabilities back to the host, which a step captured in a
        # CUDA graph cannot do (the draws are independent either way)
        t = torch.multinomial(probs.to(g.device), max(n, 2),
                              replacement=True, generator=g)[:n]
        t = t.reshape(lead).to(dev)
        mod_mask = spec.type_masks.to(dev)[t]
    else:
        num_mods = spec.modality_masks.shape[0]
        draws = torch.randint(0, num_mods,
                              lead + (max(spec.num_modalities_to_drop, 1),),
                              generator=g, device=g.device).to(dev)
        mod_mask = spec.modality_masks.to(dev)[draws].any(dim=-2)
        if spec.num_modalities_to_drop == 0:
            mod_mask = torch.zeros_like(mod_mask)
    return torch.where(mod_mask,
                       torch.full((), spec.mask_with, dtype=x.dtype,
                                  device=dev), x)
