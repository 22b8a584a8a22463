"""Waveform-domain enhancement loss of the DCCRN family (port of
``sonicsim_tpu.losses.enhancement``; reference
enhancement/look2hear/losses/dccrn_loss.py): the negative SI-SNR between
the enhanced waveform and the clean target, for training and evaluation
alike."""

from __future__ import annotations

import torch

from .sdr import singlesrc_neg_sdr


def single_channel(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, T) → (B, T); (B, T) as it is."""
    return x[:, 0] if x.dim() == 3 else x


class DCCRNLoss:
    def __init__(self, sdr_type: str = "sisdr"):
        self.sdr_type = sdr_type

    def __call__(self, ests: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        return torch.mean(singlesrc_neg_sdr(single_channel(ests), single_channel(refs),
                                            self.sdr_type))


DCCRNEval = DCCRNLoss
