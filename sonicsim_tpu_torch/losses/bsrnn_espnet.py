"""BSRNN-ESPnet's losses (port of ``sonicsim_tpu.losses.bsrnn_espnet``;
reference enhancement/look2hear/losses/bsrnn_espnet_loss.py).

``BSRNNESPNetLoss`` (ESPnet's MultiResL1SpecLoss): the estimate scaled by
its least-squares projection on the target, then the time-domain L1 and the
multi-resolution STFT-magnitude L1 (a rectangular window,
``Stft(window=None)``), each reduced by ``reduction`` and mixed by
``time_domain_weight``; ``normalize_variance`` divides both signals by
their standard deviation first. ``BSRNNESPNetEval`` is −SI-SDR.
"""

from __future__ import annotations

import torch

from ..ops.stft import stft
from .enhancement import single_channel
from .sdr import singlesrc_neg_sdr


class BSRNNESPNetLoss:
    def __init__(self, window_sz=(512,), hop_sz=None, eps: float = 1e-8,
                 time_domain_weight: float = 0.5, normalize_variance: bool = False,
                 reduction: str = "sum"):
        self.window_sz = tuple(window_sz)
        self.hop_sz = tuple(hop_sz) if hop_sz else tuple(w // 2 for w in self.window_sz)
        self.eps = eps
        self.time_domain_weight = time_domain_weight
        self.normalize_variance = normalize_variance
        self.reduction = reduction

    def _reduce(self, x: torch.Tensor, dims) -> torch.Tensor:
        return x.sum(dim=dims) if self.reduction == "sum" else x.mean(dim=dims)

    def __call__(self, ests: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        target, estimate = single_channel(targets), single_channel(ests)
        if self.normalize_variance:
            target = target / target.std(dim=1, keepdim=True, unbiased=False)
            estimate = estimate / estimate.std(dim=1, keepdim=True, unbiased=False)
        scale = (estimate * target).sum(-1, keepdim=True) / (
            (estimate**2).sum(-1, keepdim=True) + self.eps)
        scaled = estimate * scale
        td_loss = self._reduce((scaled - target).abs(), -1)
        spec_loss = torch.zeros_like(td_loss)
        for w, h in zip(self.window_sz, self.hop_sz):
            window = torch.ones(w, dtype=target.dtype, device=target.device)
            t_mag = stft(target, w, h, window).abs()
            e_mag = stft(scaled, w, h, window).abs()
            spec_loss = spec_loss + self._reduce((e_mag - t_mag).abs(), (1, 2))
        loss = (td_loss * self.time_domain_weight
                + (1.0 - self.time_domain_weight) * spec_loss / len(self.window_sz))
        return loss.mean()


class BSRNNESPNetEval:
    def __init__(self, n_fft: int = 960, hop_length: int = 480, win_length: int = 960):
        pass

    def __call__(self, ests: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return torch.mean(singlesrc_neg_sdr(single_channel(ests), single_channel(targets),
                                            "sisdr"))
