"""TaylorSENet's losses (port of ``sonicsim_tpu.losses.taylorsenet``;
reference enhancement/look2hear/losses/taylorsenet_loss.py): GaGNet's
complex + magnitude MSE on the one (B, 2, T, F) output, and −SI-SDR of the
waveform ``taylor_wav`` makes (enhancement/test.py:60-77)."""

from __future__ import annotations

import torch

from .enhancement import single_channel
from .gagnet import compressed_target, decompressed_wav, spectral_mse
from .sdr import singlesrc_neg_sdr


class TaylorSENetLoss:
    def __init__(self, n_fft: int = 320, hop_length: int = 160, win_length: int = 320):
        self.n_fft, self.hop_length = n_fft, hop_length

    def __call__(self, est: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        label = compressed_target(single_channel(refs), self.n_fft, self.hop_length)
        return spectral_mse(est, label.transpose(2, 3))


def taylor_wav(est: torch.Tensor, n_fft: int, hop_length: int, length: int) -> torch.Tensor:
    """(B, 2, T, F) compressed spectrum → the waveform (B, T)."""
    return decompressed_wav(est.transpose(2, 3), n_fft, hop_length, length)


class TaylorSENetEval:
    def __init__(self, n_fft: int = 320, hop_length: int = 160, win_length: int = 320):
        self.n_fft, self.hop_length = n_fft, hop_length

    def __call__(self, est: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        refs = single_channel(refs)
        wav = taylor_wav(est, self.n_fft, self.hop_length, refs.shape[-1])
        return torch.mean(singlesrc_neg_sdr(wav, refs, "sisdr"))
