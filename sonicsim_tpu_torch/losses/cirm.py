"""The compressed complex ideal ratio mask (cIRM) of the FullSubNet family.

Port of ``sonicsim_tpu.losses.cirm`` (reference
enhancement/look2hear/losses/fullband_loss.py:100-221): the tanh
compression (K = 10, C = 0.1) and its inverse, the ideal mask of the clean
spectrum over the noisy one, the mask applied to the noisy spectrum,
``cirm_inference``, which turns a model's ``(cRM (B, 2, F, T), noisy_real,
noisy_imag)`` into the enhanced waveform, and the configs' training loss
(``FullbandLoss``: the MSE against the compressed ideal mask) and metric
(``FullbandEval``: −SI-SDR of the enhanced waveform).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.stft import hann_window, istft, stft
from .enhancement import single_channel
from .sdr import singlesrc_neg_sdr

EPS = 1.1920929e-7  # the ideal mask's denominator floor (float32 epsilon)


def compress_cirm(mask: torch.Tensor, k: float = 10.0, c: float = 0.1) -> torch.Tensor:
    mask = torch.where(mask <= -100.0, torch.full_like(mask, -100.0), mask)
    e = torch.exp(-c * mask)
    return k * (1.0 - e) / (1.0 + e)


def decompress_cirm(mask: torch.Tensor, k: float = 10.0, limit: float = 9.9) -> torch.Tensor:
    mask = torch.clamp(mask, -limit, limit)
    return -k * torch.log((k - mask) / (k + mask))


def build_cirm(noisy_real: torch.Tensor, noisy_imag: torch.Tensor, clean_real: torch.Tensor,
               clean_imag: torch.Tensor) -> torch.Tensor:
    """The compressed ideal complex ratio mask (fullband_loss.py:132-154):
    (B, F, T, 2)."""
    denom = noisy_real**2 + noisy_imag**2 + EPS
    m_re = (noisy_real * clean_real + noisy_imag * clean_imag) / denom
    m_im = (noisy_real * clean_imag - noisy_imag * clean_real) / denom
    return compress_cirm(torch.stack([m_re, m_im], dim=-1))


def apply_cirm(crm: torch.Tensor, noisy_real: torch.Tensor, noisy_imag: torch.Tensor):
    """Decompress a (B, F, T, 2) mask and apply it → (real, imag)."""
    crm = decompress_cirm(crm)
    real = crm[..., 0] * noisy_real - crm[..., 1] * noisy_imag
    imag = crm[..., 1] * noisy_real + crm[..., 0] * noisy_imag
    return real, imag


def _stft_window(n_fft: int, win_length: int, device) -> torch.Tensor:
    """torch.stft semantics: a Hann window of ``win_length`` samples,
    zero-padded centred to ``n_fft`` when shorter."""
    w = hann_window(win_length, device=device)
    left = (n_fft - win_length) // 2
    return F.pad(w, (left, n_fft - win_length - left))


def cirm_inference(ests, n_fft: int, hop_length: int, length: int,
                   win_length: int | None = None) -> torch.Tensor:
    """Model output tuple → enhanced waveform (B, T)
    (fullband_loss.py:206-221)."""
    crm, noisy_real, noisy_imag = ests
    real, imag = apply_cirm(crm.permute(0, 2, 3, 1), noisy_real, noisy_imag)
    window = _stft_window(n_fft, win_length or n_fft, crm.device)
    return istft(torch.complex(real, imag), n_fft, hop_length, window, length=length)


class FullbandLoss:
    """MSE between the predicted and the ideal compressed cIRM."""

    def __init__(self, n_fft: int = 512, hop_length: int = 256, win_length: int = 512):
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length

    def __call__(self, ests, refs: torch.Tensor) -> torch.Tensor:
        crm, noisy_real, noisy_imag = ests
        refs = single_channel(refs)
        clean = stft(refs, self.n_fft, self.hop_length,
                     _stft_window(self.n_fft, self.win_length, refs.device))
        cirm = build_cirm(noisy_real, noisy_imag, clean.real, clean.imag)
        return torch.mean((cirm - crm.permute(0, 2, 3, 1)) ** 2)


class FullbandEval:
    """Negative SI-SDR of the enhanced waveform (fullband_loss.py:177-203)."""

    def __init__(self, n_fft: int = 512, hop_length: int = 256, win_length: int = 512):
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length

    def __call__(self, ests, refs: torch.Tensor) -> torch.Tensor:
        refs = single_channel(refs)
        wav = cirm_inference(ests, self.n_fft, self.hop_length, refs.shape[-1],
                             win_length=self.win_length)
        return torch.mean(singlesrc_neg_sdr(wav, refs, "sisdr"))
