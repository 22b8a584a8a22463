"""The compressed complex ideal ratio mask (cIRM) of the FullSubNet family:
its inference half.

Port of ``sonicsim_tpu.losses.cirm`` (reference
enhancement/look2hear/losses/fullband_loss.py:100-221): the tanh
compression (K = 10, C = 0.1) and its inverse, the mask applied to the noisy
spectrum, and ``cirm_inference``, which turns a model's
``(cRM (B, 2, F, T), noisy_real, noisy_imag)`` into the enhanced waveform.
The training losses (``FullbandLoss``, ``FullbandEval``) wait for ROADMAP
A9b.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.stft import hann_window, istft


def compress_cirm(mask: torch.Tensor, k: float = 10.0, c: float = 0.1) -> torch.Tensor:
    mask = torch.where(mask <= -100.0, torch.full_like(mask, -100.0), mask)
    e = torch.exp(-c * mask)
    return k * (1.0 - e) / (1.0 + e)


def decompress_cirm(mask: torch.Tensor, k: float = 10.0, limit: float = 9.9) -> torch.Tensor:
    mask = torch.clamp(mask, -limit, limit)
    return -k * torch.log((k - mask) / (k + mask))


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
