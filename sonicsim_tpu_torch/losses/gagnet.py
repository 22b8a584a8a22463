"""The GaGNet family's stage-wise spectral losses (port of
``sonicsim_tpu.losses.gagnet``; reference
enhancement/look2hear/losses/gagnet_loss.py).

``GaGNetLoss`` (GaGNet, G2Net): over the stage spectra, weighted 0.1 each
and 1.0 on the last, half the sum of the complex MSE and the magnitude MSE
against the target's √mag-compressed STFT (RMS-normalised, as the model's
input). ``gagnet_wav`` turns the last stage back into a waveform (the
magnitude squared back, enhancement/test.py:41-58); ``GaGNetEval`` is its
−SI-SDR. At an exactly zero-magnitude bin the gradients part from the JAX
package's (``models.gagnet``).
"""

from __future__ import annotations

import torch

from ..models.gagnet import compressed_spectrum, polar
from ..ops.stft import hann_window, istft
from .enhancement import single_channel
from .sdr import singlesrc_neg_sdr


def compressed_target(refs: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, T) → the compressed target spectrum (B, 2, F, T')."""
    return compressed_spectrum(refs, n_fft, hop_length)[0].transpose(2, 3)


def spectral_mse(est: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Half the sum of the complex MSE and the magnitude MSE."""
    mag_est = torch.linalg.vector_norm(est, dim=1)
    mag_label = torch.linalg.vector_norm(label, dim=1)
    return 0.5 * (torch.mean((est - label) ** 2) + torch.mean((mag_est - mag_label) ** 2))


def decompressed_wav(est: torch.Tensor, n_fft: int, hop_length: int, length: int) -> torch.Tensor:
    """A compressed spectrum (B, 2, F, T') → its waveform (B, length): the
    magnitude squared, the phase kept."""
    mag, phase = polar(est)
    mag = mag**2.0
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    return istft(spec, n_fft, hop_length, hann_window(n_fft, device=est.device), length=length)


class GaGNetLoss:
    def __init__(self, n_fft: int = 320, hop_length: int = 160, win_length: int = 320):
        self.n_fft, self.hop_length = n_fft, hop_length

    def __call__(self, est_list, refs: torch.Tensor) -> torch.Tensor:
        label = compressed_target(single_channel(refs), self.n_fft, self.hop_length)
        alphas = [0.1] * (len(est_list) - 1) + [1.0]
        return sum(alpha * spectral_mse(est, label) for alpha, est in zip(alphas, est_list))


def gagnet_wav(est_list, n_fft: int, hop_length: int, length: int) -> torch.Tensor:
    """The last stage's spectrum → the enhanced waveform (B, T)."""
    return decompressed_wav(est_list[-1], n_fft, hop_length, length)


class GaGNetEval:
    def __init__(self, n_fft: int = 320, hop_length: int = 160, win_length: int = 320):
        self.n_fft, self.hop_length = n_fft, hop_length

    def __call__(self, est_list, refs: torch.Tensor) -> torch.Tensor:
        refs = single_channel(refs)
        wav = gagnet_wav(est_list, self.n_fft, self.hop_length, refs.shape[-1])
        return torch.mean(singlesrc_neg_sdr(wav, refs, "sisdr"))
