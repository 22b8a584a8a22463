"""FRCRN's losses (port of ``sonicsim_tpu.losses.frcrn``; reference
enhancement/look2hear/losses/frcrn_loss.py:69-156).

``FRCRNLoss`` scores the refined (second) stage alone: the MSE between its
mask and the ideal complex mask, clipped to ±2 (values past 2 become 1,
past −2 become −1), plus its waveform's −SI-SNR. The ideal mask comes from
FRCRN's own ConvSTFT: a sqrt-Hann window and no signal padding
(``models.dccrn.conv_stft``). ``FRCRNEval`` scores the first stage's
waveform (frcrn_loss.py:148-156).
"""

from __future__ import annotations

import torch

from ..models.dccrn import conv_stft
from .enhancement import single_channel
from .sdr import singlesrc_neg_sdr


class FRCRNLoss:
    def __init__(self, win_len: int = 640, win_inc: int = 320, fft_len: int = 640):
        self.win_len, self.win_inc, self.fft_len = win_len, win_inc, fft_len
        self.feat_dim = fft_len // 2 + 1

    def __call__(self, ests, refs: torch.Tensor) -> torch.Tensor:
        noisy, out_list = ests
        refs = single_channel(refs)
        est_wav, est_mask = out_list[4], out_list[5]
        sisnr_loss = torch.mean(singlesrc_neg_sdr(est_wav, refs, "sisdr"))
        sr, si = conv_stft(refs, self.win_len, self.win_inc, self.fft_len,
                           sqrt_window=True, pad_signal=False)
        yr, yi = conv_stft(noisy, self.win_len, self.win_inc, self.fft_len,
                           sqrt_window=True, pad_signal=False)
        y_pow = yr**2 + yi**2 + 1e-8
        gth = torch.cat([(sr * yr + si * yi) / y_pow, (si * yr - sr * yi) / y_pow], dim=1)
        gth = torch.where(gth > 2.0, torch.ones_like(gth), gth)
        gth = torch.where(gth < -2.0, -torch.ones_like(gth), gth)
        d, f = est_mask.shape[1], self.feat_dim
        amp_loss = torch.mean((gth[:, :f] - est_mask[:, :f]) ** 2) * d
        phase_loss = torch.mean((gth[:, f:] - est_mask[:, f:]) ** 2) * d
        return amp_loss + phase_loss + sisnr_loss


class FRCRNEval:
    def __call__(self, ests, refs: torch.Tensor) -> torch.Tensor:
        return torch.mean(singlesrc_neg_sdr(ests[1][1], single_channel(refs), "sisdr"))
