"""BSRNN (band-split RNN separation in the STFT domain) in PyTorch.

Port of ``sonicsim_tpu.models.bsrnn`` (reference
separation/look2hear/models/bsrnn.py:6-180; config
configs/separation/bsrnn.yaml: 16 kHz, win 512, hop 128, feature 128, 12
repeats): the complex STFT (``ops.stft``) split into psychoacoustic
sub-bands, a GroupNorm(1) and 1×1 bottleneck per band, alternating
band-RNN (over time) and band-communication (over bands) ResRNNs, per-band
complex ratio masks with the sum-to-one correction, iSTFT.

Parameter names are the reference's (``BN.{i}.{0,1}``,
``separator.{r}.{band_rnn,band_comm}``, ``mask.{i}.{0,1,3,5}``). The bands
stay a Python loop of small per-band ops, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.stft import hann_window, istft, stft
from .base import BaseModel, register_model
from .zoo_layers import F32_EPS, ResRNN


def band_widths(sample_rate: int, enc_dim: int) -> list[int]:
    """Sub-band widths in bins (bsrnn.py:64-74): 20 × 50 Hz, 10 × 100 Hz,
    8 × 250 Hz, 8 × 500 Hz and the remainder; empty bands dropped."""
    def bw(hz):
        return int(np.floor(hz / (sample_rate / 2.0) * enc_dim))

    bands = [bw(50)] * 20 + [bw(100)] * 10 + [bw(250)] * 8 + [bw(500)] * 8
    bands.append(enc_dim - int(np.sum(bands)))
    return [b for b in bands if b > 0]


class BSNet(nn.Module):
    """One band-RNN and one band-communication ResRNN (bsrnn.py:28-48), on
    (B, T, nband, N)."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.band_rnn = ResRNN(feature_dim, feature_dim * 2)
        self.band_comm = ResRNN(feature_dim, feature_dim * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, nband, n = x.shape
        y = self.band_rnn(x.transpose(1, 2).reshape(b * nband, t, n))
        y = y.reshape(b, nband, t, n).transpose(1, 2).reshape(b * t, nband, n)
        return self.band_comm(y).reshape(b, t, nband, n)


@register_model
class BSRNN(BaseModel):
    """Keyword names are the JAX package's fields (bsrnn.yaml). Built on
    ``device``: the card unless the caller names another."""

    def __init__(self, sample_rate: int = 16000, win: int = 512, stride: int = 128,
                 feature_dim: int = 128, num_repeat: int = 12, num_output: int = 2, *,
                 device=None):
        super().__init__(dict(sample_rate=sample_rate, win=win, stride=stride,
                              feature_dim=feature_dim, num_repeat=num_repeat,
                              num_output=num_output))
        self.sample_rate, self.win, self.stride = sample_rate, win, stride
        self.num_output = num_output
        self.bands = band_widths(sample_rate, win // 2 + 1)
        fd, out = feature_dim, num_output
        self.BN = nn.ModuleList(
            nn.Sequential(nn.GroupNorm(1, w * 2, F32_EPS), nn.Conv1d(w * 2, fd, 1))
            for w in self.bands)
        self.separator = nn.Sequential(*(BSNet(fd) for _ in range(num_repeat)))
        self.mask = nn.ModuleList(
            nn.Sequential(nn.GroupNorm(1, fd, F32_EPS), nn.Conv1d(fd, fd * out, 1), nn.Tanh(),
                          nn.Conv1d(fd * out, fd * 2 * out, 1, groups=out), nn.Tanh(),
                          nn.Conv1d(fd * 2 * out, w * 4 * out, 1, groups=out))
            for w in self.bands)
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, out, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        bsz, nsample = wav.shape
        window = hann_window(self.win, device=wav.device)
        spec = stft(wav, self.win, self.stride, window)  # (B, F, T') complex
        edges = np.concatenate([[0], np.cumsum(self.bands)])
        subs = [spec[:, lo:hi] for lo, hi in zip(edges[:-1], edges[1:])]
        feats = [bn(torch.cat([sub.real, sub.imag], dim=1)).transpose(1, 2)
                 for bn, sub in zip(self.BN, subs)]
        x = self.separator(torch.stack(feats, dim=2))  # (B, T', nband, N)
        outs = []
        for i, (head, sub) in enumerate(zip(self.mask, subs)):
            h = head(x[:, :, i].transpose(1, 2))  # (B, 4·out·bw, T')
            h = h.reshape(bsz, 2, 2, self.num_output, sub.shape[1], -1)
            m = h[:, 0] * torch.sigmoid(h[:, 1])  # (B, 2, out, bw, T')
            # The sum-to-one correction (bsrnn.py:161-164).
            m_re = m[:, 0] - (m[:, 0].sum(dim=1, keepdim=True) - 1.0) / self.num_output
            m_im = m[:, 1] - m[:, 1].sum(dim=1, keepdim=True) / self.num_output
            re, im = sub.real[:, None], sub.imag[:, None]
            outs.append(torch.complex(re * m_re - im * m_im, re * m_im + im * m_re))
        est = torch.cat(outs, dim=2)  # (B, out, F, T')
        out = istft(est.reshape(bsz * self.num_output, *est.shape[2:]), self.win, self.stride,
                    window, length=nsample)
        return out.reshape(bsz, self.num_output, nsample)
