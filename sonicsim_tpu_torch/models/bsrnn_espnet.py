"""BSRNN-ESPnet (band-split RNN enhancement) in PyTorch.

Port of ``sonicsim_tpu.models.bsrnn_espnet`` (reference
enhancement/look2hear/models/bsrnn_espnet.py:517-881; config
configs/enhancement/bsrnn_espnet.yaml: FFT 960 / hop 480, 256 channels, 12
layers, non-causal, the 48 kHz band layout over the 481 bins of 16 kHz
input, as the JAX model keeps it): the band-split complex STFT,
alternating time-BLSTM and frequency-BLSTM residual layers, per-band GLU
mask and residual decoders, m·x + r, iSTFT. (B, T) → (B, T).

Parameter names are the reference's (``separator.bsrnn.{band_split.
{norm,fc}.{i},norm_time.{i},rnn_time.{i},fc_time.{i},norm_freq.{i},
rnn_freq.{i},fc_freq.{i},mask_decoder.{mlp_mask,mlp_residual}.{i}.
{0,1,3}}``).
"""

from __future__ import annotations

from itertools import accumulate

import torch
import torch.nn as nn

from ..ops.stft import hann_window, istft, stft
from .base import BaseModel, register_model
from .zoo_layers import GroupNorm1, LSTMLayer


def subband_layout(input_dim: int, target_fs: int) -> tuple[int, ...]:
    """Band widths in bins (bsrnn_espnet.py:623-637)."""
    if input_dim == 481 and target_fs == 48000:
        return tuple([5] + [4] * 19 + [10] * 6 + [40] * 7 + [60])
    if input_dim == 161 and target_fs == 16000:
        return tuple([2] * 20 + [5] * 6 + [20] * 3 + [31])
    raise NotImplementedError(f"no subband layout for {input_dim}@{target_fs}")


class BandSplit(nn.Module):
    """(B, T, F, 2) → (B, T, K, N) (bsrnn_espnet.py:617-686): per band the
    interleaved (real, imag) bins, a GroupNorm(1) and a 1×1 conv."""

    def __init__(self, subbands, channels: int):
        super().__init__()
        self.subbands = tuple(subbands)
        self.norm = nn.ModuleList(GroupNorm1(2 * s, eps=1e-5) for s in self.subbands)
        self.fc = nn.ModuleList(nn.Conv1d(2 * s, channels, 1) for s in self.subbands)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        edges = [0, *accumulate(self.subbands)]
        outs = [fc(norm(x[:, :, lo:hi].reshape(b, t, -1).transpose(1, 2)))
                for norm, fc, lo, hi in zip(self.norm, self.fc, edges[:-1], edges[1:])]
        return torch.stack(outs, dim=2).permute(0, 3, 2, 1)  # (B, T, K, N)


def _mlp(channels: int, sub: int) -> nn.Sequential:
    return nn.Sequential(GroupNorm1(channels, eps=1e-5), nn.Conv1d(channels, 4 * channels, 1),
                         nn.Tanh(), nn.Conv1d(4 * channels, 4 * sub, 1), nn.GLU(dim=1))


class MaskDecoder(nn.Module):
    """(B, T, K, N) → (mask, residual), each (B, T, F, 2)
    (bsrnn_espnet.py:689-744)."""

    def __init__(self, subbands, channels: int):
        super().__init__()
        self.subbands = tuple(subbands)
        self.mlp_mask = nn.ModuleList(_mlp(channels, s) for s in self.subbands)
        self.mlp_residual = nn.ModuleList(_mlp(channels, s) for s in self.subbands)

    def forward(self, x: torch.Tensor):
        b, t = x.shape[:2]

        def run(mlps):
            return torch.cat([mlp(x[:, :, i].transpose(1, 2)).transpose(1, 2)
                              .reshape(b, t, sub, 2)
                              for i, (mlp, sub) in enumerate(zip(mlps, self.subbands))], dim=2)

        return run(self.mlp_mask), run(self.mlp_residual)


class _BSRNN(nn.Module):
    def __init__(self, subbands, n: int, layers: int, causal: bool):
        super().__init__()
        self.band_split = BandSplit(subbands, n)
        width = 2 * n * (1 if causal else 2)
        self.norm_time = nn.ModuleList(GroupNorm1(n, 1e-5, True) for _ in range(layers))
        self.rnn_time = nn.ModuleList(LSTMLayer(n, 2 * n, not causal) for _ in range(layers))
        self.fc_time = nn.ModuleList(nn.Linear(width, n) for _ in range(layers))
        self.norm_freq = nn.ModuleList(GroupNorm1(n, 1e-5, True) for _ in range(layers))
        self.rnn_freq = nn.ModuleList(LSTMLayer(n, 2 * n, True) for _ in range(layers))
        self.fc_freq = nn.ModuleList(nn.Linear(4 * n, n) for _ in range(layers))
        self.mask_decoder = MaskDecoder(subbands, n)


class _Separator(nn.Module):
    def __init__(self, **kwargs):
        super().__init__()
        self.bsrnn = _BSRNN(**kwargs)


@register_model
class BSRNNESPNet(BaseModel):
    """Keyword names are the JAX package's fields (bsrnn_espnet.yaml). Built
    on ``device``: the card unless the caller names another."""

    def __init__(self, n_fft: int = 960, hop_length: int = 480, use_builtin_complex: bool = True,
                 num_spk: int = 1, num_channels: int = 256, num_layers: int = 12,
                 target_fs: int = 48000, ref_channel: int = 0, causal: bool = False,
                 sample_rate: int = 16000, *, device=None):
        super().__init__(dict(n_fft=n_fft, hop_length=hop_length,
                              use_builtin_complex=use_builtin_complex, num_spk=num_spk,
                              num_channels=num_channels, num_layers=num_layers,
                              target_fs=target_fs, ref_channel=ref_channel, causal=causal,
                              sample_rate=sample_rate))
        self.n_fft, self.hop_length = n_fft, hop_length
        self.separator = _Separator(subbands=subband_layout(n_fft // 2 + 1, target_fs),
                                    n=num_channels, layers=num_layers, causal=causal)
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        nsample = wav.shape[-1]
        window = hann_window(self.n_fft, device=wav.device)
        spec = stft(wav, self.n_fft, self.hop_length, window).transpose(1, 2)  # (B, T, F)
        f_dim = spec.shape[2]
        net = self.separator.bsrnn
        skip = net.band_split(torch.stack([spec.real, spec.imag], dim=-1))
        b, t, k, n = skip.shape
        for i in range(len(net.rnn_time)):
            h = net.norm_time[i](skip).transpose(1, 2).reshape(b * k, t, n)
            h = net.fc_time[i](net.rnn_time[i](h))
            skip = skip + h.reshape(b, k, t, n).transpose(1, 2)
            h = net.norm_freq[i](skip).reshape(b * t, k, n)
            skip = skip + net.fc_freq[i](net.rnn_freq[i](h)).reshape(b, t, k, n)
        m, r = net.mask_decoder(skip)
        m = torch.complex(m[..., 0], m[..., 1])[:, :, :f_dim]
        r = torch.complex(r[..., 0], r[..., 1])[:, :, :f_dim]
        return istft((m * spec + r).transpose(1, 2), self.n_fft, self.hop_length, window,
                     length=nsample)
