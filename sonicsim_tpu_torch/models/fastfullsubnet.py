"""Fast FullSubNet (mel-domain full-band and sub-band enhancement) in
PyTorch.

Port of ``sonicsim_tpu.models.fastfullsubnet`` (reference
enhancement/look2hear/models/fastfullsubnet.py:155-790; config
configs/enhancement/fastfullsubnet.yaml: 64 mels, shrink 2, LSTM, sub-band
neighbours 5): the magnitude STFT projected on an HTK mel filterbank, the
F_l2m encoder LSTMs, a per-mel sub-band bottleneck on time-downsampled
units, nearest upsampling, and the F_m2l decoder LSTMs emitting a
(B, 2, F, T) cIRM. Same output as FullSubNet.

Parameter names are the reference's (``encoder.{0,1}``, ``bottleneck``,
``decoder_lstm.{0,1}``, each a ``SequenceModel``). As in the JAX package,
the encoder's output width (64) and the decoder's (2 × 257) are fixed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .base import BaseModel, register_model
from .fullsubnet import (
    SequenceModel,
    freq_unfold,
    look_ahead_pad,
    offline_laplace_norm,
    stft_features,
)
from .layers import promote

ENC_OUT, DEC_FREQS = 64, 257


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """torchaudio MelScale parity (HTK mels, no norm): (n_freqs, n_mels),
    float32 (the JAX package's numpy, fastfullsubnet.py:22-46)."""
    f_max = f_max or sample_rate / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@register_model
class FastFullSubnet(BaseModel):
    """Keyword names are the JAX package's fields (fastfullsubnet.yaml).
    Built on ``device``: the card unless the caller names another."""

    def __init__(self, look_ahead: int = 2, shrink_size: int = 2, sequence_model: str = "LSTM",
                 encoder_input_size: int = 257, num_mels: int = 64, n_fft: int = 512,
                 hop_length: int = 256, win_length: int = 512,
                 bottleneck_hidden_size: int = 384, bottleneck_num_layers: int = 2,
                 noisy_input_num_neighbors: int = 5, encoder_output_num_neighbors: int = 0,
                 norm_type: str = "offline_laplace_norm", weight_init: bool = False,
                 sample_rate: int = 16000, *, device=None):
        super().__init__(dict(look_ahead=look_ahead, shrink_size=shrink_size,
                              sequence_model=sequence_model,
                              encoder_input_size=encoder_input_size, num_mels=num_mels,
                              n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                              bottleneck_hidden_size=bottleneck_hidden_size,
                              bottleneck_num_layers=bottleneck_num_layers,
                              noisy_input_num_neighbors=noisy_input_num_neighbors,
                              encoder_output_num_neighbors=encoder_output_num_neighbors,
                              norm_type=norm_type, weight_init=weight_init,
                              sample_rate=sample_rate))
        self.look_ahead, self.shrink_size, self.num_mels = look_ahead, shrink_size, num_mels
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.noisy_input_num_neighbors = noisy_input_num_neighbors
        self.encoder_output_num_neighbors = encoder_output_num_neighbors
        self.register_buffer("mel_fb", torch.from_numpy(
            mel_filterbank(n_fft // 2 + 1, num_mels, sample_rate, 0.0, 8000.0)), persistent=False)
        m = sequence_model
        self.encoder = nn.ModuleList([SequenceModel(num_mels, 0, 384, 1, m),
                                      SequenceModel(384, ENC_OUT, 257, 1, m, "ReLU")])
        n_unit = 2 * noisy_input_num_neighbors + 1 + 2 * encoder_output_num_neighbors + 1
        self.bottleneck = SequenceModel(n_unit, 1, bottleneck_hidden_size,
                                        bottleneck_num_layers, m, "ReLU")
        self.decoder_lstm = nn.ModuleList([SequenceModel(ENC_OUT + num_mels, 0, 512, 1, m),
                                           SequenceModel(512, DEC_FREQS * 2, 512, 1, m)])
        self.place(device)

    def _downsample(self, x: torch.Tensor) -> torch.Tensor:
        """real_time_downsampling (fastfullsubnet.py:260-281) over the last
        axis: the first frame, the means of whole blocks of ``shrink_size``,
        the mean of the rest."""
        s = self.shrink_size
        rest = x[..., 1:]
        n_full = (rest.shape[-1] - 1) // s
        full = rest[..., :n_full * s].reshape(*rest.shape[:-1], n_full, s).mean(-1)
        last = rest[..., n_full * s:].mean(-1, keepdim=True)
        return torch.cat([x[..., :1], full, last], dim=-1)

    def forward(self, wav: torch.Tensor):
        if wav.dim() == 1:
            wav = wav[None, :]
        mag, real, imag = stft_features(wav, self.n_fft, self.hop_length)
        mix_mag = look_ahead_pad(mag, self.look_ahead)
        b, _, t = mix_mag.shape
        mel_mag = torch.einsum("bft,fm->bmt", *promote(mix_mag, self.mel_fb))  # (B, M, T)

        h = self.encoder[0](offline_laplace_norm(mel_mag).transpose(1, 2))
        enc_out = self.encoder[1](h).transpose(1, 2)  # (B, 64, T)

        bn_in = torch.cat([freq_unfold(mel_mag, self.noisy_input_num_neighbors),
                           freq_unfold(enc_out, self.encoder_output_num_neighbors)], dim=2)
        bn_in = offline_laplace_norm(self._downsample(bn_in))  # (B, M, n, T')
        t_small = bn_in.shape[-1]
        bn_out = self.bottleneck(bn_in.reshape(b * self.num_mels, -1, t_small).transpose(1, 2))
        bn_out = bn_out.transpose(1, 2).reshape(b, self.num_mels, t_small)
        bn_out = bn_out.repeat_interleave(self.shrink_size, dim=-1)[..., :t]

        h = self.decoder_lstm[0](torch.cat([enc_out, bn_out], dim=1).transpose(1, 2))
        dec = self.decoder_lstm[1](h).transpose(1, 2).reshape(b, 2, DEC_FREQS, t)
        return dec[..., self.look_ahead:], real, imag
