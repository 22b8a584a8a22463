"""Fullband and FullSubNet (cIRM enhancement) in PyTorch, and the blocks the
FullSubNet family shares.

Port of ``sonicsim_tpu.models.fullsubnet`` (reference
enhancement/look2hear/models/fullband.py:53-658 and fullsubnet.py:154-719;
configs/enhancement/{fullband,fullsubnet}.yaml): the magnitude STFT, the
offline Laplace norm, stacked unidirectional LSTMs over the full band
(Fullband) and per frequency over its unfolded neighbour bands (FullSubNet),
and the compressed cIRM. Output: ``(cRM (B, 2, F, T), noisy_real,
noisy_imag)``, which ``losses.cirm.cirm_inference`` turns into a waveform.

Parameter names are the reference's (``fullband_model``, ``fb_model``,
``sb_model``, each ``{sequence_model,fc_output_layer}``). ``sequence_model``
is an LSTM stack (``zoo_layers.LSTMLayer``); the JAX package's GRU option is
taken by no config and has no converter, so it raises here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stft import hann_window, stft
from .base import BaseModel, register_model
from .zoo_layers import LSTMLayer

_ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "ReLU6": lambda v: torch.clamp(v, 0.0, 6.0),
    "LeakyReLU": lambda v: F.leaky_relu(v, 0.01),  # jax.nn.leaky_relu's slope
}


class SequenceModel(nn.Module):
    """A stack of unidirectional LSTMs and a linear head (fullband.py:53-152),
    (B, T, F) → (B, T, out): ``sequence_model`` and, when ``output_size``,
    ``fc_output_layer``; then ``output_activate_function``."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int, num_layers: int,
                 sequence_model: str = "LSTM", output_activate_function=None):
        super().__init__()
        if sequence_model != "LSTM":
            raise NotImplementedError(
                f"sequence_model {sequence_model!r}: the port has the LSTM (the configs' own)")
        self.sequence_model = LSTMLayer(input_size, hidden_size, num_layers=num_layers)
        if output_size:
            self.fc_output_layer = nn.Linear(hidden_size, output_size)
        self.act = _ACTIVATIONS[output_activate_function] if output_activate_function else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.sequence_model(x)
        if hasattr(self, "fc_output_layer"):
            x = self.fc_output_layer(x)
        return self.act(x) if self.act is not None else x


def offline_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x / (utterance mean + 1e-5) (fullband.py:393-408)."""
    return x / (x.mean(dim=tuple(range(1, x.dim())), keepdim=True) + 1e-5)


def offline_gaussian_norm(x: torch.Tensor) -> torch.Tensor:
    axes = tuple(range(1, x.dim()))
    mu = x.mean(dim=axes, keepdim=True)
    std = x.std(dim=axes, keepdim=True, unbiased=False)
    return (x - mu) / (std + 1e-5)


def freq_unfold(x: torch.Tensor, num_neighbors: int) -> torch.Tensor:
    """(B, F, T) → (B, F, 2n + 1, T): each frequency with its ``n``
    neighbours on each side, the edges reflected (fullband.py:203-236): the
    reflected slices joined to ``x``, then ``unfold`` over frequency."""
    if num_neighbors <= 0:
        return x[:, :, None, :]
    n = num_neighbors
    xp = torch.cat([x[:, 1:n + 1].flip(1), x, x[:, -n - 1:-1].flip(1)], dim=1)
    return xp.unfold(1, 2 * n + 1, 1).transpose(2, 3)


def stft_features(wav: torch.Tensor, n_fft: int, hop_length: int):
    """(B, T) → magnitude, real and imaginary parts, each (B, F, frames)."""
    spec = stft(wav, n_fft, hop_length, hann_window(n_fft, device=wav.device))
    return spec.abs(), spec.real, spec.imag


def look_ahead_pad(x: torch.Tensor, look_ahead: int) -> torch.Tensor:
    return F.pad(x, (0, look_ahead))


@register_model
class Fullband(BaseModel):
    """Keyword names are the JAX package's fields (fullband.yaml). Built on
    ``device``: the card unless the caller names another."""

    def __init__(self, num_freqs: int = 257, hidden_size: int = 512,
                 sequence_model: str = "LSTM", output_activate_function=False,
                 look_ahead: int = 2, n_fft: int = 512, hop_length: int = 256,
                 win_length: int = 512, norm_type: str = "offline_laplace_norm",
                 weight_init: bool = True, sample_rate: int = 16000, *, device=None):
        super().__init__(dict(num_freqs=num_freqs, hidden_size=hidden_size,
                              sequence_model=sequence_model,
                              output_activate_function=output_activate_function,
                              look_ahead=look_ahead, n_fft=n_fft, hop_length=hop_length,
                              win_length=win_length, norm_type=norm_type,
                              weight_init=weight_init, sample_rate=sample_rate))
        self.num_freqs, self.look_ahead = num_freqs, look_ahead
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.fullband_model = SequenceModel(num_freqs, num_freqs * 2, hidden_size, 3,
                                            sequence_model, output_activate_function)
        self.place(device)

    def forward(self, wav: torch.Tensor):
        if wav.dim() == 1:
            wav = wav[None, :]
        mag, real, imag = stft_features(wav, self.n_fft, self.hop_length)
        x = offline_laplace_norm(look_ahead_pad(mag, self.look_ahead))
        out = self.fullband_model(x.transpose(1, 2))  # (B, T, 2F)
        b, t, _ = out.shape
        crm = out.transpose(1, 2).reshape(b, 2, self.num_freqs, t)
        return crm[..., self.look_ahead:], real, imag


@register_model
class FullSubnet(BaseModel):
    """Keyword names are the JAX package's fields (fullsubnet.yaml).
    ``num_groups_in_drop_band`` is kept: the JAX model drops no band (its
    config's 1). Built on ``device``: the card unless the caller names
    another."""

    def __init__(self, num_freqs: int = 257, look_ahead: int = 2, sequence_model: str = "LSTM",
                 fb_num_neighbors: int = 0, sb_num_neighbors: int = 15,
                 fb_output_activate_function="ReLU", sb_output_activate_function=False,
                 fb_model_hidden_size: int = 512, sb_model_hidden_size: int = 384,
                 n_fft: int = 512, hop_length: int = 256, win_length: int = 512,
                 norm_type: str = "offline_laplace_norm", num_groups_in_drop_band: int = 1,
                 weight_init: bool = False, sample_rate: int = 16000, *, device=None):
        super().__init__(dict(num_freqs=num_freqs, look_ahead=look_ahead,
                              sequence_model=sequence_model, fb_num_neighbors=fb_num_neighbors,
                              sb_num_neighbors=sb_num_neighbors,
                              fb_output_activate_function=fb_output_activate_function,
                              sb_output_activate_function=sb_output_activate_function,
                              fb_model_hidden_size=fb_model_hidden_size,
                              sb_model_hidden_size=sb_model_hidden_size, n_fft=n_fft,
                              hop_length=hop_length, win_length=win_length,
                              norm_type=norm_type,
                              num_groups_in_drop_band=num_groups_in_drop_band,
                              weight_init=weight_init, sample_rate=sample_rate))
        self.num_freqs, self.look_ahead = num_freqs, look_ahead
        self.fb_num_neighbors, self.sb_num_neighbors = fb_num_neighbors, sb_num_neighbors
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.fb_model = SequenceModel(num_freqs, num_freqs, fb_model_hidden_size, 2,
                                      sequence_model, fb_output_activate_function)
        n_in = 2 * sb_num_neighbors + 1 + 2 * fb_num_neighbors + 1
        self.sb_model = SequenceModel(n_in, 2, sb_model_hidden_size, 2, sequence_model,
                                      sb_output_activate_function)
        self.place(device)

    def forward(self, wav: torch.Tensor):
        if wav.dim() == 1:
            wav = wav[None, :]
        mag, real, imag = stft_features(wav, self.n_fft, self.hop_length)
        noisy_mag = look_ahead_pad(mag, self.look_ahead)
        b, f, t = noisy_mag.shape
        fb_out = self.fb_model(offline_laplace_norm(noisy_mag).transpose(1, 2)).transpose(1, 2)
        sb_in = torch.cat([freq_unfold(noisy_mag, self.sb_num_neighbors),
                           freq_unfold(fb_out, self.fb_num_neighbors)], dim=2)
        sb_in = offline_laplace_norm(sb_in)  # (B, F, n, T)
        sb_mask = self.sb_model(sb_in.reshape(b * f, -1, t).transpose(1, 2))  # (B·F, T, 2)
        crm = sb_mask.reshape(b, f, t, 2).permute(0, 3, 1, 2)
        return crm[..., self.look_ahead:], real, imag
