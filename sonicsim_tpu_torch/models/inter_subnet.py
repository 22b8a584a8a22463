"""Inter-SubNet (sub-band interaction enhancement) in PyTorch.

Port of ``sonicsim_tpu.models.inter_subnet`` (reference
enhancement/look2hear/models/inter_subnet.py:732-1474; config
configs/enhancement/inter_subnet.yaml: LSTM, 31-bin sub-band units, hidden
384, 2 SIL blocks): per-frequency sub-band magnitude units through stacked
SIL blocks (a sub-band interaction, a mean-pooled exchange across
frequencies per frame, then a per-frequency LSTM) and a 2-channel cIRM
head. Same output as FullSubNet.

Parameter names are the reference's (``sb_model.sequence_list.{i}.
{SubInter.{input_linear,mean_linear,output_linear}.{0,1},SubInter.norm,RNN,
norm}``, ``sb_model.fc_output_layer``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .base import BaseModel, register_model
from .fullsubnet import freq_unfold, look_ahead_pad, offline_laplace_norm, stft_features
from .layers import PReLU
from .zoo_layers import GroupNorm1, LSTMLayer


class SubbandInteraction(nn.Module):
    """A residual exchange across the frequency axis (inter_subnet.py:
    732-776), on (B, F, T, N)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_linear = nn.Sequential(nn.Linear(input_size, hidden_size), PReLU())
        self.mean_linear = nn.Sequential(nn.Linear(hidden_size, hidden_size), PReLU())
        self.output_linear = nn.Sequential(nn.Linear(2 * hidden_size, input_size), PReLU())
        self.norm = GroupNorm1(input_size, eps=1e-5, channel_last=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.input_linear(x)
        mean = self.mean_linear(h.mean(dim=1, keepdim=True)).expand_as(h)
        out = self.output_linear(torch.cat([h, mean], dim=-1))
        # GroupNorm(1, N) per (B, F) group over (T, N) (inter_subnet.py:773-774).
        b, f, t, n = out.shape
        return x + self.norm(out.reshape(b * f, t, n)).reshape(b, f, t, n)


class SILBlock(nn.Module):
    """Interaction, per-frequency LSTM, norm (inter_subnet.py:779-818):
    ``SubInter``, ``RNN``, ``norm``."""

    def __init__(self, input_size: int, tac_hidden: int, lstm_hidden: int):
        super().__init__()
        self.SubInter = SubbandInteraction(input_size, tac_hidden)
        self.RNN = LSTMLayer(input_size, lstm_hidden)
        self.norm = GroupNorm1(lstm_hidden, eps=1e-5, channel_last=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, F, T, N)
        b, f, t, _ = x.shape
        h = self.norm(self.RNN(self.SubInter(x).reshape(b * f, t, -1)))
        return h.reshape(b, f, t, -1)


class _SubbandModel(nn.Module):
    def __init__(self, n_sub: int, hidden: int, middle: int):
        super().__init__()
        self.sequence_list = nn.ModuleList([SILBlock(n_sub, 3 * n_sub, hidden),
                                            SILBlock(hidden, middle, hidden)])
        self.fc_output_layer = nn.Linear(hidden, 2)


@register_model
class Inter_SubNet(BaseModel):
    """Keyword names are the JAX package's fields (inter_subnet.yaml). Built
    on ``device``: the card unless the caller names another."""

    def __init__(self, num_freqs: int = 257, look_ahead: int = 2, sequence_model: str = "LSTM",
                 sb_num_neighbors: int = 15, sb_output_activate_function=False,
                 sb_model_hidden_size: int = 384, n_fft: int = 512, hop_length: int = 256,
                 win_length: int = 512, norm_type: str = "offline_laplace_norm",
                 num_groups_in_drop_band: int = 2, sbinter_middle_hidden_times: float = 0.8,
                 weight_init: bool = True, sample_rate: int = 16000, *, device=None):
        super().__init__(dict(num_freqs=num_freqs, look_ahead=look_ahead,
                              sequence_model=sequence_model, sb_num_neighbors=sb_num_neighbors,
                              sb_output_activate_function=sb_output_activate_function,
                              sb_model_hidden_size=sb_model_hidden_size, n_fft=n_fft,
                              hop_length=hop_length, win_length=win_length,
                              norm_type=norm_type,
                              num_groups_in_drop_band=num_groups_in_drop_band,
                              sbinter_middle_hidden_times=sbinter_middle_hidden_times,
                              weight_init=weight_init, sample_rate=sample_rate))
        if sequence_model != "LSTM":
            raise NotImplementedError(
                f"sequence_model {sequence_model!r}: the port has the LSTM (the config's own)")
        self.look_ahead, self.sb_num_neighbors = look_ahead, sb_num_neighbors
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        middle = int(sbinter_middle_hidden_times * sb_model_hidden_size)
        self.sb_model = _SubbandModel(2 * sb_num_neighbors + 1, sb_model_hidden_size, middle)
        self.place(device)

    def forward(self, wav: torch.Tensor):
        if wav.dim() == 1:
            wav = wav[None, :]
        mag, real, imag = stft_features(wav, self.n_fft, self.hop_length)
        units = freq_unfold(look_ahead_pad(mag, self.look_ahead), self.sb_num_neighbors)
        x = offline_laplace_norm(units).transpose(2, 3)  # (B, F, T, N)
        for block in self.sb_model.sequence_list:
            x = block(x)
        crm = self.sb_model.fc_output_layer(x).permute(0, 3, 1, 2)  # (B, 2, F, T)
        return crm[..., self.look_ahead:], real, imag
