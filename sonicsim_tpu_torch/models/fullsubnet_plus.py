"""FullSubNet+ (channel-attended full-band TCNs and a sub-band LSTM) in
PyTorch.

Port of ``sonicsim_tpu.models.fullsubnet_plus`` (reference
enhancement/look2hear/models/fullsubnet_plus.py:439-1399; config
configs/enhancement/fullsubnet_plus.yaml: SE channel attention, TCN
full-band extractors on the magnitude, real and imaginary spectra, LSTM
sub-band, neighbours 15): three SE-gated full-band TCN branches (8 dilated
blocks 1, 2, 5, 9 twice, hidden 512); the sub-band LSTM reads the unfolded
attended magnitude and the three branches' outputs and emits the cIRM.
Same output as FullSubNet.

Parameter names are the reference's (``channel_attention{,_real,_imag}
.{fc1,fc2}``, ``fb_model{,_real,_imag}.{sequence_model.{i}.{conv1x1,prelu1,
norm1,depthwise_conv,prelu2,norm2,sconv},fc_output_layer}``, ``sb_model``).
"""

from __future__ import annotations

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
from .layers import Conv1d, GroupedConv1D, Linear, PReLU
from .zoo_layers import GroupNorm1

DILATIONS = (1, 2, 5, 9, 1, 2, 5, 9)


class ChannelSELayer(nn.Module):
    """SE over the frequency 'channels' of (B, F, T) (fullsubnet_plus.py:54-88)."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2):
        super().__init__()
        self.fc1 = Linear(num_channels, num_channels // reduction_ratio)
        self.fc2 = Linear(num_channels // reduction_ratio, num_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=2)))))
        return x * gate[:, :, None]


class TCNBlock(nn.Module):
    """A non-causal TCN block with its skip (fullsubnet_plus.py:439-487), on
    (B, C, T)."""

    def __init__(self, channels: int, hidden: int = 512, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        pad = dilation * (kernel_size - 1) // 2
        self.conv1x1 = Conv1d(channels, hidden, 1)
        self.prelu1 = PReLU()
        self.norm1 = GroupNorm1(hidden, eps=1e-8)
        self.depthwise_conv = GroupedConv1D(hidden, hidden, kernel_size, padding=(pad, pad),
                                            dilation=dilation, groups=hidden)
        self.prelu2 = PReLU()
        self.norm2 = GroupNorm1(hidden, eps=1e-8)
        self.sconv = Conv1d(hidden, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.prelu1(self.conv1x1(x)))
        y = self.norm2(self.prelu2(self.depthwise_conv(y)))
        return x + self.sconv(y)


class TCNSequence(nn.Module):
    """SequenceModel('TCN') (fullsubnet_plus.py:543-555, 584-598): 8 dilated
    TCN blocks, ReLU, a linear head. (B, F, T) → (B, T, F)."""

    def __init__(self, channels: int, activate="ReLU"):
        super().__init__()
        self.sequence_model = nn.Sequential(*(TCNBlock(channels, dilation=d) for d in DILATIONS))
        self.fc_output_layer = Linear(channels, channels)
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc_output_layer(torch.relu(self.sequence_model(x)).transpose(1, 2))
        if self.activate == "ReLU":
            return torch.relu(x)
        return torch.tanh(x) if self.activate == "Tanh" else x


@register_model
class FullSubNet_Plus(BaseModel):
    """Keyword names are the JAX package's fields (fullsubnet_plus.yaml).
    Built on ``device``: the card unless the caller names another."""

    def __init__(self, num_freqs: int = 257, look_ahead: int = 2, sequence_model: str = "LSTM",
                 fb_num_neighbors: int = 0, sb_num_neighbors: int = 15,
                 fb_output_activate_function="ReLU", sb_output_activate_function=False,
                 fb_model_hidden_size: int = 512, sb_model_hidden_size: int = 384,
                 n_fft: int = 512, hop_length: int = 256, win_length: int = 512,
                 channel_attention_model: str = "SE", norm_type: str = "offline_laplace_norm",
                 num_groups_in_drop_band: int = 2, output_size: int = 2, subband_num: int = 1,
                 kersize=(3, 5, 10), weight_init: bool = True, sample_rate: int = 16000, *,
                 device=None):
        super().__init__(dict(num_freqs=num_freqs, look_ahead=look_ahead,
                              sequence_model=sequence_model, fb_num_neighbors=fb_num_neighbors,
                              sb_num_neighbors=sb_num_neighbors,
                              fb_output_activate_function=fb_output_activate_function,
                              sb_output_activate_function=sb_output_activate_function,
                              fb_model_hidden_size=fb_model_hidden_size,
                              sb_model_hidden_size=sb_model_hidden_size, n_fft=n_fft,
                              hop_length=hop_length, win_length=win_length,
                              channel_attention_model=channel_attention_model,
                              norm_type=norm_type,
                              num_groups_in_drop_band=num_groups_in_drop_band,
                              output_size=output_size, subband_num=subband_num,
                              kersize=tuple(kersize), weight_init=weight_init,
                              sample_rate=sample_rate))
        self.num_freqs, self.look_ahead, self.output_size = num_freqs, look_ahead, output_size
        self.fb_num_neighbors, self.sb_num_neighbors = fb_num_neighbors, sb_num_neighbors
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        for part in ("", "_real", "_imag"):
            self.add_module(f"channel_attention{part}", ChannelSELayer(num_freqs))
            self.add_module(f"fb_model{part}",
                            TCNSequence(num_freqs, fb_output_activate_function))
        n_in = 2 * sb_num_neighbors + 1 + 3 * (2 * fb_num_neighbors + 1)
        self.sb_model = SequenceModel(n_in, output_size, sb_model_hidden_size, 2,
                                      sequence_model, sb_output_activate_function)
        self.place(device)

    def _branch(self, spec: torch.Tensor, part: str):
        """The attended input and the branch's output, each (B, F, T)."""
        x = getattr(self, f"channel_attention{part}")(offline_laplace_norm(spec))
        return x, getattr(self, f"fb_model{part}")(x).transpose(1, 2)

    def forward(self, wav: torch.Tensor):
        if wav.dim() == 1:
            wav = wav[None, :]
        mag, real, imag = stft_features(wav, self.n_fft, self.hop_length)
        mag_p, real_p, imag_p = (look_ahead_pad(z, self.look_ahead) for z in (mag, real, imag))
        b, f, t = mag_p.shape
        fb_in, fb_out = self._branch(mag_p, "")
        fbr_out = self._branch(real_p, "_real")[1]
        fbi_out = self._branch(imag_p, "_imag")[1]
        n = self.fb_num_neighbors
        sb = torch.cat([freq_unfold(fb_in, self.sb_num_neighbors), freq_unfold(fb_out, n),
                        freq_unfold(fbr_out, n), freq_unfold(fbi_out, n)], dim=2)
        sb = offline_laplace_norm(sb)  # (B, F, n, T)
        mask = self.sb_model(sb.reshape(b * f, -1, t).transpose(1, 2))  # (B·F, T, out)
        crm = mask.reshape(b, f, t, self.output_size).permute(0, 3, 1, 2)
        return crm[..., self.look_ahead:], real, imag
