"""Conv-TasNet (waveform masking separation) in PyTorch.

Port of ``sonicsim_tpu.models.conv_tasnet`` (reference
separation/look2hear/models/ConvTasnet.py:89-235; config
configs/separation/convtasnet.yaml): free conv encoder (N filters, kernel L,
stride L/2) → bottleneck 1x1 → R repeats of X dilated depthwise TCN blocks
→ per-speaker mask 1x1 + nonlinearity → masked transposed-conv decoder.

The layout is the reference's (B, C, T) and so are the parameter names
(``encoder.encoder``, ``encoder.norm``, ``encoder.conv1x1``,
``separation.sep.{r}.tcn.{i}.*``, ``mask``, ``decoder.decoder``): a
reference ``best_model.pth`` loads with ``load_state_dict`` as it is, and
``bridge.convtasnet_state_dict`` carries the JAX package's params across.
The API is the JAX package's: (B, T) → (B, num_spks, T), a 1-D input is
one batch item, and B == 1 is not squeezed.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .layers import Conv1d, ConvTranspose1d, PReLU, get_activation, select_norm


class Conv1DBlock(nn.Module):
    """Dilated depthwise TCN residual block (ConvTasnet.py:89-115). The
    depthwise conv pads (pad//2, pad − pad//2) or, causal, (pad, 0), with
    pad = dilation·(kernel_size − 1), as the JAX package does."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int, norm_type: str = "gLN", causal: bool = False):
        super().__init__()
        pad = dilation * (kernel_size - 1)
        left, right = (pad, 0) if causal else (pad // 2, pad - pad // 2)
        # A symmetric pad rides in the conv; an asymmetric one is a copy.
        self.conv1x1 = Conv1d(in_channels, out_channels, 1)
        self.prelu1 = PReLU()
        self.norm1 = select_norm(norm_type, out_channels)
        self.dwconv = Conv1d(out_channels, out_channels, kernel_size,
                             padding=left if left == right else 0,
                                dilation=dilation, groups=out_channels)
        self.prelu2 = PReLU()
        self.norm2 = select_norm(norm_type, out_channels)
        self.sconv = Conv1d(out_channels, in_channels, 1)
        self._copy_pad = None if left == right else (left, right)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, Cin, T)
        w = self.norm1(self.prelu1(self.conv1x1(x)))
        if self._copy_pad is not None:
            w = F.pad(w, self._copy_pad)
        w = self.norm2(self.prelu2(self.dwconv(w)))
        return x + self.sconv(w)


class TCN(nn.Module):
    """One repeat: X blocks at dilations 1, 2, …, 2^(X−1)."""

    def __init__(self, B: int, H: int, P: int, X: int, norm: str, causal: bool):
        super().__init__()
        self.tcn = nn.ModuleList(
            Conv1DBlock(B, H, P, 2**i, norm, causal) for i in range(X))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.tcn:
            x = block(x)
        return x


class Encoder(nn.Module):
    """Free filterbank + norm + bottleneck (ConvTasnet.py:142-162)."""

    def __init__(self, N: int, L: int, B: int, norm: str):
        super().__init__()
        self.encoder = Conv1d(1, N, L, stride=L // 2)
        self.norm = select_norm(norm, N)
        self.conv1x1 = Conv1d(N, B, 1)

    def forward(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        enc = self.encoder(wav[:, None, :])  # (B, N, T')
        return enc, self.conv1x1(self.norm(enc))


class Decoder(nn.Module):
    """Transposed conv back to the waveform (ConvTasnet.py:165-173)."""

    def __init__(self, H: int, L: int):
        super().__init__()
        self.decoder = ConvTranspose1d(H, 1, L, stride=L // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(x)[:, 0]


class Separation(nn.Module):
    def __init__(self, B: int, H: int, P: int, X: int, R: int, norm: str,
                 causal: bool):
        super().__init__()
        self.sep = nn.ModuleList(TCN(B, H, P, X, norm, causal) for _ in range(R))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for repeat in self.sep:
            x = repeat(x)
        return x


@register_model
class ConvTasNet(BaseModel):
    """Keyword names mirror the reference config keys
    (configs/separation/convtasnet.yaml). The model is built on ``device``:
    the card unless the caller names another (``bridge.resolve_device``)."""

    def __init__(self, N: int = 512, L: int = 32, B: int = 128, H: int = 512,
                 P: int = 3, X: int = 8, R: int = 3, norm: str = "gLN",
                 num_spks: int = 2, activate: str = "relu", causal: bool = False,
                 sample_rate: int = 16000, *, device=None):
        if N != H:
            # The mask is sized H per speaker but multiplies the N-channel
            # encoder output, as in the reference (ConvTasnet.py:196,211-222),
            # and every shipped config sets N == H.
            raise ValueError(
                f"ConvTasNet requires N == H (got N={N}, H={H}); the H-sized "
                "masks multiply the N-channel encoder output "
                "(ConvTasnet.py:196,211-222)"
            )
        super().__init__(dict(N=N, L=L, B=B, H=H, P=P, X=X, R=R, norm=norm,
                              num_spks=num_spks, activate=activate,
                              causal=causal, sample_rate=sample_rate))
        self.H, self.num_spks, self.activate = H, num_spks, activate
        self.sample_rate = sample_rate
        self.encoder = Encoder(N, L, B, norm)
        self.separation = Separation(B, H, P, X, R, norm, causal)
        self.mask = Conv1d(B, H * num_spks, 1)
        self.decoder = Decoder(H, L)
        self.place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, S, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        nsample = wav.shape[-1]
        enc, w = self.encoder(wav)
        m = self.mask(self.separation(w))  # (B, S·H, T')
        bsz, _, t_enc = m.shape
        m = m.view(bsz, self.num_spks, self.H, t_enc)
        if self.activate == "softmax":
            m = torch.softmax(m, dim=1)  # over the speakers
        else:
            m = get_activation(self.activate)(m)
        # The mask multiplies the un-normalised encoder output.
        masked = (enc[:, None] * m).reshape(bsz * self.num_spks, self.H, t_enc)
        dec = self.decoder(masked)[:, :nsample]  # (B·S, T'')
        dec = F.pad(dec, (0, nsample - dec.shape[-1]))
        return dec.reshape(bsz, self.num_spks, nsample)
