"""Free-filterbank encoder and decoder (asteroid-style ``make_enc_dec``).

Port of ``sonicsim_tpu.models.enc_dec`` (reference
separation/look2hear/layers/enc_dec.py): a learned conv analysis
filterbank and its transposed-conv synthesis, each a ``filterbank``
module. No zoo model uses them (each keeps its own convs under the
reference's names); they serve new models. Unlike the JAX package's
``FreeDecoder``, which infers its input width, the port's takes
``n_filters``. The decoder's transposed conv is torch's: the bridge's
kernel flip (``bridge``) carries a flax ``ConvTranspose`` kernel to it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class FreeEncoder(nn.Module):
    """(B, T) → (B, frames, n_filters), channel-last as in the JAX package."""

    def __init__(self, n_filters: int = 512, kernel_size: int = 16,
                 stride: int | None = None, use_bias: bool = False,
                 activation: str | None = None):
        super().__init__()
        self.activation = activation
        self.filterbank = nn.Conv1d(1, n_filters, kernel_size,
                                    stride=stride or kernel_size // 2, bias=use_bias)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.dim() == 1:
            wav = wav[None, :]
        x = self.filterbank(wav[:, None, :]).transpose(1, 2)
        return torch.relu(x) if self.activation == "relu" else x


class FreeDecoder(nn.Module):
    """(B, frames, n_filters) → (B, T), cut or zero-padded to ``length``."""

    def __init__(self, kernel_size: int = 16, stride: int | None = None,
                 use_bias: bool = False, n_filters: int = 512):
        super().__init__()
        self.filterbank = nn.ConvTranspose1d(n_filters, 1, kernel_size,
                                             stride=stride or kernel_size // 2,
                                             bias=use_bias)

    def forward(self, rep: torch.Tensor, length: int | None = None) -> torch.Tensor:
        wav = self.filterbank(rep.transpose(1, 2))[:, 0]
        if length is not None:
            wav = F.pad(wav[..., :length], (0, max(0, length - wav.shape[-1])))
        return wav


def make_enc_dec(fb_name: str = "free", n_filters: int = 512, kernel_size: int = 16,
                 stride: int | None = None, **kwargs) -> tuple[FreeEncoder, FreeDecoder]:
    """``enc_dec.make_enc_dec`` (the free filterbank, the only one the
    reference ships)."""
    if fb_name != "free":
        raise ValueError("only the 'free' learned filterbank is supported")
    return (FreeEncoder(n_filters=n_filters, kernel_size=kernel_size, stride=stride),
            FreeDecoder(kernel_size=kernel_size, stride=stride, n_filters=n_filters))
