"""MossFormer2 (FLASH attention with gated dilated FSMN memory) in PyTorch.

Port of ``sonicsim_tpu.models.mossformer2`` (reference
separation/look2hear/models/mossformer2.py, mossformer_block.py
MossformerBlockGFSMN :428-489 and fsmn.py UniDeepFsmnDilated :114-143,
DilatedDenseNet :76-111; config configs/separation/mossformer2.yaml, the
same hyperparameters as MossFormer): MossFormer's mask net, each FLASH
block followed by a GatedFSMNBlockDilated (1×1 conv to ``fsmn_inner``,
PReLU, cLN, a gated pair of FFConvM branches whose u-branch runs a
dilated dense FSMN memory of depth 2 and order 20 with InstanceNorm and
PReLU per layer, cLN, 1×1 conv back, residual).

The module tree is v2's: ``enc``, ``mask_net.mdl.intra_mdl.{mossformerM.
{layers,fsmn}.{i},norm}``, ``mask_net.mdl.intra_norm``, ``dec``
(mossformer2.py:543-561).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import register_model
from .layers import Conv1d, Conv2d, LayerNorm, Linear, PReLU
from .mossformer import FFConvM, MossFormer, _AttMdl, _Mdl


class DilatedDenseFSMN(nn.Module):
    """fsmn.py DilatedDenseNet (:76-111) on (B, C, T): ``depth`` dilated
    grouped memory convs over frames (``conv{i}``, a ``Conv2d`` of kernel
    (2·lorder − 1, 1) and C groups), each with an affine InstanceNorm
    (``norm{i}``, epsilon 1e-5) and a per-channel PReLU (``prelu{i}``), the
    outputs concatenated densely [newest, …, input]."""

    def __init__(self, dim: int, lorder: int = 20, depth: int = 2):
        super().__init__()
        self.dim, self.lorder, self.depth = dim, lorder, depth
        for i in range(depth):
            setattr(self, f"conv{i + 1}", Conv2d(dim * (i + 1), dim, (2 * lorder - 1, 1),
                                                 dilation=(2**i, 1), groups=dim, bias=False))
            setattr(self, f"norm{i + 1}", nn.InstanceNorm1d(dim, eps=1e-5, affine=True))
            setattr(self, f"prelu{i + 1}", PReLU(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip, out = x, x
        for i in range(self.depth):
            dil = 2**i
            pad = self.lorder + (dil - 1) * (self.lorder - 1) - 1
            w = getattr(self, f"conv{i + 1}").weight[..., 0]
            out = F.conv1d(F.pad(skip, (pad, pad)), w, dilation=dil, groups=self.dim)
            out = getattr(self, f"prelu{i + 1}")(getattr(self, f"norm{i + 1}")(out))
            skip = torch.cat([out, skip], dim=1)
        return out


class UniDeepFsmnDilated(nn.Module):
    """fsmn.py:114-143 on (B, T, C): ``linear`` + ReLU, ``project``, the
    dilated dense memory ``conv``, residual."""

    def __init__(self, input_dim: int, hidden_size: int, lorder: int = 20, depth: int = 2):
        super().__init__()
        self.linear = Linear(input_dim, hidden_size)
        self.project = Linear(hidden_size, input_dim, bias=False)
        self.conv = DilatedDenseFSMN(input_dim, lorder, depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.project(torch.relu(self.linear(x)))
        return x + self.conv(p.transpose(1, 2)).transpose(1, 2)


class _GatedFSMN(nn.Module):
    def __init__(self, inner: int):
        super().__init__()
        self.to_u = FFConvM(inner, inner, "layernorm")
        self.to_v = FFConvM(inner, inner, "layernorm")
        self.fsmn = UniDeepFsmnDilated(inner, inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.to_v(x) * self.fsmn(self.to_u(x)) + x


class GatedFSMNBlock(nn.Module):
    """GatedFSMNBlockDilated (mossformer_block.py:391-426) on (B, T, C)."""

    def __init__(self, dim: int, inner: int = 256):
        super().__init__()
        self.conv1 = nn.Sequential(Conv1d(dim, inner, 1), PReLU())
        self.norm1 = LayerNorm(inner, eps=1e-5)
        self.gated_fsmn = _GatedFSMN(inner)
        self.norm2 = LayerNorm(inner, eps=1e-5)
        self.conv2 = Conv1d(inner, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(self.conv1(x.transpose(1, 2)).transpose(1, 2))
        h = self.norm2(self.gated_fsmn(h))
        return self.conv2(h.transpose(1, 2)).transpose(1, 2) + x


class _FlashFSMN(nn.Module):
    def __init__(self, flash: list, fsmn: list):
        super().__init__()
        self.layers = nn.ModuleList(flash)
        self.fsmn = nn.ModuleList(fsmn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for flash, fsmn in zip(self.layers, self.fsmn):
            x = fsmn(flash(x))
        return x


@register_model
class MossFormer2(MossFormer):
    """MossFormer's keyword names (mossformer2.yaml) and ``fsmn_inner``, the
    gated FSMN blocks' width. Built on ``device``: the card unless the
    caller names another."""

    ENC, DEC = "enc", "dec"

    def __init__(self, kernel_size: int = 16, stride: int = 8, bias: bool = False,
                 out_channels: int = 512, in_channels: int = 512, num_blocks: int = 24,
                 d_model: int = 512, attn_dropout: float = 0.1, group_size: int = 256,
                 query_key_dim: int = 128, expansion_factor: float = 4.0, causal: bool = False,
                 norm: str = "ln", num_spks: int = 2, sample_rate: int = 16000,
                 fsmn_inner: int = 256, *, device=None):
        self._setup(locals(), device)

    def _mdl(self, flash: list, dim: int) -> _Mdl:
        fsmn = [GatedFSMNBlock(dim, self._model_args["fsmn_inner"]) for _ in flash]
        return _Mdl(_AttMdl(_FlashFSMN(flash, fsmn), LayerNorm(dim, eps=1e-6)), dim,
                    ("intra_mdl", "intra_norm"))
