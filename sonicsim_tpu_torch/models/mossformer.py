"""MossFormer (gated single-head FLASH attention separation) in PyTorch.

Port of ``sonicsim_tpu.models.mossformer`` (reference
separation/look2hear/models/mossformer.py and mossformer_block.py; config
configs/separation/mossformer.yaml: encoder k16/s8, 512 dims, 24 blocks,
groups of 256, qk 128, expansion 4): ReLU conv encoder → mask net
(GroupNorm(1), 1×1 conv, scaled sinusoidal positions, FLASH blocks, a
LayerNorm and a GroupNorm(1) with a skip, PReLU, per-speaker 1×1 conv,
tanh·sigmoid gate, ReLU) → masks on the encoder output → transposed-conv
decoder.

The FLASH block (mossformer_block.py:143-294), as the JAX model computes
it: a token shift on half the channels; a shared qk projection scaled and
offset into four heads with a partial rotary embedding (GPT-J interleaved
pairs) on the first 32 features; ReLU² attention inside groups of
``group_size`` frames, (B, groups, g, g) scores scaled by 1/g, plus a
global linear attention over all frames scaled by 1/T; the gate
(u · att_v) · σ(v · att_u). Explicit products, as there.

``attn_dropout``, ``causal`` and ``norm`` are kept as fields and unused, as
in the JAX package: no dropout is applied, in training either. Parameter
names are the reference's (``encoder.conv1d``, ``mask_net.*``,
``decoder``); the reference's ``pos_enc.inv_freq`` buffer is skipped on
load, and the tables are computed in float64 and rounded to float32 as the
JAX model does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import BaseModel, register_model
from .layers import Conv1d, ConvTranspose1d, LayerNorm, Linear, PReLU, float32_or_wider
from .zoo_layers import GroupNorm1, PrefixTable, ignore_on_load


class ScaleNorm(nn.Module):
    """mossformer_block.py:44-57: x / max(‖x‖·dim^-½, eps) · g."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale, self.eps = dim**-0.5, eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.scale
        return x / torch.clamp(norm, min=self.eps) * self.g


class ScaledSinuEmbedding(nn.Module):
    """mossformer_block.py:60-73: fixed sin/cos over frames, a learned
    ``scale``."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2) / dim))

        def table(n):
            sinu = np.arange(n)[:, None] * inv_freq[None, :]
            return np.concatenate([np.sin(sinu), np.cos(sinu)], axis=-1).astype(np.float32)

        self._table = PrefixTable(table)
        ignore_on_load(self, "inv_freq")

    def forward(self, n: int, device) -> torch.Tensor:
        return self._table(n, device) * self.scale


class _DepthwiseConv(nn.Module):
    def __init__(self, dim: int, kernel_size: int):
        super().__init__()
        self.conv = Conv1d(dim, dim, kernel_size, padding=(kernel_size - 1) // 2,
                           groups=dim, bias=False)


class ConvModuleRes(nn.Module):
    """Residual depthwise conv over frames (conv_module.py:180-219) on
    (B, T, C); the reference's transpose slot is ``sequential.0``."""

    def __init__(self, dim: int, kernel_size: int = 17):
        super().__init__()
        self.sequential = nn.Sequential(nn.Identity(), _DepthwiseConv(dim, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.sequential[1].conv(x.transpose(1, 2)).transpose(1, 2)


class FFConvM(nn.Module):
    """norm → linear → SiLU → residual depthwise conv
    (mossformer_block.py:89-103), as ``mdl.{0,1,2,3}`` (``mdl.4`` is the
    reference's dropout slot). ``linear_in`` is the width the linear reads
    where it differs from the norm's ``dim_in``, as flax infers it."""

    def __init__(self, dim_in: int, dim_out: int, norm_type: str = "scalenorm",
                 linear_in: int | None = None):
        super().__init__()
        norm = ScaleNorm(dim_in) if norm_type == "scalenorm" else LayerNorm(dim_in, eps=1e-6)
        self.mdl = nn.Sequential(norm, Linear(linear_in or dim_in, dim_out), nn.SiLU(),
                                 ConvModuleRes(dim_out), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mdl(x)


def _rotary(x: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """Partial rotary embedding on the first ``rot_dim`` features (GPT-J
    interleaved pairs), positions along axis 1."""
    t, half = x.shape[1], rot_dim // 2
    freqs = 1.0 / (10000 ** (np.arange(half) / half))
    angles = torch.from_numpy((np.arange(t)[:, None] * freqs[None, :]).astype(np.float32))
    # float32 as in the JAX package, float64 in a float64 step.
    angles = angles.to(x.device, float32_or_wider(x.dtype))
    cos, sin = torch.cos(angles), torch.sin(angles)
    xr = x[..., :rot_dim]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(xr.shape)
    return torch.cat([rotated, x[..., rot_dim:]], dim=-1)


class _OffsetScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(4, dim))
        self.beta = nn.Parameter(torch.zeros(4, dim))


class FlashBlock(nn.Module):
    """FLASH_ShareA_FFConvM (mossformer_block.py:143-294), non-causal, on
    (B, T, C)."""

    def __init__(self, dim: int, group_size: int = 256, query_key_dim: int = 128,
                 expansion_factor: float = 4.0, norm_type: str = "scalenorm",
                 shift_tokens: bool = True):
        super().__init__()
        hidden = int(dim * expansion_factor)
        self.group_size, self.shift_tokens = group_size, shift_tokens
        self.rot = min(32, query_key_dim)
        self.to_hidden = FFConvM(dim, hidden, norm_type)
        self.to_qk = FFConvM(dim, query_key_dim, norm_type)
        self.qk_offset_scale = _OffsetScale(query_key_dim)
        self.to_out = FFConvM(dim * 2, dim, norm_type, linear_in=hidden // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        normed = x
        if self.shift_tokens:
            x_shift, x_pass = normed.chunk(2, dim=-1)
            normed = torch.cat([F.pad(x_shift, (0, 0, 1, -1)), x_pass], dim=-1)
        v, u = self.to_hidden(normed).chunk(2, dim=-1)
        qk = self.to_qk(normed)
        heads = qk[..., None, :] * self.qk_offset_scale.gamma + self.qk_offset_scale.beta
        quad_q, lin_q, quad_k, lin_k = (_rotary(heads[..., i, :], self.rot) for i in range(4))

        g = self.group_size
        pad = (-n) % g
        ng = (n + pad) // g

        def grp(t):
            return F.pad(t, (0, 0, 0, pad)).reshape(b, ng, g, t.shape[-1])

        qq, qk_, lq, lk, vg, ug = map(grp, (quad_q, quad_k, lin_q, lin_k, v, u))
        attn = torch.relu(qq @ qk_.transpose(-1, -2) / g) ** 2  # (B, groups, g, g)
        quad_v, quad_u = attn @ vg, attn @ ug
        # Global linear attention (non-causal: mossformer_block.py:283-289).
        lin_kv = torch.einsum("bgnd,bgne->bde", lk, vg) / n
        lin_v = torch.einsum("bgnd,bde->bgne", lq, lin_kv)
        lin_ku = torch.einsum("bgnd,bgne->bde", lk, ug) / n
        lin_u = torch.einsum("bgnd,bde->bgne", lq, lin_ku)
        att_v = (quad_v + lin_v).reshape(b, n + pad, -1)[:, :n]
        att_u = (quad_u + lin_u).reshape(b, n + pad, -1)[:, :n]
        return x + self.to_out((att_u * v) * torch.sigmoid(att_v * u))


class _Layers(nn.Module):
    def __init__(self, blocks: list):
        super().__init__()
        self.layers = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class _Norm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class _AttMdl(nn.Module):
    def __init__(self, core: nn.Module, norm: nn.Module):
        super().__init__()
        self.mossformerM = core
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.mossformerM(x))


class _Mdl(nn.Module):
    """The attention stack, its final LayerNorm and GroupNorm(1), and the
    skip (ComputeAttention): ``att_mdl``/``att_norm`` in MossFormer,
    ``intra_mdl``/``intra_norm`` in MossFormer2."""

    def __init__(self, att: nn.Module, dim: int, names: tuple[str, str]):
        super().__init__()
        self._names = names
        setattr(self, names[0], att)
        setattr(self, names[1], GroupNorm1(dim, channel_last=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, S, N)
        att, norm = (getattr(self, n) for n in self._names)
        return x + norm(att(x))


class _Encoder(nn.Module):
    def __init__(self, n: int, k: int, stride: int):
        super().__init__()
        self.conv1d = Conv1d(1, n, k, stride=stride, bias=False)


class _MaskNet(nn.Module):
    def __init__(self, n: int, n_in: int, spks: int, mdl: _Mdl):
        super().__init__()
        self.spks = spks
        self.norm = GroupNorm1(n)
        self.conv1d_encoder = Conv1d(n, n, 1, bias=False)
        self.pos_enc = ScaledSinuEmbedding(n)
        self.mdl = mdl
        self.prelu = PReLU()
        self.conv1d_out = Conv1d(n, n * spks, 1)
        self.output = nn.Sequential(Conv1d(n, n, 1), nn.Tanh())
        self.output_gate = nn.Sequential(Conv1d(n, n, 1), nn.Sigmoid())
        self.conv1_decoder = Conv1d(n, n_in, 1, bias=False)

    def forward(self, enc: torch.Tensor) -> torch.Tensor:  # (B, N, S) → (B·spks, N_in, S)
        x = self.conv1d_encoder(self.norm(enc)).transpose(1, 2)  # (B, S, N)
        x = x + self.pos_enc(x.shape[1], x.device)
        x = self.conv1d_out(self.prelu(self.mdl(x)).transpose(1, 2))  # (B, N·spks, S)
        b, _, s = x.shape
        x = x.reshape(b * self.spks, -1, s)
        return torch.relu(self.conv1_decoder(self.output(x) * self.output_gate(x)))


@register_model
class MossFormer(BaseModel):
    """Keyword names are the JAX package's fields (mossformer.yaml). Built
    on ``device``: the card unless the caller names another."""

    ENC, DEC = "encoder", "decoder"  # the reference's module names

    def __init__(self, kernel_size: int = 16, stride: int = 8, bias: bool = False,
                 out_channels: int = 512, in_channels: int = 512, num_blocks: int = 24,
                 d_model: int = 512, attn_dropout: float = 0.1, group_size: int = 256,
                 query_key_dim: int = 128, expansion_factor: float = 4.0, causal: bool = False,
                 norm: str = "ln", num_spks: int = 2, sample_rate: int = 16000, *,
                 device=None):
        self._setup(locals(), device)

    def _setup(self, args: dict, device) -> None:
        """Build from the constructor's arguments (its ``locals()``)."""
        args = {k: v for k, v in args.items() if k not in ("self", "device")}
        BaseModel.__init__(self, args)
        a = self._model_args
        self.num_spks, self.sample_rate = a["num_spks"], a["sample_rate"]
        n, k = a["out_channels"], a["kernel_size"]
        flash = [FlashBlock(a["d_model"], a["group_size"], a["query_key_dim"],
                            a["expansion_factor"]) for _ in range(a["num_blocks"])]
        setattr(self, self.ENC, _Encoder(n, k, a["stride"]))
        self.mask_net = _MaskNet(n, a["in_channels"], self.num_spks, self._mdl(flash, n))
        setattr(self, self.DEC, ConvTranspose1d(a["in_channels"], 1, k, stride=a["stride"],
                                                bias=a["bias"]))
        self.place(device)

    def _mdl(self, flash: list, dim: int) -> _Mdl:
        return _Mdl(_AttMdl(_Layers(flash), _Norm(dim)), dim, ("att_mdl", "att_norm"))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # (B, T) → (B, S, T)
        if wav.dim() == 1:
            wav = wav[None, :]
        bsz, nsample = wav.shape
        enc = torch.relu(getattr(self, self.ENC).conv1d(wav[:, None, :]))  # (B, N, S)
        masks = self.mask_net(enc)
        dec = getattr(self, self.DEC)(enc.repeat_interleave(self.num_spks, dim=0) * masks)
        dec = dec[:, 0, :nsample]
        dec = F.pad(dec, (0, nsample - dec.shape[-1]))
        return dec.reshape(bsz, self.num_spks, nsample)
