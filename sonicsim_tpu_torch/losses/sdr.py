"""SNR / SI-SDR / SD-SDR losses (port of ``sonicsim_tpu.losses.sdr``).

Reference separation/look2hear/losses/matrix.py:5-140 (PairwiseNegSDR,
SingleSrcNegSDR, MultiSrcNegSDR): the same zero-mean, eps and log
conventions; the STFT losses ``FreqMAE`` and ``FreqMAEWavL1``
(losses/matrix.py:145-185).
"""

from __future__ import annotations

import torch

from ..ops.stft import hann_window, stft

EPS = 1e-8
_SDR_TYPES = ("snr", "sisdr", "sdsdr")


def _check(sdr_type: str):
    if sdr_type not in _SDR_TYPES:
        raise ValueError(f"sdr_type must be one of {_SDR_TYPES}, got {sdr_type!r}")


def pairwise_neg_sdr(ests: torch.Tensor, targets: torch.Tensor, sdr_type: str = "sisdr",
                     zero_mean: bool = True, take_log: bool = True) -> torch.Tensor:
    """(B, n_src, T) × (B, n_src, T) → (B, n_est, n_tgt) negative SDR matrix."""
    _check(sdr_type)
    if zero_mean:
        targets = targets - targets.mean(dim=2, keepdim=True)
        ests = ests - ests.mean(dim=2, keepdim=True)
    s_target = targets[:, None, :, :]  # (B, 1, n_tgt, T)
    s_est = ests[:, :, None, :]  # (B, n_est, 1, T)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = (s_est * s_target).sum(dim=3, keepdim=True)
        energy = (s_target**2).sum(dim=3, keepdim=True) + EPS
        proj = dot * s_target / energy  # (B, n_est, n_tgt, T)
    else:
        proj = s_target.expand(targets.shape[0], ests.shape[1], *targets.shape[1:])
    e_noise = s_est - s_target if sdr_type in ("sdsdr", "snr") else s_est - proj
    sdr = (proj**2).sum(dim=3) / ((e_noise**2).sum(dim=3) + EPS)
    if take_log:
        sdr = 10.0 * torch.log10(sdr + EPS)
    return -sdr


def singlesrc_neg_sdr(ests: torch.Tensor, targets: torch.Tensor, sdr_type: str = "sisdr",
                      zero_mean: bool = True, take_log: bool = True) -> torch.Tensor:
    """(B, T) × (B, T) → (B,) negative SDR."""
    _check(sdr_type)
    if zero_mean:
        targets = targets - targets.mean(dim=1, keepdim=True)
        ests = ests - ests.mean(dim=1, keepdim=True)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = (ests * targets).sum(dim=1, keepdim=True)
        energy = (targets**2).sum(dim=1, keepdim=True) + EPS
        scaled = dot * targets / energy
    else:
        scaled = targets
    e_noise = ests - targets if sdr_type in ("sdsdr", "snr") else ests - scaled
    sdr = (scaled**2).sum(dim=1) / ((e_noise**2).sum(dim=1) + EPS)
    if take_log:
        sdr = 10.0 * torch.log10(sdr + EPS)
    return -sdr


def multisrc_neg_sdr(ests: torch.Tensor, targets: torch.Tensor, sdr_type: str = "sisdr",
                     zero_mean: bool = True, take_log: bool = True) -> torch.Tensor:
    """(B, n_src, T) aligned pairs → (B,) mean negative SDR over sources."""
    _check(sdr_type)
    b, n_src, t = ests.shape
    per_src = singlesrc_neg_sdr(ests.reshape(b * n_src, t), targets.reshape(b * n_src, t),
                                sdr_type=sdr_type, zero_mean=zero_mean, take_log=take_log)
    return per_src.reshape(b, n_src).mean(dim=-1)


class _NegSDR:
    """Config-holding callable (reference losses/matrix.py:5-49); each
    subclass names its function ``_fn``."""

    def __init__(self, sdr_type: str = "sisdr", zero_mean: bool = True, take_log: bool = True):
        _check(sdr_type)
        self.sdr_type = sdr_type
        self.zero_mean = zero_mean
        self.take_log = take_log

    def __call__(self, ests, targets):
        return self._fn(ests, targets, self.sdr_type, self.zero_mean, self.take_log)


class PairwiseNegSDR(_NegSDR):
    """Usable as a ``PITLossWrapper`` ``loss_func`` (pit_from='pw_mtx')."""

    _fn = staticmethod(pairwise_neg_sdr)


class SingleSrcNegSDR(_NegSDR):
    _fn = staticmethod(singlesrc_neg_sdr)


class MultiSrcNegSDR(_NegSDR):
    _fn = staticmethod(multisrc_neg_sdr)


def _freq_mae(ests: torch.Tensor, targets: torch.Tensor, win: int, stride: int,
              with_wav_l1: bool) -> torch.Tensor:
    """(B, n_src, T) pairs → (B,): the L1 of the STFTs' real and imaginary
    parts (Hann window), each averaged over (F, frames), plus the waveform's
    mean L1 with ``with_wav_l1``; averaged over the sources."""
    b, n_src, t = ests.shape
    window = hann_window(win, device=ests.device)
    es, ts = (stft(x.reshape(-1, t), win, stride, window) for x in (ests, targets))
    loss = ((es.real - ts.real).abs().mean((1, 2))
            + (es.imag - ts.imag).abs().mean((1, 2))).reshape(b, n_src).mean(-1)
    if with_wav_l1:
        loss = loss + (ests - targets).abs().mean(-1).reshape(b, n_src).mean(-1)
    return loss


class FreqMAE:
    """STFT real + imaginary L1 (losses/matrix.py:168-185), (B,)."""

    def __init__(self, win: int = 2048, stride: int = 512):
        self.win, self.stride = win, stride

    def __call__(self, ests, targets):
        return _freq_mae(ests, targets, self.win, self.stride, False)


class FreqMAEWavL1:
    """STFT L1 + waveform L1 (losses/matrix.py:145-166), (B,)."""

    def __init__(self, win: int = 2048, stride: int = 512):
        self.win, self.stride = win, stride

    def __call__(self, ests, targets):
        return _freq_mae(ests, targets, self.win, self.stride, True)
