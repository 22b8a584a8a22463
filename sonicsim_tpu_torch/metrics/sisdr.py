"""Evaluation SDR metrics: SI-SDR(i), SNR and BSS-eval SDR(i).

Port of ``sonicsim_tpu.metrics.sisdr`` (reference separation/look2hear/
metrics/wrapper.py:62-148): torchmetrics ScaleInvariantSignalDistortionRatio
semantics for SI-SDR, and the fast_bss_eval-style SDR with a 512-tap
time-invariant distortion filter, solved in float32 with
``torch.linalg.solve`` (the JAX package solves in float32 too).
"""

from __future__ import annotations

import torch

EPS = 1e-8


def si_sdr(est: torch.Tensor, ref: torch.Tensor, zero_mean: bool = True) -> torch.Tensor:
    """Scale-invariant SDR in dB along the last axis (batch dims broadcast)."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        ref = ref - ref.mean(dim=-1, keepdim=True)
    dot = (est * ref).sum(dim=-1, keepdim=True)
    energy = (ref * ref).sum(dim=-1, keepdim=True) + EPS
    proj = dot * ref / energy
    noise = est - proj
    ratio = (proj**2).sum(dim=-1) / ((noise**2).sum(dim=-1) + EPS)
    return 10.0 * torch.log10(ratio + EPS)


def snr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    noise = est - ref
    ratio = (ref**2).sum(dim=-1) / ((noise**2).sum(dim=-1) + EPS)
    return 10.0 * torch.log10(ratio + EPS)


def bss_sdr(est: torch.Tensor, ref: torch.Tensor, filter_length: int = 512) -> torch.Tensor:
    """BSS-eval SDR: the reference may pass through a ``filter_length``-tap
    time-invariant distortion filter (fast_bss_eval convention).

    est/ref: (..., T). Solves the Toeplitz normal equations for the best
    projection of est onto ref's delayed span; at the optimum h (R h =
    xcorr) the target energy is h · xcorr and the error energy |est|² − h ·
    xcorr.
    """
    est = est - est.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    n = ref.shape[-1] + filter_length - 1
    nfft = 1
    while nfft < n:
        nfft *= 2
    rf = torch.fft.rfft(ref, nfft)
    ef = torch.fft.rfft(est, nfft)
    acorr = torch.fft.irfft(rf * rf.conj(), nfft)[..., :filter_length]
    xcorr = torch.fft.irfft(ef * rf.conj(), nfft)[..., :filter_length]
    lags = torch.arange(filter_length, device=ref.device)
    idx = (lags[:, None] - lags[None, :]).abs()
    toep = acorr[..., idx] + EPS * torch.eye(filter_length, device=ref.device, dtype=ref.dtype)
    h = torch.linalg.solve(toep, xcorr[..., None])[..., 0]
    s_energy = (h * xcorr).sum(dim=-1)
    e_energy = (est**2).sum(dim=-1) - s_energy
    return 10.0 * torch.log10(torch.clamp(s_energy, min=EPS) / torch.clamp(e_energy, min=EPS))


def si_sdr_improvement(est: torch.Tensor, ref: torch.Tensor,
                       mix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(SI-SDR, SI-SDRi) against the mixture baseline (wrapper.py:72-80)."""
    val = si_sdr(est, ref)
    base = si_sdr(mix.expand(ref.shape), ref)
    return val, val - base


def sdr_improvement(est: torch.Tensor, ref: torch.Tensor, mix: torch.Tensor,
                    filter_length: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    val = bss_sdr(est, ref, filter_length)
    base = bss_sdr(mix.expand(ref.shape), ref, filter_length)
    return val, val - base
