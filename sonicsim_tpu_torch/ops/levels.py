"""Level measurement and gain math for mixing (SNR/SIR).

Port of ``sonicsim_tpu/ops/levels.py``. Parity targets:

* ``rms_db`` — separation/look2hear/datas/movingdatamodule.py:29-32
  (10·log10(mean square), floored at 1e-20);
* ``mix_sources_sir`` / ``scale_noise_snr`` — the train-time mixing rules
  at movingdatamodule.py:106-124 (gain capped at +40 dB);
* ``peak_normalize`` / ``rms_normalize`` — SonicSim-SonicSet/
  SonicSim_audio.py:49-66 (peak / rms·100).
"""

from __future__ import annotations

import torch


def rms_db(wav: torch.Tensor) -> torch.Tensor:
    """RMS in dB over all axes (the reference floors at 1e-20)."""
    mean_square = torch.clamp(torch.mean(wav.to(torch.float32) ** 2), min=1e-20)
    return 10.0 * torch.log10(mean_square)


def gain_db_to_lin(gain_db: torch.Tensor) -> torch.Tensor:
    return 10.0 ** (gain_db / 20.0)


def mix_sources_sir(speakers: torch.Tensor, sirs_db: torch.Tensor) -> torch.Tensor:
    """Scale interferers to target SIRs relative to speaker 0.

    speakers: (n_spk, ...); sirs_db: (n_spk-1,). Returns scaled (n_spk, ...).
    Gain is capped at +40 dB like the reference (movingdatamodule.py:112).
    """
    target_db = rms_db(speakers[0])
    interf = speakers[1:]
    ms = torch.clamp(
        (interf.to(torch.float32) ** 2).reshape(interf.shape[0], -1).mean(dim=1),
        min=1e-20,
    )
    gain = torch.clamp(target_db - 10.0 * torch.log10(ms) - sirs_db, max=40.0)
    scale = gain_db_to_lin(gain).reshape(-1, *([1] * (interf.dim() - 1)))
    return torch.cat([speakers[:1], interf * scale], dim=0)


def scale_noise_snr(speech: torch.Tensor, noise: torch.Tensor, snr_db) -> torch.Tensor:
    """Scale ``noise`` so that speech/noise RMS ratio hits ``snr_db`` (cap +40 dB)."""
    gain = torch.clamp(rms_db(speech) - rms_db(noise) - snr_db, max=40.0)
    return noise * gain_db_to_lin(gain)


def peak_normalize(audio: torch.Tensor) -> torch.Tensor:
    peak = torch.max(torch.abs(audio))
    return torch.where(peak > 0, audio / peak, audio)


def rms_normalize(audio: torch.Tensor) -> torch.Tensor:
    """Reference 'rms' norm: divide by (rms · 100), ignoring trailing zeros:
    the samples after the last nonzero one (over any row) are left out of
    the mean (SonicSim_audio.py:56-64)."""
    x = audio.to(torch.float32)
    idx = torch.arange(x.shape[-1], device=x.device)
    last = torch.max(torch.where(x != 0, idx, -1))
    mask = idx <= last
    n = torch.clamp(mask.sum(), min=1)
    rms = torch.sqrt(torch.sum(torch.where(mask, x * x, 0.0)) / n) * 100.0
    return torch.where(rms > 0, x / rms, x)
