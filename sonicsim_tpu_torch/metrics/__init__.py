"""Evaluation metrics (port of the separation battery of
``sonicsim_tpu.metrics``): SI-SDR(i), SNR, BSS SDR(i), STOI, PESQ and the
``MetricsTracker``. DNSMOS, SigMOS, Whisper, the composite measures and the
tracker variants wait for ROADMAP A10."""

from .pesq import pesq
from .sidecars import make_pesq
from .sisdr import bss_sdr, sdr_improvement, si_sdr, si_sdr_improvement, snr
from .stoi import stoi
from .tracker import MetricsTracker

__all__ = [
    "MetricsTracker",
    "bss_sdr",
    "make_pesq",
    "pesq",
    "sdr_improvement",
    "si_sdr",
    "si_sdr_improvement",
    "snr",
    "stoi",
]
