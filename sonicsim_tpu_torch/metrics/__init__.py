"""Evaluation metrics (port of ``sonicsim_tpu.metrics``): SI-SDR(i), SNR,
BSS SDR(i), STOI, PESQ, the composite measures (CSIG/CBAK/COVL), DNSMOS and
SigMOS on the port's ONNX executor, the Whisper transcriber, WER, the
``MetricsTracker`` and its variants."""

from .composite import composite_measures, llr, ssnr, wss
from .dnsmos import DNSMOS, audio_melspec, librosa_mel_fb
from .onnx_torch import OnnxTorchModel, parse_onnx
from .pesq import pesq
from .sidecars import make_dnsmos, make_pesq, make_sigmos, make_sigmos_all, make_whisper_asr, wer
from .sigmos import SigMOS, sigmos_features, sigmos_stft, sigmos_window
from .sisdr import bss_sdr, sdr_improvement, si_sdr, si_sdr_improvement, snr
from .stoi import stoi
from .tracker import MetricsTracker
from .variants import MetricsTrackerNoASR, SplitMetricsTracker

__all__ = [
    "DNSMOS",
    "MetricsTracker",
    "MetricsTrackerNoASR",
    "OnnxTorchModel",
    "SigMOS",
    "SplitMetricsTracker",
    "audio_melspec",
    "bss_sdr",
    "composite_measures",
    "librosa_mel_fb",
    "llr",
    "make_dnsmos",
    "make_pesq",
    "make_sigmos",
    "make_sigmos_all",
    "make_whisper_asr",
    "parse_onnx",
    "pesq",
    "sdr_improvement",
    "si_sdr",
    "si_sdr_improvement",
    "sigmos_features",
    "sigmos_stft",
    "sigmos_window",
    "snr",
    "ssnr",
    "stoi",
    "wer",
    "wss",
]
