"""DNSMOS P.835 / P.808 MOS prediction on the port's ONNX executor.

Port of ``sonicsim_tpu.metrics.dnsmos`` (reference separation/look2hear/
metrics/dnsmos.py:22-95): 9.01 s hops, the raw waveform into the P.835
model and a librosa-style log-mel spectrogram into the P.808 model, with
the published polynomial calibration. The features are the JAX package's
numpy code, copied; the graphs run through ``metrics/onnx_torch.py`` on the
device the caller names (the card unless given). The .onnx weights are the
published Microsoft DNS-challenge files; pass their directory.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3.0)
    log_region = f >= 1000.0
    mel = np.where(
        log_region, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / np.log(6.4) * 27.0,
        mel,
    )
    return mel


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f = m * (200.0 / 3.0)
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)


def librosa_mel_fb(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel defaults (slaney scale + slaney norm) →
    (n_mels, 1 + n_fft // 2)."""
    n_freqs = 1 + n_fft // 2
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(0.0), _hz_to_mel_slaney(sr / 2.0), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def audio_melspec(
    audio: np.ndarray,
    n_mels: int = 120,
    frame_size: int = 320,
    hop_length: int = 160,
    sr: int = 16000,
    to_db: bool = True,
) -> np.ndarray:
    """librosa.feature.melspectrogram parity (n_fft = frame_size + 1,
    center=True reflect, |S|², slaney mel) → (frames, n_mels)."""
    n_fft = frame_size + 1
    pad = n_fft // 2
    x = np.pad(np.asarray(audio, np.float64), pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann (scipy/librosa)
    frames = x[idx] * window
    spec = np.abs(np.fft.rfft(frames, n_fft)) ** 2  # (frames, F)
    mel = spec @ librosa_mel_fb(sr, n_fft, n_mels).T  # (frames, n_mels)
    if to_db:
        ref = mel.max()
        mel_db = 10.0 * np.log10(np.maximum(mel, 1e-10) / max(ref, 1e-10))
        mel_db = np.maximum(mel_db, mel_db.max() - 80.0)
        mel = (mel_db + 40.0) / 40.0
    return mel.astype(np.float32)


_POLY = {
    False: {
        "ovr": [-0.06766283, 1.11546468, 0.04602535],
        "sig": [-0.08397278, 1.22083953, 0.0052439],
        "bak": [-0.13166888, 1.60915514, -0.39604546],
    },
    True: {
        "ovr": [-0.00533021, 0.005101, 1.18058466, -0.11236046],
        "sig": [-0.01019296, 0.02751166, 1.19576786, -0.24348726],
        "bak": [-0.04976499, 0.44276479, -0.1644611, 0.96883132],
    },
}


class DNSMOS:
    """MOS predictor over the published DNSMOS ONNX weights.

    ``model_dir`` must contain model_v8.onnx and sig_bak_ovr.onnx; the
    graphs run on ``device`` (the card unless given).
    """

    def __init__(self, model_dir: str | Path, device=None):
        from .onnx_torch import OnnxTorchModel

        model_dir = Path(model_dir)
        # Wired by declared input shapes (the reference's variable names at
        # dnsmos.py:24-25 swap the two files): sig_bak_ovr.onnx takes the
        # raw (N, 144160) waveform → (SIG, BAK, OVRL); model_v8.onnx takes
        # the (N, 900, 120) log-mel spectrogram → P.808 MOS.
        self.p835 = OnnxTorchModel(model_dir / "sig_bak_ovr.onnx", device)
        self.p808 = OnnxTorchModel(model_dir / "model_v8.onnx", device)

    def __call__(
        self, audio: np.ndarray, sampling_rate: int = SAMPLING_RATE,
        is_personalized_mos: bool = False,
    ) -> dict:
        fs = sampling_rate
        audio = np.asarray(audio, np.float32).reshape(-1)
        if len(audio) == 0:
            raise ValueError("DNSMOS: empty audio")
        len_samples = int(INPUT_LENGTH * fs)
        while len(audio) < len_samples:
            audio = np.append(audio, audio)
        num_hops = int(np.floor(len(audio) / fs) - INPUT_LENGTH) + 1

        raw = {"sig": [], "bak": [], "ovr": [], "p808": []}
        for idx in range(num_hops):
            seg = audio[int(idx * fs) : int((idx + INPUT_LENGTH) * fs)]
            if len(seg) < len_samples:
                continue
            mos_sig, mos_bak, mos_ovr = self.p835(seg[None, :].astype(np.float32))[0][0].tolist()
            mel = audio_melspec(seg[:-160])[None]
            p808 = float(self.p808(mel)[0][0][0])
            raw["sig"].append(float(mos_sig))
            raw["bak"].append(float(mos_bak))
            raw["ovr"].append(float(mos_ovr))
            raw["p808"].append(p808)

        poly = _POLY[is_personalized_mos]
        calib = {
            k: float(np.mean(np.polyval(poly[k], raw[k]))) if raw[k] else float("nan")
            for k in ("sig", "bak", "ovr")
        }
        return {
            "OVRL_raw": float(np.mean(raw["ovr"])),
            "SIG_raw": float(np.mean(raw["sig"])),
            "BAK_raw": float(np.mean(raw["bak"])),
            "OVRL": calib["ovr"],
            "SIG": calib["sig"],
            "BAK": calib["bak"],
            "P808_MOS": float(np.mean(raw["p808"])),
            "num_hops": num_hops,
        }
