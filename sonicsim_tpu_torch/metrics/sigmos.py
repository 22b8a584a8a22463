"""SigMOS (ITU-T P.804) MOS estimation on the port's ONNX executor.

Port of ``sonicsim_tpu.metrics.sigmos`` (reference separation/sigmos/
sigmos.py:17-84): 48 kHz input, 960-pt √Hann STFT at 480 hop with the
reference's tail-padding rule, compressed magnitude+complex features
(compress factor 0.3), 7 MOS axes. The features are the JAX package's numpy
code, copied; the graph runs through ``metrics/onnx_torch.py`` on the
device the caller names (the card unless given). The .onnx weights are not
committed in the reference either; pass the model path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SAMPLING_RATE = 48_000
DFT_SIZE = 960
FRAME_SIZE = 480
WINDOW_LENGTH = 960


def sigmos_window() -> np.ndarray:
    """√Hann analysis window (sigmos.py:27 convention: periodic Hann)."""
    return np.sqrt(np.hanning(WINDOW_LENGTH + 1)[:-1]).astype(np.float32)


def sigmos_stft(signal: np.ndarray,
                window: np.ndarray | None = None) -> np.ndarray:
    """960-pt √Hann STFT at 480 hop with the reference tail-padding rule.

    Parity: sigmos/sigmos.py:30-43 — lead pad of (window - hop), tail pad
    to a whole final frame.
    """
    if window is None:
        window = sigmos_window()
    signal = np.asarray(signal, np.float32).reshape(-1)
    last = len(signal) % FRAME_SIZE or FRAME_SIZE
    lead = WINDOW_LENGTH - FRAME_SIZE
    padded = np.pad(signal, (lead, WINDOW_LENGTH - last))
    n_frames = (len(padded) - WINDOW_LENGTH) // FRAME_SIZE + 1
    idx = (
        np.arange(n_frames)[:, None] * FRAME_SIZE
        + np.arange(WINDOW_LENGTH)[None, :]
    )
    return np.fft.rfft(padded[idx] * window, DFT_SIZE).astype(np.complex64)


def sigmos_features(spec: np.ndarray,
                    compress_factor: float = 0.3) -> np.ndarray:
    """Compressed magnitude + complex features (sigmos.py:46-58).

    (frames, F) complex → (1, 3, frames, F) float32:
    [|X|^c, Re(X)|X|^(c-1), Im(X)|X|^(c-1)].
    """
    x = np.stack([spec.real, spec.imag], axis=-2)  # (frames, 2, F)
    x2 = np.maximum((x * x).sum(axis=-2, keepdims=True), 1e-12)
    x = np.power(x2, (compress_factor - 1) / 2) * x
    mag = np.power(x2, compress_factor / 2)
    features = np.concatenate([mag, x], axis=-2)  # (frames, 3, F)
    features = np.transpose(features, (1, 0, 2))  # (3, frames, F)
    return features[None].astype(np.float32)


class SigMOS:
    SAMPLING_RATE = SAMPLING_RATE
    DFT_SIZE = DFT_SIZE
    FRAME_SIZE = FRAME_SIZE
    WINDOW_LENGTH = WINDOW_LENGTH

    AXES = ("MOS_COL", "MOS_DISC", "MOS_LOUD", "MOS_NOISE", "MOS_REVERB",
            "MOS_SIG", "MOS_OVRL")

    def __init__(self, model_path: str | Path, device=None):
        from .onnx_torch import OnnxTorchModel

        if not Path(model_path).exists():
            raise FileNotFoundError(
                f"SigMOS weights not found at {model_path}; download the "
                "published model-sigmos_*.onnx (not committed in the "
                "reference either) and pass its path."
            )
        self.model = OnnxTorchModel(model_path, device)
        self.window = sigmos_window()

    def __call__(self, audio: np.ndarray, sr: int | None = None) -> dict:
        audio = np.asarray(audio, np.float32).reshape(-1)
        if sr is not None and sr != self.SAMPLING_RATE:
            # Fourier-method resample, matching the reference's
            # librosa res_type='fft' (sigmos/sigmos.py:30,70) —
            # librosa maps it to scipy.signal.resample with
            # ceil(n * ratio) output samples; polyphase would give
            # slightly different 48 kHz signals and thus different MOS.
            from scipy.signal import resample as _fft_resample

            n_out = int(np.ceil(len(audio) * self.SAMPLING_RATE / sr))
            audio = _fft_resample(audio, n_out).astype(np.float32)
        feats = sigmos_features(sigmos_stft(audio, self.window))
        out = self.model(feats)[0][0].tolist()
        return {name: float(out[i]) for i, name in enumerate(self.AXES)}
