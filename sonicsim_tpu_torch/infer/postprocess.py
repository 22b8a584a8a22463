"""Model output → waveform (port of ``sonicsim_tpu.infer.postprocess``).

The enhancement zoo returns outputs of several kinds (cIRM tuples, stage
lists, compressed spectra, waveforms); the reference's eval scripts
dispatch per model family (enhancement/test.py:41-77, 128-135).
``to_waveform(model, output, length)`` → (B, n_src, T).
"""

from __future__ import annotations

import torch

from ..losses.cirm import cirm_inference
from ..losses.gagnet import gagnet_wav
from ..losses.taylorsenet import taylor_wav

_CIRM = ("fullband", "fullsubnet", "fullsubnet_plus", "inter_subnet", "fastfullsubnet")
_WAVEFORM = ("dccrn", "bsrnnespnet")


def to_waveform(model, output, length: int) -> torch.Tensor:
    name = type(model).__name__.lower()
    if name in _CIRM:
        return cirm_inference(output, model.n_fft, model.hop_length, length)[:, None, :]
    if name in ("gagnet", "g2net"):
        return gagnet_wav(output, model.n_fft, model.hop_length, length)[:, None, :]
    if name == "taylorsenet":
        return taylor_wav(output, model.n_fft, model.hop_length, length)[:, None, :]
    if name == "frcrn":
        return output[1][4][:, None, :]  # the refined stage's waveform
    if name in _WAVEFORM:
        return output[:, None, :] if output.dim() == 2 else output
    # Separation models and SuDORMRF already emit (B, n_src, T).
    if output.dim() == 2:
        output = output[:, None, :]
    return output[..., :length]
