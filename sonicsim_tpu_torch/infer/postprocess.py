"""Model output → waveform (port of ``sonicsim_tpu.infer.postprocess``).

The enhancement zoo returns outputs of several kinds (cIRM tuples, stage
lists, waveforms); the reference's eval scripts dispatch per model family
(enhancement/test.py:41-77, 128-135). ``to_waveform(model, output,
length)`` → (B, n_src, T). The GaGNet family's converters (GaGNet, G2Net,
TaylorSENet) wait for ROADMAP A9.
"""

from __future__ import annotations

import torch

from ..losses.cirm import cirm_inference

_CIRM = ("fullband", "fullsubnet", "fullsubnet_plus", "inter_subnet", "fastfullsubnet")
_WAVEFORM = ("dccrn", "bsrnnespnet")
_UNPORTED = ("gagnet", "g2net", "taylorsenet")


def to_waveform(model, output, length: int) -> torch.Tensor:
    name = type(model).__name__.lower()
    if name in _CIRM:
        return cirm_inference(output, model.n_fft, model.hop_length, length)[:, None, :]
    if name == "frcrn":
        return output[1][4][:, None, :]  # the refined stage's waveform
    if name in _UNPORTED:
        raise NotImplementedError(
            f"{type(model).__name__}: the GaGNet family's output converters are not "
            "ported yet (ROADMAP A9)")
    if name in _WAVEFORM:
        return output[:, None, :] if output.dim() == 2 else output
    # Separation models and SuDORMRF already emit (B, n_src, T).
    if output.dim() == 2:
        output = output[:, None, :]
    return output[..., :length]
