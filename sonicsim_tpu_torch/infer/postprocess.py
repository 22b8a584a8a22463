"""Model output → waveform (port of ``sonicsim_tpu.infer.postprocess``).

``to_waveform(model, output, length)`` → (B, n_src, T). The port has the
separation models' branch; the enhancement families' converters (cIRM,
GaGNet, TaylorSENet, FRCRN, DCCRN, BSRNN-ESPnet) wait for ROADMAP A9.
"""

from __future__ import annotations

import torch

_ENHANCEMENT = ("fullband", "fullsubnet", "fullsubnet_plus", "inter_subnet",
                "fastfullsubnet", "gagnet", "g2net", "taylorsenet", "frcrn",
                "dccrn", "bsrnnespnet")


def to_waveform(model, output: torch.Tensor, length: int) -> torch.Tensor:
    name = type(model).__name__.lower()
    if name in _ENHANCEMENT:
        raise NotImplementedError(
            f"{type(model).__name__}: the enhancement models' output "
            "converters are not ported yet (ROADMAP A9)"
        )
    # Separation models already emit (B, n_src, T).
    if output.dim() == 2:
        output = output[:, None, :]
    return output[..., :length]
