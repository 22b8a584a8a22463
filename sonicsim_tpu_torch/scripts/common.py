"""What the serving and evaluation CLIs share: float32 that is float32, the
model's forward and the PESQ columns."""

from __future__ import annotations

from typing import Callable

import torch

from ..infer import bf16_forward, to_waveform
from ..metrics import make_pesq


def strict_float32() -> None:
    """Run float32 convolutions and matmuls in full float32. cuDNN's default
    is TF32 for convolutions, which keeps about three decimal digits and is
    not the float32 the JAX package computes. ``cudnn.benchmark`` stays
    off: VAD and metadata spans give a new shape each time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_forward(model: torch.nn.Module, bf16: bool = False
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fwd(x)``: (B, T) on the model's device → (B, n_src, T) float32,
    under ``torch.inference_mode()``; in bfloat16 with ``bf16``."""
    apply = bf16_forward(model) if bf16 else model

    def fwd(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return to_waveform(model, apply(x), x.shape[-1])

    return fwd


def pesq_columns() -> dict:
    """The default pesq_nb/pesq_wb columns (reference wrapper.py:48). Where
    the native P.862 approximation scores them (the compiled ITU binding
    does not import), the column names say so: ``pesq_nb_native``,
    ``pesq_wb_native``."""
    p_nb, p_wb = make_pesq("nb"), make_pesq("wb")
    suffix = "" if p_nb.backend == "itu-p862-compiled" else "_native"
    return {f"pesq_nb{suffix}": p_nb, f"pesq_wb{suffix}": p_wb}
