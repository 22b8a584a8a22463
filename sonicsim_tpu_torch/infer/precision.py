"""Reduced-precision inference.

Port of ``sonicsim_tpu.infer.precision``. ``bf16_forward`` computes the
whole model in bfloat16, the norms' statistics included, as the JAX
package's ``bf16_forward`` does. ``torch.autocast`` is not that function:
it keeps norms and reductions in float32.

bf16 is held against float32 for ConvTasNet alone (its serving and train
step); the zoo's models refuse it (:func:`require_bf16`) until theirs is.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
import torch.nn as nn


BF16_MODELS = ("ConvTasNet",)


def require_bf16(model: nn.Module) -> None:
    """Raise unless ``model``'s bf16 path is held against its float32 one."""
    if type(model).__name__ not in BF16_MODELS:
        raise NotImplementedError(
            f"{type(model).__name__}: bf16 is held against float32 for {BF16_MODELS} "
            "only; run it in float32")


def bf16_forward(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fwd(x) -> float32 output`` computing in bfloat16.

    The forward runs on a bfloat16 copy of ``model``, made here, so the
    float32 model is left as it is; weights changed on ``model`` after this
    call are not seen by ``fwd``. The input is cast to bfloat16 and the
    output back to float32.
    """
    require_bf16(model)
    model16 = copy.deepcopy(model).to(torch.bfloat16)

    def fwd(x: torch.Tensor) -> torch.Tensor:
        return model16(x.to(torch.bfloat16)).to(torch.float32)

    return fwd
