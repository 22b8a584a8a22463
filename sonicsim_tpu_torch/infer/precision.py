"""Reduced-precision inference.

Port of ``sonicsim_tpu.infer.precision``. ``bf16_forward`` computes the
whole model in bfloat16, the norms' statistics included, as the JAX
package's ``bf16_forward`` does. ``torch.autocast`` is not that function:
it keeps norms and reductions in float32.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
import torch.nn as nn


def bf16_forward(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fwd(x) -> float32 output`` computing in bfloat16.

    The forward runs on a bfloat16 copy of ``model``, made here, so the
    float32 model is left as it is; weights changed on ``model`` after this
    call are not seen by ``fwd``. The input is cast to bfloat16 and the
    output back to float32.
    """
    model16 = copy.deepcopy(model).to(torch.bfloat16)

    def fwd(x: torch.Tensor) -> torch.Tensor:
        return model16(x.to(torch.bfloat16)).to(torch.float32)

    return fwd
