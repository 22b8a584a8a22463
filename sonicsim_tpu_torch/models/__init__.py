"""The port's models: ConvTasNet and the registry. The rest of the JAX
package's zoo waits for ROADMAP A8 (separation) and A9 (enhancement)."""

from .base import (
    MODELS,
    BaseModel,
    from_pretrain,
    get,
    register_model,
    save_model,
    serialize,
)
from .conv_tasnet import ConvTasNet

__all__ = [
    "MODELS",
    "BaseModel",
    "ConvTasNet",
    "from_pretrain",
    "get",
    "register_model",
    "save_model",
    "serialize",
]
