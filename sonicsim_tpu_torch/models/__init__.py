"""The port's models: ConvTasNet, the separation zoo but SkiM, and the
registry. SkiM (with its streaming path) and the enhancement zoo wait for
ROADMAP A8 and A9."""

from .base import (
    MODELS,
    BaseModel,
    from_pretrain,
    get,
    register_model,
    save_model,
    serialize,
)
from .afrcnn import AFRCNN
from .bsrnn import BSRNN
from .conv_tasnet import ConvTasNet
from .dprnn import DPRNNTasNet
from .dptnet import DPTNetModel
from .enc_dec import FreeDecoder, FreeEncoder, make_enc_dec
from .mossformer import MossFormer
from .mossformer2 import MossFormer2
from .sudormrf import SuDORMRF
from .tdanet import TDANet
from .tfgridnet import TFGridNet

__all__ = [
    "AFRCNN",
    "BSRNN",
    "MODELS",
    "BaseModel",
    "ConvTasNet",
    "DPRNNTasNet",
    "DPTNetModel",
    "FreeDecoder",
    "FreeEncoder",
    "from_pretrain",
    "get",
    "make_enc_dec",
    "MossFormer",
    "MossFormer2",
    "register_model",
    "save_model",
    "serialize",
    "SuDORMRF",
    "TDANet",
    "TFGridNet",
]
