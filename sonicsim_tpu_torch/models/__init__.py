"""The port's models: ConvTasNet, the separation zoo (SkiM with its
streamer), the enhancement zoo but the GaGNet family (ROADMAP A9), and the
registry."""

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
from .bsrnn_espnet import BSRNNESPNet
from .conv_tasnet import ConvTasNet
from .dccrn import DCCRN
from .dprnn import DPRNNTasNet
from .dptnet import DPTNetModel
from .enc_dec import FreeDecoder, FreeEncoder, make_enc_dec
from .fastfullsubnet import FastFullSubnet
from .frcrn import FRCRN
from .fullsubnet import Fullband, FullSubnet
from .fullsubnet_plus import FullSubNet_Plus
from .inter_subnet import Inter_SubNet
from .mossformer import MossFormer
from .mossformer2 import MossFormer2
from .skim import SkiMNet, SkiMStreamer
from .sudormrf import SuDORMRF
from .tdanet import TDANet
from .tfgridnet import TFGridNet

__all__ = [
    "AFRCNN",
    "BSRNN",
    "BSRNNESPNet",
    "MODELS",
    "BaseModel",
    "ConvTasNet",
    "DCCRN",
    "DPRNNTasNet",
    "DPTNetModel",
    "FastFullSubnet",
    "FRCRN",
    "FreeDecoder",
    "FreeEncoder",
    "Fullband",
    "FullSubnet",
    "FullSubNet_Plus",
    "from_pretrain",
    "get",
    "Inter_SubNet",
    "make_enc_dec",
    "MossFormer",
    "MossFormer2",
    "register_model",
    "save_model",
    "serialize",
    "SkiMNet",
    "SkiMStreamer",
    "SuDORMRF",
    "TDANet",
    "TFGridNet",
]
