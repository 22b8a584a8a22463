"""Losses and metrics (port of ``sonicsim_tpu.losses``): SI-SDR/SNR/SD-SDR,
PIT, the STFT losses, SI-SNRi, MixIT, and the enhancement zoo's training
losses and metrics (the cIRM's, DCCRN's, FRCRN's, BSRNN-ESPnet's and the
GaGNet family's)."""

from .bsrnn_espnet import BSRNNESPNetEval, BSRNNESPNetLoss
from .cirm import (
    FullbandEval,
    FullbandLoss,
    apply_cirm,
    build_cirm,
    cirm_inference,
    compress_cirm,
    decompress_cirm,
)
from .enhancement import DCCRNEval, DCCRNLoss
from .frcrn import FRCRNEval, FRCRNLoss
from .gagnet import GaGNetEval, GaGNetLoss, gagnet_wav
from .mixit import MixITLossWrapper
from .pit import PITLossWrapper, find_best_perm, reorder_sources
from .sdr import (
    EPS,
    FreqMAE,
    FreqMAEWavL1,
    MultiSrcNegSDR,
    PairwiseNegSDR,
    SingleSrcNegSDR,
    multisrc_neg_sdr,
    pairwise_neg_sdr,
    singlesrc_neg_sdr,
)
from .sisnri import SISNRi
from .taylorsenet import TaylorSENetEval, TaylorSENetLoss, taylor_wav

__all__ = [
    "BSRNNESPNetEval",
    "BSRNNESPNetLoss",
    "DCCRNEval",
    "DCCRNLoss",
    "EPS",
    "FRCRNEval",
    "FRCRNLoss",
    "FreqMAE",
    "FreqMAEWavL1",
    "FullbandEval",
    "FullbandLoss",
    "GaGNetEval",
    "GaGNetLoss",
    "MixITLossWrapper",
    "MultiSrcNegSDR",
    "PITLossWrapper",
    "PairwiseNegSDR",
    "SISNRi",
    "SingleSrcNegSDR",
    "TaylorSENetEval",
    "TaylorSENetLoss",
    "apply_cirm",
    "build_cirm",
    "cirm_inference",
    "compress_cirm",
    "decompress_cirm",
    "find_best_perm",
    "gagnet_wav",
    "multisrc_neg_sdr",
    "pairwise_neg_sdr",
    "reorder_sources",
    "singlesrc_neg_sdr",
    "taylor_wav",
]
