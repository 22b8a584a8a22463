"""Separation losses (port of the serving part of ``sonicsim_tpu.losses``):
SI-SDR/SNR/SD-SDR and PIT. The STFT losses and the enhancement losses wait
for the training slice and ROADMAP A9."""

from .pit import PITLossWrapper, find_best_perm, reorder_sources
from .sdr import (
    EPS,
    MultiSrcNegSDR,
    PairwiseNegSDR,
    SingleSrcNegSDR,
    multisrc_neg_sdr,
    pairwise_neg_sdr,
    singlesrc_neg_sdr,
)

__all__ = [
    "EPS",
    "MultiSrcNegSDR",
    "PITLossWrapper",
    "PairwiseNegSDR",
    "SingleSrcNegSDR",
    "find_best_perm",
    "multisrc_neg_sdr",
    "pairwise_neg_sdr",
    "reorder_sources",
    "singlesrc_neg_sdr",
]
