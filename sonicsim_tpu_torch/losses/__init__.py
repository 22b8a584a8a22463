"""Separation losses (port of the separation part of ``sonicsim_tpu.losses``):
SI-SDR/SNR/SD-SDR and PIT, for training and evaluation. ``losses.cirm``
holds the cIRM's inference half; the STFT losses wait for ROADMAP A7c and
the enhancement training losses for A9b."""

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
