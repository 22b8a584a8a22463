"""MixIT, mixture-invariant training (port of ``sonicsim_tpu.losses.mixit``;
the reference ships it only commented out, separation/look2hear/losses/
mixit.py): the estimated sources are assigned to the input mixtures over
every binary assignment matrix (each source to exactly one mixture), and
the least loss is taken [Wisdom et al., 2020]."""

from __future__ import annotations

from itertools import product

import numpy as np
import torch


def _assignment_matrices(n_est: int, n_mix: int = 2) -> np.ndarray:
    """(n_mix^n_est, n_mix, n_est) one-hot column assignment matrices."""
    mats = np.zeros((n_mix**n_est, n_mix, n_est), np.float32)
    for k, assign in enumerate(product(range(n_mix), repeat=n_est)):
        mats[k, list(assign), range(n_est)] = 1.0
    return mats


class MixITLossWrapper:
    """``loss_func`` maps (remixes (B, n_mix, T), mixtures (B, n_mix, T)) →
    (B,) (e.g. ``multisrc_neg_sdr``); the wrapper returns the mean over the
    batch of the least loss over the assignments and, with ``return_est``,
    the best remix. ``generalized=False`` keeps the assignments that give
    every mixture a source."""

    def __init__(self, loss_func, generalized: bool = True):
        self.loss_func = loss_func
        self.generalized = generalized

    def __call__(self, ests: torch.Tensor, mixtures: torch.Tensor, return_est: bool = False):
        n_est, n_mix = ests.shape[1], mixtures.shape[1]
        if n_est > 10:
            raise ValueError("MixIT enumerates n_mix^n_est assignments; "
                             f"n_est={n_est} is too large")
        mats = _assignment_matrices(n_est, n_mix)
        if not self.generalized:
            mats = mats[(mats.sum(axis=2) > 0).all(axis=1)]
        mats = torch.from_numpy(mats).to(ests.device, ests.dtype)
        remixes = torch.einsum("kms,bst->kbmt", mats, ests)  # (K, B, n_mix, T)
        losses = torch.stack([self.loss_func(r, mixtures) for r in remixes])  # (K, B)
        min_loss, best = losses.min(dim=0)
        if not return_est:
            return min_loss.mean()
        return min_loss.mean(), remixes[best, torch.arange(ests.shape[0], device=ests.device)]
