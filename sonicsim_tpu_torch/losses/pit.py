"""Permutation-invariant training (PIT) wrapper, forward only.

Port of ``sonicsim_tpu.losses.pit`` (reference separation/look2hear/
losses/pit_wrapper.py:7-148): the one-hot permutation search up to 6
sources and a Hungarian assignment (scipy, on the host) beyond;
``threshold_byloss`` as a masked mean over losses > −30. It is the configs'
``metrics:`` node and the tracker's PIT alignment; its use as a training
loss comes with the training slice.
"""

from __future__ import annotations

from itertools import permutations

import numpy as np
import torch

_MAX_FACTORIAL = 6
_THRESHOLD_DB = -30.0


def _perm_matrix(n_src: int) -> tuple[np.ndarray, np.ndarray]:
    perms = np.array(list(permutations(range(n_src))), dtype=np.int64)
    one_hot = np.zeros((len(perms), n_src, n_src), np.float32)
    for p, perm in enumerate(perms):
        one_hot[p, np.arange(n_src), perm] = 1.0
    return perms, one_hot


def find_best_perm(pair_wise_losses: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n_est, n_tgt) loss matrix → (min mean loss (B,), perm indices
    (B, n_src)); ``batch_indices[b, tgt] = est`` assigned to ``tgt``."""
    n_src = pair_wise_losses.shape[-1]
    pwl = pair_wise_losses.transpose(-1, -2)  # (B, n_tgt, n_est)
    dev = pwl.device
    if n_src <= _MAX_FACTORIAL:
        perms, one_hot = _perm_matrix(n_src)
        one_hot = torch.as_tensor(one_hot, device=dev, dtype=pwl.dtype)
        loss_set = torch.einsum("bij,pij->bp", pwl, one_hot) / n_src
        idx = torch.argmin(loss_set, dim=1)  # the first minimum, as jnp.argmin
        min_loss = loss_set.gather(1, idx[:, None])[:, 0]
        return min_loss, torch.as_tensor(perms, device=dev)[idx]

    from scipy.optimize import linear_sum_assignment

    mats = pwl.detach().cpu().numpy()
    batch_indices = torch.as_tensor(
        np.stack([linear_sum_assignment(m)[1] for m in mats]), device=dev)
    min_loss = pwl.gather(2, batch_indices[..., None]).mean(dim=(-1, -2))
    return min_loss, batch_indices


def reorder_sources(sources: torch.Tensor, batch_indices: torch.Tensor) -> torch.Tensor:
    """Reorder (B, n_src, T) estimates by per-batch permutations."""
    index = batch_indices[..., None].expand(-1, -1, sources.shape[-1])
    return sources.gather(1, index)


class PITLossWrapper:
    """Callable PIT wrapper. ``loss_func`` maps (ests, targets) to either a
    pairwise matrix (pit_from='pw_mtx') or per-pair losses (pit_from='pw_pt');
    'perm_avg' evaluates the full loss per permutation."""

    def __init__(self, loss_func, pit_from: str = "pw_mtx", threshold_byloss: bool = True):
        if pit_from not in ("pw_mtx", "pw_pt", "perm_avg"):
            raise ValueError(f"unsupported pit_from {pit_from!r}")
        self.loss_func = loss_func
        self.pit_from = pit_from
        self.threshold_byloss = threshold_byloss

    def __call__(self, ests, targets, return_ests: bool = False):
        if self.pit_from == "pw_mtx":
            pw_loss = self.loss_func(ests, targets)
        elif self.pit_from == "pw_pt":
            pw_loss = self._pw_from_pt(ests, targets)
        else:  # perm_avg
            return self._perm_avg(ests, targets, return_ests)
        if pw_loss.dim() != 3 or pw_loss.shape[0] != targets.shape[0]:
            raise ValueError("pairwise loss must be (B, n_est, n_tgt)")
        min_loss, batch_indices = find_best_perm(pw_loss)
        mean_loss = self._reduce(min_loss)
        if not return_ests:
            return mean_loss
        return mean_loss, reorder_sources(ests, batch_indices)

    def _reduce(self, min_loss):
        if self.threshold_byloss:
            # Reference: mean over losses > −30 when any exist
            # (pit_wrapper.py:52-54), else the plain mean.
            mask = min_loss > _THRESHOLD_DB
            masked = torch.where(mask, min_loss, 0.0).sum() / mask.sum().clamp(min=1)
            return torch.where(mask.any(), masked, min_loss.mean())
        return min_loss.mean()

    def _pw_from_pt(self, ests, targets):
        b, n_src, t = targets.shape
        est_b = torch.repeat_interleave(ests, n_src, dim=1).reshape(b * n_src * n_src, t)
        tgt_b = targets.repeat(1, n_src, 1).reshape(b * n_src * n_src, t)
        return self.loss_func(est_b, tgt_b).reshape(b, n_src, n_src)

    def _perm_avg(self, ests, targets, return_ests):
        n_src = targets.shape[1]
        if n_src > _MAX_FACTORIAL:
            raise ValueError("perm_avg only supported for n_src <= 6")
        perms, _ = _perm_matrix(n_src)
        loss_set = torch.stack([self.loss_func(ests[:, list(perm)], targets)
                                for perm in perms], dim=1)
        idx = torch.argmin(loss_set, dim=1)
        mean_loss = loss_set.gather(1, idx[:, None]).mean()
        if not return_ests:
            return mean_loss
        return mean_loss, reorder_sources(ests, torch.as_tensor(perms, device=ests.device)[idx])
