"""The permutation-best SI-SNR improvement as a loss (port of
``sonicsim_tpu.losses.sisnri``; reference losses/sisnri.py:4-42): the
negated best-permutation mean SI-SNRi of the estimates over the input
mixture."""

from __future__ import annotations

from itertools import permutations

import torch


def _si_snr_vs(ref: torch.Tensor, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """SI-SNR of ``x`` against ``ref``, both zero-meaned: (..., T) → (...)."""
    x = x - x.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    proj = (x * ref).sum(-1, keepdim=True) * ref / (ref * ref).sum(-1, keepdim=True)
    noise = x - proj
    return 10.0 * torch.log10(((proj * proj).sum(-1) + eps) / ((noise * noise).sum(-1) + eps))


class SISNRi:
    """``loss(mix, ests, refs)``: mix (B, T), ests and refs (B, S, T) → scalar."""

    def __call__(self, mix: torch.Tensor, ests: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        scores = []
        for perm in permutations(range(ests.shape[1])):
            per_src = torch.stack([_si_snr_vs(refs[:, t], ests[:, s]) - _si_snr_vs(refs[:, t], mix)
                                   for s, t in enumerate(perm)])
            scores.append(per_src.mean(dim=0))  # (B,)
        return -torch.stack(scores).max(dim=0).values.mean()
