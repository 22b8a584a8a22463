"""Cross-segment speaker tracking (permutation-consistent stitching).

Port of ``sonicsim_tpu.infer.stitch`` (reference separation/inference.py:
32-98). Each voice-active segment is separated on its own, so the speaker
order may flip between segments; each segment is re-ordered to the
permutation whose embeddings are most similar to a running reference (the
first segment's, then 0.8 · reference + 0.2 · this segment's). The default
embedding is a spectral-envelope signature (64 log bands of a 512-point
STFT, hop 128); ``embed_fn`` takes another (the reference's ECAPA:
``models.ecapa.make_ecapa_embedder``).
"""

from __future__ import annotations

from functools import partial
from itertools import permutations
from typing import Callable, Sequence

import numpy as np
import torch

from ..bridge import resolve_device
from ..ops.stft import hann_window, stft


def spectral_embedding(wav: np.ndarray, sample_rate: int = 16000,
                       device=None) -> np.ndarray:
    """Cheap speaker signature: time-averaged log band energies (64 bands),
    the STFT on ``device`` (the card unless given), the pooling on the
    host."""
    device = resolve_device(device)
    n_fft = 512
    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    spec = stft(x, n_fft, 128, hann_window(n_fft, device=device)).abs()
    bands = spec.reshape(-1, spec.shape[-1])  # (F, frames)
    rows = bands.sum(dim=-1).double().cpu().numpy()
    # Pool 257 bins → 64 log bands, each the mean over its bins and frames.
    edges = np.linspace(0, rows.shape[0], 65).astype(int)
    feat = np.array([np.log1p(rows[a:b].sum() / ((b - a) * bands.shape[-1])) if b > a else 0.0
                     for a, b in zip(edges[:-1], edges[1:])])
    norm = np.linalg.norm(feat)
    return feat / norm if norm > 0 else feat


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def stitch_segments(
    segments: Sequence[np.ndarray],
    sample_rate: int = 16000,
    embed_fn: Callable[[np.ndarray, int], np.ndarray] | None = None,
    device=None,
) -> list[np.ndarray]:
    """Reorder each segment's sources for speaker consistency.

    segments: list of (n_src, T_i) arrays (estimated sources per segment).
    Returns the same list with each segment's source order aligned to the
    first segment's speakers (maximising summed embedding similarity).
    ``device`` is where the default embedding runs (the card unless
    given).
    """
    if not segments:
        return []
    embed = embed_fn or partial(spectral_embedding, device=device)
    n_src = segments[0].shape[0]
    ref_emb = [embed(segments[0][i], sample_rate) for i in range(n_src)]
    out = [np.asarray(segments[0])]
    for seg in segments[1:]:
        embs = [embed(seg[i], sample_rate) for i in range(n_src)]
        best_perm, best_score = None, -np.inf
        for perm in permutations(range(n_src)):
            score = sum(_cos(ref_emb[i], embs[p]) for i, p in enumerate(perm))
            if score > best_score:
                best_perm, best_score = perm, score
        out.append(np.asarray(seg)[list(best_perm)])
        # Running reference update keeps tracking through drift.
        ref_emb = [0.8 * ref_emb[i] + 0.2 * embs[best_perm[i]] for i in range(n_src)]
    return out


def concatenate_tracks(segments: Sequence[np.ndarray]) -> np.ndarray:
    """Stitched segments → full tracks (n_src, total_T) (inference.py:95-97)."""
    return np.concatenate([np.asarray(s) for s in segments], axis=-1)
