"""Chunked long-audio inference: overlap-add sliding windows.

Port of ``sonicsim_tpu.infer.chunked`` (reference separation/look2hear/
utils/separator.py:72-131, ``wav_chunk_inference``): pad, window into
``target_length``-second chunks at ``hop_length`` stride, run the model on
batches of windows, sum the overlapping outputs and divide by the overlap
ratio. The windows, the model and the overlap-add stay on one device (the
mixture's, or ``device``: the card unless given); the last batch is
zero-filled to ``batch_size`` windows, as in the JAX package, so every call
of the model sees one shape. The mesh form (windows sharded over devices)
waits for ROADMAP A11.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..bridge import resolve_device


def wav_chunk_inference(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    mixture,
    sample_rate: int = 16000,
    target_length: float = 12.0,
    hop_length: float = 4.0,
    batch_size: int = 10,
    n_tracks: int = 2,
    mesh=None,
    device=None,
) -> torch.Tensor:
    """mixture (T,) → (n_tracks, T) on the device; ``model_fn`` maps
    (B, T_chunk) → (B, n_tracks, T_chunk) on that device."""
    if mesh is not None:
        raise NotImplementedError(
            "wav_chunk_inference(mesh=...): windows sharded over devices are not ported "
            "to sonicsim_tpu_torch yet (ROADMAP A11); the port runs on one device")
    if isinstance(mixture, torch.Tensor):
        x = mixture.to(device if device is not None else mixture.device, torch.float32)
    else:
        x = torch.as_tensor(np.asarray(mixture, np.float32), device=resolve_device(device))
    x = x.reshape(-1)
    total = x.shape[-1]
    chunk = int(sample_rate * target_length)
    hop = int(sample_rate * hop_length)
    overlap_ratio = target_length / hop_length

    # Lead and tail padding so that every sample sees the whole overlap;
    # the last windows run past the padded signal into zeros.
    lead = chunk - hop
    n_win = (total + 2 * lead - chunk) // hop + 2
    xpad = torch.zeros(lead + total + lead + chunk, device=x.device)
    xpad[lead:lead + total] = x
    windows = xpad.unfold(0, chunk, hop)[:n_win]  # (n_win, chunk), views

    acc = torch.zeros((n_tracks, xpad.shape[0]), device=x.device)
    with torch.inference_mode():
        for b in range(0, n_win, batch_size):
            batch = windows[b:b + batch_size]
            n = batch.shape[0]
            if n < batch_size:  # one shape for every call of the model
                batch = torch.cat([batch, batch.new_zeros(batch_size - n, chunk)])
            est = model_fn(batch.contiguous())[:n]
            for i in range(n):
                start = (b + i) * hop
                acc[:, start:start + chunk] += est[i]
    return acc[:, lead:lead + total] / overlap_ratio
