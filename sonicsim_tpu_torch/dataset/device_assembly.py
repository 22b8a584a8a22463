"""Utterance cache on the device, and long-audio assembly there.

Port of the JAX package's ``dataset/device_assembly.py``. The host path
(:func:`.assemble.assemble_long_audio`) reads and uploads every utterance
for every mixture, although the same utterances recur across many speaker
triples. Here decoded utterances stay on the device (an LRU cache by row
bytes), and each placement plan (concatenation with silences) is executed
there, so steady-state generation uploads only cache misses.

The output is bit-identical to the host path. Cached rows hold exactly the
float32 samples ``read_wav`` produces: PCM-exact audio is uploaded as int16
and converted on the device by ``* 2^-15``, which is exact in float32;
resampled or downmixed audio is uploaded as float32. The timeline is built
by adding each placement's samples in plan order, the same float32 adds the
host's ``+=`` loop performs (placements of one plan do not overlap, so each
sample is ``0 + x``; where they do, the order still matches).

Utterances longer than ``lmax`` are held as several rows, and their
placements split at the row boundaries (integer arithmetic on the host).
Rows are kept at their true length: nothing here needs padding.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from ..bridge import resolve_device
from ..utils.audio import pcm16_exact
from ..utils.wavio import read_wav, resample
from .plan import LongAudioPlan

__all__ = ["UtteranceCache", "assemble_plans_on_device"]


class UtteranceCache:
    """LRU cache of decoded utterances as float32 rows on ``device`` (the
    card unless it names another).

    ``get`` returns the rows (chunks of at most ``lmax`` samples) of one
    file and its length; eviction is by the total bytes of the rows."""

    def __init__(
        self,
        max_bytes: int = 4 << 30,
        lmax: int = 1 << 19,  # 32.77 s at 16 kHz
        sample_rate: int = 16000,
        mono_downmix: bool = True,
        device=None,
    ) -> None:
        self.max_bytes = int(max_bytes)
        self.lmax = int(lmax)
        if self.lmax & (self.lmax - 1):
            raise ValueError("lmax must be a power of two")
        self.sample_rate = int(sample_rate)
        self.mono_downmix = bool(mono_downmix)
        self.device = resolve_device(device)
        # path -> (rows [(≤ lmax,) float32 tensors], true length)
        self._entries: OrderedDict[str, tuple[list, int]] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def _load(self, path: str) -> tuple[list, int]:
        wav, sr = read_wav(path)
        if sr != self.sample_rate:
            wav = resample(wav, sr, self.sample_rate)
        if self.mono_downmix and wav.shape[0] > 1:
            wav = wav.mean(axis=0, keepdims=True)
        x = np.ascontiguousarray(wav[0], np.float32)
        q = pcm16_exact(x)
        src = x if q is None else q
        rows = []
        for c0 in range(0, x.shape[0], self.lmax):
            row = torch.from_numpy(src[c0 : c0 + self.lmax]).to(self.device)
            if q is not None:
                row = row.to(torch.float32) * (1.0 / 32768.0)
            rows.append(row)
        return rows, x.shape[0]

    def get(self, path: str | Path) -> tuple[list, int]:
        key = str(path)
        hit = self._entries.get(key)
        if hit is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return hit
        self.misses += 1
        rows, n = self._load(key)
        self._entries[key] = (rows, n)
        self._bytes += 4 * n
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            _, (_rows, old_n) = self._entries.popitem(last=False)
            self._bytes -= 4 * old_n
        return rows, n


def assemble_plans_on_device(plans: list[LongAudioPlan], cache: UtteranceCache):
    """Execute several LongAudioPlans on the cache's device.

    Returns a (len(plans), total_samples) float32 tensor there, bit-identical
    to stacking :func:`.assemble.assemble_long_audio` over ``plans`` (same
    placements, same float32 add order per output row)."""
    if not plans:
        raise ValueError("no plans")
    t = plans[0].total_samples
    if any(
        p.total_samples != t or p.sample_rate != cache.sample_rate
        for p in plans
    ):
        raise ValueError("plans must share total_samples and the cache's rate")
    out = torch.zeros((len(plans), t), dtype=torch.float32, device=cache.device)
    for row_of, plan in enumerate(plans):
        for p in plan.placements:
            rows, true_len = cache.get(p.path)
            # numpy slicing semantics: past the file's end or the timeline's
            # end, the placement is shortened.
            stop = min(p.src_start + p.length, true_len,
                       p.src_start + t - p.dest_start)
            s = p.src_start
            while s < stop:  # split at row boundaries
                c = s // cache.lmax
                take = min(stop, (c + 1) * cache.lmax) - s
                d0 = p.dest_start + (s - p.src_start)
                s0 = s - c * cache.lmax
                out[row_of, d0 : d0 + take] += rows[c][s0 : s0 + take]
                s += take
    return out
