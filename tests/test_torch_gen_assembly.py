"""Dry-track assembly: the port's utterance cache and device assembly, and its
host ``assemble_long_audio``, against the JAX package's host assembly on the
same plans and files, on the CPU.

Tolerance: none. The port adds each placement's float32 samples into the
timeline in plan order, as the host's ``+=`` loop does, so the tracks are
bit-identical: PCM16 rows (uploaded as int16), float32 rows (resampled or
downmixed), utterances split over several rows, overlapping placements,
evicted and reloaded rows, and empty plans.
"""

import numpy as np
import pytest
import torch

from sonicsim_tpu.dataset.assemble import assemble_long_audio as j_assemble
from sonicsim_tpu_torch.dataset import (
    LongAudioPlan,
    Placement,
    UtteranceCache,
    assemble_long_audio,
    assemble_plans_on_device,
    plan_background_audio,
    plan_long_audio,
    scan_audio_lengths,
)
from sonicsim_tpu_torch.utils import write_wav
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000


def _pcm_utt(path, seconds, rng, sr=SR, channels=1):
    t = np.arange(int(seconds * sr)) / sr
    x = 0.4 * np.sin(2 * np.pi * (150 + 80 * rng.random()) * t)
    x = x.astype(np.float32) + 0.02 * rng.standard_normal(len(t)).astype(np.float32)
    if channels > 1:
        x = np.stack([x, np.roll(x, 7)])
    write_wav(path, x, sr)
    return path


def _ref(plans):
    return np.stack([j_assemble(p)[0] for p in plans])


def _check(plans, cache):
    got = assemble_plans_on_device(plans, cache)
    assert got.dtype == torch.float32 and got.device == cache.device
    ref = _ref(plans)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(np.stack([assemble_long_audio(p)[0] for p in plans]), ref)
    return got


def test_pcm16_rows_and_cache_hits(tmp_path):
    rng = np.random.default_rng(0)
    paths = [_pcm_utt(tmp_path / f"u{i}.wav", 1.2 + 0.3 * i, rng) for i in range(4)]
    lengths = scan_audio_lengths(tmp_path)
    plans = [plan_long_audio(lengths, 6.0, rng, SR) for _ in range(2)]
    plans.append(plan_background_audio(lengths, 6.0, rng, SR))  # clipped tail
    cache = UtteranceCache(sample_rate=SR, lmax=1 << 15, device="cpu")
    first = _check(plans, cache)
    assert 0 < cache.misses <= len(paths)
    misses = cache.misses
    assert torch.equal(_check(plans, cache), first)
    assert cache.misses == misses and cache.hits > 0


def test_f32_rows_after_resample_and_downmix(tmp_path):
    rng = np.random.default_rng(1)
    _pcm_utt(tmp_path / "a44k.wav", 0.8, rng, sr=44100)  # resampled: float32 row
    _pcm_utt(tmp_path / "stereo.wav", 0.9, rng, channels=2)  # downmixed: float32 row
    _pcm_utt(tmp_path / "plain.wav", 0.7, rng)  # PCM-exact: int16 upload
    lengths = scan_audio_lengths(tmp_path)
    plans = [plan_long_audio(lengths, 4.0, rng, SR) for _ in range(2)]
    _check(plans, UtteranceCache(sample_rate=SR, lmax=1 << 15, device="cpu"))


def test_long_utterance_split_over_rows_and_overlap(tmp_path):
    rng = np.random.default_rng(2)
    lmax = 4096
    p = str(_pcm_utt(tmp_path / "long.wav", (3 * lmax + 500) / SR, rng))
    # Placements that straddle row boundaries, start mid-file, run past the
    # file's end, and overlap each other in the timeline.
    plan = LongAudioPlan(6 * lmax, SR, [
        Placement(p, dest_start=100, dest_end=100 + 3 * lmax + 500),
        Placement(p, dest_start=50, dest_end=50 + 2000, src_start=lmax - 1000),
        Placement(p, dest_start=9000, dest_end=9000 + 4096, src_start=3 * lmax),
    ])
    cache = UtteranceCache(sample_rate=SR, lmax=lmax, device="cpu")
    _check([plan], cache)
    rows, n = cache._entries[p]
    assert n == 3 * lmax + 500 and [len(r) for r in rows] == [lmax] * 3 + [500]


def test_lru_eviction_by_row_bytes(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(5):
        _pcm_utt(tmp_path / f"u{i}.wav", 0.6, rng)
    lengths = scan_audio_lengths(tmp_path)
    n = int(0.6 * SR)
    cache = UtteranceCache(sample_rate=SR, lmax=1 << 14, max_bytes=2 * 4 * n, device="cpu")
    plans = [plan_long_audio(lengths, 3.0, rng, SR) for _ in range(3)]
    first = _check(plans, cache)
    assert len(cache._entries) == 2 and cache._bytes == 2 * 4 * n
    assert torch.equal(_check(plans, cache), first)  # reloaded after eviction


def test_empty_plan_is_silent_and_checks(tmp_path):
    rng = np.random.default_rng(4)
    _pcm_utt(tmp_path / "u.wav", 0.5, rng)
    full = plan_long_audio(scan_audio_lengths(tmp_path), 2.0, rng, SR)
    silent = LongAudioPlan(total_samples=2 * SR, sample_rate=SR, placements=[])
    cache = UtteranceCache(sample_rate=SR, lmax=1 << 14, device="cpu")
    got = _check([full, silent], cache)
    assert not got[1].any()
    with pytest.raises(ValueError, match="no plans"):
        assemble_plans_on_device([], cache)
    with pytest.raises(ValueError, match="share"):
        assemble_plans_on_device([full, LongAudioPlan(SR, SR)], cache)
    with pytest.raises(ValueError, match="power of two"):
        UtteranceCache(lmax=1000, device="cpu")
