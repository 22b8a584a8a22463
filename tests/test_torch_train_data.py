"""The port's training data and LR controllers against the JAX package's, on
the same inputs: the schedulers, ``MovingTrainDataset``, the prefetching
loader and ``MovingDataModule``.

Tolerance: none. Every LR, stop signal and array here is equal (arrays
``np.array_equal``); the loader's worker paths are held to its synchronous
path, as the JAX package's own loader tests hold its loader.
"""

import threading
import time

import numpy as np
import pytest

import sonicsim_tpu.dataset.datamodule as jdm
import sonicsim_tpu.dataset.sampler as jsampler
import sonicsim_tpu.train.schedulers as jsched
from sonicsim_tpu_torch.dataset import (MovingDataModule, MovingTrainDataset,
                                        batched_loader, prefetch_iter)
from sonicsim_tpu_torch.train import schedulers as tsched
from sonicsim_tpu_torch.utils import import_target, write_wav
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
TRACKS = ("moving_audio_1", "moving_audio_2", "moving_audio_3", "noise_audio", "music_audio")


def _metric_stream(seed: int, n: int = 60) -> list[float]:
    """A falling loss with plateaus, noise and sub-threshold creep."""
    rng = np.random.default_rng(seed)
    level, out = 10.0, []
    for i in range(n):
        if i % 15 < 5:
            level *= 0.9
        elif i % 15 < 10:
            level *= 1.0 - 1e-7
        out.append(float(level + 0.05 * rng.standard_normal() * (i % 3 == 0)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plateau_and_early_stop_sequences_equal(seed):
    stream = _metric_stream(seed)
    for kw in (dict(), dict(factor=0.3, patience=2, min_lr=1e-5),
               dict(mode="max", threshold=1e-3, patience=1)):
        ours, ref = tsched.ReduceLROnPlateau(1e-3, **kw), jsched.ReduceLROnPlateau(1e-3, **kw)
        assert [ours.step(m) for m in stream] == [ref.step(m) for m in stream]
    for kw in (dict(patience=3), dict(patience=2, mode="max")):
        ours, ref = tsched.EarlyStopping(**kw), jsched.EarlyStopping(**kw)
        assert [ours.step(m) for m in stream] == [ref.step(m) for m in stream]


def test_step_schedules_equal():
    kw = dict(d_model=64, warmup_steps=30, exp_max=4e-4, exp_base=0.98, steps_per_epoch=7)
    ours, ref = tsched.DPTNetScheduler(**kw), jsched.DPTNetScheduler(**kw)
    assert [ours.step() for _ in range(200)] == [ref.step() for _ in range(200)]
    ours, ref = tsched.CustomExponentialLR(0.5, 0.1, 5), jsched.CustomExponentialLR(0.5, 0.1, 5)
    assert [ours.step() for _ in range(30)] == [ref.step() for _ in range(30)]


def _train_tree(root, n_leaves=3, seconds=1.0, seed=0):
    """Leaf folders of a generated split: the five tracks, mono or binaural
    by leaf, with a silent opening so the crop retries."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    for k in range(n_leaves):
        d = root / f"scene{k}" / f"mix{k}"
        d.mkdir(parents=True)
        ch = 1 + k % 2
        for name in TRACKS:
            x = (0.1 * rng.standard_normal((ch, n))).astype(np.float32)
            if name.startswith("moving"):
                x[:, : n // 3] = 0.0
            write_wav(d / f"{name}.wav", x, SR)
    return root


@pytest.mark.parametrize("kw", [dict(), dict(num_spks=3, noise_type="all"),
                                dict(num_spks=1, seed=5, is_mono=False)])
def test_moving_train_dataset_equal(tmp_path, kw):
    root = _train_tree(tmp_path / "train")
    args = dict(speech_dir=str(root), duration=0.25, num_samples=4, **kw)
    ours, ref = MovingTrainDataset(**args), jsampler.MovingTrainDataset(**args)
    assert ours.data_dirs == ref.data_dirs
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            (m, t), (rm, rt) = ours[i], ref[i]
            assert m.dtype == rm.dtype == np.float32 and t.shape == rt.shape
            assert np.array_equal(m, rm) and np.array_equal(t, rt)


def test_datamodule_from_config_target_equal(tmp_path):
    """``_target_: sonicsim_tpu.dataset.MovingDataModule`` builds the port's
    class, and its train and val batches equal the JAX package's."""
    rng = np.random.default_rng(1)
    _train_tree(tmp_path / "train", n_leaves=2, seconds=0.5)
    for k in range(3):
        d = tmp_path / "val" / f"s{k}"
        d.mkdir(parents=True)
        for name in ("mix", "s1", "s2"):
            write_wav(d / f"{name}.wav", (0.1 * rng.standard_normal(SR // 2)).astype(np.float32), SR)
    cls = import_target("sonicsim_tpu.dataset.MovingDataModule")
    assert cls is MovingDataModule
    kw = dict(train_dir=str(tmp_path / "train"), val_dir=str(tmp_path / "val"),
              test_dir=str(tmp_path / "val"), duration=0.125, num_samples=5, batch_size=2)
    ours, ref = cls(**kw, num_workers=2), jdm.MovingDataModule(**kw)
    for got, want, n in ((ours.train_batches(2), ref.train_batches(2), 3),
                         (ours.val_batches(crop=SR // 8), ref.val_batches(crop=SR // 8), 2)):
        got, want = list(got), list(want)
        assert len(got) == len(want) == n  # the ragged tail kept
        for (m, t), (rm, rt) in zip(got, want):
            assert np.array_equal(m, rm) and np.array_equal(t, rt)


def test_val_crop_seeks_active_audio(tmp_path):
    """val_batches(crop=N) crops where every target is active, not the
    head (generated mixtures open with random silences)."""
    rng = np.random.default_rng(2)
    d = tmp_path / "val" / "leaf"
    d.mkdir(parents=True)
    active = (rng.standard_normal(2 * SR) * 0.2).astype(np.float32)
    s1 = np.concatenate([np.zeros(2 * SR, np.float32), active])
    s2 = np.concatenate([np.zeros(2 * SR, np.float32), active[::-1]])
    write_wav(d / "s1.wav", s1, SR)
    write_wav(d / "s2.wav", s2, SR)
    write_wav(d / "mix.wav", s1 + s2, SR)
    kw = dict(train_dir=str(tmp_path / "val"), val_dir=str(tmp_path / "val"),
              test_dir=str(tmp_path / "val"), batch_size=1)
    (mix, tgt), = list(MovingDataModule(**kw).val_batches(crop=SR))
    (rmix, rtgt), = list(jdm.MovingDataModule(**kw).val_batches(crop=SR))
    assert np.array_equal(mix, rmix) and np.array_equal(tgt, rtgt)
    assert mix.shape[-1] == SR and np.abs(tgt).max() > 0.01
    assert float(np.square(tgt).sum()) > 0.4 * float(np.square(np.stack([s1, s2])).sum())


class _Squares:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return np.full((3,), i * i, np.float32)


def test_batched_loader_worker_parity():
    sync = list(batched_loader(_Squares(), 4, num_workers=0))
    pooled = list(batched_loader(_Squares(), 4, num_workers=3))
    assert len(sync) == len(pooled) == 3  # 4 + 4 + 2
    for a, b in zip(sync, pooled):
        np.testing.assert_array_equal(a, b)
    assert sync[-1].shape == (2, 3)


def test_batched_loader_tuple_collate():
    class Pairs:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return np.float32(i), np.full((2,), i, np.float32)

    batches = list(batched_loader(Pairs(), 2, num_workers=2))
    assert batches[0][0].shape == (2,) and batches[0][1].shape == (2, 2)
    np.testing.assert_array_equal(batches[1][0], [2.0, 3.0])


def test_prefetch_iter_propagates_exceptions():
    def bad():
        yield 1
        raise RuntimeError("decode failed")

    it = prefetch_iter(bad, depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_pooled_loader_bounds_inflight_decode():
    """In-flight ``__getitem__`` calls stay within the worker window plus
    the prefetch queue, however slow the consumer."""
    lock = threading.Lock()
    state = {"started": 0, "max_ahead": 0, "consumed": 0}

    class Tracking:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            with lock:
                state["started"] += 1
                state["max_ahead"] = max(state["max_ahead"], state["started"] - state["consumed"])
            return np.full((2,), i, np.float32)

    out = []
    for b in batched_loader(Tracking(), batch_size=4, num_workers=2, prefetch=1):
        out.append(b)
        time.sleep(0.005)
        with lock:
            state["consumed"] += len(b)
    assert len(out) == 16
    np.testing.assert_array_equal(out[3][:, 0], [12, 13, 14, 15])
    assert state["max_ahead"] <= 2 + 4 + 4 + 4 + 4


def test_prefetch_iter_abandoned_consumer_unblocks_producer():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    before = threading.active_count()
    it = prefetch_iter(gen, depth=2)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 1000
