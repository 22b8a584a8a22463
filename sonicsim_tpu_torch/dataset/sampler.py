"""Eval samplers over generated SonicSet trees (port of the eval part of
``sonicsim_tpu.dataset.sampler``, numpy on the host).

Reference separation/look2hear/datas/movingdatamodule.py and the
enhancement variant, with explicit seeding: item ``idx`` of the remix draws
from ``default_rng((seed, idx))``, as in the JAX package. The training
sampler (``MovingTrainDataset``) comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.wavio import read_wav

GAIN_CAP_DB = 40.0  # movingdatamodule.py:112


def find_bottom_directories(root_dir: str | Path) -> list[str]:
    """Leaf directories of a tree (movingdatamodule.py:22-27)."""
    out = []
    for p in sorted(Path(root_dir).rglob("*")):
        if p.is_dir() and not any(c.is_dir() for c in p.iterdir()):
            out.append(str(p))
    if not out and Path(root_dir).is_dir():
        out = [str(root_dir)]
    return out


def rms_db(wav: np.ndarray) -> float:
    return 10.0 * np.log10(max(1e-20, float(np.mean(np.square(wav)))))


def _load_mono(path: str | Path, mono: bool = True) -> np.ndarray:
    wav, _ = read_wav(path)
    return wav.mean(axis=0) if mono else wav


def apply_sir(speakers: np.ndarray, sirs: np.ndarray) -> np.ndarray:
    """Scale interferers to SIRs vs speaker 0 (movingdatamodule.py:106-113)."""
    out = speakers.copy()
    tgt = rms_db(out[0])
    for i, sir in enumerate(sirs):
        gain = min(tgt - rms_db(out[i + 1]) - float(sir), GAIN_CAP_DB)
        out[i + 1] *= 10.0 ** (gain / 20.0)
    return out


def apply_snr(speech: np.ndarray, noise: np.ndarray, snr: float) -> np.ndarray:
    """Scale noise to the target SNR vs speech (movingdatamodule.py:118-122)."""
    gain = min(rms_db(speech) - rms_db(noise) - snr, GAIN_CAP_DB)
    return noise * 10.0 ** (gain / 20.0)


def overlap_audio(wav: np.ndarray, sample_rate: int, delay: float = 6.0) -> np.ndarray:
    """Self-overlap noise densification (enhancement movingdatamodule.py:34-48):
    signal + itself shifted +delay and −delay."""
    d = int(delay * sample_rate)
    x = wav.reshape(-1)
    fwd = np.concatenate([np.zeros(d, x.dtype), x])[: len(x)]
    bwd = np.concatenate([x, np.zeros(d, x.dtype)])[-len(x):]
    return (fwd + bwd + x).astype(np.float32)


@dataclass
class MovingTestDataset:
    """Fixed materialized eval set: mix.wav + s{i}.wav per sample dir
    (movingdatamodule.py:228-259). ``return_path`` gives the Phase variant."""

    speech_dir: str
    sample_rate: int = 16000
    num_spks: int = 2
    is_mono: bool = True
    target_names: tuple[str, ...] | None = None  # e.g. ("clean",) for enh
    return_path: bool = False
    data_dirs: list[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.data_dirs:
            self.data_dirs = find_bottom_directories(self.speech_dir)

    def __len__(self) -> int:
        return len(self.data_dirs)

    def __getitem__(self, idx: int):
        folder = self.data_dirs[idx]
        names = self.target_names or tuple(
            f"s{i + 1}" for i in range(self.num_spks)
        )
        targets = np.stack(
            [_load_mono(f"{folder}/{n}.wav", self.is_mono) for n in names]
        ).astype(np.float32)
        mix = _load_mono(f"{folder}/mix.wav", self.is_mono).astype(np.float32)
        if self.return_path:
            return mix, targets, folder
        return mix, targets


@dataclass
class MovingTestEvalDataset:
    """On-the-fly remix of a generated split (movingdatamodule.py:163-226;
    enhancement variant :225-264 with overlap_audio + SNR U(−10,15))."""

    speech_dir: str
    sample_rate: int = 16000
    num_spks: tuple[int, int] | int = (0, 2)
    is_mono: bool = True
    noise_type: str = "noise"
    task: str = "separation"  # or "enhancement"
    seed: int = 0
    data_dirs: list[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.data_dirs:
            self.data_dirs = find_bottom_directories(self.speech_dir)

    def __len__(self) -> int:
        return len(self.data_dirs)

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, idx))
        folder = self.data_dirs[idx]
        noise_types = ["music", "noise"] if self.noise_type == "all" else [self.noise_type]
        noises = np.stack(
            [_load_mono(f"{folder}/{n}_audio.wav", self.is_mono) for n in noise_types]
        )
        all_noise = noises.sum(axis=0)

        if self.task == "enhancement":
            spk = _load_mono(f"{folder}/moving_audio_1.wav", self.is_mono)
            all_noise = overlap_audio(all_noise, self.sample_rate, delay=6.0)
            all_noise = apply_snr(spk, all_noise, float(rng.uniform(-10.0, 15.0)))
            mix = (spk + all_noise).astype(np.float32)
            return mix, spk[None, :].astype(np.float32), folder

        ids = self.num_spks if isinstance(self.num_spks, (tuple, list)) else (0, self.num_spks)
        speakers = np.stack(
            [
                _load_mono(f"{folder}/moving_audio_{i + 1}.wav", self.is_mono)
                for i in ids
            ]
        )
        sirs = rng.uniform(-6.0, 6.0, size=len(ids) - 1)
        speakers = apply_sir(speakers, sirs)
        all_speech = speakers.sum(axis=0)
        all_noise = apply_snr(all_speech, all_noise, float(rng.uniform(10.0, 20.0)))
        mix = (all_speech + all_noise).astype(np.float32)
        return mix, speakers.astype(np.float32), folder
