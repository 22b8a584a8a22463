"""Segment-JSON-driven remix training dataset (enhancement variant).

Port of ``sonicsim_tpu.dataset.remix`` (host code in both packages: numpy
items from WAV files, the same items for the same seed and files).
Reference: enhancement/look2hear/datas/movingdatamodule_remix.py:77-160 —
trains from a precomputed segment manifest mapping
``"<sample_dir>/<spk>-<spk>[-...]" -> [[start, end], ...]`` over separated
``s{idx}.wav`` sources; noise tracks are densified with ``overlap_audio``;
mix = speech + raw noise (the reference's "Random SIR and SNR" comment at
movingdatamodule_remix.py:141 has no code under it — no scaling is
applied). Pass ``snr_range`` explicitly to opt into SNR scaling.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .sampler import _load_mono, apply_snr, overlap_audio


@dataclass
class RemixTrainDataset:
    segment_json: str
    sample_rate: int = 16000
    duration: float = 4.0
    num_samples: int = 1000
    num_spks: int = 1
    is_mono: bool = True
    noise_type: str = "noise"
    snr_range: tuple[float, float] | None = None  # parity default: raw sum
    seed: int = 0
    epoch: int = 0
    segments: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.segments:
            with open(self.segment_json) as f:
                self.segments = json.load(f)
        self.keys = sorted(self.segments)
        if not self.keys:
            raise ValueError(f"empty segment manifest {self.segment_json}")

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(
            (self.seed * 999_983 + self.epoch * self.num_samples + idx) % (2**63)
        )
        key = self.keys[rng.integers(len(self.keys))]
        spk_ids = sorted(int(i) for i in key.split("/")[-1].split("-"))
        folder = key[: -(len(key.split("/")[-1]) + 1)]
        # Without replacement: the same s{i}.wav twice would make a
        # degenerate duplicated-target example (reference draws k=1 only,
        # movingdatamodule_remix.py:110).
        chosen = list(
            rng.choice(spk_ids, size=min(self.num_spks, len(spk_ids)),
                       replace=False)
        )
        speakers = np.stack(
            [_load_mono(f"{folder}/s{i}.wav", self.is_mono) for i in chosen]
        )
        noise_types = ["music", "noise"] if self.noise_type == "all" else [self.noise_type]
        noises = []
        for n in noise_types:
            wav = _load_mono(f"{folder}/{n}.wav", self.is_mono)
            if n == "noise":
                wav = overlap_audio(wav, self.sample_rate, delay=6.0)
            noises.append(wav)
        noise = np.stack(noises)

        spans = self.segments[key]
        start, end = spans[rng.integers(len(spans))]
        speakers = speakers[:, start:end]
        noise = noise[:, start:end]

        all_speech = speakers.sum(axis=0)
        all_noise = noise.sum(axis=0)
        if self.snr_range is not None:  # opt-in; reference applies none
            all_noise = apply_snr(
                all_speech, all_noise, float(rng.uniform(*self.snr_range))
            )
        mix = (all_speech + all_noise).astype(np.float32)
        targets = speakers.astype(np.float32)
        if self.num_spks == 1:
            targets = targets[0]
        return mix, targets


def build_segment_manifest(
    root_dir: str | Path,
    out_json: str | Path,
    duration: float = 4.0,
    sample_rate: int = 16000,
    min_rms_db: float = -40.0,
) -> dict:
    """Materialize a segment-train manifest from a fixed eval tree: for each
    sample dir with s{i}.wav files, record non-silent ``duration``-second
    spans (the producer-side counterpart of tests/segment-train.json)."""
    from .sampler import find_bottom_directories, rms_db

    manifest: dict[str, list[list[int]]] = {}
    span = int(duration * sample_rate)
    for folder in find_bottom_directories(root_dir):
        srcs = sorted(Path(folder).glob("s*.wav"))
        if not srcs:
            continue
        ids = [p.stem[1:] for p in srcs]
        wavs = [_load_mono(p) for p in srcs]
        t = min(w.shape[-1] for w in wavs)
        spans = []
        for start in range(0, t - span + 1, span):
            if all(rms_db(w[start : start + span]) >= min_rms_db for w in wavs):
                spans.append([start, start + span])
        if spans:
            manifest[f"{folder}/{'-'.join(ids)}"] = spans
    out = Path(out_json)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(manifest, f)
    return manifest
