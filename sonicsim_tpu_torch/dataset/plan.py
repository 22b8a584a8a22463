"""Seeded host-side planners for mixture construction (a copy of the JAX
package's ``dataset/plan.py``, pinned to it by
tests/test_torch_gen_host.py).

Planning is split from execution: planners consume a {path: num_samples}
manifest plus an explicit np.random.Generator and emit JSON-serialisable
plans (what goes where); ``assemble.py`` and ``device_assembly.py``
materialise plans into waveforms. The reference's sampling semantics
(create_long_audio / create_background_audio, SonicSim_audio.py:153-340),
reproducible end to end from one seed.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np

from ..utils.wavio import wav_num_frames

logger = logging.getLogger(__name__)


@dataclass
class Placement:
    path: str
    dest_start: int  # sample offset in the long buffer where audio starts
    dest_end: int  # end of the placed audio (exclusive)
    src_start: int = 0  # offset into the source file (for clipped tails)

    @property
    def length(self) -> int:
        return self.dest_end - self.dest_start


@dataclass
class LongAudioPlan:
    total_samples: int
    sample_rate: int
    placements: list[Placement] = field(default_factory=list)

    @property
    def start_end_points(self) -> list[tuple[int, int]]:
        return [(p.dest_start, p.dest_end) for p in self.placements]

    @property
    def audio_names(self) -> list[str]:
        return [p.path for p in self.placements]

    def to_json(self) -> dict:
        return asdict(self)


def scan_audio_lengths(audio_dir: str | Path) -> dict[str, int]:
    """Walk a directory tree → {path: num_samples} manifest, from the WAV
    headers alone."""
    out: dict[str, int] = {}
    for p in sorted(Path(audio_dir).rglob("*")):
        if p.is_file() and not p.suffix == ".txt":
            try:
                out[str(p)] = wav_num_frames(p)
            except (ValueError, OSError):
                continue
    return out


def load_length_manifest(json_path: str | Path) -> dict[str, int]:
    """Reference-format length JSONs ({path: num_samples};
    data/*_{noise,music}.json)."""
    with open(json_path) as f:
        return {k: int(v) for k, v in json.load(f).items()}


def load_split_manifest(
    manifest_path: str | Path,
    split: str,
    speech_root: str | Path = "",
    noise_root: str | Path = "",
    music_root: str | Path = "",
) -> dict:
    """Load one split from the framework manifest (data/sonicset_splits.json:
    the reference's data/{split}_{scene,speech}.txt + *_{noise,music}.json).

    Corpus-relative paths are re-rooted onto the caller's corpus locations.
    Returns {"scenes": [id...], "speech": [dir...],
    "noise"/"music": {path: num_samples}}.
    """
    with open(manifest_path) as f:
        manifest = json.load(f)
    try:
        sp = manifest["splits"][split]
    except KeyError as e:
        raise KeyError(
            f"split {split!r} not in manifest (has "
            f"{sorted(manifest.get('splits', {}))})"
        ) from e

    def reroot(rel: str, root) -> str:
        return str(Path(root) / rel) if root else rel

    return {
        "scenes": list(sp["scenes"]),
        "speech": [reroot(p, speech_root) for p in sp["speech"]],
        "noise": {reroot(k, noise_root): int(v) for k, v in sp["noise"].items()},
        "music": {reroot(k, music_root): int(v) for k, v in sp["music"].items()},
    }


def select_files_to_fill(
    lengths: dict[str, int],
    target_samples: int,
    rng: np.random.Generator,
    threshold: float = 0.9,
    stop_on_overflow: bool = True,
) -> list[str]:
    """Random selection totalling [threshold, 1]×target
    (get_random_wav_path[_from_json], SonicSim_audio.py:153-229).

    ``stop_on_overflow=False`` reproduces the from_json variant that appends
    the overflowing file before stopping (SonicSim_audio.py:219-227)."""
    pool = list(lengths.keys())
    selected: list[str] = []
    current = 0
    min_len = target_samples * threshold
    while pool and current < min_len:
        path = pool[rng.integers(len(pool))]
        # Reference quirk: the walk-dir variant accepts an exactly-filling
        # file (<=, SonicSim_audio.py:184) while the from_json variant
        # treats it as overflow (<, :220).
        fits = (
            current + lengths[path] <= target_samples
            if stop_on_overflow
            else current + lengths[path] < target_samples
        )
        if fits:
            selected.append(path)
            current += lengths[path]
        else:
            if not stop_on_overflow:
                selected.append(path)
            break
        pool.remove(path)
    return selected


def plan_long_audio(
    lengths: dict[str, int],
    duration: float,
    rng: np.random.Generator,
    sample_rate: int = 16000,
    max_silence_seconds: float = 10.0,
    threshold: float = 0.9,
) -> LongAudioPlan:
    """Speech-track plan: utterances in random order, each preceded by a
    random 0-10 s silence, until the buffer is full
    (create_long_audio, SonicSim_audio.py:231-277)."""
    total = int(duration * sample_rate)
    files = select_files_to_fill(lengths, total, rng, threshold)
    remaining = list(files)
    plan = LongAudioPlan(total, sample_rate)
    cursor = 0
    while cursor < total and remaining:
        i = int(rng.integers(len(remaining)))
        path = remaining[i]
        silence = int(rng.integers(0, int(max_silence_seconds * sample_rate) + 1))
        if not plan.placements:
            # Guard (deviation from SonicSim_audio.py:263-275, which can
            # emit an all-silent track for short buffers): the first
            # utterance must fit.
            silence = min(silence, max(total - cursor - lengths[path], 0))
        start = cursor + silence
        end = start + lengths[path]
        if end <= total:
            plan.placements.append(Placement(path, start, end))
            cursor = end
            remaining.pop(i)
        else:
            break
    if not plan.placements:
        # Every candidate utterance is longer than the track buffer (e.g.
        # a corpus of full-length recordings instead of utterances): the
        # rendered speech track will be pure silence and every downstream
        # eval row will be skipped as a silent reference. Loud, because
        # this failure mode is otherwise invisible until metrics are NaN.
        logger.warning(
            "plan_long_audio: no utterance fits the %.1f s buffer "
            "(shortest candidate: %.1f s) — this speech track will be "
            "SILENT",
            duration,
            min(lengths.values()) / sample_rate if lengths else float("nan"),
        )
    return plan


def plan_background_audio(
    lengths: dict[str, int],
    duration: float,
    rng: np.random.Generator,
    sample_rate: int = 16000,
    max_silence_seconds: float = 10.0,
    threshold: float = 0.4,
) -> LongAudioPlan:
    """Noise/music-track plan: clips with trailing silences; the final clip
    is trimmed into the remaining window with random edge offsets
    (create_background_audio, SonicSim_audio.py:279-340)."""
    total = int(duration * sample_rate)
    files = select_files_to_fill(lengths, total, rng, threshold, stop_on_overflow=False)
    remaining = list(files)
    plan = LongAudioPlan(total, sample_rate)
    cursor = 0
    while cursor < total and remaining:
        i = int(rng.integers(len(remaining)))
        path = remaining[i]
        n = lengths[path]
        silence = int(rng.integers(0, int(max_silence_seconds * sample_rate) + 1))
        padded_len = n + silence  # silence after the clip (ref :314-315)
        window = total - cursor
        if padded_len >= window:
            # Final clip: random inset from both edges of what remains
            # (+1: random.randint's upper bound is inclusive, :316-318).
            r_start = int(rng.integers(0, int(window * 0.1) + 1))
            r_end = int(rng.integers(0, int(window * 0.1) + 1))
            dest_start = cursor + r_start
            dest_end = total - r_end
            avail = min(n - r_start, dest_end - dest_start)
            if avail > 0:
                plan.placements.append(
                    Placement(path, dest_start, dest_start + avail, src_start=r_start)
                )
            break
        plan.placements.append(Placement(path, cursor, cursor + n))
        cursor += padded_len
        remaining.pop(i)
    return plan


@dataclass
class MixturePlan:
    """Everything needed to render one SonicSet sample (process_single
    equivalent, SonicSet_train.py:25-138), fully determined by its seed."""

    room: str
    sample_rate: int
    duration: float
    channel_type: str
    channel_order: int
    mic_array: list | None
    seed: int
    trajectories: list[list[list[float]]]  # per speaker: (P, 3) waypoints
    mic_point: list[float]
    noise_point: list[float]
    music_point: list[float]
    speech_plans: list[LongAudioPlan]
    noise_plan: LongAudioPlan
    music_plan: LongAudioPlan
    lufs_speech: list[float]  # jittered targets, one per speaker (−17±2)
    lufs_noise: float  # −24±2
    lufs_music: float  # −29±2

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)

        def _default(o):
            if isinstance(o, LongAudioPlan):
                return o.to_json()
            raise TypeError(type(o))

        with open(path, "w") as f:
            json.dump(asdict(self), f, default=_default)


LUFS_SPEECH, LUFS_NOISE, LUFS_MUSIC = -17.0, -24.0, -29.0  # SonicSet_train.py:97-101
LUFS_JITTER = 2.0  # get_lufs_norm_audio, SonicSim_audio.py:83-86
