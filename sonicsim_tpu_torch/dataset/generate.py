"""SonicSet generation: plans, per-mixture render and the split loop.

Port of the JAX package's ``dataset/generate.py`` (SonicSet_train.py:25-219
/ SonicSet_val_test.py): per (scene, 3-speaker triple), sample trajectories,
the mic and the noise/music points; render per-waypoint RIR banks; build
60 s speech/noise/music tracks; moving-convolve the speech and
static-convolve the backgrounds; LUFS-normalise to −17/−24/−29 (±2); and
write 5 WAVs + json_data.json + mixture_plan.json + the bank + trace.png,
with resume by existence.

All randomness flows from one np.random.Generator per mixture, so plans and
outputs are reproducible from (seed, scene, triple), and equal to the JAX
package's for the same seed (tests/test_torch_gen_render.py).

Device: everything runs on the scene's ``device`` (the card unless it names
another). The RIR banks, the dry tracks (from the utterance cache), the
mixture step (K1's ramp form, through ``render_mixture_sources``) and the
PCM16 pack stay there; the finished tracks and the float16 bank come back
to the host through pinned-memory copies that overlap the next mixture.
"""

from __future__ import annotations

import json
import logging
import queue
import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..bridge import resolve_device
from ..ops.fftconv import segment_plan
from ..ops.interp import dynamic_interp_plan
from ..parallel.pipeline import pad_moving_plans, render_mixture_sources
from ..sim.geometry import densify_path
from ..sim.maps import save_trace_image
from ..sim.oracle import save_rir_bank
from ..sim.scene import Scene
from ..utils.audio import pcm16_exact, pcm16_quantize
from ..utils.seeding import stable_seed
from ..utils.wavio import write_wav
from .assemble import (
    assemble_long_audio,
    loudness_normalize_to,
    render_moving_source,
    render_static_source,
)
from .device_assembly import UtteranceCache, assemble_plans_on_device
from .plan import (
    LUFS_JITTER,
    LUFS_MUSIC,
    LUFS_NOISE,
    LUFS_SPEECH,
    MixturePlan,
    plan_background_audio,
    plan_long_audio,
    scan_audio_lengths,
)

logger = logging.getLogger(__name__)

PCM16_LIMIT = 1.0 - 1.0 / 32768.0  # the largest PCM16 code, as a float


def plan_mixture(
    scene: Scene,
    speech_manifests: list[dict[str, int]],
    noise_manifest: dict[str, int],
    music_manifest: dict[str, int],
    rng: np.random.Generator,
    duration: float = 60.0,
    distance_threshold: float = 5.0,
    static_threshold: float = 6.0,
    seed: int = 0,
    max_silence_seconds: float = 10.0,
    min_waypoints: int = 0,
) -> MixturePlan:
    """Sample the full layout + audio plans for one mixture
    (SonicSet_train.py:40-74).

    ``min_waypoints`` arc-length-densifies each sampled trajectory
    (geometry.densify_path); 0 keeps the raw A* corner vertices, as the
    reference does."""
    n_spk = len(speech_manifests)
    trajectories = [
        densify_path(
            scene.sample_trajectory(rng, distance_threshold), min_waypoints
        )
        for _ in range(n_spk)
    ]
    mid_points = [t[len(t) // 2] for t in trajectories]
    mic_point = scene.select_static_points(mid_points, rng, static_threshold, 1)[0]
    noise_music = scene.select_static_points(mid_points, rng, static_threshold, 2)
    sr = scene.oracle.sample_rate
    return MixturePlan(
        room=scene.room,
        sample_rate=sr,
        duration=duration,
        channel_type=scene.channel.channel_type,
        channel_order=scene.channel.channel_order,
        mic_array=scene.channel.mic_array,
        seed=seed,
        trajectories=[[list(map(float, p)) for p in t] for t in trajectories],
        mic_point=list(map(float, mic_point)),
        noise_point=list(map(float, noise_music[0])),
        music_point=list(map(float, noise_music[1])),
        speech_plans=[
            plan_long_audio(m, duration, rng, sr, max_silence_seconds)
            for m in speech_manifests
        ],
        noise_plan=plan_background_audio(
            noise_manifest, duration, rng, sr, max_silence_seconds
        ),
        music_plan=plan_background_audio(
            music_manifest, duration, rng, sr, max_silence_seconds
        ),
        lufs_speech=[
            float(rng.uniform(LUFS_SPEECH - LUFS_JITTER, LUFS_SPEECH + LUFS_JITTER))
            for _ in range(n_spk)
        ],
        lufs_noise=float(rng.uniform(LUFS_NOISE - LUFS_JITTER, LUFS_NOISE + LUFS_JITTER)),
        lufs_music=float(rng.uniform(LUFS_MUSIC - LUFS_JITTER, LUFS_MUSIC + LUFS_JITTER)),
    )


def pack_tracks(moving: torch.Tensor, static: torch.Tensor):
    """(S, C, T) moving + (K, C, T) static tracks → ((S+K, C, T) int16 PCM,
    (S+K,) float32 peak-guard scales), on their device.

    A track whose peak exceeds the PCM16 ceiling is first scaled by
    ``limit/peak`` (the scale is recorded in json_data.json) instead of
    clipped: the reference writes float32 WAVs whose peaks survive, and a
    −17 LUFS speech track can exceed int16 full scale. The codes equal
    ``write_wav``'s host quantisation bit for bit."""
    x = torch.cat([moving, static])
    peak = x.abs().amax(dim=(1, 2))
    scale = torch.where(
        peak > PCM16_LIMIT, PCM16_LIMIT / torch.clamp(peak, min=1e-12), 1.0
    ).to(torch.float32)
    return pcm16_quantize(x * scale[:, None, None]), scale


def _pcm16_upload(x: np.ndarray) -> np.ndarray:
    """A float track block as int16 PCM where every sample fits exactly
    (audio assembled from PCM16 WAVs is i/32768, and the mixture step's
    ``* 2^-15`` reproduces it bit for bit), halving the upload; anything
    else (at or over full scale, off the PCM16 grid) stays float32."""
    q = pcm16_exact(x)
    return x if q is None else q


def _copy_to_host_async(t: torch.Tensor) -> tuple[torch.Tensor, object]:
    """Start a device→host copy of ``t`` into pinned memory on the current
    stream, so it streams while later work is queued. Returns (host tensor,
    CUDA event recorded after the copy); read the host tensor only through
    :func:`_host_array`, which waits on the event. A CPU tensor is its own
    host copy (event None)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def _host_array(copy: tuple[torch.Tensor, object]) -> np.ndarray:
    host, event = copy
    if event is not None:
        event.synchronize()
    return host.numpy()


class ArtifactWriter:
    """Single background thread draining disk writes (WAVs, bank npz,
    trace, metadata) in FIFO order.

    File writes release the interpreter lock, so one writer thread overlaps
    a mixture's disk I/O with the next mixture's dispatch. FIFO order keeps
    the resume contract: json_data.json, the completion marker, is queued
    after the WAVs. The first error stops the queue and is raised again on
    the next submit or on close()."""

    def __init__(self) -> None:
        # Bounded, so a slow disk applies backpressure: a few mixtures of
        # track and bank payloads at most.
        self._q: "queue.Queue" = queue.Queue(maxsize=32)
        self._error: BaseException | None = None
        # Latched apart from _error: _check hands the error to the caller
        # (clearing _error), but the worker must keep skipping, or a
        # json_data.json queued behind a failed WAV write could still land
        # and mark a broken mixture complete.
        self._failed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, kwargs = item
            if not self._failed:
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — raised again on the main thread
                    self._error = e
                    self._failed = True
            self._q.task_done()

    def _check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, fn, *args, **kwargs) -> None:
        self._check()
        self._q.put((fn, args, kwargs))

    def barrier(self) -> None:
        """Block until everything queued so far is on disk."""
        self._q.join()
        self._check()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        self._check()


def dispatch_mixture(
    scene: Scene,
    plan: MixturePlan,
    output_dir: str | Path,
    transcripts: dict[str, str] | None = None,
    save_bank: bool = True,
    save_trace: bool = True,
    mesh=None,
    wav_encoding: str = "pcm16",
    cache: UtteranceCache | None = None,
    sink: str = "disk",
) -> dict:
    """Device half of :func:`render_mixture`: queue the RIR-bank render and
    the mixture step on the scene's device, start the device→host copies of
    every artifact, and return a handle for :func:`finalize_mixture`.

    Splitting dispatch from finalize lets :func:`generate_split` overlap
    mixture k's copies and writes with mixture k+1's device work.

    ``cache``: an :class:`.device_assembly.UtteranceCache`: long audio is
    then assembled on the device from cached utterance rows (bit-identical
    output; steady-state uploads drop to cache misses).

    ``sink="device"`` renders the same computation but keeps every output
    on the device: no copies, no bank, trace or WAV bytes. It separates the
    device's work from the host's artifact path.

    ``mesh``: a ``parallel.mesh.Mesh``: the bank render and the source
    render are sharded over it (as the JAX package passes its mesh to
    both), and every output is gathered on its first device, where the
    tracks are packed and copied from."""
    if sink not in ("disk", "device"):
        raise ValueError(f"sink must be 'disk' or 'device', got {sink!r}")
    if sink == "device":
        save_bank = False
        save_trace = False
    device = resolve_device(scene.device) if mesh is None else mesh.primary
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    sr = plan.sample_rate
    rng = np.random.default_rng(plan.seed)

    # Per-speaker RIR banks (trajectory waypoints × the mic) and the
    # noise/music RIRs as one more "bank" of two sources, all in one render
    # that stays on the device. The joint peak normalisation of the static
    # pair differs from separate renders by a scalar, which the loudness
    # normalisation cancels.
    mic = np.asarray(plan.mic_point)
    all_banks = scene.render_banks(
        [[np.asarray(p) for p in traj] for traj in plan.trajectories]
        + [[np.asarray(plan.noise_point), np.asarray(plan.music_point)]],
        [mic],
        out_device=True,
        mesh=mesh,
    )
    banks = [b[:, 0] for b in all_banks[:-1]]  # (P, C, L) each
    rir_noise, rir_music = all_banks[-1][0, 0], all_banks[-1][1, 0]
    bank_f16 = None
    if save_bank:
        # float16 halves the copy; its rounding (~5e-4 relative) sits at the
        # float32 tap-placement noise floor.
        bank_f16 = [_copy_to_host_async(b.to(torch.float16)) for b in banks]

    # The rng is drawn in the reference's per-speaker order, so seeded
    # plans give the reference's segment tables.
    if all(b.shape[0] >= 2 for b in banks):
        dry, weights, offs, lens = [], [], [], []
        for sp, traj in zip(plan.speech_plans, plan.trajectories):
            if cache is None:
                audio = assemble_long_audio(sp)[0]
                n = audio.shape[-1]
                dry.append(audio)
            else:
                n = sp.total_samples
            idx, w = dynamic_interp_plan(np.asarray(traj), n, rng=rng)
            o, le, _ = segment_plan(idx)
            weights.append(w)
            offs.append(o)
            lens.append(le)
        banks_p, _, off_p, len_p, max_seg = pad_moving_plans(
            banks, weights, offs, lens, stack_weights=False
        )
        # Both static RIRs come from the same bank render: same length.
        static_rirs = torch.stack([rir_noise, rir_music])
        if cache is not None:
            assembled = assemble_plans_on_device(
                list(plan.speech_plans) + [plan.noise_plan, plan.music_plan],
                cache,
            )
            speech_in = assembled[: len(plan.speech_plans)]
            static_in = assembled[len(plan.speech_plans) :]
        else:
            static_audio = np.stack([
                assemble_long_audio(plan.noise_plan)[0],
                assemble_long_audio(plan.music_plan)[0],
            ]).astype(np.float32)
            speech_in = _pcm16_upload(np.stack(dry).astype(np.float32))
            static_in = _pcm16_upload(static_audio)
        # weights=None: the fused crossfade (K1's ramp form) rebuilds the
        # ramps from the segment tables on the device.
        moving_t, static_t = render_mixture_sources(
            speech_in,
            banks_p, None, off_p, len_p,
            max_seg, static_in, static_rirs,
            np.asarray(plan.lufs_speech, np.float32),
            np.asarray([plan.lufs_noise, plan.lufs_music], np.float32),
            sr,
            mesh=mesh,
            weight_mask=np.asarray(
                [1.0 if w.any() else 0.0 for w in weights], np.float32
            ),
            device=None if mesh is not None else device,
        )
        if wav_encoding == "pcm16":
            tracks, peak_scales = pack_tracks(moving_t, static_t)
        else:  # float32: the reference's format (no quantisation)
            tracks, peak_scales = torch.cat([moving_t, static_t]), None
        payload = {"tracks": tracks, "peak_scales": peak_scales,
                   "n_moving": len(banks)}
        if sink != "device":
            payload["tracks"] = _copy_to_host_async(tracks)
            if peak_scales is not None:
                payload["peak_scales"] = _copy_to_host_async(peak_scales)
    else:
        # A trajectory of one waypoint: per-source renders on the device,
        # each brought to the host.
        if mesh is not None:
            logger.warning("a single-waypoint trajectory renders source by source on %s, "
                           "unsharded", device)
        moving = []
        for i, (sp, traj, bank) in enumerate(
            zip(plan.speech_plans, plan.trajectories, banks)
        ):
            wet = render_moving_source(
                assemble_long_audio(sp), bank, np.asarray(traj), rng
            )
            wet, _ = loudness_normalize_to(wet, sr, plan.lufs_speech[i], device)
            moving.append(wet)
        noise = render_static_source(assemble_long_audio(plan.noise_plan), rir_noise)
        music = render_static_source(assemble_long_audio(plan.music_plan), rir_music)
        noise, _ = loudness_normalize_to(noise, sr, plan.lufs_noise, device)
        music, _ = loudness_normalize_to(music, sr, plan.lufs_music, device)
        payload = {"moving": moving, "noise": noise, "music": music}
    return {
        **payload,
        "scene": scene,
        "plan": plan,
        "out": out,
        "mic": mic,
        "transcripts": transcripts,
        "bank_f16": bank_f16,
        "save_trace": save_trace,
        "wav_encoding": wav_encoding,
        "sink": sink,
    }


def _write_json(path: Path, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _peak_guard_host(tracks: list[np.ndarray]) -> tuple[list, np.ndarray]:
    """Host twin of :func:`pack_tracks`' peak guard (the single-waypoint
    path): scale tracks whose peak exceeds the PCM16 ceiling."""
    scales = np.ones(len(tracks), np.float32)
    for i, tr in enumerate(tracks):
        peak = float(np.max(np.abs(tr))) if np.size(tr) else 0.0
        if peak > PCM16_LIMIT:
            scales[i] = PCM16_LIMIT / peak
    return [t * s for t, s in zip(tracks, scales)], scales


def finalize_mixture(handle: dict, writer: "ArtifactWriter | None" = None) -> dict:
    """Host half of :func:`render_mixture`: wait for the device→host copies
    and write the WAVs, bank, trace and metadata (SonicSet_train.py:50-138).

    With ``writer`` the disk writes are queued to its thread (call
    ``writer.barrier()`` before relying on the files).

    For ``sink="device"`` it writes nothing and does not wait: it returns
    the tracks (on the device) and ``fence``, a CUDA event recorded after
    the mixture's last output (None off the card), for the caller to wait
    on when it must."""
    if handle.get("sink") == "device":
        tracks = handle.get("tracks")
        fence = None
        if torch.is_tensor(tracks) and tracks.device.type == "cuda":
            fence = torch.cuda.Event()
            fence.record(torch.cuda.current_stream(tracks.device))
        return {"device_resident": True, "out": handle["out"], "fence": fence,
                "tracks": tracks, "peak_scales": handle.get("peak_scales")}
    out: Path = handle["out"]
    plan: MixturePlan = handle["plan"]
    mic = handle["mic"]
    transcripts = handle["transcripts"]
    sr = plan.sample_rate

    def do(fn, *args, **kwargs):
        if writer is not None:
            writer.submit(fn, *args, **kwargs)
        else:
            fn(*args, **kwargs)

    if handle["bank_f16"] is not None:
        banks_np = [_host_array(b) for b in handle["bank_f16"]]
        do(
            save_rir_bank,
            out / f"rir_bank_{plan.channel_type}.npz",
            np.stack(
                [b[: min(x.shape[0] for x in banks_np)] for b in banks_np]
            ) if len({b.shape for b in banks_np}) > 1 else np.stack(banks_np),
            source_positions=np.asarray(
                [t[0] for t in plan.trajectories], np.float64
            ),
            receiver_positions=mic[None, :],
            sample_rate=sr,
        )

    encoding = handle.get("wav_encoding", "pcm16")
    peak_scales = None
    if "tracks" in handle:
        tracks = _host_array(handle["tracks"])
        n_moving = handle["n_moving"]
        moving = [tracks[i] for i in range(n_moving)]
        noise, music = tracks[n_moving], tracks[n_moving + 1]
        if handle.get("peak_scales") is not None:
            peak_scales = _host_array(handle["peak_scales"])
    else:
        moving = list(handle["moving"])
        noise, music = handle["noise"], handle["music"]
        if encoding == "pcm16":
            scaled, peak_scales = _peak_guard_host(moving + [noise, music])
            moving, (noise, music) = scaled[:-2], scaled[-2:]
    track_names = [f"moving_audio_{i + 1}.wav" for i in range(len(moving))]
    track_names += ["noise_audio.wav", "music_audio.wav"]
    for name, wet in zip(track_names, moving + [noise, music]):
        do(write_wav, out / name, wet, sr, encoding=encoding)

    if handle["save_trace"]:
        do(
            save_trace_image,
            out / "trace.png",
            handle["scene"].nav,
            trajectories=[np.asarray(t) for t in plan.trajectories],
            mic_points=mic[None, :],
            static_points=np.stack(
                [np.asarray(plan.noise_point), np.asarray(plan.music_point)]
            ),
        )

    def _words(names):
        if not transcripts:
            return []
        # Extension-blind fallback: transcript CSVs key '<id>.flac' while
        # the WAV corpus places '<id>.wav': the exact name, then the stem.
        by_stem = {Path(k).stem: v for k, v in transcripts.items()}
        return [
            transcripts.get(Path(n).name)
            or by_stem.get(Path(n).stem, "")
            for n in names
        ]

    meta = {
        **{
            f"source{i + 1}": {
                "audio": sp.audio_names,
                "start_end_points": sp.start_end_points,
                "words": _words(sp.audio_names),
            }
            for i, sp in enumerate(plan.speech_plans)
        },
        "noise": {
            "audio": plan.noise_plan.audio_names,
            "start_end_points": plan.noise_plan.start_end_points,
        },
        "music": {
            "audio": plan.music_plan.audio_names,
            "start_end_points": plan.music_plan.start_end_points,
        },
    }
    if peak_scales is not None:
        applied = {
            name: float(s)
            for name, s in zip(track_names, peak_scales)
            if s != 1.0
        }
        if applied:
            # Tracks scaled below the plan's LUFS target to fit int16 full
            # scale without clipping; original = written / scale.
            meta["pcm16_peak_scale"] = applied
    # json_data.json is the completion marker: it must be queued last
    # (the partial-dir cleanup and remove_existing_speakers key on it).
    do(plan.save, out / "mixture_plan.json")
    do(_write_json, out / "json_data.json", meta)
    return meta


def render_mixture(
    scene: Scene,
    plan: MixturePlan,
    output_dir: str | Path,
    transcripts: dict[str, str] | None = None,
    save_bank: bool = True,
    save_trace: bool = True,
    mesh=None,
    wav_encoding: str = "pcm16",
    cache: UtteranceCache | None = None,
    sink: str = "disk",
) -> dict:
    """Execute a MixturePlan → WAVs + metadata on disk, on the scene's
    device (SonicSet_train.py:50-138).

    ``wav_encoding``: "pcm16" (half-size copies and files; peak-guarded,
    scales recorded in json_data.json) or "float32" (the reference's
    format). ``sink="device"``: compute only, no copies and no files (see
    :func:`dispatch_mixture`). ``mesh``: the bank and source renders
    sharded over a ``parallel.mesh.Mesh`` (:func:`dispatch_mixture`)."""
    return finalize_mixture(
        dispatch_mixture(
            scene, plan, output_dir, transcripts, save_bank, save_trace,
            mesh, wav_encoding, cache, sink,
        )
    )


def looks_like_partial_mixture(folder: Path) -> bool:
    """True for dirs this pipeline plausibly created and left incomplete:
    empty (crash right after mkdir) or holding a recognisable mixture
    artifact. Unrelated user dirs are left alone by the resume cleanup in
    :func:`generate_split`."""
    entries = list(folder.iterdir())
    if not entries:
        return True
    marks = ("moving_audio_", "noise_audio", "music_audio",
             "rir_bank_", "mixture_plan", "trace.")
    return any(e.name.startswith(marks) for e in entries)


def remove_existing_speakers(results_root: str | Path, speech_dirs: list[str]) -> list[str]:
    """Resume: drop speakers already present in a completed triple dir
    (removing_exist_speaker, SonicSet_train.py:140-151).

    Stricter than the reference, which counts any existing folder: a dir
    left partial by a crash (no ``json_data.json``, which is written last)
    returns its speakers to the pool, and when the same triple forms again
    the mixture is regenerated in place (plans are seeded by (scene,
    triple), so it is identical)."""
    root = Path(results_root)
    if not root.exists():
        return list(speech_dirs)
    used: set[str] = set()
    for folder in root.iterdir():
        if (folder / "json_data.json").exists():
            used.update(folder.name.split("-"))
    return [s for s in speech_dirs if Path(s).name not in used]


def _clean_partial_dirs(scene_root: Path) -> None:
    """A crash between artifact writes leaves a dir without json_data.json
    (written last). Remove it, so its speakers return to the pool and no
    reader scans a half-written mixture; leave unrelated dirs alone."""
    if not scene_root.exists():
        return
    for folder in scene_root.iterdir():
        if not folder.is_dir() or (folder / "json_data.json").exists():
            continue
        if looks_like_partial_mixture(folder):
            logger.warning("removing partial mixture dir %s", folder)
            shutil.rmtree(folder)
        else:
            logger.warning(
                "ignoring non-mixture dir %s (no pipeline artifacts)", folder
            )


def generate_split(
    scene_factory,
    scene_names: list[str],
    speech_dirs: list[str],
    noise_manifest: dict[str, int],
    music_manifest: dict[str, int],
    results_root: str | Path,
    transcripts: dict[str, str] | None = None,
    duration: float = 60.0,
    speakers_per_mixture: int = 3,
    base_seed: int = 0,
    max_mixtures: int | None = None,
    pipeline: bool = True,
    pipeline_depth: int = 2,
    wav_encoding: str = "pcm16",
    utterance_cache: "bool | UtteranceCache" = True,
    save_bank: bool = True,
    sink: str = "disk",
) -> list[Path]:
    """Outer generation loop (SonicSet_train.py:153-219): per scene, consume
    speaker directories in random triples until too few are left, with
    resume. Each mixture runs on its scene's ``device``.

    ``scene_factory(scene_name) -> Scene``; speech dirs are per-speaker
    folders whose WAV lengths are scanned into manifests.

    With ``pipeline`` (the default), up to ``pipeline_depth`` mixtures are
    in flight: mixture k's device→host copies and disk writes overlap
    mixture k+1's device work. Plans are seeded per (scene, triple), so
    results are identical either way.

    With ``utterance_cache`` (the default), decoded utterances stay on the
    device across mixtures and long audio is assembled there
    (device_assembly.py): bit-identical output, uploads reduced to cache
    misses (the speaker pool resets per scene, so every speaker recurs).
    Pass an :class:`UtteranceCache` to share a warm cache across several
    calls (e.g. train and val of one corpus).

    ``sink="device"`` writes nothing; every fourth mixture, and once at the
    end, the loop waits on a CUDA event recorded after that mixture's
    output, which bounds the device memory held by queued work.
    """
    results_root = Path(results_root)
    produced: list[Path] = []
    pending: list = []  # [(handle, out_dir, scene, name, t0), ...]
    writer = ArtifactWriter() if pipeline else None
    cache: UtteranceCache | None = (
        utterance_cache if isinstance(utterance_cache, UtteranceCache) else None
    )
    length_memo: dict[str, dict] = {}
    fences: list = []  # device-sink events not waited on yet

    def scan_lengths_memo(c: str) -> dict:
        # Speaker dirs recur across scenes: read each one's headers once.
        got = length_memo.get(c)
        if got is None:
            got = length_memo[c] = scan_audio_lengths(c)
        return got

    def _drain_fences() -> None:
        if fences:
            fences[-1].synchronize()  # events on one stream complete in order
            fences.clear()

    def _note_fence(res) -> None:
        if isinstance(res, dict) and res.get("fence") is not None:
            fences.append(res["fence"])
            if len(fences) >= 4:
                _drain_fences()

    def _log(scene_name_, name_, t0_) -> None:
        logger.info(
            "%s/%s: %.1f s elapsed (%d generated)",
            scene_name_, name_, time.perf_counter() - t0_, len(produced),
        )

    def _finish(p) -> None:
        handle, out_dir, scene_name_, name_, t0_ = p
        _note_fence(finalize_mixture(handle, writer))
        produced.append(out_dir)
        _log(scene_name_, name_, t0_)

    try:
        for s_idx, scene_name in enumerate(scene_names):
            scene = scene_factory(scene_name)
            scene_root = results_root / scene_name
            _clean_partial_dirs(scene_root)
            pool = remove_existing_speakers(scene_root, speech_dirs)
            rng_outer = np.random.default_rng(base_seed + s_idx)
            while len(pool) >= speakers_per_mixture:
                triple = list(
                    rng_outer.choice(
                        len(pool), speakers_per_mixture, replace=False
                    )
                )
                chosen = [pool[i] for i in sorted(triple)]
                pool = [p for p in pool if p not in chosen]
                name = "-".join(Path(c).name.split(".")[0] for c in chosen)
                out_dir = scene_root / name
                if (out_dir / "json_data.json").exists():
                    continue
                # stable_seed, not hash(): str hashing is randomised per
                # process, which would break replay and resume.
                seed = stable_seed(base_seed, scene_name, name)
                rng = np.random.default_rng(seed)
                t0 = time.perf_counter()
                plan = plan_mixture(
                    scene,
                    [scan_lengths_memo(c) for c in chosen],
                    noise_manifest,
                    music_manifest,
                    rng,
                    duration=duration,
                    seed=seed,
                )
                if utterance_cache and cache is None:
                    cache = UtteranceCache(sample_rate=plan.sample_rate,
                                           device=scene.device)
                if pipeline:
                    handle = dispatch_mixture(
                        scene, plan, out_dir, transcripts,
                        save_bank=save_bank,
                        wav_encoding=wav_encoding, cache=cache, sink=sink,
                    )
                    # Dispatch k before finalising k-1: k's device work and
                    # copies stream while the host waits on k-1's bytes and
                    # writes its files.
                    pending.append((handle, out_dir, scene_name, name, t0))
                    while len(pending) > max(int(pipeline_depth), 1):
                        _finish(pending.pop(0))
                else:
                    _note_fence(render_mixture(
                        scene, plan, out_dir, transcripts,
                        save_bank=save_bank,
                        wav_encoding=wav_encoding, cache=cache, sink=sink,
                    ))
                    produced.append(out_dir)
                    _log(scene_name, name, t0)
                if (
                    max_mixtures is not None
                    and len(produced) + len(pending) >= max_mixtures
                ):
                    while pending:
                        _finish(pending.pop(0))
                    _drain_fences()
                    return produced
        while pending:
            _finish(pending.pop(0))
        _drain_fences()
        return produced
    finally:
        while pending:
            # Unwinding with mixtures in flight (an error or an interrupt):
            # report the dispatched mixtures' outcomes rather than drop them.
            try:
                _finish(pending.pop(0))
            except Exception:
                logger.exception("pipelined render failed while unwinding")
        try:
            _drain_fences()
        except Exception:
            logger.exception("device-sink fence wait failed while unwinding")
        if writer is not None:
            # Every queued artifact is on disk before the caller sees
            # `produced`; a deferred write error is raised here, unless
            # another exception is already unwinding, which it must not mask.
            unwinding = sys.exc_info()[0] is not None
            try:
                writer.close()
            except Exception:
                if unwinding:
                    logger.exception("artifact writer failed while unwinding")
                else:
                    raise
