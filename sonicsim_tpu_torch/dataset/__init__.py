"""SonicSet generation (port of the generation part of
``sonicsim_tpu.dataset``): seeded plans, dry-track assembly on the host or
on the device, the per-mixture render and the split loop. The training-data
modules (datamodule, loader, remix, sampler) are not ported yet (ROADMAP
A7)."""

from .assemble import (
    assemble_long_audio,
    loudness_normalize_to,
    render_moving_source,
    render_static_source,
)
from .device_assembly import UtteranceCache, assemble_plans_on_device
from .generate import (
    ArtifactWriter,
    dispatch_mixture,
    finalize_mixture,
    generate_split,
    looks_like_partial_mixture,
    pack_tracks,
    plan_mixture,
    remove_existing_speakers,
    render_mixture,
)
from .plan import (
    LUFS_JITTER,
    LUFS_MUSIC,
    LUFS_NOISE,
    LUFS_SPEECH,
    LongAudioPlan,
    MixturePlan,
    Placement,
    load_length_manifest,
    load_split_manifest,
    plan_background_audio,
    plan_long_audio,
    scan_audio_lengths,
    select_files_to_fill,
)

__all__ = [
    "ArtifactWriter",
    "LUFS_JITTER",
    "LUFS_MUSIC",
    "LUFS_NOISE",
    "LUFS_SPEECH",
    "LongAudioPlan",
    "MixturePlan",
    "Placement",
    "UtteranceCache",
    "assemble_long_audio",
    "assemble_plans_on_device",
    "dispatch_mixture",
    "finalize_mixture",
    "generate_split",
    "load_length_manifest",
    "load_split_manifest",
    "looks_like_partial_mixture",
    "loudness_normalize_to",
    "pack_tracks",
    "plan_background_audio",
    "plan_long_audio",
    "plan_mixture",
    "remove_existing_speakers",
    "render_mixture",
    "render_moving_source",
    "render_static_source",
    "scan_audio_lengths",
    "select_files_to_fill",
]
