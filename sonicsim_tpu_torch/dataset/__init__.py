"""SonicSet generation and evaluation data (port of ``sonicsim_tpu.dataset``
but its training modules): seeded plans, dry-track assembly on the host or
on the device, the per-mixture render, the split loop, and the eval
samplers that read a generated split. The training-data modules
(datamodule, loader, remix, the training sampler) come with the training
slice (ROADMAP A7)."""

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
from .sampler import (
    MovingTestDataset,
    MovingTestEvalDataset,
    apply_sir,
    apply_snr,
    find_bottom_directories,
    overlap_audio,
    rms_db,
)

__all__ = [
    "ArtifactWriter",
    "LUFS_JITTER",
    "LUFS_MUSIC",
    "LUFS_NOISE",
    "LUFS_SPEECH",
    "LongAudioPlan",
    "MixturePlan",
    "MovingTestDataset",
    "MovingTestEvalDataset",
    "Placement",
    "UtteranceCache",
    "apply_sir",
    "apply_snr",
    "assemble_long_audio",
    "assemble_plans_on_device",
    "dispatch_mixture",
    "finalize_mixture",
    "find_bottom_directories",
    "generate_split",
    "load_length_manifest",
    "load_split_manifest",
    "looks_like_partial_mixture",
    "loudness_normalize_to",
    "overlap_audio",
    "pack_tracks",
    "plan_background_audio",
    "plan_long_audio",
    "plan_mixture",
    "remove_existing_speakers",
    "render_mixture",
    "render_moving_source",
    "render_static_source",
    "rms_db",
    "scan_audio_lengths",
    "select_files_to_fill",
]
