"""SonicSet generation, training and evaluation data (port of
``sonicsim_tpu.dataset``): seeded plans, dry-track assembly on the host or
on the device, the per-mixture render, the split loop, the samplers that
read a generated split, the prefetching loader, ``MovingDataModule`` and
the segment-manifest remix training set (``RemixTrainDataset``)."""

from .assemble import (
    assemble_long_audio,
    loudness_normalize_to,
    render_moving_source,
    render_static_source,
)
from .datamodule import MovingDataModule
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
from .loader import batched_loader, prefetch_iter
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
from .remix import RemixTrainDataset, build_segment_manifest
from .sampler import (
    MovingTestDataset,
    MovingTestEvalDataset,
    MovingTrainDataset,
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
    "MovingDataModule",
    "MovingTestDataset",
    "MovingTestEvalDataset",
    "MovingTrainDataset",
    "Placement",
    "RemixTrainDataset",
    "UtteranceCache",
    "apply_sir",
    "apply_snr",
    "assemble_long_audio",
    "assemble_plans_on_device",
    "batched_loader",
    "build_segment_manifest",
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
    "prefetch_iter",
    "remove_existing_speakers",
    "render_mixture",
    "render_moving_source",
    "render_static_source",
    "rms_db",
    "scan_audio_lengths",
    "select_files_to_fill",
]
