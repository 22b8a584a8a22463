"""Host helpers: WAV I/O, seeding, audio and list helpers, transcripts, the
component registry, the YAML config system and per-stage timing and
traces (port of ``sonicsim_tpu.utils``)."""

from .audio import (
    all_pairs,
    clip_all,
    clip_two,
    make_pad_mask,
    normalize,
    pad_x_to_y,
    pcm16_exact,
    pcm16_quantize,
    sum_arrays_with_different_length,
)
from .config import import_target, instantiate, load_config, save_config
from .profiling import StageTimer, annotate, trace
from .registry import Registry
from .seeding import stable_seed
from .transcripts import load_transcripts, process_librispeech
from .wavio import read_wav, resample, wav_num_frames, write_wav

__all__ = [
    "Registry",
    "StageTimer",
    "all_pairs",
    "annotate",
    "clip_all",
    "clip_two",
    "import_target",
    "instantiate",
    "load_config",
    "load_transcripts",
    "make_pad_mask",
    "normalize",
    "pad_x_to_y",
    "pcm16_exact",
    "pcm16_quantize",
    "process_librispeech",
    "read_wav",
    "resample",
    "save_config",
    "stable_seed",
    "sum_arrays_with_different_length",
    "trace",
    "wav_num_frames",
    "write_wav",
]
