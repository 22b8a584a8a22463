"""Host helpers of SonicSet generation: WAV I/O, seeding, audio and list
helpers, transcripts (port of the generation part of ``sonicsim_tpu.utils``)."""

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
from .seeding import stable_seed
from .transcripts import load_transcripts, process_librispeech
from .wavio import read_wav, resample, wav_num_frames, write_wav

__all__ = [
    "all_pairs",
    "clip_all",
    "clip_two",
    "load_transcripts",
    "make_pad_mask",
    "normalize",
    "pad_x_to_y",
    "pcm16_exact",
    "pcm16_quantize",
    "process_librispeech",
    "read_wav",
    "resample",
    "stable_seed",
    "sum_arrays_with_different_length",
    "wav_num_frames",
    "write_wav",
]
