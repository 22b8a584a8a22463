"""Inference helpers (port of ``sonicsim_tpu.infer``): bf16 forward, output
→ waveform, the energy VAD, cross-segment stitching and chunked
(overlap-add) inference."""

from .chunked import wav_chunk_inference
from .postprocess import to_waveform
from .precision import bf16_forward
from .stitch import concatenate_tracks, spectral_embedding, stitch_segments
from .vad import energy_vad, segment_mixture

__all__ = [
    "bf16_forward",
    "concatenate_tracks",
    "energy_vad",
    "segment_mixture",
    "spectral_embedding",
    "stitch_segments",
    "to_waveform",
    "wav_chunk_inference",
]
