"""Inference helpers (port of ``sonicsim_tpu.infer``): bf16 forward, output
→ waveform, the energy VAD and cross-segment stitching. Chunked inference
(``wav_chunk_inference``) waits for ROADMAP A10."""

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
]
