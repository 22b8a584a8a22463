"""WAV file I/O without external audio dependencies.

A copy of the JAX package's ``utils/wavio.py``: RIFF/WAVE PCM 8/16/24/32
and IEEE float 32/64 read, PCM16 and float32 write, on numpy, plus a
polyphase resampler (``scipy.signal.resample_poly``). The port carries no
native decoder; the pure-Python parser below decodes exactly what the
reference's readers decode (tests/test_torch_gen_host.py).

Convention: waveforms are float32 numpy arrays shaped ``(channels,
samples)``, values in [-1, 1] for PCM.
"""

from __future__ import annotations

import os
import struct
from math import gcd
from pathlib import Path

import numpy as np
from scipy.signal import resample_poly


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file. Returns (waveform (C, T) float32, sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_ch, sr, _, _, bits = fmt
    if audio_format == 0xFFFE and len(data) >= 24:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack_from("<H", data, data.index(b"fmt ") + 8 + 24)[0]

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int8).astype(np.int32) << 16)
            ).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    n_frames = len(x) // n_ch
    return x[: n_frames * n_ch].reshape(n_frames, n_ch).T.copy(), sr


def wav_num_frames(path: str | Path) -> int:
    """Frame count from the RIFF header alone (fmt block_align + data
    chunk size), without decoding samples."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        size = os.fstat(f.fileno()).st_size
        block_align = data_size = None
        while block_align is None or data_size is None:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (csize,) = struct.unpack("<I", hdr[4:])
            if hdr[:4] == b"fmt ":
                body = f.read(csize + (csize & 1))
                block_align = struct.unpack_from("<HHIIHH", body, 0)[4]
            else:
                if hdr[:4] == b"data":
                    # clamp: a truncated file's data header may overclaim
                    data_size = min(csize, size - f.tell())
                f.seek(csize + (csize & 1), 1)
    if not block_align or data_size is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return data_size // block_align


def write_wav(
    path: str | Path,
    waveform: np.ndarray,
    sample_rate: int,
    *,
    encoding: str = "pcm16",
) -> None:
    """Write a WAV file. ``waveform``: (C, T) or (T,); encoding: pcm16 or
    float32. int16 input is written as it is (pcm16 only): the codes
    ``utils.audio.pcm16_quantize`` makes on the device."""
    x = np.asarray(waveform)
    if x.ndim == 1:
        x = x[None, :]
    n_ch, _ = x.shape
    interleaved = x.T.reshape(-1)
    if x.dtype == np.int16:
        if encoding != "pcm16":
            raise ValueError("int16 input requires pcm16 encoding")
        fmt_code, bits = 1, 16
        payload = interleaved.astype("<i2").tobytes()
    elif encoding == "pcm16":
        fmt_code, bits = 1, 16
        payload = (
            np.clip(interleaved, -1.0, 1.0 - 1.0 / 32768.0) * 32768.0
        ).astype("<i2").tobytes()
    elif encoding == "float32":
        fmt_code, bits = 3, 32
        payload = interleaved.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported encoding {encoding}")
    byte_rate = sample_rate * n_ch * bits // 8
    block_align = n_ch * bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_code, n_ch, sample_rate, byte_rate, block_align, bits
    )
    header += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(header + payload)


def resample(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis, to float32."""
    if orig_sr == new_sr:
        return waveform
    g = gcd(orig_sr, new_sr)
    return resample_poly(waveform, new_sr // g, orig_sr // g, axis=-1).astype(
        np.float32
    )
