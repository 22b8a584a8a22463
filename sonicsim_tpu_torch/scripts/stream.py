"""Real-time streaming separation with a causal SkiM, chunk by chunk.

  python -m sonicsim_tpu_torch.scripts.stream --model_path skim_causal.pkl \\
      --mix mix.wav [--out_dir DIR] [--chunks_per_step 1] [--device cpu]

Port of scripts/stream.py (SkiM's ``forward_stream`` role,
separation/look2hear/models/skim.py:603+, at segment granularity): feeds a
mixture through ``SkiMStreamer`` in the chunks a live microphone would
deliver, writes the separated tracks (``stream_spk{i}.wav``) and prints one
JSON line of stats: per-chunk latency (mean, p50, p95, max) and the
real-time factor. The model runs on ``--device`` (default: the card) in
full float32 (TF32 off).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..models import SkiMNet, SkiMStreamer, from_pretrain
from ..utils import read_wav, write_wav
from .common import strict_float32


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_path", required=True,
                    help="causal SkiMNet checkpoint (a pack of either package, or a .pth)")
    ap.add_argument("--mix", required=True, help="input mixture wav")
    ap.add_argument("--out_dir", default=".")
    ap.add_argument("--chunks_per_step", type=int, default=1,
                    help="stream granularity in streamer chunks (1 = lowest latency)")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card; cpu for the CPU)")
    args = ap.parse_args(argv)
    strict_float32()

    model = from_pretrain(args.model_path, device=args.device)
    if not isinstance(model, SkiMNet):
        raise SystemExit(f"streaming requires a SkiMNet checkpoint, got {type(model).__name__}")
    streamer = SkiMStreamer(model)
    device = streamer.device
    mix, sr = read_wav(args.mix)
    mono = mix.mean(axis=0).astype(np.float32)

    step_samples = streamer.chunk_samples * args.chunks_per_step
    chunk_ms = 1000.0 * step_samples / sr
    n_steps = max(1, int(np.ceil(len(mono) / step_samples)))
    padded = np.pad(mono, (0, n_steps * step_samples - len(mono)))
    # The encoder's last frame needs kernel_size − hop more samples, so N
    # whole chunks leave one segment buffered; this flush chunk completes it
    # (what a live pipeline feeds at the end of the stream).
    flush = np.zeros(model.kernel_size - streamer.hop, np.float32)

    # Warm up on silence (two chunks reach the segment path: the first alone
    # leaves the segment one frame short), then reset the state.
    for warm in (step_samples, step_samples, len(flush)):
        streamer.step(torch.zeros(1, warm, device=device))
    streamer.reset()

    outs, latencies = [], []
    t_start = time.perf_counter()
    for i in range(n_steps):
        chunk = torch.from_numpy(padded[None, i * step_samples:(i + 1) * step_samples])
        t0 = time.perf_counter()
        out = streamer.step(chunk.to(device)).cpu().numpy()  # a live consumer reads each chunk
        latencies.append(time.perf_counter() - t0)
        if out.size:
            outs.append(out)
    out = streamer.step(torch.from_numpy(flush[None]).to(device)).cpu().numpy()
    if out.size:
        outs.append(out)
    wall = time.perf_counter() - t_start

    est = np.concatenate(outs, axis=-1)[0, :, :len(mono)]  # (spk, T)
    est = np.pad(est, ((0, 0), (0, len(mono) - est.shape[-1])))
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for s in range(est.shape[0]):
        write_wav(out_dir / f"stream_spk{s + 1}.wav", est[s], sr)

    lat_ms = np.asarray(latencies) * 1000.0
    stats = {
        "audio_seconds": len(mono) / sr,
        "wall_seconds": round(wall, 3),
        "real_time_factor": round((len(mono) / sr) / wall, 2),
        "chunk_ms": round(chunk_ms, 1),
        "chunk_latency_ms": {
            "mean": round(float(lat_ms.mean()), 2),
            "p50": round(float(np.percentile(lat_ms, 50)), 2),
            "p95": round(float(np.percentile(lat_ms, 95)), 2),
            "max": round(float(lat_ms.max()), 2),
        },
        "realtime_safe": bool(np.percentile(lat_ms, 95) < chunk_ms),
        "outputs": [str(out_dir / f"stream_spk{s + 1}.wav") for s in range(est.shape[0])],
    }
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
