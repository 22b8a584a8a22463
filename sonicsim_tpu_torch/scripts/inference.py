"""Single-mixture inference from the command line, on the card or the CPU.

  python -m sonicsim_tpu_torch.scripts.inference --model_path best_model.pkl \\
      --mix mix.wav [--out_dir DIR] [--segment_seconds 10] [--bf16] \\
      [--ecapa embedding_model.ckpt] [--device cpu]

Port of scripts/inference.py (reference separation/inference.py:32-154):
downmixes the mixture to mono, separates it in fixed windows, re-tracks the
speakers across windows by embedding similarity (the spectral envelope, or
with ``--ecapa`` speechbrain's ECAPA-TDNN from its embedding_model.ckpt),
and writes s{i}_est.wav. The model and the embedder run on ``--device``
(default: the card), in full float32 (TF32 off) or, with ``--bf16``, the
model in bfloat16.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..infer import concatenate_tracks, stitch_segments
from ..models import from_pretrain
from ..utils import read_wav, write_wav
from .common import make_forward, model_device, strict_float32


def separate(model, mono: np.ndarray, sample_rate: int, segment_seconds: float = 10.0,
             bf16: bool = False, embed_fn=None) -> np.ndarray:
    """(T,) mixture → (n_src, T) stitched tracks: windows of
    ``segment_seconds`` (the last one zero-padded for the forward and cut
    back), each separated on the model's device."""
    device = model_device(model)
    fwd = make_forward(model, bf16)
    seg_len = int(segment_seconds * sample_rate)
    segments = []
    for s in range(0, len(mono), seg_len):
        chunk = np.asarray(mono[s:s + seg_len], np.float32)
        pad = seg_len - len(chunk)
        if pad:
            chunk = np.pad(chunk, (0, pad))
        est = fwd(torch.from_numpy(chunk)[None].to(device))[0].cpu().numpy()
        segments.append(est[..., :seg_len - pad])
    return concatenate_tracks(
        stitch_segments(segments, sample_rate, embed_fn=embed_fn, device=device))


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--mix", required=True, help="input mixture wav")
    ap.add_argument("--out_dir", default=None,
                    help="output directory (default: next to the mix)")
    ap.add_argument("--segment_seconds", type=float, default=10.0)
    ap.add_argument("--bf16", action="store_true",
                    help="run the model in bfloat16")
    ap.add_argument("--ecapa", default=None, metavar="CKPT",
                    help="speechbrain embedding_model.ckpt: re-track speakers with the "
                    "ECAPA-TDNN embedder instead of the spectral-envelope default")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card; cpu for the CPU)")
    args = ap.parse_args(argv)
    strict_float32()

    embed_fn = None
    if args.ecapa:
        from ..models.ecapa import make_ecapa_embedder

        embed_fn = make_ecapa_embedder(args.ecapa, device=args.device)
    model = from_pretrain(args.model_path, device=args.device)
    mix, sr = read_wav(args.mix)
    tracks = separate(model, mix.mean(axis=0), sr, args.segment_seconds, args.bf16, embed_fn)
    out = Path(args.out_dir) if args.out_dir else Path(args.mix).parent
    out.mkdir(parents=True, exist_ok=True)
    for i in range(tracks.shape[0]):
        write_wav(out / f"s{i + 1}_est.wav", tracks[i], sr)
    print(f"wrote {tracks.shape[0]} tracks to {out}")
    return out


if __name__ == "__main__":
    main()
