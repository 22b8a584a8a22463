"""Materialise the seeded eval remix of a generated split into WAV trees.

  python -m sonicsim_tpu_torch.scripts.generate_fixed_eval --in_dir SPLIT \\
      --out_dir OUT [--task separation|enhancement] [--noise_type noise|music|all] \\
      [--seed 0] [--device cpu]

Port of scripts/generate_fixed_eval.py (reference
separation/generate_fixed_validation.py:8-27, generate_fixed_test.py):
``sample{i}/mix.wav`` and ``s{j}.wav`` (``clean.wav`` for enhancement) per
folder, so metrics compare across runs. The remix is numpy on the host;
``--device`` is checked as every CLI of the port checks it (the card
unless ``cpu`` is named), so no CLI of the port runs without a card unless
asked to.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..bridge import resolve_device
from ..dataset.sampler import MovingTestEvalDataset
from ..utils import write_wav


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--in_dir", required=True, help="generated split root")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--task", default="separation", choices=["separation", "enhancement"])
    ap.add_argument("--noise_type", default="noise", choices=["noise", "music", "all"])
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    ds = MovingTestEvalDataset(speech_dir=args.in_dir, sample_rate=args.sample_rate,
                               noise_type=args.noise_type, task=args.task, seed=args.seed)
    out_root = Path(args.out_dir)
    for i in range(len(ds)):
        mix, targets, _folder = ds[i]
        sample_dir = out_root / f"sample{i + 1}"
        sample_dir.mkdir(parents=True, exist_ok=True)
        write_wav(sample_dir / "mix.wav", mix, args.sample_rate)
        if args.task == "enhancement":
            if targets.shape[0] != 1:
                raise ValueError(f"enhancement expects one source, got {targets.shape[0]}")
            write_wav(sample_dir / "clean.wav", targets[0], args.sample_rate)
        else:
            for s in range(targets.shape[0]):
                write_wav(sample_dir / f"s{s + 1}.wav", targets[s], args.sample_rate)
    print(f"materialized {len(ds)} samples into {out_root}")
    return out_root


if __name__ == "__main__":
    main()
