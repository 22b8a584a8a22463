"""Remix-tree evaluation from the command line, on the card or the CPU.

  python -m sonicsim_tpu_torch.scripts.audio_test --conf_dir CONFIG.yaml \\
      [--model_path best_model.pkl] [--segments_json spans.json] \\
      [--noise_type noise|music|all] [--limit N] [--bf16] [--no_pesq] [--device cpu]

Port of scripts/audio_test.py (reference separation/audio_test*.py):
remixes each folder of a generated split on the fly (``MovingTestEvalDataset``,
SIR and SNR drawn from ``--seed``), separates the spans of
``--segments_json`` (``{folder: [[start, end], ...]}``; the whole mixture
where a folder has none) and scores them with the ``MetricsTracker``
(SI-SNR(i), SDR(i), STOI and, unless ``--no_pesq``, PESQ nb/wb) into
``<exp.dir>/<exp.name>/results/metrics_remix-<noise_type>.csv``. The
config's ``exp`` and ``datas.test_dir`` are read; its ``_target_`` paths
are never imported.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from ..dataset.sampler import MovingTestEvalDataset
from ..metrics import MetricsTracker
from ..models import from_pretrain
from ..utils.config import load_config
from .common import make_forward, model_device, pesq_columns, strict_float32

MIN_SEGMENT = 320


def evaluate_remix(model, test_dir, save_file, segments: dict | None = None,
                   noise_type: str = "noise", task: str = "separation",
                   limit: int | None = None, bf16: bool = False,
                   extra_metrics: dict | None = None, seed: int = 0) -> dict:
    """The CLI's loop; ``extra_metrics`` are the tracker's sidecar columns
    (the CLI's: ``common.pesq_columns()``). Returns the tracker's final
    averages (``final``),
    the CSV path, the mixtures and spans evaluated, and the seconds spent in
    the forward (``forward_s``, device→host copy included) and in the
    tracker (``metrics_s``: SDRs on the model's device, STOI and PESQ on the
    host)."""
    device = model_device(model)
    fwd = make_forward(model, bf16)
    ds = MovingTestEvalDataset(speech_dir=str(test_dir), noise_type=noise_type,
                               task=task, seed=seed)
    segments = segments or {}
    tracker = MetricsTracker(save_file, extra_metrics=extra_metrics, device=device)
    n = len(ds) if limit is None else min(limit, len(ds))
    forward_s = metrics_s = 0.0
    spans_done = 0
    for i in range(n):
        mix, targets, folder = ds[i]
        spans = segments.get(folder) or segments.get(Path(folder).name) or [(0, mix.shape[-1])]
        for s, e in spans:
            if e - s <= MIN_SEGMENT:
                continue
            t0 = time.perf_counter()
            est = fwd(torch.from_numpy(mix[None, s:e]).to(device))[0].cpu().numpy()
            t1 = time.perf_counter()
            tracker(mix[s:e], targets[:, s:e], est, f"{Path(folder).name}:{s}")
            forward_s += t1 - t0
            metrics_s += time.perf_counter() - t1
            spans_done += 1
        print(f"[{i + 1}/{n}] {Path(folder).name} running={tracker.update()}", flush=True)
    return dict(final=tracker.final(), csv=tracker.save_file, mixtures=n,
                spans=spans_done, skipped_silent=tracker.skipped_silent,
                forward_s=forward_s, metrics_s=metrics_s)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf_dir", required=True)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--segments_json", default=None,
                    help="precomputed {folder: [[start, end], ...]} spans")
    ap.add_argument("--noise_type", default="noise", choices=["noise", "music", "all"])
    ap.add_argument("--task", default="separation", choices=["separation", "enhancement"])
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--bf16", action="store_true", help="run the model in bfloat16")
    ap.add_argument("--no_pesq", action="store_true",
                    help="drop the default pesq_nb/pesq_wb columns")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model and the SDRs run (default: the card; "
                    "cpu for the CPU)")
    args = ap.parse_args(argv)
    strict_float32()

    cfg = load_config(args.conf_dir)
    exp_dir = Path(cfg["exp"]["dir"]) / cfg["exp"]["name"]
    model = from_pretrain(args.model_path or exp_dir / "best_model.pkl", device=args.device)
    segments = None
    if args.segments_json:
        with open(args.segments_json) as f:
            segments = json.load(f)
    result = evaluate_remix(
        model, cfg["datas"]["test_dir"],
        exp_dir / "results" / f"metrics_remix-{args.noise_type}.csv",
        segments=segments, noise_type=args.noise_type, task=args.task,
        limit=args.limit, bf16=args.bf16,
        extra_metrics=None if args.no_pesq else pesq_columns(), seed=args.seed)
    print("final:", result["final"])
    print(f"{result['spans']} spans of {result['mixtures']} mixtures: forward "
          f"{result['forward_s']:.3f} s, metrics {result['metrics_s']:.3f} s")
    return result


if __name__ == "__main__":
    main()
