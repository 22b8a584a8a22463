"""Benchmark evaluation of a materialised test tree, on the card or the CPU.

  python -m sonicsim_tpu_torch.scripts.test --conf_dir CONFIG.yaml \\
      [--model_path best_model.pkl] [--limit N] [--bf16] [--use_vad] \\
      [--dnsmos_dir DIR] [--sigmos_path MODEL.onnx] [--no_pesq] \\
      [--whisper MODEL] [--vad_ckpt CKPT] [--bucket SAMPLES] [--device cpu]

Port of scripts/test.py (reference separation/test.py, enhancement/test.py):
walks ``datas.test_dir`` (mix.wav + s{i}.wav per folder), segments each
mixture by the start/end points its ``json_data.json`` records (or, with
``--use_vad``, by the energy VAD, or by PyanNet from a pyannote checkpoint
with ``--vad_ckpt``, which turns ``--use_vad`` on), separates each span and
scores it with the ``MetricsTracker`` into
``<exp.dir>/<exp.name>/results/metrics.csv``. ``--dnsmos_dir`` adds a
``dnsmos`` column (OVRL) and ``--sigmos_path`` the seven SigMOS axes, each
from the user's .onnx weights; ``--whisper`` an ``asr`` text column, the
transcript of each estimate (a local Whisper checkpoint through the port,
a model name through faster-whisper). Every sidecar runs on the device of
``--device``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..dataset.sampler import MovingTestDataset
from ..infer import segment_mixture
from ..metrics import MetricsTracker, make_dnsmos, make_sigmos_all, make_whisper_asr
from ..models import from_pretrain
from ..models.pyannet import make_neural_vad
from ..utils.config import load_config
from .common import make_forward, model_device, pesq_columns, strict_float32

MIN_SEGMENT = 320  # samples; the reference skips shorter (separation/test.py:80)


def metadata_segments(folder: str, total: int) -> list[tuple[int, int]]:
    """Voice-active spans from json_data.json start_end_points (union over
    sources), falling back to one full-length segment."""
    meta_path = Path(folder) / "json_data.json"
    if not meta_path.exists():
        return [(0, total)]  # the caller may VAD instead (see --use_vad)
    with open(meta_path) as f:
        meta = json.load(f)
    spans = []
    for key, src in meta.items():
        if key.startswith("source") and "start_end_points" in src:
            spans.extend(tuple(p) for p in src["start_end_points"])
    if not spans:
        return [(0, total)]
    spans.sort()
    merged = [list(spans[0])]
    for s, e in spans[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, min(e, total)) for s, e in merged if e - s > MIN_SEGMENT]


def evaluate_split(model, test_dir, save_file, sample_rate: int = 16000,
                   num_spks: int = 2, limit: int | None = None, bf16: bool = False,
                   use_vad: bool = False, extra_metrics: dict | None = None,
                   bucket: int = 0, vad_fn=None, extra_text: dict | None = None) -> dict:
    """The CLI's loop; returns what ``audio_test.evaluate_remix`` returns
    and the tracker's host seconds per column (``column_s``). ``bucket`` > 0 zero-pads each span up to a
    multiple of ``bucket`` samples for the forward and cuts the estimate
    back (padding moves the global norms' statistics slightly). With
    ``use_vad``, ``vad_fn`` (the energy VAD if None) segments each mixture;
    ``extra_text`` are the tracker's text columns."""
    device = model_device(model)
    fwd = make_forward(model, bf16)
    ds = MovingTestDataset(speech_dir=str(test_dir), sample_rate=sample_rate,
                           num_spks=num_spks, return_path=True)
    tracker = MetricsTracker(save_file, extra_metrics=extra_metrics, extra_text=extra_text,
                             device=device)
    n = len(ds) if limit is None else min(limit, len(ds))
    forward_s = metrics_s = 0.0
    spans_done = 0
    for i in range(n):
        mix, targets, folder = ds[i]
        spans = (segment_mixture(mix, ds.sample_rate, vad_fn=vad_fn) if use_vad
                 else metadata_segments(folder, mix.shape[-1]))
        for s, e in spans:
            seg_mix = mix[s:e]
            run_mix = seg_mix
            if bucket:
                padded = -((s - e) // bucket) * bucket
                run_mix = np.pad(seg_mix, (0, padded - (e - s)))
            t0 = time.perf_counter()
            est = fwd(torch.from_numpy(np.ascontiguousarray(run_mix))[None].to(device))
            est = est[0].cpu().numpy()[..., :e - s]
            t1 = time.perf_counter()
            tracker(seg_mix, targets[:, s:e], est, f"{Path(folder).name}:{s}")
            forward_s += t1 - t0
            metrics_s += time.perf_counter() - t1
            spans_done += 1
        print(f"[{i + 1}/{n}] {Path(folder).name} running={tracker.update()}", flush=True)
    return dict(final=tracker.final(), csv=tracker.save_file, mixtures=n,
                spans=spans_done, skipped_silent=tracker.skipped_silent,
                forward_s=forward_s, metrics_s=metrics_s, column_s=dict(tracker.seconds))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf_dir", required=True)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--bf16", action="store_true", help="run the model in bfloat16")
    ap.add_argument("--use_vad", action="store_true",
                    help="segment with the energy VAD instead of json_data.json spans")
    ap.add_argument("--dnsmos_dir", default=None,
                    help="directory of the DNSMOS weights (sig_bak_ovr.onnx, model_v8.onnx)")
    ap.add_argument("--sigmos_path", default=None, help="the SigMOS .onnx weights")
    ap.add_argument("--no_pesq", action="store_true",
                    help="drop the default pesq_nb/pesq_wb columns")
    ap.add_argument("--whisper", default=None, metavar="MODEL_SIZE",
                    help="add an asr transcript column: a local Whisper checkpoint "
                    "(HF directory or OpenAI .pt) or a faster-whisper model name")
    ap.add_argument("--vad_ckpt", default=None, metavar="CKPT",
                    help="a pyannote PyanNet checkpoint: segment with the neural VAD "
                    "(turns --use_vad on)")
    ap.add_argument("--bucket", type=int, default=0, metavar="SAMPLES",
                    help="zero-pad spans up to multiples of SAMPLES for the "
                    "forward (default 0: exact lengths)")
    ap.add_argument("--device", default=None,
                    help="where the model and the SDRs run (default: the card; "
                    "cpu for the CPU)")
    args = ap.parse_args(argv)
    strict_float32()

    cfg = load_config(args.conf_dir)
    exp_dir = Path(cfg["exp"]["dir"]) / cfg["exp"]["name"]
    model = from_pretrain(args.model_path or exp_dir / "best_model.pkl", device=args.device)
    device = model_device(model)
    extra_metrics = {}  # in the JAX script's order
    if args.dnsmos_dir:
        extra_metrics["dnsmos"] = make_dnsmos(args.dnsmos_dir, device=device)
    if args.sigmos_path:
        extra_metrics.update(make_sigmos_all(args.sigmos_path, device=device))
    if not args.no_pesq:
        extra_metrics.update(pesq_columns())
    extra_text = {}
    if args.whisper:
        extra_text["asr"] = make_whisper_asr(args.whisper, device=device)
    vad_fn = None
    if args.vad_ckpt:
        if not args.use_vad:
            # the checkpoint states the intent: without --use_vad it would
            # be loaded and the metadata spans used
            print("--vad_ckpt given: enabling --use_vad")
            args.use_vad = True
        vad_fn = make_neural_vad(args.vad_ckpt, device=device)
    result = evaluate_split(
        model, cfg["datas"]["test_dir"], exp_dir / "results" / "metrics.csv",
        sample_rate=int(cfg["datas"].get("sample_rate", 16000)),
        num_spks=int(cfg["datas"].get("num_spks", 2)), limit=args.limit,
        bf16=args.bf16, use_vad=args.use_vad,
        extra_metrics=extra_metrics or None, bucket=args.bucket, vad_fn=vad_fn,
        extra_text=extra_text or None)
    print("final:", result["final"])
    print(f"{result['spans']} spans of {result['mixtures']} mixtures: forward "
          f"{result['forward_s']:.3f} s, metrics {result['metrics_s']:.3f} s")
    return result


if __name__ == "__main__":
    main()
