"""Tracker variants: the no-ASR alias and the 3-source split tracker.

Port of ``sonicsim_tpu.metrics.variants`` (reference separation/look2hear/
metrics/wrapper_noasr.py, splitwrapper.py:18-115). ``MetricsTrackerNoASR``
is the ``MetricsTracker``, which runs no sidecar unless given one.
``SplitMetricsTracker`` PIT-aligns 3 estimates on SNR, then scores speakers
{0, 1} ("two") and speaker 2 ("one") apart, with mixture baselines; its
SNRs run on ``device`` (the card unless given).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch

from ..bridge import resolve_device
from ..losses.pit import PITLossWrapper
from ..losses.sdr import PairwiseNegSDR
from .tracker import MetricsTracker

MetricsTrackerNoASR = MetricsTracker


class SplitMetricsTracker:
    COLUMNS = [
        "snt_id",
        "one_snr", "one_snr_i", "one_si-snr", "one_si-snr_i",
        "two_snr", "two_snr_i", "two_si-snr", "two_si-snr_i",
    ]

    def __init__(self, save_file: str | Path, device=None):
        self.save_file = Path(save_file)
        self.device = resolve_device(device)
        self.rows: list[dict] = []
        self.pit_sisnr = PITLossWrapper(PairwiseNegSDR("sisdr"), threshold_byloss=False)
        self.pit_snr = PITLossWrapper(PairwiseNegSDR("snr"), threshold_byloss=False)

    def __call__(self, mix, clean, estimate, key: str) -> None:
        def up(a):
            return torch.as_tensor(np.atleast_2d(np.asarray(a, np.float32)), device=self.device)

        mix = up(np.asarray(mix, np.float32).reshape(-1))[0]
        clean, est = up(clean)[None], up(estimate)[None]
        with torch.no_grad():
            _, est_np = self.pit_snr(est, clean, return_ests=True)
            mixb = mix.expand(clean.shape[1:])[None]
            scores = []
            for pit in (self.pit_sisnr, self.pit_snr):
                scores += [pit(est_np[:, 0:2], clean[:, 0:2]), pit(est_np[:, 2:3], clean[:, 2:3]),
                           pit(mixb[:, 0:2], clean[:, 0:2]), pit(mixb[:, 2:3], clean[:, 2:3])]
            scores = torch.stack(scores).tolist()  # one read back for the row

        row = {"snt_id": key}
        for i, name in enumerate(("si-snr", "snr")):
            two, one, two_base, one_base = scores[4 * i:4 * i + 4]
            row[f"two_{name}"] = -two
            row[f"two_{name}_i"] = -(two - two_base)
            row[f"one_{name}"] = -one
            row[f"one_{name}_i"] = -(one - one_base)
        self.rows.append(row)

    def final(self) -> dict:
        self.save_file.parent.mkdir(parents=True, exist_ok=True)
        avg = {"snt_id": "avg"}
        for c in self.COLUMNS[1:]:
            vals = [r[c] for r in self.rows]
            avg[c] = float(np.mean(vals)) if vals else float("nan")
        with open(self.save_file, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.COLUMNS)
            writer.writeheader()
            for r in self.rows + [avg]:
                writer.writerow(r)
        return {c: avg[c] for c in self.COLUMNS[1:]}
