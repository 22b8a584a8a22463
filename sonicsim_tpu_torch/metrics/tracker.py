"""MetricsTracker: per-segment eval accumulation → CSV with avg+std footer.

Port of ``sonicsim_tpu.metrics.tracker`` (reference separation/look2hear/
metrics/wrapper.py:28-199): PIT alignment on SNR, then per-source
SI-SDR(i), SDR(i) and STOI; the silent-reference skip; per-segment
isolation; ``final()`` appends the avg and std rows. The SDR math runs on
the tracker's ``device`` (the card unless given); STOI and the
``extra_metrics`` sidecars (PESQ) run in numpy on the host.
"""

from __future__ import annotations

import csv
import json
import logging
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..bridge import resolve_device
from ..losses.pit import find_best_perm, reorder_sources
from ..losses.sdr import pairwise_neg_sdr
from .sisdr import bss_sdr, si_sdr
from .stoi import stoi

logger = logging.getLogger(__name__)


class MetricsTracker:
    COLUMNS = ["snt_id", "sdr", "sdr_i", "si-snr", "si-snr_i", "stoi"]

    def __init__(
        self,
        save_file: str | Path,
        sample_rate: int = 16000,
        extra_metrics: dict[str, Callable] | None = None,
        extra_text: dict[str, Callable] | None = None,
        device=None,
    ):
        """extra_metrics: name -> fn(ref, est, sr) -> float (averaged rows).

        extra_text: name -> fn(est, sr) -> str, recorded verbatim per
        segment and left out of the avg/std footer (the reference's ASR
        transcript column, wrapper.py:113,125).
        """
        self.save_file = Path(save_file)
        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        self.extra = extra_metrics or {}
        self.extra_text = extra_text or {}
        self.rows: list[dict] = []
        self.skipped_silent = 0
        # Host seconds per column (the SDRs under "sdr"), summed over segments.
        self.seconds: dict[str, float] = {}
        self.columns = self.COLUMNS + sorted(self.extra) + sorted(self.extra_text)
        # Sidecar factories may name their implementation in ``backend``
        # (make_pesq: compiled ITU or the native approximation); recorded
        # beside the CSV so scores are comparable across machines.
        self.backends = {
            name: fn.backend
            for name, fn in {**self.extra, **self.extra_text}.items()
            if getattr(fn, "backend", None)
        }

    def _sdr_row(self, mix: np.ndarray, clean: np.ndarray,
                 estimate: np.ndarray) -> tuple[dict, np.ndarray]:
        """SI-SNR(i) and SDR(i) on the device, after PIT alignment on SNR
        (wrapper.py:62-66). Returns the row and the aligned estimate."""
        mix_t, clean_t, est_t = (torch.as_tensor(a, device=self.device)
                                 for a in (mix, clean, estimate))
        pw = pairwise_neg_sdr(est_t[None], clean_t[None], "snr")
        _, idx = find_best_perm(pw)
        est_t = reorder_sources(est_t[None], idx)[0]
        mixb = mix_t.expand(clean_t.shape)
        sisdr_v, sisdr_b = si_sdr(est_t, clean_t), si_sdr(mixb, clean_t)
        sdr_v, sdr_b = bss_sdr(est_t, clean_t), bss_sdr(mixb, clean_t)
        vals = torch.stack([sisdr_v.mean(), (sisdr_v - sisdr_b).mean(),
                            sdr_v.mean(), (sdr_v - sdr_b).mean()]).tolist()
        row = dict(zip(("si-snr", "si-snr_i", "sdr", "sdr_i"), vals))
        return row, est_t.cpu().numpy()

    def __call__(self, mix: np.ndarray, clean: np.ndarray, estimate: np.ndarray,
                 key: str) -> None:
        """mix (T,), clean (n_src, T), estimate (n_src, T)."""
        mix = np.asarray(mix, np.float32).reshape(-1)
        clean = np.atleast_2d(np.asarray(clean, np.float32))
        estimate = np.atleast_2d(np.asarray(estimate, np.float32))
        # Skip silent references (wrapper.py:25-26,66), and count them: a
        # corpus silent throughout otherwise shows only as an empty CSV.
        if bool(np.any(np.abs(clean).max(axis=-1) < 1e-6)):
            self.skipped_silent += 1
            logger.warning("segment %r skipped: silent reference source "
                           "(%d skipped so far)", key, self.skipped_silent)
            return
        try:
            with self._timed("sdr"):
                sdrs, est = self._sdr_row(mix, clean, estimate)
            row: dict = {"snt_id": key, **sdrs}
            with self._timed("stoi"):
                stoi_vals = [stoi(clean[i], est[i], self.sample_rate)
                             for i in range(len(clean))]
            stoi_vals = [v for v in stoi_vals if np.isfinite(v)]
            row["stoi"] = float(np.mean(stoi_vals)) if stoi_vals else float("nan")
            for name, fn in self.extra.items():
                try:
                    with self._timed(name):
                        row[name] = float(np.mean([fn(clean[i], est[i], self.sample_rate)
                                                   for i in range(len(clean))]))
                except Exception:
                    # The reference logs per-metric failures
                    # (wrapper.py:69-103): a quietly-NaN column would hide
                    # a sidecar broken throughout.
                    logger.warning("extra metric %r failed on segment %r", name, key,
                                   exc_info=True)
                    row[name] = float("nan")
            for name, fn in self.extra_text.items():
                try:
                    with self._timed(name):
                        row[name] = " | ".join(str(fn(est[i], self.sample_rate))
                                               for i in range(len(est)))
                except Exception:
                    logger.warning("text metric %r failed on segment %r", name, key,
                                   exc_info=True)
                    row[name] = ""
            self.rows.append(row)
        except Exception:
            # Per-segment isolation (wrapper.py:69-103).
            logger.warning("metrics failed on segment %r", key, exc_info=True)

    @contextmanager
    def _timed(self, name: str):
        """Add the block's host seconds to ``seconds[name]``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    def update(self) -> dict:
        """Running means (progress prints, wrapper.py:150-154)."""
        if not self.rows:
            return {}
        return {
            c: float(np.nanmean([r.get(c, np.nan) for r in self.rows]))
            for c in self.columns
            if c != "snt_id" and c not in self.extra_text
        }

    def final(self) -> dict:
        """Write the CSV with avg and std footer rows (wrapper.py:156-199)."""
        if self.skipped_silent:
            logger.warning("%d/%d segments skipped for silent references",
                           self.skipped_silent, self.skipped_silent + len(self.rows))
        self.save_file.parent.mkdir(parents=True, exist_ok=True)
        avg = {"snt_id": "avg"}
        std = {"snt_id": "std"}
        for c in self.columns:
            if c == "snt_id" or c in self.extra_text:
                continue
            vals = np.array([r.get(c, np.nan) for r in self.rows], np.float64)
            avg[c] = float(np.nanmean(vals)) if len(vals) else float("nan")
            std[c] = float(np.nanstd(vals)) if len(vals) else float("nan")
        with open(self.save_file, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.columns)
            writer.writeheader()
            for r in self.rows + [avg, std]:
                writer.writerow({c: r.get(c, "") for c in self.columns})
        if self.backends:
            self.save_file.with_suffix(".meta.json").write_text(
                json.dumps({"metric_backends": self.backends}, indent=2))
        return {c: avg[c] for c in self.columns
                if c != "snt_id" and c not in self.extra_text}
