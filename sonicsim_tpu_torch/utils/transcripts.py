"""LibriSpeech transcript tooling (a copy of the JAX package's
``utils/transcripts.py``)."""

from __future__ import annotations

import csv
from pathlib import Path


def process_librispeech(librispeech_root: str | Path, out_csv: str | Path) -> int:
    """Walk LibriSpeech .trans.txt files → CSV (name, words)."""
    rows = []
    for txt in sorted(Path(librispeech_root).rglob("*.trans.txt")):
        with open(txt) as f:
            for line in f:
                parts = line.strip().split(" ", 1)
                if len(parts) == 2:
                    rows.append((parts[0] + ".flac", parts[1]))
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "words"])
        w.writerows(rows)
    return len(rows)


def load_transcripts(csv_path: str | Path) -> dict[str, str]:
    """CSV → {audio_name: words}. The lookup that ignores the extension
    (CSVs key '<id>.flac', WAV corpora place '<id>.wav') is the consumer's
    job: dataset/generate.py falls back from the name to its stem."""
    out: dict[str, str] = {}
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            out[row["name"]] = row["words"]
    return out
