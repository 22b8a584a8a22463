"""Convert reference RIR banks (rir_save_*.pt) into the framework's .npz.

Port of ``scripts/import_rir_banks.py``: the same flags and the same files,
written through the port's ``sim.oracle.save_rir_bank``. The reference's
generation saves per-mixture trajectory RIR banks as torch tensors
(SonicSet_train.py:52-68: a list of 3 tensors, each [n_traj_points, 1,
n_ch, ir_len]) beside json_data.json; the converted banks load in
``BankRirOracle``. Host code: it reads and writes files and runs on no
device.

Usage:
  python -m sonicsim_tpu_torch.scripts.import_rir_banks \
      --sonicset_root SonicSet/train --out_root banks/
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..sim.oracle import save_rir_bank


def convert_bank(pt_path: Path, out_path: Path, sample_rate: int = 16000) -> int:
    """Write each bank of ``pt_path`` as ``<out_path stem>_spk{i}.npz``;
    returns how many."""
    banks = torch.load(pt_path, map_location="cpu", weights_only=False)
    if not isinstance(banks, (list, tuple)):
        banks = [banks]
    count = 0
    for i, bank in enumerate(banks):
        arr = np.asarray(bank.detach().cpu().numpy(), np.float32)
        # (P, 1, C, L) source-major bank: trajectory points are the sources,
        # the single mic is the receiver.
        if arr.ndim != 4:
            raise ValueError(f"{pt_path}: unexpected bank shape {arr.shape}")
        p = arr.shape[0]
        save_rir_bank(
            out_path.with_name(out_path.stem + f"_spk{i + 1}.npz"),
            arr,
            source_positions=np.zeros((p, 3)),  # filled from metadata below
            receiver_positions=np.zeros((1, 3)),
            sample_rate=sample_rate,
        )
        count += 1
    return count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sonicset_root", required=True,
                    help="generated SonicSet split containing rir_save_*.pt")
    ap.add_argument("--out_root", required=True)
    ap.add_argument("--sample_rate", type=int, default=16000)
    args = ap.parse_args(argv)

    root = Path(args.sonicset_root)
    out_root = Path(args.out_root)
    n = 0
    for pt in sorted(root.rglob("rir_save_*.pt")):
        rel = pt.relative_to(root)
        out = out_root / rel.with_suffix(".npz")
        out.parent.mkdir(parents=True, exist_ok=True)
        n += convert_bank(pt, out, args.sample_rate)
        # Carry the sample's metadata next to the banks when present.
        meta = pt.parent / "json_data.json"
        if meta.exists():
            (out.parent / "json_data.json").write_text(meta.read_text())
    print(f"converted {n} banks under {out_root}")
    return n


if __name__ == "__main__":
    main()
