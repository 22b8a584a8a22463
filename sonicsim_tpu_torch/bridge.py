"""State carried over from the JAX package: RIR banks, audio and plans.

The render has no learned parameters; its state is the RIR bank and the
host plan tables. ``load_rir_bank`` reads the JAX package's ``.npz`` bank
format (``sim/oracle.save_rir_bank``) without importing it, and
``to_torch`` turns numpy banks, audio and plans into tensors on a device
(the card unless the caller asks for the CPU), so both packages can be fed
the same state.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def load_rir_bank(path: str | Path) -> dict:
    """Read a bank ``.npz``: ``rirs (S, R, C, L)`` (float16 or float32 on
    disk, float32 here), ``source_positions (S, 3)``,
    ``receiver_positions (R, 3)``, ``sample_rate`` (an int here; 16000
    where the file has none, as in the reference's reader) and any extra
    metadata arrays, as numpy."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    if data["rirs"].dtype != np.float32:
        data["rirs"] = data["rirs"].astype(np.float32)
    data["sample_rate"] = int(data.get("sample_rate", 16000))
    return data


def resolve_device(device=None) -> torch.device:
    """The device to run on: the card unless the caller names another.

    Raises ``RuntimeError`` where the card is wanted (``None`` or a CUDA
    device) and CUDA is absent: the port never falls back to the CPU, which
    runs only when asked for by ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU; pass "
            "device='cpu' to run on the CPU"
        )
    return device


def to_torch(arrays, device=None):
    """Numeric numpy arrays (alone or in dicts, lists and tuples) → tensors
    on ``device`` (the card unless given, see :func:`resolve_device`) with
    their dtypes kept; tensors are moved, anything else (strings, scalars)
    is returned as it is."""
    device = resolve_device(device)
    if isinstance(arrays, np.ndarray) and arrays.dtype.kind in "biufc":
        return torch.from_numpy(np.ascontiguousarray(arrays)).to(device)
    if torch.is_tensor(arrays):
        return arrays.to(device)
    if isinstance(arrays, dict):
        return {k: to_torch(v, device) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(to_torch(v, device) for v in arrays)
    return arrays
