"""Acoustic material definitions and mp3d material-config loading.

The reference maps Matterport3D semantic labels to frequency-dependent
absorption/scattering/transmission/damping curves via a habitat material
JSON (SonicSet/material/mp3d_material_config.json, applied at
SonicSim_rir.py:189-193,307). This module reads that JSON format — curves
are stored as INTERLEAVED [freq, value, freq, value, ...] pairs — and
resamples them onto the shoebox oracle's log-spaced band centers; a small
built-in table covers hermetic use.

The port's own copy of ``sonicsim_tpu/sim/materials.py`` (numpy only),
interleaved-pair guess of :func:`_curve_values` included;
tests/test_torch_sim_host.py pins it to the reference's output.

All four curve families drive synthesis (image_source.py):

* absorption — energy removed at each wall bounce;
* scattering — fraction of the REFLECTED energy diverted from the
  specular image path into the diffuse field (early/late re-balance);
* transmission — energy leaving the room through the wall (attenuates
  the reflection AND shortens the reverberant decay);
* damping — medium/HF loss, an extra per-band decay rate on the tail.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

CURVE_FAMILIES = ("absorption", "scattering", "transmission", "damping")


@dataclass
class Material:
    name: str
    absorption: list[float] = field(default_factory=lambda: [0.3])
    scattering: list[float] = field(default_factory=lambda: [0.1])
    transmission: list[float] = field(default_factory=lambda: [0.0])
    damping: list[float] = field(default_factory=lambda: [0.0])
    labels: list[str] = field(default_factory=list)
    # Optional per-family frequency axes (Hz), parallel to the value
    # lists above. Populated by load_material_config when the JSON
    # carries interleaved pairs; None means "values span the band range
    # uniformly" (the legacy plain-list convention).
    freqs: dict[str, list[float]] = field(default_factory=dict)

    def mean_absorption(self) -> float:
        return sum(self.absorption) / max(len(self.absorption), 1)

    def mean_scattering(self) -> float:
        return sum(self.scattering) / max(len(self.scattering), 1)

    def curve_at(self, family: str, freqs_hz: np.ndarray) -> np.ndarray:
        """Family curve sampled at ``freqs_hz`` (log-frequency interp,
        flat extrapolation — habitat clamps outside the tabulated range).
        Falls back to index-uniform interpolation when the material has
        no frequency axis for the family."""
        vals = np.asarray(getattr(self, family), np.float64)
        if vals.size == 0:
            return np.zeros(len(freqs_hz))
        if vals.size == 1:
            return np.full(len(freqs_hz), vals[0])
        fx = self.freqs.get(family)
        if fx is not None and len(fx) == len(vals):
            lf = np.log(np.maximum(np.asarray(fx, np.float64), 1e-3))
            return np.interp(
                np.log(np.maximum(freqs_hz, 1e-3)), lf, vals
            )
        x = np.linspace(0.0, 1.0, len(vals))
        xq = np.linspace(0.0, 1.0, len(freqs_hz))
        return np.interp(xq, x, vals)


# Generic broadband values for hermetic scenes (typical published ranges).
DEFAULT_MATERIALS = {
    "default": Material("default", [0.30], [0.10]),
    "carpet": Material("carpet", [0.45], [0.15], labels=["rug", "carpet", "floor"]),
    "concrete": Material("concrete", [0.05], [0.05], labels=["wall", "ceiling"]),
    "wood": Material("wood", [0.12], [0.10], labels=["door", "furniture", "table"]),
    "glass": Material("glass", [0.04], [0.02], [0.10], labels=["window", "mirror"]),
    "fabric": Material("fabric", [0.55], [0.20], [0.05], labels=["curtain", "sofa", "bed"]),
}


def _curve_values(entry) -> tuple[list[float], list[float] | None]:
    """Parse one curve entry → (values, freqs | None).

    Accepts habitat's three spellings: [{frequency, value}, ...] dicts,
    INTERLEAVED [freq, value, freq, value, ...] flat pairs (the actual
    mp3d_material_config.json format — e.g. Brick absorption
    [125, 0.02, 250, 0.02, ...]), or a plain list of values."""
    if not entry:
        return [], None
    if isinstance(entry[0], dict):
        return (
            [float(p.get("value", 0.0)) for p in entry],
            [float(p.get("frequency", 0.0)) for p in entry],
        )
    vals = [float(v) for v in entry]
    if len(vals) >= 4 and len(vals) % 2 == 0:
        maybe_f = vals[0::2]
        # Frequencies: positive, strictly increasing, spanning audio range.
        if (
            all(b > a for a, b in zip(maybe_f, maybe_f[1:]))
            and maybe_f[0] >= 10.0
            and maybe_f[-1] > 10.0 * maybe_f[0]
        ):
            return vals[1::2], maybe_f
    return vals, None


def load_material_config(path: str | Path) -> dict[str, Material]:
    """Parse a habitat/mp3d material config JSON into Material objects."""
    with open(path) as f:
        cfg = json.load(f)
    out: dict[str, Material] = {}
    for entry in cfg.get("materials", []):
        name = entry.get("name", f"material_{len(out)}")
        fams, freqs = {}, {}
        for fam, default in (
            ("absorption", [0.3]),
            ("scattering", [0.1]),
            ("transmission", [0.0]),
            ("damping", [0.0]),
        ):
            vals, fx = _curve_values(entry.get(fam, []))
            fams[fam] = vals or default
            if fx is not None:
                freqs[fam] = fx
        out[name] = Material(
            name=name,
            labels=list(entry.get("labels", [])),
            freqs=freqs,
            **fams,
        )
    return out


def material_for_label(
    label: str, materials: dict[str, Material] | None = None
) -> Material:
    materials = materials or DEFAULT_MATERIALS
    for mat in materials.values():
        if label in mat.labels or label == mat.name:
            return mat
    for mat in materials.values():  # case-insensitive fallback (mp3d names
        if label.lower() == mat.name.lower():  # are capitalized: "Brick")
            return mat
    return materials.get("default", Material("default"))


def room_mean_absorption(
    label_areas: dict[str, float], materials: dict[str, Material] | None = None
) -> float:
    """Area-weighted mean absorption for a room's surface composition.

    Coarsest reduction — collapses material diversity to one scalar. The
    shoebox oracle's faithful path is :func:`wall_curves_from_labels`,
    which keeps per-wall frequency curves (the reference applies materials
    per semantic surface, SonicSim_rir.py:189-193,307)."""
    total = sum(label_areas.values())
    if total <= 0:
        return 0.3
    acc = sum(
        material_for_label(lbl, materials).mean_absorption() * area
        for lbl, area in label_areas.items()
    )
    return acc / total


# Semantic aliases accepted by wall_absorption_from_labels, mapped onto the
# shoebox wall order shared with the native kernel and the bank renderer
# (image_source.WALLS: x0, xL, y0, yL, z0, zL; y up → y0 floor, yL ceiling).
WALL_ALIASES = {
    "x0": "x0", "xl": "xL", "y0": "y0", "yl": "yL", "z0": "z0", "zl": "zL",
    "floor": "y0", "ceiling": "yL",
    "west": "x0", "east": "xL", "north": "z0", "south": "zL",
}


def _resolve_wall_labels(
    wall_labels: dict[str, str] | list[str],
) -> list[str]:
    from .image_source import WALLS

    if isinstance(wall_labels, dict):
        resolved: dict[str, str] = {}
        fallback = None
        for key, label in wall_labels.items():
            alias = WALL_ALIASES.get(key.lower())
            if alias is not None:
                resolved[alias] = label
            elif key.lower() in ("walls", "default"):
                fallback = label
            else:
                raise ValueError(
                    f"unknown wall name {key!r}; use one of "
                    f"{sorted(set(WALL_ALIASES))} or 'walls'/'default'"
                )
        labels = [resolved.get(wname, fallback) for wname in WALLS]
        missing = [w for w, lbl in zip(WALLS, labels) if lbl is None]
        if missing:
            raise ValueError(
                f"walls {missing} have no material; add them or a "
                "'walls'/'default' entry"
            )
        return labels  # type: ignore[return-value]
    if len(wall_labels) != 6:
        raise ValueError(
            f"need 6 wall labels in WALLS order {WALLS}, got "
            f"{len(wall_labels)}"
        )
    return list(wall_labels)


def wall_absorption_from_labels(
    wall_labels: dict[str, str] | list[str],
    materials: dict[str, Material] | None = None,
) -> tuple[tuple[float, ...], ...]:
    """Per-wall absorption curves for ``ShoeboxRoom.wall_absorption_bands``.

    ``wall_labels`` is either a 6-list of material labels in WALLS order
    (x0, xL, y0, yL, z0, zL) or a dict keyed by wall name / alias
    (``floor``, ``ceiling``, ``north``/``south``/``east``/``west``, or the
    raw wall names) with a ``"walls"`` (or ``"default"``) entry covering
    the unnamed rest. Each label resolves through
    :func:`material_for_label` (so mp3d config labels and the built-in
    table both work) and keeps its FULL frequency curve — no banding
    collapse; the renderers resample to their band count.

    Absorption only — the full-physics constructor is
    :func:`wall_curves_from_labels`, which also carries scattering,
    transmission, and damping.
    """
    labels = _resolve_wall_labels(wall_labels)
    return tuple(
        tuple(material_for_label(lbl, materials).absorption) for lbl in labels
    )


def wall_curves_from_labels(
    wall_labels: dict[str, str] | list[str],
    materials: dict[str, Material] | None = None,
    n_bands: int = 32,
    sample_rate: int = 16000,
) -> dict[str, tuple[tuple[float, ...], ...]]:
    """ALL FOUR per-wall curve families, resampled onto the oracle's
    log-spaced band centers — the full counterpart of the reference's
    per-surface material assignment (mp3d_material_config.json curves,
    applied via setAudioMaterialsJSON at SonicSim_rir.py:189-193,307).

    Returns a dict with keys ``wall_absorption_bands``,
    ``wall_scattering_bands``, ``wall_transmission_bands``,
    ``wall_damping_bands``, each a 6-tuple of n_bands-tuples in WALLS
    order, ready to splat into :class:`ShoeboxRoom`::

        room = ShoeboxRoom(dims, **wall_curves_from_labels(
            {"floor": "carpet", "walls": "Brick", "ceiling": "concrete"},
            load_material_config(cfg_path)))
    """
    from .image_source import band_centers

    labels = _resolve_wall_labels(wall_labels)
    centers = band_centers(n_bands, sample_rate)
    out: dict[str, tuple[tuple[float, ...], ...]] = {}
    for fam in CURVE_FAMILIES:
        out[f"wall_{fam}_bands"] = tuple(
            tuple(
                float(v)
                for v in material_for_label(lbl, materials).curve_at(
                    fam, centers
                )
            )
            for lbl in labels
        )
    return out
