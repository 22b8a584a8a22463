"""Shoebox image-source RIR synthesis (the hermetic acoustic engine).

Port of ``sonicsim_tpu/sim/image_source.py``. The host part (rooms and
their material physics, the image lattice, edge diffraction, the band
filterbank) is the reference's numpy code, copied. The serial per-pair
renderers assemble their impulse trains and filter them in torch, on the
card unless the caller asks for the CPU.

The reference's JAX scatter of windowed-sinc taps becomes
:func:`place_taps`: the blocked weighted one-hot product that the batched
bank renderer uses (``bank_render``), which has no atomics, so a render is
bit-identical from run to run on the card. The reference's native C++
image-source library is not carried over: the serial multiband renderer
takes the reference's pure-numpy lattice path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..bridge import resolve_device
from . import prng
from .channels import ChannelModel

SPEED_OF_SOUND = 343.0
SINC_HALF = 40  # windowed-sinc fractional-delay taps: 2*SINC_HALF+1


# Wall index order shared by every per-wall consumer (the native kernel's
# contract, sonicsim_native.cpp image_sources): x0, xL, y0, yL, z0, zL.
# y is up, so y0 is the floor and yL the ceiling.
WALLS = ("x0", "xL", "y0", "yL", "z0", "zL")


@dataclass
class ShoeboxRoom:
    """Axis-aligned room [0,Lx]x[0,Ly]x[0,Lz] (y up).

    Every material family, most to least specific (most specific wins):

    * ``wall_<family>_bands`` — (6, n_curve) per-wall frequency curves in
      :data:`WALLS` order, the counterpart of the reference's per-surface
      material assignment (mp3d_material_config.json applied at
      SonicSim_rir.py:189-193,307); families are absorption, scattering,
      transmission, damping — the four curve sets the reference's material
      JSON carries and its tracer consumes (SonicSim_rir.py:176-187
      enables direct + indirect + diffraction + transmission);
    * ``absorption_bands`` — one absorption curve shared by all walls;
    * scalars ``absorption`` / ``scattering`` / ``transmission`` /
      ``damping`` — broadband fallbacks.

    Physics (see :meth:`wall_physics`): at each wall bounce the incident
    energy splits into absorbed ``α``, transmitted-through-the-wall ``τ``
    (attenuates the reflection and shortens the decay — it leaves the
    room but is not zeroed out of the energy budget), and reflected
    ``1−α−τ``; of the reflected part, fraction ``s`` (scattering) is
    diverted from the specular image path into the diffuse field.
    ``damping`` is a per-metre medium loss feeding the damped-Eyring
    decay. ``diffraction`` gates the 12-edge Maekawa/UTD-style term
    (the reference tracer enables diffraction, SonicSim_rir.py:179).
    """

    dims: tuple[float, float, float]
    absorption: float = 0.3
    scattering: float = 0.1  # diffuse split of reflected energy (USED)
    transmission: float = 0.0  # energy leaving through walls
    damping: float = 0.0  # medium loss, intensity rate per metre
    diffraction: bool = True  # edge-diffraction term (reference enables)
    absorption_bands: tuple[float, ...] | None = None
    wall_absorption_bands: tuple[tuple[float, ...], ...] | None = None
    wall_scattering_bands: tuple[tuple[float, ...], ...] | None = None
    wall_transmission_bands: tuple[tuple[float, ...], ...] | None = None
    wall_damping_bands: tuple[tuple[float, ...], ...] | None = None

    @staticmethod
    def _resample(curve, n_bands: int) -> np.ndarray:
        curve = np.asarray(curve, np.float64)
        x = np.linspace(0.0, 1.0, len(curve))
        xq = np.linspace(0.0, 1.0, n_bands)
        return np.interp(xq, x, curve)

    def _wall_bands_of(self, family: str, n_bands: int) -> np.ndarray:
        """Per-wall curves for one family → (n_bands, 6) in WALLS order."""
        table = getattr(self, f"wall_{family}_bands")
        if table is not None:
            if len(table) != 6:
                raise ValueError(
                    f"wall_{family}_bands needs 6 curves "
                    f"({', '.join(WALLS)}), got {len(table)}"
                )
            return np.stack(
                [self._resample(c, n_bands) for c in table], axis=1
            )
        if family == "absorption":
            return np.tile(self.band_absorption(n_bands)[:, None], (1, 6))
        return np.full((n_bands, 6), float(getattr(self, family)))

    def wall_band_absorption(self, n_bands: int) -> np.ndarray:
        """Per-wall absorption curves → (n_bands, 6) in WALLS order."""
        return self._wall_bands_of("absorption", n_bands)

    def band_absorption(self, n_bands: int) -> np.ndarray:
        """Area-weighted room-mean absorption curve (n_bands,) — the value
        scalar consumers (Sabine/Eyring RT60, tail calibration) use."""
        if self.wall_absorption_bands is not None:
            walls = self.wall_band_absorption(n_bands)  # (n_bands, 6)
            w = self.wall_areas()
            return walls @ (w / w.sum())
        if self.absorption_bands is None:
            return np.full(n_bands, self.absorption)
        return self._resample(self.absorption_bands, n_bands)

    @property
    def is_uniform(self) -> bool:
        """True when every wall shares one curve in EVERY family — the bank
        renderer's cheap hit-class factorization applies (bank_render)."""
        for family in ("absorption", "scattering", "transmission", "damping"):
            table = getattr(self, f"wall_{family}_bands")
            if table is None:
                continue
            first = np.asarray(table[0], np.float64)
            if not all(
                np.array_equal(first, np.asarray(c, np.float64))
                for c in table[1:]
            ):
                return False
        return True

    def wall_physics(
        self, n_bands: int, absorption_override: np.ndarray | None = None
    ) -> "WallPhysics":
        """Effective per-band reflection tables + damped-Eyring decay.

        The single source of truth consumed by BOTH renderers (serial
        :func:`render_shoebox_rir_multiband` and the batched bank path,
        bank_render._bank_params) so material physics stays bit-consistent
        across them. ``absorption_override`` — (n_bands,) or (n_bands, 6)
        — lets legacy callers that pass an explicit absorption table keep
        their numbers while the other three families come from the room.
        """
        if absorption_override is not None:
            a = np.asarray(absorption_override, np.float64)
            alpha = np.tile(a[:, None], (1, 6)) if a.ndim == 1 else a
            if alpha.shape != (n_bands, 6):
                raise ValueError(
                    f"absorption_override must be ({n_bands},) or "
                    f"({n_bands}, 6), got {a.shape}"
                )
        else:
            alpha = self._wall_bands_of("absorption", n_bands)
        scat = np.clip(self._wall_bands_of("scattering", n_bands), 0.0, 0.999)
        trans = np.clip(self._wall_bands_of("transmission", n_bands), 0.0, None)
        damp = np.clip(self._wall_bands_of("damping", n_bands), 0.0, None)
        # Energy split per bounce: absorbed α + transmitted τ leave the
        # reflection; the floor keeps β > 0 (attenuate, don't zero).
        refl = np.clip(1.0 - alpha - trans, 1e-4, 1.0)  # (B, 6)
        beta_total = np.sqrt(refl)
        beta_spec = np.sqrt(refl * (1.0 - scat))
        w = self.wall_areas()
        w = w / w.sum()
        alpha_eff = np.clip(alpha + trans, 0.0, 1.0 - 1e-4) @ w  # (B,)
        damp_mean = damp @ w  # intensity rate per metre, (B,)
        # Damped Eyring: RT60 = 0.161 V / (−S ln(1−ᾱ_eff) + 4 m V); the
        # 4 m V term is the classic air/medium absorption correction.
        denom = (
            -self.surface * np.log(np.maximum(1.0 - alpha_eff, 1e-4))
            + 4.0 * damp_mean * self.volume
        )
        rt60_bands = 0.161 * self.volume / np.maximum(denom, 1e-6)
        return WallPhysics(
            alpha=alpha,
            scattering=scat,
            transmission=trans,
            damping=damp,
            beta_spec=beta_spec,
            beta_total=beta_total,
            alpha_eff_mean=alpha_eff,
            damp_mean=damp_mean,
            rt60_bands=rt60_bands,
        )

    def wall_areas(self) -> np.ndarray:
        """(6,) wall areas in WALLS order."""
        lx, ly, lz = self.dims
        return np.array(
            [ly * lz, ly * lz, lx * lz, lx * lz, lx * ly, lx * ly]
        )

    @property
    def volume(self) -> float:
        lx, ly, lz = self.dims
        return lx * ly * lz

    @property
    def surface(self) -> float:
        lx, ly, lz = self.dims
        return 2.0 * (lx * ly + ly * lz + lx * lz)

    def mean_absorption(self) -> float:
        """Area-weighted broadband mean across walls."""
        if self.wall_absorption_bands is None:
            return self.absorption
        means = np.array(
            [float(np.mean(c)) for c in self.wall_absorption_bands]
        )
        w = self.wall_areas()
        return float(means @ (w / w.sum()))

    def rt60(self) -> float:
        """Sabine reverberation time (seconds), area-weighted EFFECTIVE
        absorption (absorption + transmission — both drain the field)."""
        a_eff = min(self.mean_absorption() + float(self.transmission), 0.999)
        return 0.161 * self.volume / max(self.surface * a_eff, 1e-6)


@dataclass(frozen=True)
class WallPhysics:
    """Per-band effective reflection tables (ShoeboxRoom.wall_physics).

    All (n_bands, 6) arrays are in :data:`WALLS` order; ``beta_spec`` is
    the SPECULAR amplitude per bounce sqrt((1−α−τ)·(1−s)), ``beta_total``
    the total-reflected amplitude sqrt(1−α−τ) (their energy gap is what
    scattering diverts into the diffuse tail), and ``rt60_bands`` the
    damped-Eyring decay 0.161V/(−S·ln(1−ᾱ_eff) + 4·m·V)."""

    alpha: np.ndarray  # (B, 6)
    scattering: np.ndarray  # (B, 6)
    transmission: np.ndarray  # (B, 6)
    damping: np.ndarray  # (B, 6)
    beta_spec: np.ndarray  # (B, 6)
    beta_total: np.ndarray  # (B, 6)
    alpha_eff_mean: np.ndarray  # (B,)
    damp_mean: np.ndarray  # (B,)
    rt60_bands: np.ndarray  # (B,)


def image_sources(
    room: ShoeboxRoom, source: np.ndarray, max_order: int
) -> tuple[np.ndarray, np.ndarray]:
    """All image positions and reflection counts up to ``max_order`` per axis.

    Returns (positions (N, 3), wall_hits (N,)).
    """
    dims = np.asarray(room.dims)
    src = np.asarray(source, np.float64)
    rng_n = np.arange(-max_order, max_order + 1)
    pos_axes, hits_axes = [], []
    for ax in range(3):
        n = rng_n[:, None]  # periodic index
        p = np.array([0, 1])[None, :]  # parity (mirrored or not)
        coord = (1 - 2 * p) * src[ax] + 2 * n * dims[ax]
        hits = np.abs(n - p) + np.abs(n)
        pos_axes.append(coord.reshape(-1))
        hits_axes.append(hits.reshape(-1))
    px, py, pz = np.meshgrid(pos_axes[0], pos_axes[1], pos_axes[2], indexing="ij")
    hx, hy, hz = np.meshgrid(hits_axes[0], hits_axes[1], hits_axes[2], indexing="ij")
    positions = np.stack([px.reshape(-1), py.reshape(-1), pz.reshape(-1)], axis=1)
    return positions, (hx + hy + hz).reshape(-1)


def image_sources_walls(
    room: ShoeboxRoom, source: np.ndarray, max_order: int
) -> tuple[np.ndarray, np.ndarray]:
    """Image positions and PER-WALL reflection counts (Allen & Berkley).

    Returns (positions (N, 3), wall_hits (N, 6)) in WALLS order — wall w0
    of an axis (the 0-coordinate plane) is hit |n - p| times and wall wL
    |n| times for lattice index (n, parity p). Same lattice ordering as
    :func:`image_sources` (summing the pairs reproduces its hit counts).
    """
    dims = np.asarray(room.dims)
    src = np.asarray(source, np.float64)
    rng_n = np.arange(-max_order, max_order + 1)
    pos_axes, h0_axes, hL_axes = [], [], []
    for ax in range(3):
        n = rng_n[:, None]
        p = np.array([0, 1])[None, :]
        coord = (1 - 2 * p) * src[ax] + 2 * n * dims[ax]
        pos_axes.append(coord.reshape(-1))
        h0_axes.append(np.broadcast_to(np.abs(n - p), coord.shape).reshape(-1))
        hL_axes.append(np.broadcast_to(np.abs(n), coord.shape).reshape(-1))
    px, py, pz = np.meshgrid(pos_axes[0], pos_axes[1], pos_axes[2], indexing="ij")
    positions = np.stack([px.reshape(-1), py.reshape(-1), pz.reshape(-1)], axis=1)
    k = len(pos_axes[0])
    grids = np.meshgrid(np.arange(k), np.arange(k), np.arange(k), indexing="ij")
    wall_hits = np.stack(
        [
            h0_axes[0][grids[0].reshape(-1)],
            hL_axes[0][grids[0].reshape(-1)],
            h0_axes[1][grids[1].reshape(-1)],
            hL_axes[1][grids[1].reshape(-1)],
            h0_axes[2][grids[2].reshape(-1)],
            hL_axes[2][grids[2].reshape(-1)],
        ],
        axis=1,
    )
    return positions, wall_hits


def edge_diffraction_paths(
    dims, source: np.ndarray, receiver: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Shortest src→edge→recv paths over the room's 12 edges.

    Returns (paths (12,) total path lengths, points (12, 3) the
    diffraction points). The room is convex so each edge path is a valid
    interior path; the minimizing point on edge {free axis f, other axes
    pinned} has the classic unfolded-reflection closed form
    t* = (s_f·√B + r_f·√A)/(√A+√B) with A/B the squared perpendicular
    distances of source/receiver to the edge line, clamped to [0, L_f].
    """
    dims = np.asarray(dims, np.float64)
    s = np.asarray(source, np.float64)
    r = np.asarray(receiver, np.float64)
    paths = np.empty(12)
    points = np.empty((12, 3))
    e = 0
    for f in range(3):
        a, b = [ax for ax in range(3) if ax != f]
        for wa in (0.0, dims[a]):
            for wb in (0.0, dims[b]):
                A = (s[a] - wa) ** 2 + (s[b] - wb) ** 2
                B = (r[a] - wa) ** 2 + (r[b] - wb) ** 2
                sa, sb = np.sqrt(A), np.sqrt(B)
                t = (s[f] * sb + r[f] * sa) / max(sa + sb, 1e-9)
                t = min(max(t, 0.0), dims[f])
                paths[e] = np.sqrt(A + (t - s[f]) ** 2) + np.sqrt(
                    B + (t - r[f]) ** 2
                )
                pt = np.empty(3)
                pt[f], pt[a], pt[b] = t, wa, wb
                points[e] = pt
                e += 1
    return paths, points


def diffraction_band_gain(detour: np.ndarray, freqs_hz: np.ndarray):
    """Maekawa-style edge-diffraction amplitude per band.

    Fresnel number N = 2·Δ/λ = 2·Δ·f/c for detour Δ (path − direct);
    Maekawa insertion loss 10·log10(3 + 20N) → amplitude (3+20N)^(−1/2).
    Low-frequency favoured, as edge diffraction is. Shapes broadcast:
    detour (..., 1) × freqs (B,) → (..., B)."""
    n_fresnel = 2.0 * detour * freqs_hz / SPEED_OF_SOUND
    return 1.0 / np.sqrt(3.0 + 20.0 * np.maximum(n_fresnel, 0.0))


def edge_diffraction_arrivals(
    room: "ShoeboxRoom",
    source: np.ndarray,
    receiver: np.ndarray,
    freqs_hz: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """12 edge arrivals for one (source, receiver) → (delays_s (12,),
    amps (12, B) BEFORE directional gain, dirs (12, 3) unit directions
    receiver→point for the channel gain model — same convention as the
    image list). The UTD-style counterpart of the reference tracer's
    enableDiffraction (SonicSim_rir.py:179)."""
    s = np.asarray(source, np.float64)
    r = np.asarray(receiver, np.float64)
    paths, points = edge_diffraction_paths(room.dims, s, r)
    direct = max(float(np.linalg.norm(s - r)), 1e-9)
    detour = np.maximum(paths - direct, 0.0)
    amps = diffraction_band_gain(detour[:, None], freqs_hz[None, :]) / (
        4.0 * np.pi * np.maximum(paths, 1e-9)[:, None]
    )
    diff = points - r[None, :]
    dist = np.maximum(np.linalg.norm(diff, axis=1, keepdims=True), 1e-9)
    return paths / SPEED_OF_SOUND, amps, diff / dist


DEFAULT_N_BANDS = 32  # reference acoustic config (SonicSim_rir.py:185)


def band_centers(n_bands: int, sample_rate: int) -> np.ndarray:
    """Log-spaced band centers 20 Hz → Nyquist (RLR-style 32 bands)."""
    return np.geomspace(20.0, sample_rate / 2.0, n_bands)


def band_masks(n_bands: int, nfft: int, sample_rate: int) -> np.ndarray:
    """(n_bands, nfft//2+1) triangular partition-of-unity over rfft bins."""
    freqs = np.fft.rfftfreq(nfft, 1.0 / sample_rate)
    centers = band_centers(n_bands, sample_rate)
    log_c = np.log(centers)
    log_f = np.log(np.maximum(freqs, 1e-3))
    masks = np.zeros((n_bands, len(freqs)))
    for b in range(n_bands):
        lo = log_c[b - 1] if b > 0 else -np.inf
        hi = log_c[b + 1] if b < n_bands - 1 else np.inf
        up = (log_f - lo) / max(log_c[b] - lo, 1e-9) if np.isfinite(lo) else np.ones_like(log_f)
        down = (hi - log_f) / max(hi - log_c[b], 1e-9) if np.isfinite(hi) else np.ones_like(log_f)
        masks[b] = np.clip(np.minimum(up, down), 0.0, 1.0)
    # Normalize to a partition of unity so flat spectra pass unchanged.
    total = masks.sum(axis=0)
    return (masks / np.maximum(total, 1e-9)).astype(np.float32)


def tail_noise(seed: int, channel_index, ir_len: int, device=None) -> torch.Tensor:
    """Unit-variance broadband tail noise (ir_len,) float32 for one (pair,
    channel): jax's ``normal(fold_in(PRNGKey(seed), channel), (ir_len,))``
    (see :mod:`.prng`). One stream feeds every band; the disjoint
    filterbank masks carve the per-band signals out of it."""
    k = prng.fold_in(prng.key(seed, device), channel_index)
    return prng.normal(k, ir_len)


# Time-block quantum of the tap placement: each image's taps are evaluated
# densely over the WIN = BLOCK + 128 columns of its block's window (the 81
# taps plus their spill into the next block).
BLOCK = 128
WIN = BLOCK + 128


def tap_grid(d: torch.Tensor):
    """Block coordinates of fractional-sample delays ``d`` (..., E) float32.

    Window column j of block b covers absolute sample b·BLOCK − 2·SINC_HALF
    + j. Returns (frac, blk, ioff_i, jm): the fractional part, the block of
    each delay, the exact int32 column of its integer part, and the exact
    integer tap grid jm = j − ioff (..., E, WIN), which is the tap index k
    at the delay's own 2·SINC_HALF + 1 taps."""
    base = torch.floor(d)
    frac = d - base
    base_i = base.to(torch.int32)
    blk = (base_i + SINC_HALF) // BLOCK
    # int32 keeps ioff exact (the float32 rounding of an offset near 1e3
    # differs from that of frac at d).
    ioff_i = base_i + 2 * SINC_HALF - blk * BLOCK
    j = torch.arange(WIN, dtype=torch.float32, device=d.device)
    jm = j - ioff_i.to(torch.float32)[..., None]
    return frac, blk, ioff_i, jm


def n_tap_blocks(ir_len: int) -> int:
    return -(-(ir_len + 2 * SINC_HALF + 2) // BLOCK)


def place_blocks(vals, blk, weights, ir_len: int) -> torch.Tensor:
    """Tap windows into impulse trains: (P, E, WIN) window values ``vals``
    in blocks ``blk`` (P, E), each row weighted by ``weights`` (P, E, Q)
    (None: one train, unit weights) → (P, Q, ir_len).

    One batched matrix product places every row: W[e, q·n_blocks + b] =
    weights[e, q]·[blk_e == b] against ``vals``. Rows whose block lies
    past the last one place nothing. Windows overlap by WIN − BLOCK =
    BLOCK columns, so the stitch is two shifted adds."""
    p, e, _ = vals.shape
    n_blocks = n_tap_blocks(ir_len)
    onehot = (
        blk[..., None] == torch.arange(n_blocks, device=blk.device)
    ).to(torch.float32)  # (P, E, n_blocks)
    if weights is None:
        w, q = onehot, 1
    else:
        q = weights.shape[-1]
        w = (weights[..., :, None] * onehot[..., None, :]).reshape(p, e, q * n_blocks)
    accw = torch.bmm(w.transpose(1, 2), vals).reshape(p, q, n_blocks, WIN)
    head = accw[..., :BLOCK].reshape(p, q, n_blocks * BLOCK)
    spill = accw[..., BLOCK:].reshape(p, q, n_blocks * BLOCK)
    acc = torch.nn.functional.pad(head, (0, BLOCK)) + torch.nn.functional.pad(
        spill, (BLOCK, 0)
    )
    return acc[..., 2 * SINC_HALF : 2 * SINC_HALF + ir_len]


def sinc_taps(frac, jm) -> torch.Tensor:
    """Hann-windowed sinc values at the tap grid ``jm`` (..., E, WIN),
    zero outside each delay's 2·SINC_HALF + 1 taps."""
    t = jm - frac[..., None]  # T − d
    window = 0.5 + 0.5 * torch.cos(math.pi * t / (SINC_HALF + 1))
    return torch.where(jm.abs() <= SINC_HALF, torch.sinc(t) * window, 0.0)


def place_taps(delays, weights, ir_len: int) -> torch.Tensor:
    """(P, E) fractional-sample delays and (P, E, Q) amplitudes → (P, Q,
    ir_len) impulse trains of windowed-sinc fractional delays. The
    reference's scatter (``_assemble_ir_1ch``), as a product."""
    frac, blk, _, jm = tap_grid(delays)
    return place_blocks(sinc_taps(frac, jm), blk, weights, ir_len)


def render_shoebox_rir_multiband(
    room: "ShoeboxRoom",
    source_position: np.ndarray,
    receiver_position: np.ndarray,
    channel: ChannelModel,
    band_absorption: np.ndarray | None = None,
    sample_rate: int = 16000,
    receiver_rotation: float = 90.0,
    max_order: int = 4,
    ir_seconds: float | None = None,
    seed: int = 0,
    n_bands: int = DEFAULT_N_BANDS,
    device=None,
) -> np.ndarray:
    """Frequency-dependent RIR → (C, L) float32 numpy: per-band image-source
    amplitudes (per-wall specular β, scattering's diffuse energy into the
    tail, damped-Eyring decay, 12-edge diffraction) assembled as band
    impulse trains and filtered through the log-triangular filterbank, plus
    per-band tails. Same physics and tail stream as the reference's
    renderer; see there for the model. ``band_absorption`` ((n_bands,) or
    (n_bands, 6)) overrides the room's absorption curves."""
    device = resolve_device(device)
    if band_absorption is not None:
        band_absorption = np.asarray(band_absorption, np.float64)
        n_bands = band_absorption.shape[0]
    phys = room.wall_physics(n_bands, absorption_override=band_absorption)
    rt60_bands = phys.rt60_bands
    if ir_seconds is None:
        ir_seconds = min(max(float(rt60_bands.max()) * 1.1, 0.25), 2.0)
    ir_len = int(ir_seconds * sample_rate)

    offsets = channel.receiver_offsets(receiver_rotation)
    recv = np.asarray(receiver_position, np.float64)[None, :] + offsets  # (C, 3)
    beta = phys.beta_spec  # (n_bands, 6) specular amplitude per bounce

    n_ch = channel.count
    out = np.zeros((n_ch, ir_len), np.float32)
    nfft = int(2 ** np.ceil(np.log2(ir_len + 2 * SINC_HALF + 2)))
    masks = torch.from_numpy(band_masks(n_bands, nfft, sample_rate)).to(device)
    centers = band_centers(n_bands, sample_rate)
    k_b = 6.908 / np.maximum(rt60_bands, 1e-6)  # (n_bands,)

    imgs_all, wall_hits_all = image_sources_walls(room, source_position, max_order)
    log_e_spec = np.log(np.maximum(phys.beta_spec**2, 1e-24))  # (B, 6)
    log_e_tot = np.log(np.maximum(phys.beta_total**2, 1e-24))
    log_beta = np.log(np.maximum(beta, 1e-12))  # (n_bands, 6)

    t_axis = np.arange(ir_len) / sample_rate

    for c_idx in range(n_ch):
        # Same validity window as the batched bank renderer: d ≤ c·ir_seconds
        # and d ≥ 1e-6.
        diff = imgs_all - recv[c_idx][None, :]
        dist = np.linalg.norm(diff, axis=1)
        keep = (dist / SPEED_OF_SOUND <= ir_seconds) & (dist >= 1e-6)
        delays = dist[keep] / SPEED_OF_SOUND
        dirs = diff[keep] / dist[keep, None]
        # amp[n, b] = prod_w beta[b, w]^hits[n, w] / (4 pi d_n)
        amps = np.exp(wall_hits_all[keep] @ log_beta.T) / (
            4.0 * np.pi * dist[keep]
        )[:, None]
        gains = channel.directional_gain(dirs, receiver_rotation)[:, c_idx]
        amps = amps * gains[:, None]  # (N, n_bands)

        # Per-band diffuse energy the specular train lost to scattering:
        # E_div[b] = Σ_n (g_n/(4πd_n))² · (∏β_total² − ∏β_spec²)^hits.
        geom2 = (gains / (4.0 * np.pi * dist[keep])) ** 2  # (N,)
        e_div = geom2 @ (
            np.exp(wall_hits_all[keep] @ log_e_tot.T)
            - np.exp(wall_hits_all[keep] @ log_e_spec.T)
        )  # (n_bands,)

        # Tail calibration on the specular train, before diffraction.
        t_direct = float(delays.min()) if len(delays) else 0.0
        mix_sel = (delays > t_direct + 0.03) & (delays < t_direct + 0.08)
        level = (
            np.sqrt(np.mean(amps[mix_sel] ** 2, axis=0))
            if mix_sel.any()
            else np.abs(amps).max(axis=0) * 0.05
        )
        level = np.sqrt(level**2 + 2.0 * k_b * e_div / sample_rate)

        if room.diffraction:
            d_delays, d_amps, d_dirs = edge_diffraction_arrivals(
                room, source_position, recv[c_idx], centers
            )
            keep_d = d_delays <= ir_seconds
            if keep_d.any():
                d_gains = channel.directional_gain(
                    d_dirs[keep_d], receiver_rotation
                )[:, c_idx]
                delays = np.concatenate([delays, d_delays[keep_d]])
                amps = np.concatenate([amps, d_amps[keep_d] * d_gains[:, None]])

        # Per-band impulse trains through the filterbank.
        trains = place_taps(
            torch.tensor(delays * sample_rate, dtype=torch.float32, device=device)[None],
            torch.tensor(amps, dtype=torch.float32, device=device)[None],
            ir_len,
        )[0]  # (n_bands, ir_len)
        spec = torch.fft.rfft(trains, nfft) * masks
        early = torch.fft.irfft(spec.sum(dim=0), nfft)[:ir_len]

        # Per-band damped-Eyring tails of one broadband stream.
        noise = tail_noise(seed, c_idx, ir_len, device)[None, :]
        decay = np.exp(
            -6.908 * np.maximum(t_axis[None, :] - t_direct, 0.0) / rt60_bands[:, None]
        )
        ramp = np.clip((t_axis - t_direct) / 0.02, 0.0, 1.0) ** 2
        env = torch.from_numpy(level[:, None] * decay * ramp[None, :]).to(device)
        shaped = (noise.double() * env).float()
        tail_spec = torch.fft.rfft(shaped, nfft) * masks
        tail = torch.fft.irfft(tail_spec.sum(dim=0), nfft)[:ir_len]
        out[c_idx] = (early + tail).cpu().numpy()
    return out


def render_shoebox_rir(
    room: ShoeboxRoom,
    source_position: np.ndarray,
    receiver_position: np.ndarray,
    channel: ChannelModel,
    sample_rate: int = 16000,
    receiver_rotation: float = 90.0,
    max_order: int = 4,
    ir_seconds: float | None = None,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """One (source, receiver) RIR → (C, L) float32 numpy: broadband
    image-source early reflections with per-channel directional gains, plus
    a decorrelated exponential tail (numpy's ``default_rng(seed)``, as in
    the reference) calibrated to the Sabine RT60 and the late image energy."""
    device = resolve_device(device)
    rt60 = max(room.rt60(), 0.05)
    if ir_seconds is None:
        ir_seconds = min(max(rt60 * 1.1, 0.25), 2.0)
    ir_len = int(ir_seconds * sample_rate)
    refl = max(1.0 - room.absorption - float(room.transmission), 1e-4)
    s_scat = min(max(float(room.scattering), 0.0), 0.999)
    beta_total = np.sqrt(refl)
    beta = np.sqrt(refl * (1.0 - s_scat))

    offsets = channel.receiver_offsets(receiver_rotation)  # (C, 3)
    recv = np.asarray(receiver_position, np.float64)[None, :] + offsets  # (C, 3)
    imgs, hits = image_sources(room, source_position, max_order)

    diff = imgs[:, None, :] - recv[None, :, :]
    dist = np.maximum(np.linalg.norm(diff, axis=2), 1e-3)
    dirs = diff / dist[..., None]
    gains = np.stack(
        [
            channel.directional_gain(dirs[:, c, :], receiver_rotation)[:, c]
            for c in range(channel.count)
        ],
        axis=1,
    )  # (N, C)
    amps = (beta**hits)[:, None] / (4.0 * np.pi * dist) * gains
    delays = dist / SPEED_OF_SOUND * sample_rate  # (N, C) float samples

    keep = delays.min(axis=1) < ir_len - 1
    delays, amps = delays[keep], amps[keep]
    if len(delays) == 0:  # degenerate: source too far for the window
        return np.zeros((channel.count, ir_len), np.float32)

    rng = np.random.default_rng(seed)
    t = np.arange(ir_len) / sample_rate
    t_direct = float(delays.min()) / sample_rate if len(delays) else 0.0
    decay = np.exp(-6.908 * np.maximum(t - t_direct, 0.0) / rt60)
    ramp = np.clip((t - t_direct) / max(0.02, 1e-6), 0.0, 1.0) ** 2
    mix_t = t_direct + 0.05
    near = (delays.mean(axis=1) / sample_rate > mix_t - 0.02) & (
        delays.mean(axis=1) / sample_rate < mix_t + 0.03
    )
    level = np.sqrt(np.mean(amps[near] ** 2)) if near.any() else np.abs(amps).max() * 0.05
    # Diffuse re-injection of the energy scattering diverted off the kept
    # specular images (per-channel mean geometry).
    e_div = float(
        np.mean(
            (amps / np.maximum(beta**hits[keep], 1e-12)[:, None]) ** 2
            * ((beta_total ** (2.0 * hits[keep]))[:, None]
               - (beta ** (2.0 * hits[keep]))[:, None])
        )
        * amps.shape[0]
    )
    level = float(np.sqrt(level**2 + 2.0 * (6.908 / rt60) * e_div / sample_rate))
    tail = (
        rng.standard_normal((channel.count, ir_len), dtype=np.float32)
        * (level * decay * ramp)[None, :].astype(np.float32)
    )

    early = place_taps(
        torch.tensor(delays.T, dtype=torch.float32, device=device),
        torch.tensor(amps.T, dtype=torch.float32, device=device)[..., None],
        ir_len,
    )[:, 0]
    return early.cpu().numpy() + tail
