"""Batched RIR-bank rendering: all (source, receiver, channel) items at once.

Port of ``sonicsim_tpu/sim/bank_render.py``, in plain PyTorch on one device
(the card unless the caller asks for the CPU). The reference's replacement
for the process-pool fan-out of ``render_rir_parallel`` (SonicSim_rir.py:
724-791), with the same formulation, kept for parity:

* the shoebox image lattice, the 12 diffraction edges and the directional
  gains are arithmetic on the device from the item positions;
* the per-image band amplitude ``amp[n, b] = g_n · ∏_w β[b, w]^hits[n, w]``
  splits into a per-item gain and an item-independent (N, bands) profile,
  factored on the host to rank r (exactly 1 for a uniform room);
* tap placement is the blocked weighted one-hot product of
  :func:`.image_source.place_blocks` (a batched matrix product, no
  atomics), so a bank is bit-identical from run to run;
* bands are restored in the frequency domain (one rfft per factor train),
  and the late tail is one threefry noise stream per item shaped by a
  rank-Q factored decay table, all through one shared irfft.

The products run in full float32: this module turns TF32 off around them
(:func:`_full_float32`), since TF32 keeps about three decimal digits and
the bank is held to the reference within 5e-5 of its peak.

Not carried over: the reference's padding of the item axis, its packed
transport of the item tables and its ``lower_only`` hook, which exist for
XLA and the TPU link; ``mesh=`` raises (ROADMAP A11).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..bridge import resolve_device
from . import prng
from .channels import ChannelModel
from .image_source import (
    SINC_HALF,
    SPEED_OF_SOUND,
    WIN,
    ShoeboxRoom,
    band_centers,
    band_masks,
    diffraction_band_gain,
    n_tap_blocks,
    place_blocks,
    place_taps,
    tap_grid,
)

# Budget of the dense per-chunk placement operands (tap windows and the
# weighted one-hot), in bytes: the item axis is cut into chunks only as far
# as this needs. The chip smoke's 240 binaural items of a uniform room
# (5,832 images each) fit in one chunk.
_PLACE_BYTES = 2 << 30


@contextmanager
def _full_float32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _real_sh(x, y, z, order: int) -> torch.Tensor:
    """Real spherical harmonics, ACN/SN3D, y-up, of unit-direction
    components → (..., (order+1)^2): the torch twin of
    ``channels.real_sh_matrix`` (unrolled recurrences, no Condon-Shortley
    phase)."""
    az = torch.atan2(-x, -z)
    s = torch.clamp(y, -1.0, 1.0)  # sin(elevation)
    c = torch.sqrt(torch.clamp(1.0 - s * s, min=0.0))
    P = {(0, 0): torch.ones_like(s)}
    for m in range(1, order + 1):
        P[(m, m)] = P[(m - 1, m - 1)] * float(2 * m - 1) * c
    for m in range(0, order):
        P[(m + 1, m)] = s * float(2 * m + 1) * P[(m, m)]
    for m in range(0, order + 1):
        for l in range(m + 2, order + 1):
            P[(l, m)] = (
                float(2 * l - 1) * s * P[(l - 1, m)]
                - float(l + m - 1) * P[(l - 2, m)]
            ) / float(l - m)
    cols = []
    for l in range(order + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt(
                (2.0 if m != 0 else 1.0)
                * math.factorial(l - am)
                / math.factorial(l + am)
            )
            leg = P[(l, am)]
            if m > 0:
                cols.append(norm * leg * torch.cos(am * az))
            elif m < 0:
                cols.append(norm * leg * torch.sin(am * az))
            else:
                cols.append(norm * leg)
    return torch.stack(cols, dim=-1)


def _lattice_wall_hits(max_order: int, device=None):
    """Per-axis reflection counts (h0, hL) of the image lattice, (K,) float32
    each with K = 2·(2·order+1), in ``_device_geometry``'s per-axis order:
    wall 0 of an axis is hit |n − p| times and wall L |n| times."""
    m = max_order
    n = torch.arange(-m, m + 1, dtype=torch.float32, device=device)[:, None]
    p = torch.arange(2, dtype=torch.float32, device=device)[None, :]
    h0 = torch.abs(n - p).expand(2 * m + 1, 2).reshape(-1)
    hL = torch.abs(n).expand(2 * m + 1, 2).reshape(-1)
    return h0, hL


def _amplitude_profile(beta_walls: torch.Tensor, max_order: int) -> torch.Tensor:
    """(N, n_bands) per-image per-band reflection product
    ∏_w β[b, w]^hits[n, w] of ``beta_walls`` (n_bands, 6) in WALLS order,
    as a separable exp of outer sums over the three axes."""
    h0, hL = _lattice_wall_hits(max_order, beta_walls.device)
    log_b = torch.log(torch.clamp(beta_walls, min=1e-12))  # (B, 6)
    ex = h0[:, None] * log_b[None, :, 0] + hL[:, None] * log_b[None, :, 1]
    ey = h0[:, None] * log_b[None, :, 2] + hL[:, None] * log_b[None, :, 3]
    ez = h0[:, None] * log_b[None, :, 4] + hL[:, None] * log_b[None, :, 5]
    k = h0.shape[0]
    amp = torch.exp(
        ex[:, None, None, :] + ey[None, :, None, :] + ez[None, None, :, :]
    )  # (K, K, K, B): the (i→x, j→y, k→z) order of _device_geometry
    return amp.reshape(k * k * k, -1)


def _amplitude_profile_np(beta_walls: np.ndarray, max_order: int) -> np.ndarray:
    """Host/numpy twin of :func:`_amplitude_profile` (same lattice order),
    for the host factorization below."""
    m = max_order
    n = np.arange(-m, m + 1, dtype=np.float64)[:, None]
    p = np.arange(2, dtype=np.float64)[None, :]
    h0 = np.broadcast_to(np.abs(n - p), (2 * m + 1, 2)).reshape(-1)
    hL = np.broadcast_to(np.abs(n), (2 * m + 1, 2)).reshape(-1)
    log_b = np.log(np.maximum(beta_walls, 1e-12))  # (B, 6)
    ex = h0[:, None] * log_b[None, :, 0] + hL[:, None] * log_b[None, :, 1]
    ey = h0[:, None] * log_b[None, :, 2] + hL[:, None] * log_b[None, :, 3]
    ez = h0[:, None] * log_b[None, :, 4] + hL[:, None] * log_b[None, :, 5]
    k = h0.shape[0]
    amp = np.exp(
        ex[:, None, None, :] + ey[None, :, None, :] + ez[None, None, :, :]
    )
    return amp.reshape(k * k * k, -1)


def _factor_amplitude_profile(
    beta_walls: np.ndarray, max_order: int, tol: float = 1e-7
) -> tuple[np.ndarray, np.ndarray]:
    """Rank-r factorization amp ≈ U @ V of the (N, n_bands) amplitude
    profile, on the host. r is exactly 1 for a uniform room (every band one
    β: identical columns); higher ranks pad to a multiple of 8, and a rank
    that saves nothing keeps the exact profile."""
    A = _amplitude_profile_np(beta_walls, max_order)
    n_bands = A.shape[1]
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    rank = max(1, int(np.sum(s > s[0] * tol)))
    r = 1 if rank == 1 else min(n_bands, -(-rank // 8) * 8)
    if r >= n_bands:  # no savings — keep the exact profile
        return A.astype(np.float32), np.eye(n_bands, dtype=np.float32)
    return (U[:, :r] * s[:r]).astype(np.float32), Vt[:r].astype(np.float32)


def _factor_tail_envelopes(
    rt60_bands: np.ndarray, ir_len: int, sample_rate: int,
    tol: float = 1e-8,
) -> tuple[np.ndarray, np.ndarray]:
    """Rank-Q factorization D ≈ U @ V of the per-band Eyring decay table
    D[b, t] = exp(−6.908·t/rt60_b), on the host. The shift by an item's
    direct delay factors exactly as exp(k_b·td)·exp(−k_b·t) under the ramp,
    so D is item-independent; Q is exactly 1 for a uniform room."""
    t_axis = np.arange(ir_len, dtype=np.float64) / sample_rate
    k_b = 6.908 / np.maximum(np.asarray(rt60_bands, np.float64), 1e-6)
    D = np.exp(-k_b[:, None] * t_axis[None, :])  # (B, L)
    U, s, Vt = np.linalg.svd(D, full_matrices=False)
    rank = max(1, int(np.sum(s > s[0] * tol)))
    q = 1 if rank == 1 else min(len(k_b), -(-rank // 4) * 4)
    return (U[:, :q] * s[:q]).astype(np.float32), Vt[:q].astype(np.float32)


_DIFF_RANK = 6  # diffraction-basis rank: ≤5e-4 abs curve error
_DIFF_GRID = 128  # log-detour interpolation grid size
_DIFF_DMIN, _DIFF_DMAX = 1e-4, 200.0  # detour range covered, metres


@lru_cache(maxsize=4)
def _diffraction_basis(n_bands: int, sample_rate: int):
    """Fixed rank-Q basis of the Maekawa edge-diffraction curve family
    (3 + 40·Δ·f/c)^(−1/2) over a log-Δ grid: numpy (coeffs (grid, Q), basis
    (Q, n_bands)); the device core interpolates coeffs at log Δ per edge."""
    freqs = band_centers(n_bands, sample_rate)
    dgrid = np.geomspace(_DIFF_DMIN, _DIFF_DMAX, _DIFF_GRID)
    D = diffraction_band_gain(dgrid[:, None], freqs[None, :])  # (grid, B)
    _, _, Vt = np.linalg.svd(D, full_matrices=False)
    basis = Vt[:_DIFF_RANK]  # (Q, B), orthonormal rows
    coeffs = D @ basis.T  # (grid, Q)
    return coeffs.astype(np.float32), basis.astype(np.float32)


def _device_edge_geometry(dims, srcs, recvs):
    """12-edge diffraction geometry of every item: (P, 3) srcs/recvs →
    (paths (P, 12) total path lengths, detours (P, 12), unit directions
    receiver→edge point (ux, uy, uz) each (P, 12)). The minimizing point on
    an edge has the unfolded-reflection closed form
    t* = (s_f·√B + r_f·√A)/(√A+√B), clamped to [0, L_f]."""
    paths, pts = [], []
    for f in range(3):
        a, b = [ax for ax in range(3) if ax != f]
        for wa_sel in (0, 1):
            for wb_sel in (0, 1):
                wa = dims[a] * wa_sel
                wb = dims[b] * wb_sel
                A = (srcs[:, a] - wa) ** 2 + (srcs[:, b] - wb) ** 2
                Bq = (recvs[:, a] - wa) ** 2 + (recvs[:, b] - wb) ** 2
                sa, sb = torch.sqrt(A), torch.sqrt(Bq)
                t = (srcs[:, f] * sb + recvs[:, f] * sa) / torch.clamp(
                    sa + sb, min=1e-9
                )
                t = torch.minimum(torch.clamp(t, min=0.0), dims[f])
                paths.append(
                    torch.sqrt(A + (t - srcs[:, f]) ** 2)
                    + torch.sqrt(Bq + (t - recvs[:, f]) ** 2)
                )
                pt = [None, None, None]
                pt[f] = t
                pt[a] = wa.expand(t.shape)
                pt[b] = wb.expand(t.shape)
                pts.append(torch.stack(pt, dim=1))  # (P, 3)
    paths = torch.stack(paths, dim=1)  # (P, 12)
    points = torch.stack(pts, dim=1)  # (P, 12, 3)
    direct = torch.linalg.vector_norm(srcs - recvs, dim=1, keepdim=True)
    detours = torch.clamp(paths - direct, min=0.0)
    diff = points - recvs[:, None, :]  # (P, 12, 3)
    dist = torch.clamp(torch.linalg.vector_norm(diff, dim=2), min=1e-9)
    ux, uy, uz = (diff[..., i] / dist for i in range(3))
    return paths, detours, (ux, uy, uz)


def _directional_gain(channel_type, channel_order, ux, uy, uz, normals,
                      chan_idx):
    """Per-arrival channel gain (P, N) of unit directions receiver→source
    image: unity (Mono, CustomArrayIR), the cardioid head shadow toward the
    ear normal (Binaural), or the item's real-SH column in the head frame
    (Ambisonics, whose ``normals`` row carries [cos, sin, 0] of the head
    rotation)."""
    if channel_type in ("Mono", "CustomArrayIR"):
        return torch.ones_like(ux)
    if channel_type == "Binaural":
        return 0.6 + 0.4 * (
            ux * normals[:, 0:1] + uy * normals[:, 1:2] + uz * normals[:, 2:3]
        )
    if channel_type == "Ambisonics":
        c_, s_ = normals[:, 0:1], normals[:, 1:2]
        lx = c_ * ux - s_ * uz
        lz = s_ * ux + c_ * uz
        Y = _real_sh(lx, uy, lz, channel_order)  # (P, N, C)
        idx = chan_idx[:, None, None].expand(Y.shape[0], Y.shape[1], 1)
        return torch.gather(Y, 2, idx)[..., 0]
    raise ValueError(f"unknown channel type {channel_type!r}")


def _device_geometry(dims, srcs, recvs, max_order: int, max_delay: float):
    """Image-source lattice of every item: ``srcs``/``recvs`` (P, 3) →
    delays_s (P, N), hits (P, N) int32, unit direction components (ux, uy,
    uz) each (P, N), valid (P, N), with N = (2·(2·max_order+1))³: the
    lattice of ``image_source.image_sources``. Distances are a separable
    outer sum of per-axis squared offsets."""
    m = max_order
    n = torch.arange(-m, m + 1, dtype=torch.float32, device=srcs.device)
    p = torch.arange(2, dtype=torch.float32, device=srcs.device)
    coeff = (1.0 - 2.0 * p)[None, :]  # (1, 2)
    dcomp, hits_axis = [], []
    for ax in range(3):
        coord = (
            coeff[None] * srcs[:, ax, None, None]
            + (2.0 * n[:, None] * dims[ax])[None]
        )  # (P, 2m+1, 2)
        hits = torch.abs(n[:, None] - p[None, :]) + torch.abs(n[:, None])
        dcomp.append(coord.reshape(srcs.shape[0], -1) - recvs[:, ax, None])
        hits_axis.append(hits.reshape(-1))
    K = 2 * (2 * m + 1)
    P_items = srcs.shape[0]
    dx, dy, dz = dcomp
    d2 = (
        (dx * dx)[:, :, None, None]
        + (dy * dy)[:, None, :, None]
        + (dz * dz)[:, None, None, :]
    ).reshape(P_items, K * K * K)
    dist = torch.sqrt(d2)
    hits = (
        hits_axis[0][:, None, None]
        + hits_axis[1][None, :, None]
        + hits_axis[2][None, None, :]
    ).reshape(-1)  # (N,)
    valid = (dist / SPEED_OF_SOUND <= max_delay) & (dist >= 1e-6)
    delays_s = dist / SPEED_OF_SOUND
    inv = 1.0 / torch.clamp(dist, min=1e-9)
    shape = (P_items, K, K, K)
    ux = dx[:, :, None, None].expand(shape).reshape(d2.shape) * inv
    uy = dy[:, None, :, None].expand(shape).reshape(d2.shape) * inv
    uz = dz[:, None, None, :].expand(shape).reshape(d2.shape) * inv
    hits_i = hits.to(torch.int32)[None].expand(P_items, hits.shape[0])
    return delays_s, hits_i, (ux, uy, uz), valid


def _lattice_taps(delays_s, g, sample_rate: int) -> tuple:
    """Windowed-sinc tap windows (P, N, WIN) of every image, scaled by its
    gain ``g``, and their blocks (P, N).

    The sine and the Hann cosine factor into per-row and per-column terms
    by angle addition (sin πt = −(−1)^(j−ioff)·sin π·frac, and cos πt/S1 =
    cos a_j·cos b_n + sin a_j·sin b_n), so each element costs one divide
    and a few products. t is built as (j − ioff) − frac from the exact
    integer grid, so inside the taps it takes the serial renderer's values."""
    d = delays_s * sample_rate
    frac, blk, ioff_i, jm = tap_grid(d)
    t = jm - frac[..., None]  # T − d
    s1 = float(SINC_HALF + 1)
    j = torch.arange(WIN, dtype=torch.float32, device=d.device)
    sin_off = torch.where(ioff_i % 2 == 0, 1.0, -1.0) * torch.sin(math.pi * frac)
    sign_j = torch.where(j % 2.0 == 0, 1.0, -1.0)
    sinc_t = torch.where(
        torch.abs(t) < 1e-6, 1.0, (-sign_j * sin_off[..., None]) / (math.pi * t)
    )
    a = math.pi * (j % (2.0 * s1)) / s1
    # off mod 2·S1 from the exact integer part keeps large-magnitude
    # rounding out of the Hann.
    b = math.pi * ((ioff_i % int(2 * s1)).to(torch.float32) + frac) / s1
    window = 0.5 + 0.5 * (
        torch.cos(a) * torch.cos(b)[..., None]
        + torch.sin(a) * torch.sin(b)[..., None]
    )
    vals = torch.where(torch.abs(jm) <= SINC_HALF, sinc_t * window, 0.0)
    return vals * g[..., None], blk


def _place_lattice(delays_s, g, amp_u, sample_rate: int, ir_len: int):
    """Every image of every item into r factor trains (P, r, ir_len).

    r == 1 (uniform room): the factor column is already folded into ``g``
    and the product is a plain one-hot block placement. r > 1: each image
    is weighted by its row of ``amp_u`` (N, r). The item axis is cut into
    chunks only as far as :data:`_PLACE_BYTES` needs."""
    p, n = delays_s.shape
    r = amp_u.shape[1]
    w_cols = (r if r > 1 else 1) * n_tap_blocks(ir_len)
    chunk = max(1, _PLACE_BYTES // (4 * n * (WIN + w_cols)))
    outs = []
    for i in range(0, p, chunk):
        vals, blk = _lattice_taps(delays_s[i:i + chunk], g[i:i + chunk], sample_rate)
        weights = None if r == 1 else amp_u.expand(vals.shape[0], n, r)
        outs.append(place_blocks(vals, blk, weights, ir_len))
    return torch.cat(outs)


def _assemble_core(
    delays_s,  # (P, N) float32 seconds
    g,  # (P, N) float32 directional_gain / (4 pi d), 0 where invalid
    valid,  # (P, N) bool
    amp_nb,  # (N, n_bands) per-image per-band specular reflection product
    delta_nb,  # (N, n_bands) per-image energy gap total − specular
    amp_u,  # (N, r) left factor of amp_nb ≈ amp_u @ amp_v
    amp_v,  # (r, n_bands) right factor
    noise_keys,  # (P, 2) threefry keys of the items' tail noise
    masks,  # (n_bands, nfft//2+1) float32 filterbank partition
    rt60_bands,  # (n_bands,) float32 damped-Eyring RT60 per band
    tail_u,  # (n_bands, q) left factor of the Eyring decay table
    tail_v,  # (q, ir_len) right factor
    sample_rate: int,
    ir_len: int,
    nfft: int,
    edge_delays_s=None,  # (P, 12) edge-diffraction arrival times, or None
    edge_w=None,  # (P, 12, Q) per-edge loadings in the diffraction basis
    diff_v=None,  # (Q, n_bands) diffraction band basis
):
    """(P items) → (P, ir_len) float32 RIRs, un-normalised.

    Early part: every image into r factor trains (plus Q diffraction
    trains), and the band structure restored in the frequency domain:
    early_spec = Σ_q rfft(train_q)·(V @ masks)_q. Tail: one noise stream
    per item, ramped, shaped by the rank-Q decay factors and the per-band
    levels matched to the mixing-zone image energy plus scattering's
    diffuse energy. One irfft for both."""
    r_amp = amp_u.shape[1]
    g_place = g * amp_u[:, 0][None, :] if r_amp == 1 else g
    accs = _place_lattice(delays_s, g_place, amp_u, sample_rate, ir_len)
    v_all = amp_v
    if edge_delays_s is not None:
        edges = place_taps(edge_delays_s * sample_rate, edge_w, ir_len)
        accs = torch.cat([accs, edges], dim=1)
        v_all = torch.cat([amp_v, diff_v], dim=0)
    spec = torch.fft.rfft(accs, nfft)  # (P, r [+Q], F)
    vmask = v_all @ masks  # (r [+Q], F)
    early_spec = (spec * vmask).sum(dim=1)  # (P, F)

    big = 1e30
    t_direct = torch.where(valid, delays_s, big).amin(dim=1)
    t_direct = torch.where(valid.any(dim=1), t_direct, 0.0)  # (P,)
    mix_sel = (
        valid
        & (delays_s > t_direct[:, None] + 0.03)
        & (delays_s < t_direct[:, None] + 0.08)
    )
    # level_sel[p, b] = sqrt(mean over the mixing zone of (g·amp)²)
    sel_sum = torch.where(mix_sel, g * g, 0.0) @ (amp_nb * amp_nb)
    k = mix_sel.sum(dim=1)  # (P,)
    level_sel = torch.sqrt(sel_sum / torch.clamp(k, min=1)[:, None])
    # Fallback when the mixing zone is empty: 0.05·max_n |g·amp| per band.
    level_fb = 0.05 * torch.where(
        valid[:, :, None], torch.abs(g)[:, :, None] * amp_nb[None], 0.0
    ).amax(dim=1)  # (P, n_bands)
    level = torch.where((k > 0)[:, None], level_sel, level_fb)
    # Scattering's diffuse energy E_div[p, b] = Σ_n g²·(total − specular)
    # returns through the tail: level² + 2·k_b·E_div/sr.
    div_sum = torch.where(valid, g * g, 0.0) @ delta_nb
    k_b = 6.908 / torch.clamp(rt60_bands, min=1e-6)  # (B,)
    level = torch.sqrt(level * level + 2.0 * k_b[None, :] * div_sum / sample_rate)

    # tail_spec = Σ_q rfft(noise·ramp·tail_v_q) · M_q with
    # M_pq(f) = Σ_b masks[b, f]·level_pb·exp(k_b·td_p)·tail_u[b, q].
    t_axis = torch.arange(ir_len, dtype=torch.float32, device=g.device) / sample_rate
    lift = torch.exp(k_b[None, :] * t_direct[:, None])  # (P, B)
    noise = prng.normal(noise_keys, ir_len)  # (P, ir_len)
    ramp = torch.clamp((t_axis[None, :] - t_direct[:, None]) / 0.02, 0.0, 1.0) ** 2
    sig = noise * ramp
    S = torch.fft.rfft(sig[:, None, :] * tail_v[None, :, :], nfft)  # (P, Q, F)
    cu = (level * lift)[:, :, None] * tail_u[None, :, :]  # (P, B, Q)
    M = cu.transpose(1, 2) @ masks  # (P, Q, F)
    tail_spec = (S * M).sum(dim=1)  # (P, F)
    return torch.fft.irfft(early_spec + tail_spec, nfft)[:, :ir_len]


@dataclass(frozen=True)
class _RoomTables:
    """Per-room host tables of one oracle: the IR length, the FFT size and
    the numpy constants the device core reads."""

    ir_seconds: float
    ir_len: int
    nfft: int
    dims: np.ndarray  # (3,)
    beta_spec: np.ndarray  # (n_bands, 6) specular amplitude per bounce
    beta_total: np.ndarray  # (n_bands, 6) total-reflected amplitude
    rt60_bands: np.ndarray  # (n_bands,)
    amp_u: np.ndarray
    amp_v: np.ndarray
    tail_u: np.ndarray
    tail_v: np.ndarray
    masks: np.ndarray  # (n_bands, nfft//2+1)


def _bank_params(oracle) -> _RoomTables:
    """The room's tables, from ``ShoeboxRoom.wall_physics`` as the serial
    renderer reads them: specular β sqrt((1−α−τ)(1−s)), total β
    sqrt(1−α−τ) and the damped-Eyring RT60 per band, with the host
    factorizations of the amplitude profile and the decay table."""
    room: ShoeboxRoom = oracle.room
    n_bands = oracle.n_bands
    phys = room.wall_physics(n_bands)
    rt60_bands = np.asarray(phys.rt60_bands, np.float32)
    ir_seconds = oracle.ir_seconds
    if ir_seconds is None:
        ir_seconds = min(max(float(phys.rt60_bands.max()) * 1.1, 0.25), 2.0)
    ir_len = int(ir_seconds * oracle.sample_rate)
    nfft = int(2 ** np.ceil(np.log2(ir_len + 2 * SINC_HALF + 2)))
    beta_spec = np.asarray(phys.beta_spec, np.float32)
    amp_u, amp_v = _cached_amp_factors(beta_spec.tobytes(), n_bands, oracle.max_order)
    tail_u, tail_v = _cached_tail_factors(rt60_bands.tobytes(), ir_len, oracle.sample_rate)
    return _RoomTables(
        ir_seconds=float(ir_seconds), ir_len=ir_len, nfft=nfft,
        dims=np.asarray(room.dims, np.float32), beta_spec=beta_spec,
        beta_total=np.asarray(phys.beta_total, np.float32),
        rt60_bands=rt60_bands, amp_u=amp_u, amp_v=amp_v, tail_u=tail_u,
        tail_v=tail_v, masks=_cached_masks(n_bands, nfft, oracle.sample_rate),
    )


@lru_cache(maxsize=32)
def _cached_amp_factors(beta_bytes: bytes, n_bands: int, max_order: int):
    """Per-room amplitude-profile factorization, cached by the β table."""
    beta = np.frombuffer(beta_bytes, np.float32).reshape(n_bands, 6)
    return _factor_amplitude_profile(beta.astype(np.float64), max_order)


@lru_cache(maxsize=32)
def _cached_tail_factors(rt60_bytes: bytes, ir_len: int, sample_rate: int):
    """Per-room tail-envelope factorization, cached by the RT60 table."""
    rt60 = np.frombuffer(rt60_bytes, np.float32)
    return _factor_tail_envelopes(rt60, ir_len, sample_rate)


@lru_cache(maxsize=8)
def _cached_masks(n_bands: int, nfft: int, sample_rate: int) -> np.ndarray:
    return band_masks(n_bands, nfft, sample_rate)


def _render_core(items: dict, room: _RoomTables, *, n_bands: int,
                 channel_type: str, channel_order: int, max_order: int,
                 sample_rate: int, diffraction: bool = True) -> torch.Tensor:
    """Geometry → gains → assembly of the items (tensors ``srcs``, ``recvs``,
    ``normals`` (P, 3) float32, ``chan_idx`` and ``seeds`` (P,) int64 on one
    device) → (P, ir_len) un-normalised RIRs."""
    srcs, recvs, normals = items["srcs"], items["recvs"], items["normals"]
    chan_idx = items["chan_idx"]
    device = srcs.device

    def dev(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    dims = dev(room.dims)
    max_delay = room.ir_seconds
    delays_s, _hits, (ux, uy, uz), valid = _device_geometry(
        dims, srcs, recvs, max_order, max_delay
    )
    amp_nb = _amplitude_profile(dev(room.beta_spec), max_order)  # (N, B)
    amp_tot = _amplitude_profile(dev(room.beta_total), max_order)
    delta_nb = amp_tot * amp_tot - amp_nb * amp_nb  # (N, B)
    gain = _directional_gain(
        channel_type, channel_order, ux, uy, uz, normals, chan_idx
    )
    g = torch.where(
        valid, gain / (4.0 * math.pi * delays_s * SPEED_OF_SOUND + 1e-30), 0.0
    )

    edge_delays_s = edge_w = diff_v = None
    if diffraction:
        # 12-edge Maekawa/UTD arrivals: per-edge band curves in the fixed
        # rank-Q basis, loaded by the log-detour-interpolated coefficient
        # times the geometric gain.
        diff_c, diff_v = (dev(a) for a in _diffraction_basis(n_bands, sample_rate))
        paths, detours, (eux, euy, euz) = _device_edge_geometry(dims, srcs, recvs)
        e_gain = _directional_gain(
            channel_type, channel_order, eux, euy, euz, normals, chan_idx
        )
        e_valid = paths / SPEED_OF_SOUND <= max_delay
        e_g = torch.where(e_valid, e_gain / (4.0 * math.pi * paths + 1e-30), 0.0)
        lo, hi = float(np.log(_DIFF_DMIN)), float(np.log(_DIFF_DMAX))
        pos = (
            (torch.log(torch.clamp(detours, min=_DIFF_DMIN)) - lo)
            / (hi - lo)
            * (_DIFF_GRID - 1)
        )
        pos = torch.clamp(pos, 0.0, _DIFF_GRID - 1)
        i0 = torch.floor(pos).to(torch.int64)
        frac = (pos - i0.to(torch.float32))[..., None]  # (P, 12, 1)
        c0 = diff_c[i0]  # (P, 12, Q)
        c1 = diff_c[torch.clamp(i0 + 1, max=_DIFF_GRID - 1)]
        edge_w = (c0 * (1.0 - frac) + c1 * frac) * e_g[..., None]
        edge_delays_s = paths / SPEED_OF_SOUND

    noise_keys = prng.fold_in(prng.key(items["seeds"]), chan_idx)
    return _assemble_core(
        delays_s, g, valid, amp_nb, delta_nb, dev(room.amp_u), dev(room.amp_v),
        noise_keys, dev(room.masks), dev(room.rt60_bands), dev(room.tail_u),
        dev(room.tail_v), sample_rate, room.ir_len, room.nfft,
        edge_delays_s=edge_delays_s, edge_w=edge_w, diff_v=diff_v,
    )


def _flatten_items(oracle, source_positions, receiver_positions, channel,
                   rotations):
    """Host item tables: per-(s, r, c) source/receiver/normal rows, channel
    indices and tail-noise seeds (numpy)."""
    n_src, n_recv, n_ch = (
        len(source_positions),
        len(receiver_positions),
        channel.count,
    )
    offs_r = np.stack(
        [channel.receiver_offsets(rot) for rot in rotations[:n_recv]]
    )  # (R, C, 3)
    if channel.channel_type == "Ambisonics":
        # SH offsets are all zero, so the normals slot carries the
        # per-receiver head rotation as [cos, sin, 0].
        rot = np.radians(np.asarray(rotations[:n_recv], np.float64))
        norms_r = np.broadcast_to(
            np.stack(
                [np.cos(rot), np.sin(rot), np.zeros_like(rot)], axis=1
            )[:, None, :],
            (n_recv, n_ch, 3),
        )
    else:
        norms_r = offs_r / np.maximum(
            np.linalg.norm(offs_r, axis=2, keepdims=True), 1e-9
        )
    recv_arr = np.asarray(receiver_positions, np.float64)  # (R, 3)
    src_arr = np.asarray(source_positions, np.float64)  # (S, 3)
    rc = (recv_arr[:, None, :] + offs_r).reshape(n_recv * n_ch, 3)
    srcs_flat = np.repeat(src_arr, n_recv * n_ch, axis=0)
    recvs_flat = np.tile(rc, (n_src, 1))
    normals = np.tile(norms_r.reshape(n_recv * n_ch, 3), (n_src, 1))
    chan_idx = np.tile(np.arange(n_ch, dtype=np.int32), n_src * n_recv)

    # Tail-noise seeds: the (pair seed, channel) streams of
    # SyntheticRirOracle.render. Python's hash() of the rounded pair tuple
    # (float tuples are not salted) with the oracle seed, in uint32.
    seeds_sr = np.empty((n_src, n_recv), np.int64)
    src_round = np.round(src_arr, 4)
    recv_round = np.round(recv_arr, 4)
    for s in range(n_src):
        s_part = tuple(src_round[s].tolist())
        for r in range(n_recv):
            pair = s_part + tuple(recv_round[r].tolist())
            seeds_sr[s, r] = int(
                np.uint32(oracle.seed)
                + np.uint32(abs(hash(pair)) % (2**31))
            )
    seeds = np.repeat(seeds_sr.reshape(-1), n_ch)
    return (
        srcs_flat.astype(np.float32),
        recvs_flat.astype(np.float32),
        normals.astype(np.float32),
        chan_idx,
        seeds,
    )


def _render_flat_items(oracle, flat, channel, room: _RoomTables,
                       peak_normalize: bool, bank_sizes: list[int],
                       device) -> torch.Tensor:
    """Upload the item tables, render, and peak-normalise each bank (the
    contiguous runs of ``bank_sizes`` items) by its own max |x|."""
    srcs, recvs, normals, chan_idx, seeds = flat
    items = {
        "srcs": torch.tensor(srcs, device=device),
        "recvs": torch.tensor(recvs, device=device),
        "normals": torch.tensor(normals, device=device),
        "chan_idx": torch.tensor(chan_idx, dtype=torch.int64, device=device),
        "seeds": torch.tensor(seeds, dtype=torch.int64, device=device),
    }
    with _full_float32():
        out = _render_core(
            items, room,
            n_bands=oracle.n_bands,
            channel_type=channel.channel_type,
            channel_order=channel.channel_order,
            max_order=oracle.max_order,
            sample_rate=oracle.sample_rate,
            diffraction=bool(getattr(oracle.room, "diffraction", True)),
        )
    if peak_normalize:
        item_peak = torch.abs(out).amax(dim=1)
        peak = torch.stack([x.max() for x in item_peak.split(bank_sizes)])
        peak = torch.where(peak > 0, peak, 1.0)
        sizes = torch.tensor(bank_sizes, device=device)
        out = out / peak.repeat_interleave(sizes)[:, None]
    return out


def _device(oracle, mesh) -> torch.device:
    """Where a bank renders: the oracle's ``device`` (the card unless it
    names another). ``mesh=`` is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded bank rendering is not ported yet (ROADMAP A11); call "
            "without mesh"
        )
    return resolve_device(oracle.device)


def render_bank_batched(
    oracle,
    source_positions: list[np.ndarray],
    receiver_positions: list[np.ndarray],
    channel: ChannelModel,
    receiver_rotations: list[float] | None = None,
    peak_normalize: bool = True,
    out_device: bool = False,
    mesh=None,
):
    """All-pairs bank (S, R, C, L) through the batched multiband renderer:
    the serial loop over ``SyntheticRirOracle.render`` (multiband), with
    the same lattice and the same per-pair tail streams. Runs on the
    oracle's ``device`` (the card unless it names another); with
    ``out_device=True`` the bank is returned as a tensor there, else as
    numpy."""
    return render_rir_banks(oracle, [source_positions], receiver_positions,
                            channel, receiver_rotations, peak_normalize,
                            out_device, mesh)[0]


def render_rir_banks(
    oracle,
    source_lists: list[list[np.ndarray]],
    receiver_positions: list[np.ndarray],
    channel: ChannelModel,
    receiver_rotations: list[float] | None = None,
    peak_normalize: bool = True,
    out_device: bool = False,
    mesh=None,
) -> list:
    """Several banks (e.g. one per speaker trajectory) in one render, each
    peak-normalised on its own. Returns one (S_k, R, C, L) array per entry
    of ``source_lists`` (tensors on the oracle's ``device`` with
    ``out_device=True``)."""
    device = _device(oracle, mesh)
    rotations = receiver_rotations or [90.0] * len(receiver_positions)
    room = _bank_params(oracle)
    parts = [
        _flatten_items(oracle, srcs, receiver_positions, channel, rotations)
        for srcs in source_lists
    ]
    flat = [np.concatenate([p[i] for p in parts]) for i in range(5)]
    sizes = [len(p[0]) for p in parts]
    out = _render_flat_items(oracle, flat, channel, room, peak_normalize,
                             sizes, device)
    n_recv, n_ch = len(receiver_positions), channel.count
    banks = [
        b.reshape(len(srcs), n_recv, n_ch, room.ir_len)
        for b, srcs in zip(out.split(sizes), source_lists)
    ]
    return banks if out_device else [b.cpu().numpy() for b in banks]
