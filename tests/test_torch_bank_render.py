"""The port's batched RIR-bank renderer against the JAX package's, on the CPU:
the device internals, and whole banks over every channel type, a uniform
room (amplitude rank r = 1) and per-wall materials (r > 1), diffraction on
and off, peak normalisation on and off, and several banks in one render.

Tolerances:

* internals that both sides compute eagerly in float32 (lattice, profile,
  SH, edge geometry): 1e-6 relative, a few float32 roundings;
* host factorizations (numpy on both sides): equal;
* banks: 5e-5·peak absolute and 1e-4 relative. 1e-5·peak was the target;
  the measured gap is up to 3.8e-5·peak, at taps next to the direct path.
  Its cause is the image distances: XLA's fused lattice rounds them
  differently from eager float32 (up to 3.6e-4 samples at 16 kHz, both
  sides equally far from a float64 lattice), and a sinc tap near its peak
  moves by about its slope times that shift. The JAX package's own bank
  differs from its serial renderer by as much (tests/test_bank_render.py
  holds them to 5e-5·peak and 1e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicsim_tpu.sim import bank_render as JB
from sonicsim_tpu.sim.channels import ChannelModel as JChannel
from sonicsim_tpu.sim.image_source import ShoeboxRoom as JRoom
from sonicsim_tpu.sim.oracle import SyntheticRirOracle as JOracle
from sonicsim_tpu_torch.bridge import sim_from_fields
from sonicsim_tpu_torch.parallel import Mesh
from sonicsim_tpu_torch.sim import bank_render as TB
from torch_threads import one_intra_op_thread  # noqa: F401

ATOL, RTOL = 5e-5, 1e-4  # atol is a fraction of the bank's peak
REL = 1e-6

CHANNELS = {
    "mono": JChannel("Mono"),
    "binaural": JChannel("Binaural"),
    "ambisonics": JChannel("Ambisonics", channel_order=1),
    "array": JChannel("CustomArrayIR", mic_array=[[0, 0, -0.05], [0.05, 0, 0], [0, 0, 0.05]]),
}


def _per_wall():
    f = np.linspace(0, 1, 8)
    absorption = tuple(
        tuple(np.clip(0.05 + 0.5 * f ** (0.5 + 0.3 * w) + 0.05 * np.sin(3 * f + w), 0.01, 0.95))
        for w in range(6))
    scattering = tuple(tuple(0.05 + 0.1 * f + 0.02 * w) for w in range(6))
    return dict(wall_absorption_bands=absorption, wall_scattering_bands=scattering)


# (channel, per-wall materials, diffraction, peak normalisation): every
# channel type in both rooms, each of the other two options on and off.
CASES = [
    ("mono", False, True, True),
    ("binaural", False, False, True),
    ("ambisonics", False, True, False),
    ("array", False, True, True),
    ("mono", True, True, False),
    ("binaural", True, True, True),
    ("ambisonics", True, False, True),
    ("array", True, False, False),
]
SRCS = [np.array([1.5, 1.4, 1.5]), np.array([4.2, 2.1, 3.3]), np.array([5.6, 1.1, 1.2])]
RECVS = [np.array([3.5, 1.5, 2.5]), np.array([5.0, 1.2, 3.0])]
ROTATIONS = [37.0, 90.0]


def _both(walls, diffraction, channel="binaural", seed=3):
    room = JRoom((7.0, 3.0, 5.0), absorption=0.35, diffraction=diffraction,
                 **(_per_wall() if walls else {}))
    ref = JOracle(room, n_bands=8, max_order=2, seed=seed)
    ch = CHANNELS[channel]
    ours, ours_ch = sim_from_fields(dataclasses.asdict(ref), dataclasses.asdict(ch), device="cpu")
    return (ref, ch), (ours, ours_ch)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * np.abs(ref).max())


@pytest.fixture(scope="module")
def rendered():
    """The JAX package's banks for every case, rendered once."""
    out = {}
    for case in CASES:
        channel, walls, diffraction, norm = case
        (ref, ch), _ = _both(walls, diffraction, channel)
        out[case] = JB.render_bank_batched(ref, SRCS, RECVS, ch, ROTATIONS,
                                           peak_normalize=norm)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    [c[0], "walls" if c[1] else "uniform", "diffr" if c[2] else "nodiffr",
     "norm" if c[3] else "raw"]))
def test_render_bank_batched(rendered, case):
    channel, walls, diffraction, norm = case
    _, (ours, ch) = _both(walls, diffraction, channel)
    r = TB._bank_params(ours).amp_u.shape[1]
    assert (r > 1) == walls
    got = TB.render_bank_batched(ours, SRCS, RECVS, ch, ROTATIONS,
                                 peak_normalize=norm)
    _close(got, rendered[case])
    if norm:
        assert np.abs(got).max() == 1.0


def test_render_rir_banks_several(rendered):
    """Three banks in one render, each peak-normalised on its own; the
    device tensor of ``out_device`` equals the numpy bank."""
    (ref, ch), (ours, ours_ch) = _both(False, True)
    lists = [SRCS[:2], SRCS[2:], [SRCS[1], SRCS[0]]]
    want = JB.render_rir_banks(ref, lists, RECVS, ch)
    got = TB.render_rir_banks(ours, lists, RECVS, ours_ch)
    on_dev = TB.render_rir_banks(ours, lists, RECVS, ours_ch, out_device=True)
    assert len(got) == len(on_dev) == 3
    for g, d, w in zip(got, on_dev, want):
        _close(g, w)
        assert torch.is_tensor(d) and torch.equal(d, torch.from_numpy(g))
        assert np.abs(g).max() == 1.0
    single = TB.render_bank_batched(ours, SRCS[2:], RECVS, ours_ch)
    np.testing.assert_array_equal(got[1], single)


def test_bank_deterministic_and_sharded():
    """Bit-identical from run to run; over a mesh of three CPU devices the
    same banks (tests/test_torch_mesh_render.py holds the mesh to JAX's)."""
    _, (ours, ch) = _both(True, True)
    a = TB.render_bank_batched(ours, SRCS, RECVS[:1], ch)
    b = TB.render_bank_batched(ours, SRCS, RECVS[:1], ch)
    np.testing.assert_array_equal(a, b)
    mesh = Mesh(["cpu"] * 3)
    whole = TB.render_bank_batched(ours, SRCS, RECVS, ch)
    np.testing.assert_allclose(TB.render_bank_batched(ours, SRCS, RECVS, ch, mesh=mesh),
                               whole, rtol=0, atol=1e-6)
    for got, want in zip(TB.render_rir_banks(ours, [SRCS[:2], SRCS[2:]], RECVS, ch, mesh=mesh),
                         TB.render_rir_banks(ours, [SRCS[:2], SRCS[2:]], RECVS, ch)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_place_lattice_chunks(monkeypatch):
    """Cutting the item axis into chunks changes no value."""
    _, (ours, ch) = _both(True, True)
    whole = TB.render_bank_batched(ours, SRCS, RECVS, ch)
    monkeypatch.setattr(TB, "_PLACE_BYTES", 1)  # one item per chunk
    np.testing.assert_array_equal(
        TB.render_bank_batched(ours, SRCS, RECVS, ch), whole)


def _geometry_inputs(rng, p=4):
    dims = np.asarray([7.0, 3.0, 5.0], np.float32)
    srcs = rng.uniform([0.5] * 3, [6.5, 2.5, 4.5], (p, 3)).astype(np.float32)
    recvs = rng.uniform([0.5] * 3, [6.5, 2.5, 4.5], (p, 3)).astype(np.float32)
    return dims, srcs, recvs


def _rel(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=REL, atol=REL * np.abs(ref).max())


def test_device_geometry(rng):
    dims, srcs, recvs = _geometry_inputs(rng)
    for order in (1, 2, 4):
        ours = TB._device_geometry(*map(torch.from_numpy, (dims, srcs, recvs)), order, 0.3)
        ref = JB._device_geometry(*map(jnp.asarray, (dims, srcs, recvs)), order, 0.3)
        _rel(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
        for a, b in zip(ours[2], ref[2]):
            _rel(a, b)
        valid_gap = ours[3].numpy() != np.asarray(ref[3])
        assert valid_gap.mean() < 1e-3  # only images at the 0.3 s edge may flip


def test_edge_geometry_gains_and_sh(rng):
    dims, srcs, recvs = _geometry_inputs(rng, 6)
    ours = TB._device_edge_geometry(*map(torch.from_numpy, (dims, srcs, recvs)))
    ref = JB._device_edge_geometry(*map(jnp.asarray, (dims, srcs, recvs)))
    _rel(ours[0], ref[0])
    _rel(ours[1], ref[1])
    for a, b in zip(ours[2], ref[2]):
        _rel(a, b)
    u = rng.standard_normal((6, 3, 50)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    normals = rng.standard_normal((6, 3)).astype(np.float32)
    chan = np.asarray([0, 1, 2, 3, 1, 0])
    for order in (1, 2, 3):
        _rel(TB._real_sh(*torch.from_numpy(u).unbind(1), order),
             JB._real_sh(tuple(jnp.asarray(u[:, i]) for i in range(3)), order))
    for ctype in ("Mono", "CustomArrayIR", "Binaural", "Ambisonics"):
        _rel(TB._directional_gain(ctype, 1, *torch.from_numpy(u).unbind(1),
                                  torch.from_numpy(normals), torch.from_numpy(chan)),
             JB._directional_gain(ctype, 1, *(jnp.asarray(u[:, i]) for i in range(3)),
                                  jnp.asarray(normals), jnp.asarray(chan)))


def test_profiles_and_factorizations():
    f = np.linspace(0, 1, 32)
    walls = np.sqrt(1 - np.clip(np.stack(
        [0.05 + 0.5 * f ** (0.5 + 0.3 * w) for w in range(6)], 1), 0.01, 0.95))
    for beta in (np.full((32, 6), np.sqrt(0.7)), walls):
        for order in (2, 4):
            _rel(TB._amplitude_profile(torch.tensor(beta, dtype=torch.float32), order),
                 JB._amplitude_profile(jnp.asarray(beta, jnp.float32), order))
            np.testing.assert_array_equal(TB._amplitude_profile_np(beta, order),
                                          JB._amplitude_profile_np(beta, order))
            for a, b in zip(TB._factor_amplitude_profile(beta, order),
                            JB._factor_amplitude_profile(beta, order)):
                np.testing.assert_array_equal(a, b)
    for rt60 in (np.full(32, 0.36, np.float32), np.geomspace(0.15, 0.5, 32).astype(np.float32)):
        for a, b in zip(TB._factor_tail_envelopes(rt60, 6355, 16000),
                        JB._factor_tail_envelopes(rt60, 6355, 16000)):
            np.testing.assert_array_equal(a, b)
    for n_bands in (8, 32):
        for a, b in zip(TB._diffraction_basis(n_bands, 16000),
                        JB._diffraction_basis(n_bands, 16000)):
            np.testing.assert_array_equal(a, b)
