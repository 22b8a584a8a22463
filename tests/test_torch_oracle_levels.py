"""The port's RIR oracles, bank I/O and level math against the JAX package's,
on the CPU, and the default device of the bank entry points.

Tolerances: the serial renderers place the same float32 taps by a product
instead of a scatter and filter through the same masks: 1e-5 of the peak
(measured below 2e-7). The batched route of ``render_rir_bank`` is the bank
renderer, held as in tests/test_torch_bank_render.py (5e-5·peak, 1e-4).
Bank files round-trip exactly. Level math runs the same float32 formulas,
summed in another order: 1e-5 relative, and 1e-5 dB absolute on levels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonicsim_tpu.ops.levels as JL
import sonicsim_tpu_torch.ops.levels as TL
from sonicsim_tpu.sim.channels import ChannelModel as JChannel
from sonicsim_tpu.sim.image_source import ShoeboxRoom as JRoom
from sonicsim_tpu.sim.oracle import BankRirOracle as JBank
from sonicsim_tpu.sim.oracle import SyntheticRirOracle as JOracle
from sonicsim_tpu.sim.oracle import render_rir_bank as j_bank
from sonicsim_tpu.sim.oracle import save_rir_bank as j_save
from sonicsim_tpu_torch import sim as T
from sonicsim_tpu_torch.bridge import sim_from_fields

SERIAL_REL = 1e-5
BANK_ATOL, BANK_RTOL = 5e-5, 1e-4
REL = 1e-5
CHANNELS = [JChannel("Mono"), JChannel("Binaural"), JChannel("Ambisonics", channel_order=1),
            JChannel("CustomArrayIR", mic_array=[[0, 0, 0], [0, 0, 0.04]])]
SRC = np.array([2.0, 1.3, 1.6])
RECV = np.array([4.6, 1.5, 3.1])


def _oracles(n_bands, channel, device="cpu", **room):
    ref = JOracle(JRoom((7.0, 3.0, 5.0), absorption=0.35, **room), n_bands=n_bands,
                  max_order=2, seed=11)
    return (ref, channel), sim_from_fields(dataclasses.asdict(ref),
                                           dataclasses.asdict(channel), device=device)


@pytest.mark.parametrize("n_bands", [0, 8], ids=["flat", "multiband"])
@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.channel_type)
def test_synthetic_oracle_render(n_bands, channel):
    (ref, ch), (ours, ours_ch) = _oracles(n_bands, channel, transmission=0.05)
    for rot in (90.0, 37.0):
        want = ref.render(SRC, RECV, ch, rot)
        got = ours.render(SRC, RECV, ours_ch, rot)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SERIAL_REL * np.abs(want).max())


def test_multiband_band_override_and_far_source():
    """An explicit absorption table, and a source whose images all lie past
    the IR window of the flat renderer (an all-zero early part)."""
    (ref, ch), (ours, ours_ch) = _oracles(8, JChannel("Binaural"))
    from sonicsim_tpu.sim.image_source import render_shoebox_rir as j_flat
    from sonicsim_tpu.sim.image_source import render_shoebox_rir_multiband as j_multi

    bands = np.linspace(0.1, 0.6, 8)
    want = j_multi(ref.room, SRC, RECV, ch, band_absorption=bands, max_order=2, seed=4)
    got = T.render_shoebox_rir_multiband(ours.room, SRC, RECV, ours_ch, band_absorption=bands,
                                         max_order=2, seed=4, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=SERIAL_REL * np.abs(want).max())
    far = np.array([600.0, 1.5, 2.0])
    want = j_flat(ref.room, far, RECV, ch, max_order=1, ir_seconds=0.05)
    got = T.render_shoebox_rir(ours.room, far, RECV, ours_ch, max_order=1, ir_seconds=0.05,
                               device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_bands", [0, 8], ids=["serial", "batched"])
def test_render_rir_bank_routes(n_bands):
    (ref, ch), (ours, ours_ch) = _oracles(n_bands, JChannel("Binaural"))
    srcs = [SRC, np.array([5.5, 2.0, 1.0])]
    recvs = [RECV, np.array([1.5, 1.2, 4.0])]
    for norm in (True, False):
        want = j_bank(ref, srcs, recvs, ch, [90.0, 45.0], norm)
        got = T.render_rir_bank(ours, srcs, recvs, ours_ch, [90.0, 45.0], norm)
        assert got.shape == want.shape == (2, 2, 2, want.shape[-1])
        atol = (BANK_ATOL if n_bands else SERIAL_REL) * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=BANK_RTOL if n_bands else 0, atol=atol)


def test_save_load_round_trip(tmp_path):
    """Banks written by either package read back equal in both, and the
    nearest-pair lookup of BankRirOracle agrees."""
    rng = np.random.default_rng(5)
    rirs = (rng.standard_normal((3, 2, 2, 64)) * 0.1).astype(np.float16)
    src, rcv = rng.uniform(0, 5, (3, 3)), rng.uniform(0, 5, (2, 3))
    for name, save in (("port", T.save_rir_bank), ("jax", j_save)):
        path = tmp_path / name / "bank.npz"
        save(path, rirs, src, rcv, sample_rate=8000, scene=np.asarray("room"))
        ours, ref = T.BankRirOracle(path), JBank(path)
        assert ours.sample_rate == ref.sample_rate == 8000
        assert ours._data.keys() == ref._data.keys()
        for k in ref._data:
            np.testing.assert_array_equal(ours._data[k], ref._data[k])
        ch = T.ChannelModel("Binaural")
        for s in src:
            for r in rcv:
                np.testing.assert_array_equal(ours.render(s + 0.01, r, ch),
                                              ref.render(s + 0.01, r, JChannel("Binaural")))
        with pytest.raises(ValueError):
            ours.render(src[0], rcv[0], T.ChannelModel("Mono"))
    path = tmp_path / "f64.npz"
    T.save_rir_bank(path, rirs.astype(np.float64), src, rcv)
    assert np.load(path)["rirs"].dtype == np.float32


def test_levels(rng):
    x = rng.standard_normal((3, 2, 800)).astype(np.float32) * np.float32([[[1.0]], [[0.1]], [[0.01]]])
    x[1, :, 600:] = 0.0
    sirs = np.asarray([3.0, -60.0], np.float32)

    def both(fn, *args):
        ours = getattr(TL, fn)(*(torch.from_numpy(np.asarray(a)) for a in args))
        ref = np.asarray(getattr(JL, fn)(*(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=REL,
                                   atol=REL * max(np.abs(ref).max(), 1.0))

    both("rms_db", x[0])
    both("rms_db", np.zeros(5, np.float32))
    both("gain_db_to_lin", np.linspace(-60, 40, 11, dtype=np.float32))
    both("mix_sources_sir", x, sirs)
    both("mix_sources_sir", x[:, 0], sirs)
    both("scale_noise_snr", x[0], x[1], np.float32(5.0))
    both("scale_noise_snr", x[0], x[2], np.float32(-80.0))
    for a in (x[1], x[1, 0], np.zeros(16, np.float32)):
        both("peak_normalize", a)
        both("rms_normalize", a)


def test_bank_entry_points_default_to_the_card(monkeypatch):
    """With no device, the renderers ask for the card: without CUDA they
    raise and never fall back to the CPU, which runs when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _), (on_card, ch) = _oracles(8, JChannel("Mono"), device=None)
    (_, _), (flat, _) = _oracles(0, JChannel("Mono"), device=None)
    # The bank renderers take their device from the oracle alone.
    calls = [
        lambda d: T.render_bank_batched(dataclasses.replace(on_card, device=d),
                                        [SRC], [RECV], ch),
        lambda d: T.render_rir_banks(dataclasses.replace(on_card, device=d),
                                     [[SRC]], [RECV], ch),
        lambda d: T.render_shoebox_rir(flat.room, SRC, RECV, ch, device=d),
        lambda d: T.render_shoebox_rir_multiband(on_card.room, SRC, RECV, ch, n_bands=8,
                                                 max_order=2, device=d),
    ]
    for call in calls:
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call(device)
        assert np.isfinite(np.asarray(call("cpu")[0])).all()
    for oracle in (on_card, flat):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            oracle.render(SRC, RECV, ch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.render_rir_bank(oracle, [SRC], [RECV], ch)
    on_cpu = dataclasses.replace(on_card, device="cpu")
    bank = T.render_rir_banks(on_cpu, [[SRC]], [RECV], ch, out_device=True)[0]
    assert torch.is_tensor(bank) and bank.device.type == "cpu"
    assert T.render_rir_bank(on_cpu, [SRC], [RECV], ch).shape == (1, 1, 1, bank.shape[-1])
