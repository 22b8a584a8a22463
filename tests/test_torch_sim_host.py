"""The port's copies of the JAX package's host-side simulation code (numpy):
channels, entities, materials and the image-source host part, against
``sonicsim_tpu.sim``.

Tolerance: none. Both sides run the same numpy code on the same inputs, so
every output must be equal.
"""

import dataclasses
import json

import numpy as np
import pytest

import sonicsim_tpu.sim.channels as JC
import sonicsim_tpu.sim.image_source as JI
import sonicsim_tpu.sim.materials as JM
import sonicsim_tpu_torch.sim.channels as TC
import sonicsim_tpu_torch.sim.image_source as TI
import sonicsim_tpu_torch.sim.materials as TM
from sonicsim_tpu.sim.entities import Receiver as JReceiver
from sonicsim_tpu_torch.sim.entities import Receiver, Source
from torch_threads import one_intra_op_thread  # noqa: F401

CHANNELS = [
    dict(channel_type="Mono"),
    dict(channel_type="Binaural"),
    dict(channel_type="Ambisonics", channel_order=1),
    dict(channel_type="Ambisonics", channel_order=3),
    dict(channel_type="CustomArrayIR", mic_array=JC.CIRCULAR_4CH_ARRAY),
]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fields", CHANNELS, ids=lambda f: f["channel_type"] + str(f.get("channel_order", "")))
def test_channel_models(fields, rng):
    ours, ref = TC.ChannelModel(**fields), JC.ChannelModel(**fields)
    assert ours.count == ref.count
    dirs = rng.standard_normal((50, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for rot in (0.0, 37.0, 90.0, 215.5):
        _eq(ours.receiver_offsets(rot), ref.receiver_offsets(rot))
        _eq(ours.directional_gain(dirs, rot), ref.directional_gain(dirs, rot))


def test_channel_constants_and_sh(rng):
    assert TC.CHANNEL_TYPES == JC.CHANNEL_TYPES
    assert TC.LINEAR_4CH_ARRAY == JC.LINEAR_4CH_ARRAY
    assert TC.HEAD_RADIUS == JC.HEAD_RADIUS
    dirs = rng.standard_normal((64, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for order in range(4):
        _eq(TC.real_sh_matrix(dirs, order), JC.real_sh_matrix(dirs, order))
    for t, o, m in (("Mono", 1, None), ("Ambisonics", 2, None), ("CustomArrayIR", 1, [[0, 0, 0]] * 3)):
        assert TC.channel_count(t, o, m) == JC.channel_count(t, o, m)
    with pytest.raises(ValueError):
        TC.channel_count("CustomArrayIR")
    assert dataclasses.asdict(Receiver((1, 2, 3))) == dataclasses.asdict(JReceiver((1, 2, 3)))
    assert Source((0, 0, 0)).rotation == 0.0


def _rooms():
    f = np.linspace(0, 1, 7)
    walls = tuple(tuple(np.clip(0.05 + 0.5 * f ** (0.5 + 0.3 * w), 0.01, 0.95)) for w in range(6))
    scat = tuple(tuple(0.05 + 0.1 * f + 0.02 * w) for w in range(6))
    return [
        dict(dims=(7.0, 3.0, 5.0), absorption=0.35),
        dict(dims=(6.0, 2.8, 4.0), absorption=0.2, scattering=0.3, transmission=0.05,
             damping=0.01, absorption_bands=(0.1, 0.2, 0.4, 0.6)),
        dict(dims=(8.0, 3.0, 6.0), wall_absorption_bands=walls, wall_scattering_bands=scat,
             wall_transmission_bands=((0.02,) * 3,) * 6, wall_damping_bands=((0.0, 0.01),) * 6,
             diffraction=False),
    ]


@pytest.mark.parametrize("fields", _rooms(), ids=["uniform", "banded", "per-wall"])
def test_room_physics(fields):
    ours, ref = TI.ShoeboxRoom(**fields), JI.ShoeboxRoom(**fields)
    assert ours.is_uniform == ref.is_uniform
    assert ours.volume == ref.volume and ours.surface == ref.surface
    assert ours.rt60() == ref.rt60() and ours.mean_absorption() == ref.mean_absorption()
    _eq(ours.wall_areas(), ref.wall_areas())
    for n_bands in (8, 32):
        _eq(ours.band_absorption(n_bands), ref.band_absorption(n_bands))
        _eq(ours.wall_band_absorption(n_bands), ref.wall_band_absorption(n_bands))
        for override in (None, np.linspace(0.1, 0.5, n_bands)):
            a = dataclasses.asdict(ours.wall_physics(n_bands, override))
            b = dataclasses.asdict(ref.wall_physics(n_bands, override))
            assert a.keys() == b.keys()
            for k in a:
                _eq(a[k], b[k])
    with pytest.raises(ValueError):
        ours.wall_physics(8, np.ones((8, 5)))


def test_filterbank_lattice_and_edges(rng):
    assert TI.WALLS == JI.WALLS and TI.SINC_HALF == JI.SINC_HALF
    assert TI.SPEED_OF_SOUND == JI.SPEED_OF_SOUND
    for n_bands, nfft in ((8, 8192), (32, 8192), (32, 32768)):
        _eq(TI.band_centers(n_bands, 16000), JI.band_centers(n_bands, 16000))
        _eq(TI.band_masks(n_bands, nfft, 16000), JI.band_masks(n_bands, nfft, 16000))
    room_t, room_j = TI.ShoeboxRoom((7.0, 3.0, 5.0)), JI.ShoeboxRoom((7.0, 3.0, 5.0))
    freqs = TI.band_centers(8, 16000)
    for _ in range(3):
        src, rcv = rng.uniform([0.5] * 3, [6.5, 2.5, 4.5], (2, 3))
        for order in (1, 2, 4):
            for a, b in zip(TI.image_sources(room_t, src, order),
                            JI.image_sources(room_j, src, order)):
                _eq(a, b)
            for a, b in zip(TI.image_sources_walls(room_t, src, order),
                            JI.image_sources_walls(room_j, src, order)):
                _eq(a, b)
        for a, b in zip(TI.edge_diffraction_paths(room_t.dims, src, rcv),
                        JI.edge_diffraction_paths(room_j.dims, src, rcv)):
            _eq(a, b)
        for a, b in zip(TI.edge_diffraction_arrivals(room_t, src, rcv, freqs),
                        JI.edge_diffraction_arrivals(room_j, src, rcv, freqs)):
            _eq(a, b)
    detour = rng.uniform(0, 3, (20, 1))
    _eq(TI.diffraction_band_gain(detour, freqs[None]), JI.diffraction_band_gain(detour, freqs[None]))


def test_material_parsing(tmp_path):
    """All three curve spellings, the interleaved-pair guess kept as it is,
    and the per-wall constructors."""
    cfg = {"materials": [
        {"name": "Brick", "labels": ["wall"],
         "absorption": [125, 0.02, 250, 0.02, 500, 0.03, 1000, 0.04, 2000, 0.05, 4000, 0.07],
         "scattering": [{"frequency": 125, "value": 0.1}, {"frequency": 4000, "value": 0.4}],
         "transmission": [0.01, 0.02, 0.03]},
        {"name": "carpet", "labels": ["floor", "rug"], "absorption": [0.1, 0.3, 0.5, 0.6],
         "damping": [0.0, 0.01]},
        {"absorption": []},
    ]}
    path = tmp_path / "materials.json"
    path.write_text(json.dumps(cfg))
    ours, ref = TM.load_material_config(path), JM.load_material_config(path)
    assert [dataclasses.asdict(m) for m in ours.values()] == [
        dataclasses.asdict(m) for m in ref.values()]
    for entry in (*(m.get("absorption") for m in cfg["materials"]), [1, 2, 3, 4], []):
        assert TM._curve_values(entry) == JM._curve_values(entry)
    freqs = np.geomspace(20, 8000, 16)
    for name in ours:
        for fam in TM.CURVE_FAMILIES:
            _eq(ours[name].curve_at(fam, freqs), ref[name].curve_at(fam, freqs))
    for label in ("wall", "brick", "floor", "unknown"):
        assert dataclasses.asdict(TM.material_for_label(label, ours)) == dataclasses.asdict(
            JM.material_for_label(label, ref))
    areas = {"wall": 20.0, "floor": 8.0, "door": 2.0}
    assert TM.room_mean_absorption(areas) == JM.room_mean_absorption(areas)
    labels = {"floor": "carpet", "ceiling": "concrete", "walls": "Brick"}
    assert TM.wall_absorption_from_labels(labels, ours) == JM.wall_absorption_from_labels(labels, ref)
    curves = TM.wall_curves_from_labels(labels, ours, n_bands=8)
    assert curves == JM.wall_curves_from_labels(labels, ref, n_bands=8)
    room = TI.ShoeboxRoom((8.0, 3.0, 6.0), **curves)
    assert not room.is_uniform
    for bad in ({"attic": "carpet"}, {"floor": "carpet"}, ["carpet"] * 5):
        with pytest.raises(ValueError):
            TM._resolve_wall_labels(bad)
