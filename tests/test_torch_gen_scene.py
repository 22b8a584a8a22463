"""The port's ``Scene`` against the JAX package's, on the CPU: a scene over a
saved RIR bank (``from_bank``) and a synthetic shoebox scene built from the
JAX scene's fields (``bridge.scene_from_fields``), through their render
entry points.

Tolerances: bank scenes look RIRs up in the same file, so they are equal.
The flat synthetic renderers place the same float32 taps: 1e-5 of the peak
(tests/test_torch_oracle_levels.py's ``SERIAL_REL``); a dry sound convolved
with them, 1e-5 of its peak (float32 FFT rounding, as in
tests/test_torch_slice.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sonicsim_tpu.sim.oracle import save_rir_bank as j_save_rir_bank
from sonicsim_tpu.sim.scene import Scene as JScene
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.parallel import Mesh
from sonicsim_tpu_torch.sim import CIRCULAR_4CH_ARRAY, Scene
from torch_threads import one_intra_op_thread  # noqa: F401

SERIAL_REL = 1e-5
REL = 1e-5


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def test_bank_scene_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    rirs = (rng.standard_normal((4, 3, 2, 128)) * 0.1).astype(np.float16)
    path = tmp_path / "room7.npz"
    j_save_rir_bank(path, rirs, rng.uniform(1, 5, (4, 3)), rng.uniform(1, 5, (3, 3)),
                    sample_rate=16000)
    scene = Scene.from_bank(str(path), device="cpu")
    ref = JScene.from_bank(str(path))
    assert scene.room == ref.room == "room7" and scene.device == "cpu"
    np.testing.assert_array_equal(scene.nav.occupancy, ref.nav.occupancy)
    assert (scene.nav.origin, scene.nav.resolution, scene.nav.floor_height) == \
        (ref.nav.origin, ref.nav.resolution, ref.nav.floor_height)
    r_t, r_j = np.random.default_rng(1), np.random.default_rng(1)
    srcs = [scene.nav.get_random_navigable_point(r_t) for _ in range(3)]
    for _ in range(3):
        ref.nav.get_random_navigable_point(r_j)
    mic = scene.select_static_points(srcs, r_t, 3.0, 1)[0]
    np.testing.assert_array_equal(mic, ref.select_static_points(srcs, r_j, 3.0, 1)[0])
    np.testing.assert_array_equal(scene.render_ir(srcs[0], mic), ref.render_ir(srcs[0], mic))
    banks = scene.render_banks([srcs[:2], srcs[2:]], [mic], out_device=True)
    ref_banks = ref.render_banks([srcs[:2], srcs[2:]], [mic])
    for got, want in zip(banks, ref_banks):
        assert torch.is_tensor(got) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(scene.render_bank(srcs, [mic]), ref.render_bank(srcs, [mic]))
    np.testing.assert_array_equal(scene.grid_points(0.7), ref.grid_points(0.7))


@pytest.mark.parametrize("channel", ["Mono", "Binaural"])
def test_synthetic_scene_renders_match_reference(channel):
    ref = JScene.synthetic(room="r", dims=(6.0, 3.0, 5.0), channel_type=channel, seed=3,
                           max_order=2)
    scene = bridge.scene_from_fields(dataclasses.asdict(ref), device="cpu")
    assert scene.oracle.device == "cpu" and scene.acoustic_config == ref.acoustic_config
    src, mic = np.array([1.2, 0.0, 1.1]), np.array([4.1, 0.0, 3.3])
    _close(scene.render_ir(src, mic, 45.0), ref.render_ir(src, mic, 45.0), SERIAL_REL)
    for got, want in zip(scene.render_ir_all([src, mic], np.array([3.0, 0, 2.0])),
                         ref.render_ir_all([src, mic], np.array([3.0, 0, 2.0]))):
        _close(got, want, SERIAL_REL)
    _close(scene.render_custom_arrayir(src, mic, CIRCULAR_4CH_ARRAY),
           ref.render_custom_arrayir(src, mic, CIRCULAR_4CH_ARRAY), SERIAL_REL)
    _close(scene.render_bank([src], [mic]), ref.render_bank([src], [mic]), SERIAL_REL)
    dry = (np.random.default_rng(2).standard_normal(4000) * 0.1).astype(np.float32)
    got = scene.generate_data([src], mic, dry_sounds=[dry], use_dry_sound=True)
    want = ref.generate_data([src], mic, dry_sounds=[dry], use_dry_sound=True)
    assert got["sample_rate"] == want["sample_rate"] and got["envmap"] == [None, None]
    _close(got["audio_list"][0], want["audio_list"][0], REL)
    np.testing.assert_array_equal(got["dry_sound_list"][0], want["dry_sound_list"][0])
    with pytest.raises(ValueError, match="one dry sound per source"):
        scene.generate_data([src, mic], mic, dry_sounds=[dry], use_dry_sound=True)


def test_scene_device_and_materials(caplog):
    """The scene's device reaches its oracle; per-wall materials need the
    multiband renderer, as in the reference; a sharded render over a mesh of
    two CPU devices gives the unsharded banks, and a flat oracle's bank by
    bank render says that it is unsharded."""
    walls = {"floor": "carpet", "walls": "concrete"}
    scene = Scene.synthetic(n_bands=4, wall_materials=walls, device="cpu")
    ref = JScene.synthetic(n_bands=4, wall_materials=walls)
    assert scene.oracle.device == "cpu"
    for f in dataclasses.fields(ref.oracle.room):
        np.testing.assert_array_equal(np.asarray(getattr(scene.oracle.room, f.name)),
                                      np.asarray(getattr(ref.oracle.room, f.name)))
    with pytest.raises(ValueError, match="multiband"):
        Scene.synthetic(wall_materials=walls, device="cpu")
    mesh = Mesh(["cpu", "cpu"])
    srcs = [[np.array([2.0, 0.0, 2.0]), np.array([3.0, 0.0, 5.0])], [np.array([7.0, 0.0, 3.0])]]
    mic = [np.array([5.0, 0.0, 4.0])]
    for sc in (scene, Scene.synthetic(device="cpu")):
        want = sc.render_banks(srcs, mic)
        with caplog.at_level("WARNING", logger="sonicsim_tpu_torch.sim.scene"):
            got = sc.render_banks(srcs, mic, mesh=mesh, out_device=True)
        assert ("unsharded" in caplog.text) == (sc.oracle.n_bands == 0)
        for g, w in zip(got, want):
            assert torch.is_tensor(g) and g.device.type == "cpu"
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
