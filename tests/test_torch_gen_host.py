"""The port's host copies for SonicSet generation against the JAX package's
originals, on the same inputs: seeding, WAV I/O, PCM16 helpers, transcripts,
navigable-space geometry, the audio planners and ``plan_mixture``.

Tolerance: none. Every result here is equal (arrays bit for bit, JSON
byte for byte), and every generator is left in the same state.
"""

import dataclasses
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import sonicsim_tpu.dataset.generate as jgen
import sonicsim_tpu.dataset.plan as jplan
import sonicsim_tpu.native as jnative
import sonicsim_tpu.sim.geometry as jgeo
import sonicsim_tpu.sim.grid_cache as jgrid
import sonicsim_tpu.sim.maps as jmaps
import sonicsim_tpu.utils.audio as jaudio
import sonicsim_tpu.utils.transcripts as jtrans
import sonicsim_tpu.utils.wavio as jwav
from sonicsim_tpu.sim.scene import Scene as JScene
from sonicsim_tpu.utils.seeding import stable_seed as j_stable_seed
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.dataset import generate as tgen
from sonicsim_tpu_torch.dataset import plan as tplan
from sonicsim_tpu_torch.sim import geometry as tgeo
from sonicsim_tpu_torch.sim import grid_cache as tgrid
from sonicsim_tpu_torch.sim import maps as tmaps
from sonicsim_tpu_torch.utils import audio as taudio
from sonicsim_tpu_torch.utils import transcripts as ttrans
from sonicsim_tpu_torch.utils import wavio as twav
from sonicsim_tpu_torch.utils.seeding import stable_seed
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000


def _tone_corpus(root, n, seconds, rng, prefix):
    """PCM16 AM tones plus noise (tests/test_dataset.py's corpus)."""
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        t = np.arange(int(seconds * SR)) / SR
        x = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)
             * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
        x += 0.01 * rng.standard_normal(len(x)).astype(np.float32)
        twav.write_wav(root / f"{prefix}{i}.wav", x, SR)
    return tplan.scan_audio_lengths(root)


def _riff(path, fmt_code, n_ch, sr, bits, payload, extensible=False):
    """A RIFF/WAVE file with any format code and bit depth."""
    block = n_ch * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHH", 0xFFFE, n_ch, sr, sr * block, block, bits)
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\0" * 14
    else:
        fmt = struct.pack("<HHIIHH", fmt_code, n_ch, sr, sr * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"LIST" + struct.pack("<I", 3) + b"abc\0"  # odd chunk, padded
    body += b"data" + struct.pack("<I", len(payload)) + payload
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("parts", [(0, "roomA", "s1-s2-s3"), (7,), ("x", 1.5, None)])
def test_stable_seed(parts):
    assert stable_seed(*parts) == j_stable_seed(*parts)


@pytest.mark.parametrize("case", ["float32", "pcm16", "int16"])
def test_write_wav_bytes(tmp_path, case):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 999)) * 0.6).astype(np.float32)
    x[0, :4] = [1.5, -1.5, 1.0, -1.0]  # clipped by pcm16
    enc = "float32" if case == "float32" else "pcm16"
    if case == "int16":
        x = taudio.pcm16_quantize(x)
    twav.write_wav(tmp_path / "t.wav", x, SR, encoding=enc)
    jwav.write_wav(tmp_path / "j.wav", x, SR, encoding=enc)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    assert twav.wav_num_frames(tmp_path / "t.wav") == jwav.wav_num_frames(tmp_path / "j.wav") == 999


@pytest.mark.parametrize("fmt", ["pcm8", "pcm16", "pcm24", "pcm32", "float32",
                                 "float64", "pcm16-extensible"])
def test_read_wav_matches_reference(tmp_path, fmt):
    rng = np.random.default_rng(4)
    n_ch, n = 2, 1001
    if fmt.startswith("pcm"):
        bits = int(fmt[3:5].rstrip("-"))
        code = 1
        if bits == 8:
            payload = rng.integers(0, 256, n * n_ch).astype(np.uint8).tobytes()
        elif bits == 24:
            payload = rng.integers(0, 256, n * n_ch * 3).astype(np.uint8).tobytes()
        else:
            lim = 2 ** (bits - 1)
            payload = rng.integers(-lim, lim, n * n_ch).astype(f"<i{bits // 8}").tobytes()
    else:
        bits, code = int(fmt[5:]), 3
        payload = rng.standard_normal(n * n_ch).astype(f"<f{bits // 8}").tobytes()
    path = tmp_path / "x.wav"
    _riff(path, code, n_ch, 22050, bits, payload, extensible=fmt.endswith("extensible"))
    got, sr = twav.read_wav(path)
    ref, ref_sr = jwav.read_wav(path)
    assert sr == ref_sr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (n_ch, n) and twav.wav_num_frames(path) == n
    np.testing.assert_array_equal(twav.resample(got, 22050, SR),
                                  jwav.resample(ref, 22050, SR))


def test_read_wav_rejects_malformed(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX0000WAVE")
    with pytest.raises(ValueError, match="not a RIFF"):
        twav.read_wav(bad)
    _riff(tmp_path / "u.wav", 1, 1, SR, 12, b"\0" * 12)
    with pytest.raises(ValueError, match="bit depth"):
        twav.read_wav(tmp_path / "u.wav")


def test_pcm16_exact_and_quantize():
    rng = np.random.default_rng(5)
    on_grid = rng.integers(-32768, 32767, 4000).astype(np.float32) / 32768.0
    off_grid = on_grid + np.float32(1e-7)
    hot = np.concatenate([on_grid[:10], np.float32([32767.5 / 32768.0])])
    for x in (on_grid, off_grid, hot, np.zeros(0, np.float32)):
        a, b = taudio.pcm16_exact(x), jaudio.pcm16_exact(x)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == np.int16
            np.testing.assert_array_equal(a, b)
    wave = (rng.standard_normal((2, 3000)) * 0.7).astype(np.float32)
    ref = jaudio.pcm16_quantize(wave)
    np.testing.assert_array_equal(taudio.pcm16_quantize(wave), ref)
    on_dev = taudio.pcm16_quantize(torch.from_numpy(wave))
    assert on_dev.dtype == torch.int16
    np.testing.assert_array_equal(on_dev.numpy(), ref)


def test_list_helpers_and_transcripts(tmp_path):
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((2, 50)), rng.standard_normal((2, 70))
    for x, y in zip(taudio.clip_all([a, b]), jaudio.clip_all([a, b])):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(taudio.sum_arrays_with_different_length([a, b]),
                                  jaudio.sum_arrays_with_different_length([a, b]))
    np.testing.assert_array_equal(taudio.pad_x_to_y(a, b), jaudio.pad_x_to_y(a, b))
    np.testing.assert_array_equal(taudio.make_pad_mask([3, 5]), jaudio.make_pad_mask([3, 5]))
    assert taudio.all_pairs([1, 2], "ab") == jaudio.all_pairs([1, 2], "ab")
    for norm in ("peak", "rms"):
        np.testing.assert_array_equal(taudio.normalize(a[0], norm), jaudio.normalize(a[0], norm))
    book = tmp_path / "ls" / "19" / "198"
    book.mkdir(parents=True)
    (book / "19-198.trans.txt").write_text("19-198-0000 HELLO WORLD\n19-198-0001 BYE\n")
    assert ttrans.process_librispeech(tmp_path / "ls", tmp_path / "t.csv") == 2
    jtrans.process_librispeech(tmp_path / "ls", tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert ttrans.load_transcripts(tmp_path / "t.csv") == jtrans.load_transcripts(tmp_path / "j.csv")


def _grids():
    """Rectangular footprints (what synthetic and bank scenes use) and one
    room with walls and scattered obstacles."""
    occ = np.ones((40, 32), bool)
    occ[10:12, 0:25] = False
    occ[25:27, 8:32] = False
    occ[np.random.default_rng(1).integers(0, 40, 30),
        np.random.default_rng(2).integers(0, 32, 30)] = False
    return [
        ("rect", lambda m: m.NavGrid.rectangle(9.3, 7.1, resolution=0.25)),
        ("rect-fine", lambda m: m.NavGrid.rectangle(12.0, 10.0, resolution=0.1)),
        ("obstacles", lambda m: m.NavGrid(occ.copy(), (0.5, -1.0), 0.25, 0.2)),
    ]


@pytest.mark.parametrize("name,make", _grids(), ids=[g[0] for g in _grids()])
def test_geometry_under_equal_seeds(name, make, monkeypatch):
    """find_path, sample_trajectory, select_static_points, densify_path,
    generate_xy_grid_points, snapping and the top-down raster. On the
    obstacle grid the reference is the JAX package's Python A*: its native
    A* breaks ties otherwise there (ROADMAP C)."""
    if name == "obstacles":
        monkeypatch.setattr(jnative, "available", lambda: False)
    tn, jn = make(tgeo), make(jgeo)
    rt, rj = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(6):
        s, e = tn.get_random_navigable_point(rt), tn.get_random_navigable_point(rt)
        jn.get_random_navigable_point(rj), jn.get_random_navigable_point(rj)
        a, b = tn.find_path(s, e), jn.find_path(s, e)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.stack(a), np.stack(b))
    far = tn.snap_point(np.array([-50.0, 0.0, 80.0]))
    np.testing.assert_array_equal(far, jn.snap_point(np.array([-50.0, 0.0, 80.0])))
    trajs = []
    for mod, nav, rng in ((tgeo, tn, rt), (jgeo, jn, rj)):
        t = mod.sample_trajectory(nav, rng, 3.0)
        dense = mod.densify_path(t, 9)
        mids = [t[len(t) // 2], dense[4]]
        pts = mod.select_static_points(nav, mids, rng, 2.0, 3)
        pts += mod.select_static_points(nav, mids, rng, 0.01, 2, max_tries=3)  # fallback
        trajs.append([np.stack(t), np.stack(dense), np.stack(pts),
                      mod.generate_xy_grid_points(nav, 1.3)])
    for a, b in zip(*trajs):
        np.testing.assert_array_equal(a, b)
    assert rt.bit_generator.state == rj.bit_generator.state
    np.testing.assert_array_equal(tmaps.topdown_map(tn, 0.1), jmaps.topdown_map(jn, 0.1))
    # Its rounding-error spread draws from an unseeded generator in both
    # packages, so only the frame count and the first pose are fixed.
    poses = tgeo.interpolate_receiver_poses(trajs[0][1], np.linspace(0, 90, 9), 25)
    assert len(poses) == 25 and poses[0][1] == 0.0
    np.testing.assert_array_equal(poses[0][0], trajs[0][1][0])


def test_grid_cache_and_trace(tmp_path):
    nav = tgeo.NavGrid.rectangle(6.0, 5.0, resolution=0.25)
    pts = tgrid.load_room_grid("r", 1.0, tmp_path / "t", nav)
    assert tgrid.grid_cache_path(tmp_path, "r", 1.0) == jgrid.grid_cache_path(tmp_path, "r", 1.0)
    ref = jgrid.load_room_grid("r", 1.0, tmp_path / "j", jgeo.NavGrid.rectangle(6.0, 5.0, resolution=0.25))
    np.testing.assert_array_equal(pts, ref)
    np.testing.assert_array_equal(tgrid.load_room_grid("r", 1.0, tmp_path / "t"), ref)
    with pytest.raises(FileNotFoundError):
        tgrid.load_room_grid("other", 1.0, tmp_path / "t")
    traj = [np.array([1.0, 0, 1.0]), np.array([4.0, 0, 3.5])]
    mic, static = np.array([[3.0, 0, 2.0]]), np.array([[2.0, 0, 4.0], [5.0, 0, 1.0]])
    drew = tmaps.save_trace_image(tmp_path / "t.png", nav, [traj], mic, static)
    jmaps.save_trace_image(tmp_path / "j.png", jgeo.NavGrid.rectangle(6.0, 5.0, resolution=0.25),
                           [traj], mic, static)
    assert drew == "PIL"
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_trace_left_out_without_pil_or_matplotlib(tmp_path, monkeypatch, caplog):
    import builtins

    real_import = builtins.__import__

    def no_drawing(name, *args, **kwargs):
        if name.split(".")[0] in ("PIL", "matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_drawing)
    nav = tgeo.NavGrid.rectangle(4.0, 4.0, resolution=0.25)
    assert tmaps.save_trace_image(tmp_path / "t.png", nav) is None
    assert not (tmp_path / "t.png").exists()
    assert "left out" in caplog.text


def test_audio_planners(tmp_path):
    rng = np.random.default_rng(7)
    lengths = _tone_corpus(tmp_path / "sp", 7, 0.9, rng, "u")
    lengths.update({str(tmp_path / "long.wav"): 3 * SR})
    for args in [(2.0, 0.9), (3.0, 0.5)]:
        for mod_plan in ("plan_long_audio", "plan_background_audio"):
            got = getattr(tplan, mod_plan)(lengths, args[0], np.random.default_rng(8), SR,
                                           1.0, args[1])
            ref = getattr(jplan, mod_plan)(lengths, args[0], np.random.default_rng(8), SR,
                                           1.0, args[1])
            assert got.to_json() == ref.to_json()
            assert got.start_end_points == ref.start_end_points
    for stop in (True, False):  # both overflow quirks of the reference
        for target in (SR, 2 * SR, int(0.9 * SR) * 2):
            assert tplan.select_files_to_fill(lengths, target, np.random.default_rng(9),
                                              stop_on_overflow=stop) == \
                jplan.select_files_to_fill(lengths, target, np.random.default_rng(9),
                                           stop_on_overflow=stop)
    assert tplan.scan_audio_lengths(tmp_path / "sp") == jplan.scan_audio_lengths(tmp_path / "sp")
    manifest = tmp_path / "m.json"
    manifest.write_text('{"a.wav": 12, "b.wav": "7"}')
    assert tplan.load_length_manifest(manifest) == jplan.load_length_manifest(manifest)
    splits = Path(__file__).resolve().parents[1] / "data" / "sonicset_splits.json"
    assert tplan.load_split_manifest(splits, "val", speech_root="/c") == \
        jplan.load_split_manifest(splits, "val", speech_root="/c")
    assert (tplan.LUFS_SPEECH, tplan.LUFS_NOISE, tplan.LUFS_MUSIC, tplan.LUFS_JITTER) == \
        (jplan.LUFS_SPEECH, jplan.LUFS_NOISE, jplan.LUFS_MUSIC, jplan.LUFS_JITTER)


@pytest.mark.parametrize("channel,min_waypoints", [("Binaural", 0), ("Mono", 6)])
def test_plan_mixture_byte_equal(tmp_path, channel, min_waypoints):
    """plan_mixture from the JAX scene and from the port's scene built from
    its fields (bridge.scene_from_fields) saves byte-equal plans, which
    bridge.plan_from_json loads back byte-equal."""
    rng = np.random.default_rng(10)
    speech = [_tone_corpus(tmp_path / f"spk{i}", 4, 0.8, rng, f"s{i}_") for i in range(3)]
    noise = _tone_corpus(tmp_path / "noise", 3, 1.2, rng, "n")
    music = _tone_corpus(tmp_path / "music", 3, 2.5, rng, "m")
    ref_scene = JScene.synthetic(room="roomB", dims=(9.0, 3.0, 7.0), channel_type=channel,
                                 seed=3, max_order=2, n_bands=4)
    scene = bridge.scene_from_fields(dataclasses.asdict(ref_scene), device="cpu")
    assert scene.device == "cpu" and scene.oracle.device == "cpu"
    kw = dict(duration=4.0, seed=12, min_waypoints=min_waypoints, max_silence_seconds=1.0)
    tgen.plan_mixture(scene, speech, noise, music, np.random.default_rng(12), **kw).save(
        tmp_path / "t.json")
    jgen.plan_mixture(ref_scene, speech, noise, music, np.random.default_rng(12), **kw).save(
        tmp_path / "j.json")
    blob = (tmp_path / "j.json").read_bytes()
    assert (tmp_path / "t.json").read_bytes() == blob
    bridge.plan_from_json(tmp_path / "j.json").save(tmp_path / "again.json")
    assert (tmp_path / "again.json").read_bytes() == blob
