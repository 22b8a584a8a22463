"""The port's host adapters against the JAX package's: the remix training
set and its segment manifest, the visual path, the live habitat oracle
(both packages driven by tests/test_visual_habitat.py's fake
``habitat_sim``), the RIR-bank import and ``StageTimer``. Host code in
both packages: the outputs must be equal, not close.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from sonicsim_tpu.dataset import RemixTrainDataset as JRemix
from sonicsim_tpu.dataset import build_segment_manifest as j_build_segment_manifest
from sonicsim_tpu.sim import visual as JV
from sonicsim_tpu.sim.channels import ChannelModel as JChannel
from sonicsim_tpu.sim.geometry import NavGrid as JNavGrid
from sonicsim_tpu.sim.oracle import HabitatRirOracle as JHabitat
from sonicsim_tpu_torch.dataset import RemixTrainDataset, build_segment_manifest
from sonicsim_tpu_torch.scripts import import_rir_banks
from sonicsim_tpu_torch.sim import BankRirOracle, HabitatRirOracle, visual
from sonicsim_tpu_torch.sim.channels import ChannelModel
from sonicsim_tpu_torch.sim.geometry import NavGrid
from sonicsim_tpu_torch.utils import StageTimer, annotate, trace, write_wav

from test_visual_habitat import _FakeSim, _fake_habitat
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def fixed_tree(tmp_path):
    """tests/test_dataset.py's fixed tree: two sample dirs of s1/s2, noise
    and music WAVs, 6 s each, one of them quiet for its last 2 s."""
    rng = np.random.default_rng(0)
    for d in range(2):
        leaf = tmp_path / "fixed" / f"sample{d}"
        leaf.mkdir(parents=True)
        t = 6 * SR
        for i in (1, 2):
            wav = 0.1 * rng.standard_normal(t).astype(np.float32)
            if d == 1 and i == 2:
                wav[4 * SR:] *= 1e-4  # a silent span the manifest drops
            write_wav(leaf / f"s{i}.wav", wav, SR)
        write_wav(leaf / "noise.wav", 0.05 * rng.standard_normal(t).astype(np.float32), SR)
        write_wav(leaf / "music.wav", 0.05 * rng.standard_normal(t).astype(np.float32), SR)
    return tmp_path


def test_segment_manifest_is_jax(fixed_tree):
    ours = build_segment_manifest(fixed_tree / "fixed", fixed_tree / "port.json", duration=2.0)
    want = j_build_segment_manifest(fixed_tree / "fixed", fixed_tree / "jax.json", duration=2.0)
    assert ours == want and len(ours) == 2
    assert json.loads((fixed_tree / "port.json").read_text()) == json.loads(
        (fixed_tree / "jax.json").read_text())
    assert sorted(len(v) for v in ours.values()) == [2, 3]


@pytest.mark.parametrize("kw", [dict(), dict(num_spks=2, noise_type="all", snr_range=(0, 10))],
                         ids=["parity", "two-speakers-snr"])
def test_remix_items_are_jax(fixed_tree, kw):
    build_segment_manifest(fixed_tree / "fixed", fixed_tree / "seg.json", duration=2.0)
    ours = RemixTrainDataset(str(fixed_tree / "seg.json"), duration=2.0, num_samples=4, seed=1,
                             **kw)
    want = JRemix(str(fixed_tree / "seg.json"), duration=2.0, num_samples=4, seed=1, **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(ours)):
            (m, t), (jm, jt) = ours[i], want[i]
            assert m.dtype == jm.dtype and t.shape == jt.shape
            np.testing.assert_array_equal(m, jm)
            np.testing.assert_array_equal(t, jt)


def test_visual_frames_are_jax():
    waypoints = np.array([[1.0, 0.0, 1.0], [5.0, 0.0, 1.0], [5.0, 0.0, 3.0]])
    rotations = [0.0, 90.0, 180.0]
    ours = visual.topdown_render_fn(NavGrid.rectangle(6.0, 4.0, resolution=0.1))
    want = JV.topdown_render_fn(JNavGrid.rectangle(6.0, 4.0, resolution=0.1))
    frames = visual.interpolate_rgb_images(ours, waypoints, rotations, video_len=12)
    j_frames = JV.interpolate_rgb_images(want, waypoints, rotations, video_len=12)
    assert len(frames) == 12 and (frames[0] != frames[-1]).any()
    for a, b in zip(frames, j_frames):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    rgb, depth = visual.render_envmap(ours, np.array([2.0, 0.0, 2.0]), 30.0)
    j_rgb, j_depth = JV.render_envmap(want, np.array([2.0, 0.0, 2.0]), 30.0)
    np.testing.assert_array_equal(rgb, j_rgb)
    np.testing.assert_array_equal(depth, j_depth)


def test_habitat_render_fn_is_jax():
    frame = np.full((8, 10, 4), 7, np.uint8)
    logs = [], []
    outs = []
    for fn, log in zip((visual.habitat_render_fn, JV.habitat_render_fn), logs):
        sim = _FakeSim(None, log, frame=frame)
        outs.append(fn(sim, habitat=_fake_habitat(log))(np.array([1.0, 0.0, 2.0]), 90.0))
    (rgb, depth), (j_rgb, j_depth) = outs
    np.testing.assert_array_equal(rgb, j_rgb)
    np.testing.assert_array_equal(depth, j_depth)
    assert _comparable(logs[0]) == _comparable(logs[1])
    kind, pos, rot, *_ = next(e for e in logs[0] if e[0] == "agent_state")
    assert rot == ("quat", math.radians(90.0), (0.0, 1.0, 0.0))


def _comparable(log):
    """A fake simulator's call log with arrays as lists and specs as the
    attributes set on them."""
    def norm(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if hasattr(v, "set"):
            return {k: norm(x) for k, x in v.set.items()}
        if isinstance(v, (tuple, list)):
            return [norm(x) for x in v]
        return v

    return [norm(e) for e in log]


@pytest.mark.parametrize("channel,n", [("Binaural", 2), ("Mono", 1)])
def test_habitat_oracle_is_jax(channel, n):
    """Construction (sensor spec, acoustics config, navmesh, materials, seed),
    the re-posing and the returned IR, call for call; the channel check."""
    logs = [], []
    irs = []
    src, rcv = np.array([1.0, 0.0, 2.0]), np.array([3.0, 0.0, 4.0])
    for cls, ch, log in ((HabitatRirOracle, ChannelModel, logs[0]),
                         (JHabitat, JChannel, logs[1])):
        oracle = cls("scene.glb", navmesh="room.navmesh", material_json="mat.json",
                     channel=ch(channel), sample_rate=16000, seed=7,
                     acoustic_config={"indirectRayCount": 1000},
                     habitat=_fake_habitat(log, n_channels=n))
        irs.append(oracle.render(src, rcv, ch(channel), receiver_rotation=45.0))
        oracle.close()
    assert irs[0].dtype == np.float32 and irs[0].shape == (n, 64)
    np.testing.assert_array_equal(irs[0], irs[1])
    assert _comparable(logs[0]) == _comparable(logs[1])
    spec = next(e[1] for e in logs[0] if e[0] == "add_sensor")
    assert spec.set["acousticsConfig"].set["indirectRayCount"] == 1000
    wrong = HabitatRirOracle("scene.glb", channel=ChannelModel("Mono"),
                             habitat=_fake_habitat([], n_channels=4))
    with pytest.raises(ValueError, match="channels"):
        wrong.render(np.zeros(3), np.ones(3), ChannelModel("Mono"))


def test_habitat_oracle_without_habitat_sim():
    if importlib.util.find_spec("habitat_sim") is not None:
        pytest.skip("habitat_sim is installed here")  # the message is for its absence
    with pytest.raises(ImportError, match="habitat_sim is not installed"):
        HabitatRirOracle("scene.glb")


def _root_script():
    spec = importlib.util.spec_from_file_location("root_import_rir_banks",
                                                  ROOT / "scripts" / "import_rir_banks.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_import_rir_banks_writes_the_root_scripts_arrays(tmp_path):
    """tests/test_scripts.py's case: rir_save_*.pt converts to the same
    .npz arrays as the root script's, loadable by ``BankRirOracle``."""
    rng = np.random.default_rng(0)
    samp = tmp_path / "set" / "room" / "a-b-c"
    samp.mkdir(parents=True)
    banks = [torch.from_numpy((rng.standard_normal((5, 1, 2, 400)) * 0.1).astype(np.float32))
             for _ in range(3)]
    torch.save(banks, samp / "rir_save_train_Binaural.pt")
    (samp / "json_data.json").write_text("{}")
    n = import_rir_banks.main(["--sonicset_root", str(tmp_path / "set"),
                               "--out_root", str(tmp_path / "port")])
    assert n == 3
    root = _root_script()
    out = tmp_path / "jax" / "room" / "a-b-c" / "rir_save_train_Binaural.npz"
    out.parent.mkdir(parents=True)
    assert root.convert_bank(samp / "rir_save_train_Binaural.pt", out) == 3
    for i in (1, 2, 3):
        name = f"rir_save_train_Binaural_spk{i}.npz"
        ours = np.load(tmp_path / "port" / "room" / "a-b-c" / name)
        want = np.load(tmp_path / "jax" / "room" / "a-b-c" / name)
        assert sorted(ours.files) == sorted(want.files)
        for k in want.files:
            assert ours[k].dtype == want[k].dtype
            np.testing.assert_array_equal(ours[k], want[k])
    assert (tmp_path / "port" / "room" / "a-b-c" / "json_data.json").exists()
    got = BankRirOracle(tmp_path / "port" / "room" / "a-b-c" /
                        "rir_save_train_Binaural_spk2.npz").render(
        np.zeros(3), np.zeros(3), ChannelModel("Binaural"))
    np.testing.assert_array_equal(got, banks[1].numpy()[0, 0])


def test_stage_timer_on_the_cpu(tmp_path):
    timer = StageTimer()
    with timer.stage("a", result=torch.ones(3)):
        pass
    with timer.stage("a"):
        pass
    out = timer.time("b", lambda x: [x * 2, {"k": x}], torch.ones(2))
    assert torch.equal(out[0], torch.full((2,), 2.0))
    s = timer.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1 and s["a"]["total_s"] >= 0
    lines = timer.report().splitlines()
    assert lines[0].split() == ["stage", "count", "mean", "ms", "total", "s"] and len(lines) == 3
    timer.dump(tmp_path / "t" / "stages.json")
    assert json.loads((tmp_path / "t" / "stages.json").read_text()) == s
    with trace(tmp_path / "trace"):
        with annotate("region"):
            torch.ones(4).sum()
    assert "region" in (tmp_path / "trace" / "trace.json").read_text()
