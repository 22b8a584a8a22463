"""The port's split loop and CLI on the CPU, in the port alone: resume,
cleanup of partial mixture dirs, the device sink, the utterance cache and
the pipeline (both bit-identical to their absence), a trajectory of one
waypoint, the artifact writer, the entry points' default device, and
``python -m sonicsim_tpu_torch.scripts.generate_sonicset --device cpu``.

Tolerance: byte equality wherever two runs compute the same mixture; the
loudness of rendered tracks within 1e-3 LU of the plan's target (float32
rounding of one gain).
"""

import json
import time

import numpy as np
import pytest
import torch

from sonicsim_tpu_torch.dataset import (
    ArtifactWriter,
    assemble_long_audio,
    generate_split,
    looks_like_partial_mixture,
    plan_mixture,
    remove_existing_speakers,
    render_mixture,
    scan_audio_lengths,
)
from sonicsim_tpu_torch.ops import convolve_fixed_receiver, integrated_loudness, lufs_norm
from sonicsim_tpu_torch.parallel import Mesh
from sonicsim_tpu_torch.scripts import generate_sonicset
from sonicsim_tpu_torch.sim import Scene
from sonicsim_tpu_torch.utils import read_wav, write_wav
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
LU_TOL = 1e-3
TRACKS = [f"moving_audio_{i}.wav" for i in (1, 2, 3)] + ["noise_audio.wav", "music_audio.wav"]


def _corpus(root, n, seconds, rng, prefix):
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        t = np.arange(int(seconds * SR)) / SR
        x = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)
             * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
        x += 0.01 * rng.standard_normal(len(x)).astype(np.float32)
        write_wav(root / f"{prefix}{i}.wav", x, SR)
    return scan_audio_lengths(root)


@pytest.fixture
def corpus(tmp_path):
    """3 speaker dirs of 2 utterances, 2 noise and 2 music clips."""
    rng = np.random.default_rng(0)
    dirs = []
    for i in range(3):
        _corpus(tmp_path / "speech" / f"spk{i}", 2, 1.0, rng, f"u{i}_")
        dirs.append(str(tmp_path / "speech" / f"spk{i}"))
    return (dirs, _corpus(tmp_path / "noise", 2, 1.5, rng, "n_"),
            _corpus(tmp_path / "music", 2, 1.5, rng, "m_"))


def _factory(name, n_bands=0, channel="Mono"):
    return Scene.synthetic(room=name, dims=(8.0, 3.0, 6.0), channel_type=channel, seed=4,
                           max_order=2, n_bands=n_bands, device="cpu")


def _files(folder):
    return {p.name: p.read_bytes() for p in sorted(folder.iterdir())}


def test_resume_and_partial_dir_cleanup(tmp_path, corpus):
    dirs, noise, music = corpus
    root = tmp_path / "set"
    produced = generate_split(_factory, ["roomA"], dirs, noise, music, root, duration=3.0)
    assert len(produced) == 1  # 3 speakers: one triple
    out = produced[0]
    golden = _files(out)
    assert set(TRACKS) <= set(golden) and "json_data.json" in golden
    assert remove_existing_speakers(root / "roomA", dirs) == []
    assert generate_split(_factory, ["roomA"], dirs, noise, music, root, duration=3.0) == []

    # A crash between the WAV writes and the completion marker.
    (out / "json_data.json").unlink()
    (out / "moving_audio_2.wav").unlink()
    keep = out.parent / "plots"
    keep.mkdir()
    (keep / "notes.txt").write_text("user data")
    assert remove_existing_speakers(root / "roomA", dirs) == dirs
    again = generate_split(_factory, ["roomA"], dirs, noise, music, root, duration=3.0)
    assert [p.name for p in again] == [out.name]
    assert _files(out) == golden
    assert (keep / "notes.txt").read_text() == "user data"


def test_cache_pipeline_and_sinks_agree(tmp_path, corpus):
    """Cache on/off and pipeline on/off give byte-identical folders over two
    scenes; the device sink writes nothing and returns the same codes."""
    dirs, noise, music = corpus

    def run(root, **kw):
        return generate_split(lambda n: _factory(n, n_bands=4, channel="Binaural"),
                              ["roomA", "roomB"], dirs, noise, music, tmp_path / root,
                              duration=3.0, **kw)

    ref = run("cached")
    assert len(ref) == 2
    for root, kw in (("host", dict(utterance_cache=False)),
                     ("serial", dict(pipeline=False, pipeline_depth=1))):
        got = run(root, **kw)
        assert [p.name for p in got] == [p.name for p in ref]
        for a, b in zip(got, ref):
            assert _files(a) == _files(b)
    device = run("device", sink="device")
    assert len(device) == 2 and all(not any(p.iterdir()) for p in device)

    plan_path = ref[0] / "mixture_plan.json"
    from sonicsim_tpu_torch.bridge import plan_from_json

    res = render_mixture(_factory("roomA", n_bands=4, channel="Binaural"),
                         plan_from_json(plan_path), tmp_path / "one", sink="device")
    assert res["device_resident"] and res["fence"] is None
    assert not any((tmp_path / "one").iterdir())
    codes = res["tracks"]
    assert codes.dtype == torch.int16 and codes.shape == (5, 2, 3 * SR)
    for i, name in enumerate(TRACKS):
        wav, _ = read_wav(ref[0] / name)
        np.testing.assert_array_equal(codes[i].numpy() / 32768.0, wav.astype(np.float64))


def test_single_waypoint_trajectory(tmp_path, corpus):
    """A trajectory of one waypoint takes the per-source path: that speaker
    is a fixed convolution with its one RIR; every track reaches its
    target loudness."""
    dirs, noise, music = corpus
    scene = _factory("roomA")
    manifests = [scan_audio_lengths(d) for d in dirs]
    plan = plan_mixture(scene, manifests, noise, music, np.random.default_rng(3),
                        duration=3.0, seed=3)
    plan.trajectories[0] = plan.trajectories[0][:1]
    out = tmp_path / "one"
    meta = render_mixture(scene, plan, out, wav_encoding="float32")
    assert "pcm16_peak_scale" not in meta
    tracks = [torch.from_numpy(read_wav(out / n)[0]) for n in TRACKS]
    targets = plan.lufs_speech + [plan.lufs_noise, plan.lufs_music]
    for x, want in zip(tracks, targets):
        assert x.shape == (1, 3 * SR) and torch.isfinite(x).all()
        assert abs(float(integrated_loudness(x, SR)) - want) <= LU_TOL
    bank = scene.render_banks([[np.asarray(p) for p in plan.trajectories[0]]],
                              [np.asarray(plan.mic_point)], out_device=True)[0]
    dry = torch.from_numpy(assemble_long_audio(plan.speech_plans[0])[0])
    want = lufs_norm(convolve_fixed_receiver(dry, bank[0, 0]), SR, plan.lufs_speech[0])[0]
    np.testing.assert_array_equal(tracks[0].numpy(), want.numpy())
    pcm = render_mixture(scene, plan, tmp_path / "pcm")
    assert json.loads((tmp_path / "pcm" / "json_data.json").read_text()) == \
        json.loads(json.dumps(pcm))


def test_artifact_writer_and_partial_marks(tmp_path):
    order = []
    w = ArtifactWriter()
    for i in range(16):
        w.submit(lambda i=i: (order.append(i), time.sleep(0.001)))
    w.barrier()
    assert order == list(range(16))

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    w.submit(order.append, 99)  # skipped after the failure
    with pytest.raises(OSError, match="disk full"):
        w.close()
    assert 99 not in order

    empty = tmp_path / "empty"
    empty.mkdir()
    partial = tmp_path / "partial"
    partial.mkdir()
    (partial / "moving_audio_1.wav").write_bytes(b"\0")
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "analysis.ipynb").write_text("{}")
    assert looks_like_partial_mixture(empty) and looks_like_partial_mixture(partial)
    assert not looks_like_partial_mixture(foreign)


def test_entry_points_refuse_what_is_not_ported(tmp_path, corpus):
    """An unknown sink raises; a mesh of two CPU devices (the name is older
    than the port of the mesh) writes the unsharded WAVs within one int16
    step (tests/test_torch_mesh_render.py holds the mesh to JAX's)."""
    dirs, noise, music = corpus
    scene = _factory("roomA")
    plan = plan_mixture(scene, [scan_audio_lengths(d) for d in dirs], noise, music,
                        np.random.default_rng(1), duration=2.0)
    render_mixture(scene, plan, tmp_path / "one", save_trace=False)
    render_mixture(scene, plan, tmp_path / "m", save_trace=False, mesh=Mesh(["cpu", "cpu"]))
    for name in TRACKS:
        a, _ = read_wav(tmp_path / "one" / name)
        b, _ = read_wav(tmp_path / "m" / name)
        np.testing.assert_allclose(b, a, rtol=0, atol=1.01 / 32768, err_msg=name)
    with pytest.raises(ValueError, match="sink"):
        render_mixture(scene, plan, tmp_path / "s", sink="ram")


def test_default_device_is_the_card(tmp_path, corpus):
    """Without a device the scene runs on the card: without CUDA, generation
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    dirs, noise, music = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_split(lambda n: Scene.synthetic(room=n, channel_type="Mono", max_order=1),
                       ["roomA"], dirs, noise, music, tmp_path / "set", duration=2.0)


def test_cli_on_the_cpu(tmp_path, corpus, capsys):
    dirs, noise, music = corpus
    speech_root = tmp_path / "speech"
    (tmp_path / "noise.json").write_text(json.dumps(noise))
    words = tmp_path / "t.csv"
    words.write_text("name,words\nu0_0.flac,hello there\n")
    generate_sonicset.main([
        "--mode", "val", "--results_root", str(tmp_path / "SonicSet"),
        "--speech_root", str(speech_root), "--noise_json", str(tmp_path / "noise.json"),
        "--music_dir", str(tmp_path / "music"), "--channel_type", "Mono",
        "--duration", "2.0", "--n_scenes", "1", "--transcripts_csv", str(words),
        "--device", "cpu",
    ])
    assert "generated 1 mixtures" in capsys.readouterr().out
    (folder,) = (tmp_path / "SonicSet" / "val" / "scene000").iterdir()
    names = {p.name for p in folder.iterdir()}
    assert set(TRACKS) | {"json_data.json", "mixture_plan.json", "rir_bank_Mono.npz"} <= names
    meta = json.loads((folder / "json_data.json").read_text())
    assert "hello there" in sum((meta[f"source{i}"]["words"] for i in (1, 2, 3)), [])
