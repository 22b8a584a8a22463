"""The port's serving and evaluation CLIs on the CPU, on a tiny generated
split, against the same flow through the JAX package's functions: the eval
samplers, ``generate_fixed_eval``, ``inference``, ``audio_test`` and
``test`` (``--device cpu``), the config's targets read as the port's, and
``metadata_segments``.

Tolerances: the samplers and the materialised WAVs are equal; separated
tracks within 1e-5 · max|ref| plus one PCM16 step; the CSVs' SI-SNR(i)
within 1e-3 dB, SDR(i) within 1e-2 dB, STOI within 1e-4 and PESQ within
1e-3 (numpy on estimates that differ by float32 rounding).
"""

import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonicsim_tpu.dataset.sampler as JD
import sonicsim_tpu.infer as JI
import sonicsim_tpu.metrics as JMet
import sonicsim_tpu.models as JM
import sonicsim_tpu_torch.dataset.sampler as TD
from sonicsim_tpu.utils import read_wav as j_read_wav
from sonicsim_tpu.utils import write_wav as j_write_wav
from sonicsim_tpu_torch import losses as TL
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.scripts import audio_test, generate_fixed_eval, inference, test
from sonicsim_tpu_torch.utils import import_target, instantiate, load_config, read_wav, save_config
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SR = 16000
TINY = dict(N=16, L=16, B=8, H=16, X=2, R=1)
TRACK_REL, PCM_STEP = 1e-5, 2.0 / 32768
COLUMN_TOL = {"si-snr": 1e-3, "si-snr_i": 1e-3, "sdr": 1e-2, "sdr_i": 1e-2,
              "stoi": 1e-4, "pesq_nb_native": 1e-3, "pesq_wb_native": 1e-3}


def _tone(rng, t, f0):
    n = np.arange(t) / SR
    x = 0.3 * np.sin(2 * np.pi * f0 * n) * (1 + 0.5 * np.sin(2 * np.pi * 3 * n))
    return (x + 0.02 * rng.standard_normal(t)).astype(np.float32)


def _split(root: Path, folders=2, seconds=1.5, seed=0) -> Path:
    """A generated split's shape: per folder, binaural moving_audio_{1,2,3},
    noise and music tracks and a json_data.json of start/end points."""
    rng = np.random.default_rng(seed)
    t = int(seconds * SR)
    for k in range(folders):
        d = root / "split" / f"room{k}" / f"mix{k}"
        d.mkdir(parents=True)
        for i in (1, 2, 3):
            x = _tone(rng, t, 150 * i + 40 * k)
            j_write_wav(d / f"moving_audio_{i}.wav", np.stack([x, 0.9 * x]), SR)
        for name in ("noise", "music"):
            j_write_wav(d / f"{name}_audio.wav",
                        0.05 * rng.standard_normal((2, t)).astype(np.float32), SR)
        meta = {f"source{i}": {"start_end_points": [[int(0.1 * i * SR), int((0.6 + 0.2 * i) * SR)]]}
                for i in (1, 2, 3)}
        meta["noise"] = {"start_end_points": [[0, t]]}
        (d / "json_data.json").write_text(json.dumps(meta))
    return root / "split"


@pytest.fixture
def served(tmp_path):
    """A split, a tiny ConvTasNet saved by the JAX package, and a config."""
    split = _split(tmp_path)
    jm = JM.ConvTasNet(**TINY)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                          jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 800))))
    exp = tmp_path / "exp"
    JM.save_model(jm, params, exp / "ctn" / "best_model.pkl")
    cfg = {"exp": {"dir": str(exp), "name": "ctn"},
           "datas": {"test_dir": str(split), "sample_rate": SR, "num_spks": 2}}
    save_config(cfg, tmp_path / "cfg.yaml")
    return dict(root=tmp_path, split=split, jm=jm, params=params,
                model_path=exp / "ctn" / "best_model.pkl", conf=tmp_path / "cfg.yaml",
                results=exp / "ctn" / "results")


def _jax_forward(jm, params):
    return jax.jit(lambda p, x: JI.to_waveform(jm, jm.apply(p, x), x.shape[-1]))


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _same_tables(ours, ref):
    assert [r["snt_id"] for r in ours] == [r["snt_id"] for r in ref]
    assert ours[0].keys() == ref[0].keys()
    assert ours[-2]["snt_id"] == "avg" and ours[-1]["snt_id"] == "std"
    for a, b in zip(ours, ref):
        for col, tol in COLUMN_TOL.items():
            assert float(a[col]) == pytest.approx(float(b[col]), abs=tol, nan_ok=True), (
                a["snt_id"], col)


def _jax_tracker(path):
    return JMet.MetricsTracker(path, extra_metrics={
        "pesq_nb_native": JMet.make_pesq("nb"), "pesq_wb_native": JMet.make_pesq("wb")})


def test_samplers_equal(tmp_path):
    split = _split(tmp_path, folders=3)
    assert TD.find_bottom_directories(split) == JD.find_bottom_directories(split)
    for noise_type in ("noise", "music", "all"):
        for task in ("separation", "enhancement"):
            ours = TD.MovingTestEvalDataset(str(split), noise_type=noise_type, task=task, seed=3)
            ref = JD.MovingTestEvalDataset(str(split), noise_type=noise_type, task=task, seed=3)
            assert len(ours) == len(ref) == 3
            for i in range(3):
                for a, b in zip(ours[i], ref[i]):
                    assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    np.testing.assert_array_equal(TD.apply_sir(x, np.array([3.0, -2.0])),
                                  JD.apply_sir(x, np.array([3.0, -2.0])))
    np.testing.assert_array_equal(TD.apply_snr(x[0], x[1], 12.5), JD.apply_snr(x[0], x[1], 12.5))
    np.testing.assert_array_equal(TD.overlap_audio(x[0], SR, 0.1), JD.overlap_audio(x[0], SR, 0.1))
    assert TD.rms_db(x[2]) == JD.rms_db(x[2])


def test_generate_fixed_eval_and_test_cli(served):
    """The materialised tree equals the JAX flow's, and ``test`` over it
    scores as the JAX functions do (metadata spans in one folder, the whole
    mixture in the other; with ``--bucket``)."""
    fixed = served["root"] / "fixed"
    generate_fixed_eval.main(["--in_dir", str(served["split"]), "--out_dir", str(fixed),
                              "--seed", "2", "--device", "cpu"])
    ds = JD.MovingTestEvalDataset(str(served["split"]), seed=2)
    for i in range(len(ds)):
        mix, targets, _ = ds[i]
        for name, wav in [("mix", mix)] + [(f"s{s + 1}", targets[s]) for s in range(2)]:
            got, _ = read_wav(fixed / f"sample{i + 1}" / f"{name}.wav")
            j_write_wav(served["root"] / "ref.wav", wav, SR)
            np.testing.assert_array_equal(got, j_read_wav(served["root"] / "ref.wav")[0])
    spans = [[800, 9000], [8000, 12000], [17000, 23000]]
    (fixed / "sample1" / "json_data.json").write_text(json.dumps(
        {"source1": {"start_end_points": spans[:2]}, "source2": {"start_end_points": spans[2:]}}))
    assert test.metadata_segments(str(fixed / "sample1"), 24000) == [(800, 12000), (17000, 23000)]
    assert test.metadata_segments(str(fixed / "sample2"), 24000) == [(0, 24000)]

    cfg = load_config(served["conf"])
    cfg["datas"]["test_dir"] = str(fixed)
    save_config(cfg, served["root"] / "fixed.yaml")
    test.main(["--conf_dir", str(served["root"] / "fixed.yaml"), "--bucket", "4000",
               "--device", "cpu"])

    fwd = _jax_forward(served["jm"], served["params"])
    tracker = _jax_tracker(served["root"] / "jax.csv")
    ds = JD.MovingTestDataset(str(fixed), return_path=True)
    for i in range(len(ds)):
        mix, targets, folder = ds[i]
        for s, e in test.metadata_segments(folder, mix.shape[-1]):
            padded = -((s - e) // 4000) * 4000
            run = np.pad(mix[s:e], (0, padded - (e - s)))
            est = np.asarray(fwd(served["params"], run[None]))[0][..., :e - s]
            tracker(mix[s:e], targets[:, s:e], est, f"{Path(folder).name}:{s}")
    tracker.final()
    ours = _read_csv(served["results"] / "metrics.csv")
    assert len(ours) == 3 + 2
    _same_tables(ours, _read_csv(served["root"] / "jax.csv"))


def test_audio_test_cli(served):
    segs = {"mix0": [[1000, 15000]], "mix1": [[0, 100], [2000, 20000]]}
    (served["root"] / "segs.json").write_text(json.dumps(segs))
    res = audio_test.main(["--conf_dir", str(served["conf"]), "--segments_json",
                           str(served["root"] / "segs.json"), "--seed", "5", "--device", "cpu"])
    assert res["mixtures"] == 2 and res["spans"] == 2

    fwd = _jax_forward(served["jm"], served["params"])
    tracker = _jax_tracker(served["root"] / "jax.csv")
    ds = JD.MovingTestEvalDataset(str(served["split"]), seed=5)
    for i in range(len(ds)):
        mix, targets, folder = ds[i]
        for s, e in segs[Path(folder).name]:
            if e - s > audio_test.MIN_SEGMENT:
                est = np.asarray(fwd(served["params"], mix[None, s:e]))[0]
                tracker(mix[s:e], targets[:, s:e], est, f"{Path(folder).name}:{s}")
    tracker.final()
    _same_tables(_read_csv(served["results"] / "metrics_remix-noise.csv"),
                 _read_csv(served["root"] / "jax.csv"))


def test_inference_cli(served):
    folder = served["split"] / "room0" / "mix0"
    out = served["root"] / "out"
    for bf16 in (False, True):
        inference.main(["--model_path", str(served["model_path"]), "--mix",
                        str(folder / "moving_audio_1.wav"), "--out_dir", str(out / str(bf16)),
                        "--segment_seconds", "0.4", "--device", "cpu"] + ["--bf16"] * bf16)
    mix, _ = j_read_wav(folder / "moving_audio_1.wav")
    mono = mix.mean(axis=0)
    fwd = _jax_forward(served["jm"], served["params"])
    seg_len = int(0.4 * SR)
    segments = []
    for s in range(0, len(mono), seg_len):
        chunk = mono[s:s + seg_len]
        pad = seg_len - len(chunk)
        est = np.asarray(fwd(served["params"], np.pad(chunk, (0, pad))[None]))[0]
        segments.append(est[..., :seg_len - pad])
    tracks = JI.concatenate_tracks(JI.stitch_segments(segments, SR))
    for i in range(2):
        j_write_wav(served["root"] / "ref.wav", tracks[i], SR)
        ref, _ = j_read_wav(served["root"] / "ref.wav")
        got, _ = read_wav(out / "False" / f"s{i + 1}_est.wav")
        np.testing.assert_allclose(got, ref, rtol=0, atol=TRACK_REL * np.abs(ref).max() + PCM_STEP)
        got16, _ = read_wav(out / "True" / f"s{i + 1}_est.wav")
        assert np.linalg.norm(got16 - got) / np.linalg.norm(got) < 0.05


def _fixed_tree(served) -> Path:
    """``generate_fixed_eval`` of the split and a config over it."""
    fixed = served["root"] / "fixed"
    generate_fixed_eval.main(["--in_dir", str(served["split"]), "--out_dir", str(fixed),
                              "--seed", "2", "--device", "cpu"])
    cfg = load_config(served["conf"])
    cfg["datas"]["test_dir"] = str(fixed)
    save_config(cfg, served["root"] / "fixed.yaml")
    return fixed


def test_unported_sidecar_flags_raise(served, capsys):
    """The sidecar flags that raised before their models were ported now
    run: ``test --vad_ckpt --whisper`` (a seeded pyannote checkpoint and a
    tiny Whisper HF directory, tests/test_torch_pyannet.py's and
    tests/test_torch_whisper.py's) segments by the neural VAD and writes an
    ``asr`` column, as the JAX flow does over the same tree."""
    import sonicsim_tpu.models.pyannet as JP
    import test_torch_pyannet
    import test_torch_whisper

    fixed = _fixed_tree(served)
    vad = test_torch_pyannet.write_checkpoint(served["root"] / "vad.ckpt",
                                              test_torch_pyannet.jax_params(2)[1])
    asr = test_torch_whisper.write_hf_dir(served["root"] / "whisper",
                                          test_torch_whisper.jax_params(5)[1])
    res = test.main(["--conf_dir", str(served["root"] / "fixed.yaml"), "--vad_ckpt", str(vad),
                     "--whisper", str(asr), "--limit", "1", "--device", "cpu"])
    assert "--vad_ckpt given: enabling --use_vad" in capsys.readouterr().out

    fwd = _jax_forward(served["jm"], served["params"])
    transcribe = JMet.make_whisper_asr(str(asr))
    tracker = JMet.MetricsTracker(served["root"] / "jax.csv", extra_text={"asr": transcribe},
                                  extra_metrics=_jax_tracker(served["root"] / "x.csv").extra)
    vad_fn = JP.make_neural_vad(vad)
    mix, targets, folder = JD.MovingTestDataset(str(fixed), return_path=True)[0]
    spans = JI.segment_mixture(mix, SR, vad_fn=vad_fn)
    assert spans and res["spans"] == len(spans)
    for s, e in spans:
        est = np.asarray(fwd(served["params"], mix[None, s:e]))[0]
        tracker(mix[s:e], targets[:, s:e], est, f"{Path(folder).name}:{s}")
    tracker.final()
    ours, ref = _read_csv(served["results"] / "metrics.csv"), _read_csv(served["root"] / "jax.csv")
    assert "asr" in ours[0] and [r["asr"] for r in ours] == [r["asr"] for r in ref]
    assert all(" | " in r["asr"] for r in ours[:-2])  # one transcript per estimate
    _same_tables(ours, ref)


def test_inference_ecapa_retracks_as_jax(served):
    """``inference --ecapa`` re-tracks with the ECAPA embedder from a seeded
    speechbrain checkpoint (tests/test_torch_ecapa.py's): the tracks equal
    the JAX flow's with the JAX embedder."""
    import sonicsim_tpu.models.ecapa as JE
    import test_torch_ecapa

    ckpt = test_torch_ecapa.write_checkpoint(served["root"] / "embedding_model.ckpt",
                                             test_torch_ecapa.jax_params(2)[1])
    folder = served["split"] / "room0" / "mix0"
    out = served["root"] / "out"
    inference.main(["--model_path", str(served["model_path"]), "--mix",
                    str(folder / "moving_audio_1.wav"), "--out_dir", str(out),
                    "--segment_seconds", "0.4", "--ecapa", str(ckpt), "--device", "cpu"])
    mono = j_read_wav(folder / "moving_audio_1.wav")[0].mean(axis=0)
    fwd = _jax_forward(served["jm"], served["params"])
    seg_len = int(0.4 * SR)
    segments = []
    for s in range(0, len(mono), seg_len):
        chunk = mono[s:s + seg_len]
        pad = seg_len - len(chunk)
        est = np.asarray(fwd(served["params"], np.pad(chunk, (0, pad))[None]))[0]
        segments.append(est[..., :seg_len - pad])
    tracks = JI.concatenate_tracks(JI.stitch_segments(
        segments, SR, embed_fn=JE.make_ecapa_embedder(ckpt)))
    for i in range(2):
        j_write_wav(served["root"] / "ref.wav", tracks[i], SR)
        ref, _ = j_read_wav(served["root"] / "ref.wav")
        got, _ = read_wav(out / f"s{i + 1}_est.wav")
        np.testing.assert_allclose(got, ref, rtol=0, atol=TRACK_REL * np.abs(ref).max() + PCM_STEP)


def test_repo_config_targets_resolve_to_the_port():
    cfg = load_config(ROOT / "configs" / "separation" / "convtasnet.yaml")
    assert import_target(cfg["model"]["_target_"]) is TM.ConvTasNet
    model = instantiate(dict(cfg["model"], **TINY), device="cpu")
    assert isinstance(model, TM.ConvTasNet)
    metric = instantiate(cfg["metrics"])
    assert isinstance(metric, TL.PITLossWrapper)
    assert isinstance(metric.loss_func, TL.PairwiseNegSDR) and metric.loss_func.sdr_type == "sisdr"
    x = torch.randn(2, 2, 800, generator=torch.Generator().manual_seed(0))
    assert float(metric(x, x)) < -50  # a perfect estimate
    from sonicsim_tpu_torch.dataset import MovingDataModule

    assert import_target(cfg["datas"]["_target_"]) is MovingDataModule


def test_clis_default_to_the_card(served):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for main, argv in ((audio_test.main, ["--conf_dir", str(served["conf"])]),
                       (test.main, ["--conf_dir", str(served["conf"])]),
                       (inference.main, ["--model_path", str(served["model_path"]), "--mix", "x"]),
                       (generate_fixed_eval.main, ["--in_dir", str(served["split"]),
                                                   "--out_dir", str(served["root"] / "o")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
