"""The port's weightless evaluation sidecars against the JAX package, on the
CPU, from the same seeded inputs:

* DNSMOS and SigMOS end to end over chip_smoke.py's seeded stand-in graphs
  written as .onnx files (no published weights are in the repository), and
  ``make_dnsmos``/``make_sigmos``/``make_sigmos_all`` scoring the estimate
  as tests/test_sidecars.py wires them; their numpy features equal;
* the composite measures (SSNR, WSS, LLR, CSIG/CBAK/COVL) and ``wer``;
* ``SplitMetricsTracker``'s rows and CSV;
* ``wav_chunk_inference`` with a tiny ConvTasNet;
* the test CLI's ``--dnsmos_dir``/``--sigmos_path`` columns against the
  JAX flow over the same evaluation tree.

Tolerances: the MOS scores within 1e-5 relative (float32 graphs summed in
another order); the features, the composite measures and WER equal (numpy
copies; measured 0); the split tracker's dB values within 1e-3 dB (float32
SNRs on 2 s); the chunked output within 1e-5 · max|ref|; the CLI's columns
as tests/test_torch_serve.py holds the tracker's, the MOS columns within
1e-4 (their estimates differ by float32 rounding).
"""

import csv
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.dataset.sampler as JD
import sonicsim_tpu.metrics as JMet
import sonicsim_tpu.metrics.composite as JC
from sonicsim_tpu.infer import wav_chunk_inference as j_chunked
from sonicsim_tpu_torch import metrics as TMet
from sonicsim_tpu_torch.infer import wav_chunk_inference
from sonicsim_tpu_torch.models import ConvTasNet
from sonicsim_tpu_torch.parallel import Mesh
from sonicsim_tpu_torch.scripts import generate_fixed_eval
from sonicsim_tpu_torch.scripts import test as test_cli
from sonicsim_tpu_torch.scripts.common import make_forward
from sonicsim_tpu_torch.utils import load_config, save_config

from test_torch_serve import _jax_forward, served  # noqa: F401
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
MOS_REL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The seeded DNSMOS graphs in a directory and the SigMOS graph, as
    .onnx files."""
    root = tmp_path_factory.mktemp("onnx")
    p835, p808 = chip_smoke.dnsmos_graphs(0)
    (root / "dnsmos").mkdir()
    (root / "dnsmos" / "sig_bak_ovr.onnx").write_bytes(chip_smoke.onnx_bytes(p835))
    (root / "dnsmos" / "model_v8.onnx").write_bytes(chip_smoke.onnx_bytes(p808))
    (root / "sigmos.onnx").write_bytes(chip_smoke.onnx_bytes(chip_smoke.sigmos_graph(0)))
    return root


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)).astype(
        np.float32)


def _close(ours: dict, ref: dict, rel=MOS_REL):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k] == pytest.approx(v, rel=rel), k


def test_dnsmos_features_are_the_jax_packages():
    x = _audio(2.0)
    np.testing.assert_array_equal(TMet.librosa_mel_fb(SR, 321, 120),
                                  JMet.librosa_mel_fb(SR, 321, 120))
    np.testing.assert_array_equal(TMet.audio_melspec(x), JMet.audio_melspec(x))
    np.testing.assert_array_equal(TMet.audio_melspec(x, to_db=False),
                                  JMet.audio_melspec(x, to_db=False))


@pytest.mark.parametrize("personalized", [False, True])
def test_dnsmos_end_to_end(weights, personalized):
    """An 11.2 s clip: two 9.01 s hops at 1 s; a 3 s one, doubled until it
    holds a hop (12 s): three."""
    ours, ref = TMet.DNSMOS(weights / "dnsmos", "cpu"), JMet.DNSMOS(weights / "dnsmos")
    for seconds, hops in ((11.2, 2), (3.0, 3)):
        x = _audio(seconds, seed=int(seconds))
        got, want = ours(x, SR, personalized), ref(x, SR, personalized)
        assert got["num_hops"] == want["num_hops"] == hops
        _close(got, want)


def test_make_dnsmos_scores_the_estimate(weights):
    metric = TMet.make_dnsmos(weights / "dnsmos", device="cpu")
    ref, est = np.zeros(SR, np.float32), _audio(1.0)
    scorer = TMet.DNSMOS(weights / "dnsmos", "cpu")
    assert metric(ref, est, SR) == pytest.approx(scorer(est, SR)["OVRL"], rel=1e-6)
    assert metric(ref, est, SR) == pytest.approx(
        JMet.make_dnsmos(weights / "dnsmos")(ref, est, SR), rel=MOS_REL)
    two = np.stack([est, _audio(1.0, seed=3)])
    assert metric(ref, two, SR) == pytest.approx(np.mean([scorer(e, SR)["OVRL"] for e in two]),
                                                 rel=1e-6)
    assert TMet.make_dnsmos(weights / "dnsmos", key="P808_MOS", device="cpu")(
        ref, est, SR) == pytest.approx(scorer(est, SR)["P808_MOS"], rel=1e-6)


def test_sigmos_features_are_the_jax_packages():
    x = _audio(0.7)
    np.testing.assert_array_equal(TMet.sigmos_window(), JMet.sigmos_window())
    spec = TMet.sigmos_stft(x)
    np.testing.assert_array_equal(spec, JMet.sigmos_stft(x))
    np.testing.assert_array_equal(TMet.sigmos_features(spec), JMet.sigmos_features(spec))


@pytest.mark.parametrize("sr", [48000, 16000])  # 16 kHz: the Fourier resample first
def test_sigmos_end_to_end(weights, sr):
    x = _audio(1.2)
    ours, ref = TMet.SigMOS(weights / "sigmos.onnx", "cpu"), JMet.SigMOS(weights / "sigmos.onnx")
    got = ours(x, sr)
    assert list(got) == list(TMet.SigMOS.AXES)
    _close(got, ref(x, sr))


def test_make_sigmos_columns_score_the_estimate(weights):
    ref, est = np.zeros(SR, np.float32), _audio(1.0)
    scorer = TMet.SigMOS(weights / "sigmos.onnx", "cpu")(est, SR)
    cols = TMet.make_sigmos_all(weights / "sigmos.onnx", device="cpu")
    j_cols = JMet.make_sigmos_all(weights / "sigmos.onnx")
    assert list(cols) == list(j_cols) == list(TMet.SigMOS.AXES)
    for k, fn in cols.items():
        assert fn(ref, est, SR) == pytest.approx(scorer[k], rel=1e-6)
        assert fn(ref, est, SR) == pytest.approx(j_cols[k](ref, est, SR), rel=MOS_REL)
    one = TMet.make_sigmos(weights / "sigmos.onnx", "MOS_SIG", device="cpu")
    assert one(ref, est, SR) == pytest.approx(scorer["MOS_SIG"], rel=1e-6)
    with pytest.raises(ValueError, match="MOS_"):
        TMet.make_sigmos(weights / "sigmos.onnx", "OVRL", device="cpu")
    with pytest.raises(FileNotFoundError):
        TMet.SigMOS(weights / "missing.onnx", "cpu")


def test_whisper_waits_for_a10b(tmp_path):
    """``make_whisper_asr``, which raised until Whisper was ported: over a
    tiny seeded HF checkpoint (tests/test_torch_whisper.py's) it fills the
    tracker's ``asr`` text column as the JAX package's does, one transcript
    per estimate, kept out of the averages; a model name without
    faster-whisper raises ImportError."""
    import test_torch_whisper

    ckpt = test_torch_whisper.write_hf_dir(tmp_path / "whisper",
                                           test_torch_whisper.jax_params(5)[1])
    rng = np.random.default_rng(8)
    clean = (0.1 * rng.standard_normal((2, SR))).astype(np.float32)
    est = (clean + 0.02 * rng.standard_normal((2, SR))).astype(np.float32)
    ours = TMet.MetricsTracker(tmp_path / "ours.csv", device="cpu",
                               extra_text={"asr": TMet.make_whisper_asr(str(ckpt), device="cpu")})
    ref = JMet.MetricsTracker(tmp_path / "ref.csv",
                              extra_text={"asr": JMet.make_whisper_asr(str(ckpt))})
    for tracker in (ours, ref):
        tracker(clean.sum(0), clean, est, "s0")
    assert ours.rows[0]["asr"] == ref.rows[0]["asr"] and ours.rows[0]["asr"].count(" | ") == 1
    assert "asr" not in ours.final()
    with pytest.raises(ImportError, match="faster-whisper"):
        TMet.make_whisper_asr("medium.en")


@pytest.mark.parametrize("ref,hyp", [("the cat sat", "the cat sat"), ("the cat sat", "a cat"),
                                     ("", ""), ("", "noise"), ("a b c d", "a x c d e"),
                                     ("one", "")])
def test_wer_is_the_jax_packages(ref, hyp):
    assert TMet.wer(ref, hyp) == JMet.wer(ref, hyp)


def _pair(seconds=1.5, seed=4):
    rng = np.random.default_rng(seed)
    clean = _audio(seconds, seed)
    deg = (0.8 * clean + 0.1 * rng.standard_normal(clean.size)).astype(np.float32)
    return clean, deg


def test_composite_measures_are_the_jax_packages():
    clean, deg = _pair()
    assert TMet.ssnr(clean, deg, SR) == JC.ssnr(clean, deg, SR)
    assert TMet.wss(clean, deg, SR) == JC.wss(clean, deg, SR)
    assert TMet.llr(clean, deg, SR) == JC.llr(clean, deg, SR)
    ours, ref = TMet.composite_measures(clean, deg, SR), JMet.composite_measures(clean, deg, SR)
    assert ours == ref and all(np.isfinite(v) for v in ours.values())
    given = TMet.composite_measures(clean, deg, SR, pesq_value=2.5)
    assert given == JMet.composite_measures(clean, deg, SR, pesq_value=2.5)
    short = TMet.composite_measures(clean[:200], deg[:200], SR)  # too short for PESQ
    assert np.isnan(short["csig"]) and short.keys() == ours.keys()


def test_split_tracker_rows_and_csv(tmp_path):
    rng = np.random.default_rng(6)
    ours = TMet.SplitMetricsTracker(tmp_path / "ours.csv", device="cpu")
    ref = JMet.SplitMetricsTracker(tmp_path / "ref.csv")
    for k in range(3):
        clean = (0.1 * rng.standard_normal((3, 2 * SR))).astype(np.float32)
        est = (clean[[2, 0, 1]] + 0.02 * rng.standard_normal((3, 2 * SR))).astype(np.float32)
        mix = clean.sum(axis=0)
        ours(mix, clean, est, f"s{k}")
        ref(mix, clean, est, f"s{k}")
    final, j_final = ours.final(), ref.final()
    assert final.keys() == j_final.keys()
    for c in final:
        assert final[c] == pytest.approx(j_final[c], abs=1e-3), c
    with open(tmp_path / "ours.csv") as f, open(tmp_path / "ref.csv") as g:
        a, b = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert [r["snt_id"] for r in a] == [r["snt_id"] for r in b] == ["s0", "s1", "s2", "avg"]
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for c in TMet.SplitMetricsTracker.COLUMNS[1:]:
            assert float(ra[c]) == pytest.approx(float(rb[c]), abs=1e-3), (ra["snt_id"], c)
    assert TMet.MetricsTrackerNoASR is TMet.MetricsTracker


def test_wav_chunk_inference_is_the_jax_packages():
    """A tiny ConvTasNet over 2.3 s in 0.5 s windows at a 0.25 s hop, three
    windows a batch (the last batch zero-filled)."""
    import sonicsim_tpu.models as JM
    from sonicsim_tpu_torch import bridge

    cfg = dict(N=16, L=16, B=8, H=16, X=2, R=1, num_spks=2)
    jm = JM.ConvTasNet(**cfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), np.zeros((1, 800),
                                                                              np.float32)))
    model = ConvTasNet(**cfg, device="cpu").eval()
    model.load_state_dict(bridge.convtasnet_state_dict(params))
    mix = _audio(2.3, seed=8)
    args = dict(sample_rate=SR, target_length=0.5, hop_length=0.25, batch_size=3, n_tracks=2)
    apply = jax.jit(jm.apply)
    ref = j_chunked(lambda b: np.asarray(apply(params, b)), mix, **args)
    got = wav_chunk_inference(make_forward(model), mix, device="cpu", **args)
    assert got.shape == ref.shape == (2, mix.size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # a tensor keeps its own device; over a mesh of two CPU devices the
    # module's replicas take three windows each (tests/test_torch_mesh_render.py
    # holds the mesh to JAX's)
    same = wav_chunk_inference(make_forward(model), torch.from_numpy(mix), **args)
    np.testing.assert_array_equal(same.numpy(), got.numpy())
    sharded = wav_chunk_inference(model, mix, mesh=Mesh(["cpu", "cpu"]), device="cpu", **args)
    np.testing.assert_allclose(sharded.numpy(), got.numpy(), rtol=0, atol=2e-5)
    with pytest.raises(TypeError, match="nn.Module"):
        wav_chunk_inference(make_forward(model), mix, mesh=Mesh(["cpu"]), device="cpu", **args)


def test_test_cli_scores_mos_columns(served, weights):  # noqa: F811
    """``scripts.test --dnsmos_dir --sigmos_path --no_pesq`` over a fixed
    evaluation tree: the dnsmos and seven SigMOS columns, as the JAX
    script's flow scores them with its own executor."""
    fixed = served["root"] / "fixed"
    generate_fixed_eval.main(["--in_dir", str(served["split"]), "--out_dir", str(fixed),
                              "--seed", "2", "--device", "cpu"])
    cfg = load_config(served["conf"])
    cfg["datas"]["test_dir"] = str(fixed)
    save_config(cfg, served["root"] / "mos.yaml")
    test_cli.main(["--conf_dir", str(served["root"] / "mos.yaml"), "--dnsmos_dir",
                   str(weights / "dnsmos"), "--sigmos_path", str(weights / "sigmos.onnx"),
                   "--no_pesq", "--limit", "1", "--device", "cpu"])
    fwd = _jax_forward(served["jm"], served["params"])
    tracker = JMet.MetricsTracker(served["root"] / "jax.csv", extra_metrics={
        "dnsmos": JMet.make_dnsmos(weights / "dnsmos"),
        **JMet.make_sigmos_all(weights / "sigmos.onnx")})
    ds = JD.MovingTestDataset(speech_dir=str(fixed), sample_rate=SR, num_spks=2,
                              return_path=True)
    mix, targets, folder = ds[0]
    for s, e in test_cli.metadata_segments(folder, mix.shape[-1]):
        est = np.asarray(fwd(served["params"], mix[None, s:e]))[0]
        tracker(mix[s:e], targets[:, s:e], est, f"{Path(folder).name}:{s}")
    tracker.final()
    with open(served["results"] / "metrics.csv") as f, open(served["root"] / "jax.csv") as g:
        ours, ref = list(csv.DictReader(f)), list(csv.DictReader(g))
    mos = ["dnsmos", *TMet.SigMOS.AXES]
    assert all(c in ours[0] for c in mos) and ours[0].keys() == ref[0].keys()
    assert [r["snt_id"] for r in ours] == [r["snt_id"] for r in ref]
    for a, b in zip(ours, ref):
        for c in mos:
            assert np.isfinite(float(a[c])) and float(a[c]) == pytest.approx(float(b[c]),
                                                                             abs=1e-4), c
