"""Serving the enhancement zoo with the port: ``to_waveform``'s enhancement
branches against the JAX package's, the GaGNet family's included, bf16
for it, every config of ``configs/enhancement/`` built through its
``_target_``, the inference CLI on an enhancement pack without jax, the
remix evaluation (task enhancement) against the same flow through the JAX
package's functions, bf16 by model (served, training refused or refused),
and the streaming CLI's default device.

Tolerances: ``to_waveform`` within 1e-5 · max|ref|; the evaluation's columns
as tests/test_torch_serve.py holds them (SI-SNR(i) 1e-3 dB, SDR(i) 1e-2 dB,
STOI 1e-4).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import sonicsim_tpu.dataset.sampler as JD
import sonicsim_tpu.infer as JI
import sonicsim_tpu.metrics as JMet
import sonicsim_tpu.models as JM
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.infer import to_waveform
from sonicsim_tpu_torch.scripts import audio_test, stream
from sonicsim_tpu_torch.utils import instantiate, read_wav, save_config, write_wav

from test_torch_enh_models import SMALL, jax_params, port
from test_torch_gagnet import SMALL as GAG_SMALL
from test_torch_serve import COLUMN_TOL, SR, _read_csv, _split
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
GAGNET_FAMILY = ("GaGNet", "G2Net", "TaylorSENet")


def _outputs(name, rng, b=2, t=3200):
    """A synthetic output of model ``name``'s kind, as numpy."""
    if name in ("Fullband", "FullSubnet"):
        f, fr = 129, t // 128 + 1
        return (rng.uniform(-9, 9, (b, 2, f, fr)).astype(np.float32),
                rng.standard_normal((b, f, fr)).astype(np.float32),
                rng.standard_normal((b, f, fr)).astype(np.float32))
    if name == "FRCRN":
        return (rng.standard_normal((b, t)).astype(np.float32),
                [rng.standard_normal((b, t)).astype(np.float32) for _ in range(6)])
    if name == "SuDORMRF":
        return rng.standard_normal((b, 1, t + 7)).astype(np.float32)
    if name in ("GaGNet", "G2Net"):  # the stage spectra (B, 2, F, T)
        return [rng.standard_normal((b, 2, 129, t // 128 + 1)).astype(np.float32)
                for _ in range(2)]
    if name == "TaylorSENet":  # (B, 2, T, F)
        return rng.standard_normal((b, 2, t // 128 + 1, 129)).astype(np.float32)
    return rng.standard_normal((b, t)).astype(np.float32)


def _to_torch(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_to_torch(o) for o in out)
    return torch.from_numpy(out)


@pytest.mark.parametrize("name", ["Fullband", "FullSubnet", "FRCRN", "DCCRN", "BSRNNESPNet",
                                  "SuDORMRF", *GAGNET_FAMILY])
def test_to_waveform_branches(name):
    cfg = dict(SMALL.get(name, GAG_SMALL.get(name, {})),
               **({"num_sources": 1} if name == "SuDORMRF" else {}))
    out = _outputs(name, np.random.default_rng(0))
    want = np.asarray(JI.to_waveform(JM.get(name)(**cfg), jax.tree.map(jnp.asarray, out), 3200))
    got = to_waveform(TM.get(name)(**cfg, device="cpu"), _to_torch(out), 3200).numpy()
    assert got.shape == want.shape == (2, 1, 3200)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


@pytest.mark.parametrize("name", GAGNET_FAMILY)
def test_the_gagnet_family_is_refused(name):
    """GaGNet and G2Net refuse bf16 serving and training, naming the gate
    their full-width bf16 misses in both packages; TaylorSENet serves and
    trains in bf16 (tests/test_torch_bf16_enh.py holds both): its served
    waveform lies within rel-L2 0.05 of float32, and a bf16 step takes a
    finite loss."""
    from sonicsim_tpu_torch.infer import bf16_forward
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step

    torch.manual_seed(0)
    model = TM.get(name)(**GAG_SMALL[name], device="cpu")
    if name != "TaylorSENet":
        with pytest.raises(NotImplementedError, match=f"{name}.*0.05 gate"):
            bf16_forward(model)
        with pytest.raises(NotImplementedError, match=f"{name}.*0.05 gate"):
            make_train_step(model, None, make_optimizer(model.parameters()), "bf16")
        return
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3200)).astype(np.float32))
    with torch.inference_mode():
        want = to_waveform(model, model(x), 3200)
        got = to_waveform(model, bf16_forward(model)(x), 3200)
    assert got.dtype == torch.float32
    assert 0 < float((got - want).norm() / want.norm()) < 0.05
    step = make_train_step(model, lambda e, r: e.square().mean(),
                           make_optimizer(model.parameters()), "bf16")
    assert bool(torch.isfinite(step(x, x[:, None])))


def _enh_nodes():
    for path in sorted((ROOT / "configs" / "enhancement").glob("*.yaml")):
        yield path.stem, yaml.safe_load(path.read_text())["model"]


@pytest.mark.parametrize("stem,node", list(_enh_nodes()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_enhancement_configs_build_through_the_port(stem, node):
    """Each enhancement config's ``_target_`` resolves to the port's class at
    full width (chip_smoke.py's phase 13 drives the same node)."""
    name = node["_target_"].rsplit(".", 1)[1]
    model = instantiate(node, device="cpu")
    assert type(model) is TM.get(name) and type(model).__module__.startswith("sonicsim_tpu_torch.")
    args = {k: v for k, v in node.items() if k != "_target_"}
    assert chip_smoke.ENH_MODELS[stem] == (name, args)
    got = model.model_args()
    assert {k: list(got[k]) if isinstance(got[k], tuple) else got[k] for k in args} == args


def test_inference_cli_runs_an_enhancement_pack_without_jax(tmp_path):
    """``python -m sonicsim_tpu_torch.scripts.inference`` on a small
    FullSubnet pack on the CPU: one track, as the JAX forward,
    ``to_waveform`` and stitcher give it over 1 s windows, and no jax
    module imported."""
    cfg = SMALL["FullSubnet"]
    params = jax_params("FullSubnet", cfg)
    TM.save_model(port("FullSubnet", cfg, params), tmp_path / "fsn.pkl")
    mix = (0.1 * np.random.default_rng(2).standard_normal((1, 24000))).astype(np.float32)
    write_wav(tmp_path / "mix.wav", mix, SR, encoding="float32")
    r = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "sonicsim_tpu_torch.scripts.inference", "--model_path",
                        str(tmp_path / "fsn.pkl"), "--mix", str(tmp_path / "mix.wav"),
                        "--out_dir", str(tmp_path / "out"), "--segment_seconds", "1.0",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    imported = {line.split("|")[-1].strip() for line in r.stderr.splitlines()
                if line.startswith("import time:")}
    assert "sonicsim_tpu_torch.models.fullsubnet" in imported
    assert not sorted(m for m in imported
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sonicsim_tpu"))
    got, sr = read_wav(tmp_path / "out" / "s1_est.wav")
    assert sr == SR and got.shape == (1, 24000) and not (tmp_path / "out" / "s2_est.wav").exists()
    jm = JM.FullSubnet(**cfg)
    fwd = jax.jit(lambda p, x: JI.to_waveform(jm, jm.apply(p, x), x.shape[-1]))
    segments = []
    for s in range(0, 24000, SR):
        chunk = mix[0, s:s + SR]
        pad = SR - len(chunk)
        segments.append(np.asarray(fwd(params, np.pad(chunk, (0, pad))[None]))[0][..., :SR - pad])
    want = JI.concatenate_tracks(JI.stitch_segments(segments, SR))[0]
    np.testing.assert_allclose(got[0], want, rtol=0, atol=REL * np.abs(want).max() + 2.0 / 32768)


def test_remix_evaluation_of_an_enhancement_model(tmp_path):
    """``audio_test --task enhancement`` over a tiny split with a small
    Fullband pack, against the JAX forward and tracker on the same remix."""
    split = _split(tmp_path)
    cfg = SMALL["Fullband"]
    params = jax_params("Fullband", cfg)
    exp = tmp_path / "exp"
    JM.save_model(JM.Fullband(**cfg), jax.tree.map(jnp.asarray, params),
                  exp / "fb" / "best_model.pkl")
    save_config({"exp": {"dir": str(exp), "name": "fb"},
                 "datas": {"test_dir": str(split), "sample_rate": SR, "num_spks": 1}},
                tmp_path / "cfg.yaml")
    res = audio_test.main(["--conf_dir", str(tmp_path / "cfg.yaml"), "--task", "enhancement",
                           "--no_pesq", "--seed", "3", "--device", "cpu"])
    assert res["mixtures"] == 2 and res["spans"] == 2

    jm = JM.Fullband(**cfg)
    fwd = jax.jit(lambda p, x: JI.to_waveform(jm, jm.apply(p, x), x.shape[-1]))
    tracker = JMet.MetricsTracker(tmp_path / "jax.csv")
    ds = JD.MovingTestEvalDataset(str(split), task="enhancement", seed=3)
    for i in range(len(ds)):
        mix, targets, folder = ds[i]
        tracker(mix, targets, np.asarray(fwd(params, mix[None]))[0], f"{Path(folder).name}:0")
    tracker.final()
    ours = _read_csv(exp / "fb" / "results" / "metrics_remix-noise.csv")
    ref = _read_csv(tmp_path / "jax.csv")
    assert [r["snt_id"] for r in ours] == [r["snt_id"] for r in ref] and len(ours) == 2 + 2
    for a, b in zip(ours, ref):
        for col in ("si-snr", "si-snr_i", "sdr", "sdr_i", "stoi"):
            assert float(a[col]) == pytest.approx(float(b[col]), abs=COLUMN_TOL[col]), col


@pytest.mark.parametrize("name", ["Fullband", "DCCRN", "FRCRN"])
def test_bf16_is_refused_for_the_enhancement_zoo(name):
    """What bf16 each of three enhancement models takes: Fullband serves in
    it and refuses bf16 training (the JAX package's bf16 step raises on its
    mixed-shape outputs); DCCRN serves within rel-L2 0.05 of float32; FRCRN
    refuses bf16, over the gate (tests/test_torch_bf16_enh.py)."""
    from sonicsim_tpu_torch.infer import bf16_forward
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step

    torch.manual_seed(0)
    model = TM.get(name)(**SMALL[name], device="cpu")
    if name == "FRCRN":
        with pytest.raises(NotImplementedError, match="FRCRN.*0.05 gate"):
            bf16_forward(model)
        return
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3200)).astype(np.float32))
    with torch.inference_mode():
        want = to_waveform(model, model(x), 3200)
        got = to_waveform(model, bf16_forward(model)(x), 3200)
    assert 0 < float((got - want).norm() / want.norm()) < 0.05
    if name == "Fullband":
        with pytest.raises(NotImplementedError, match="Fullband.*sonicsim_tpu/train/trainer.py:123"):
            make_train_step(model, None, make_optimizer(model.parameters()), "bf16")


def test_the_streaming_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    TM.save_model(TM.SkiMNet(input_dim=8, layer=2, unit=8, segment_size=10, causal=True,
                             seg_overlap=False, device="cpu"), tmp_path / "skim.pkl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.main(["--model_path", str(tmp_path / "skim.pkl"), "--mix", "x.wav"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.FullSubnet(**SMALL["FullSubnet"])
