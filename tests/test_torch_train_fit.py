"""``Trainer.fit`` and the train CLI of the port against the JAX package's,
on one tiny SonicSet-shaped split on disk, on the CPU.

Tolerances: the ``metrics.jsonl`` losses of the two packages within rel
1e-5 over 2 epochs from the same weights (float32 steps summed in another
order, as in test_torch_train_step.py; measured 4e-7);
the JAX package's forward of the port's ``best_model.pkl`` within 1e-5 ·
max|ref| of the port's. A resumed run equals an uninterrupted one exactly
(the same float32 ops on the CPU in the same order).
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import sonicsim_tpu.dataset.datamodule as jdm
import sonicsim_tpu.models as JM
from sonicsim_tpu.losses import PairwiseNegSDR as JNegSDR
from sonicsim_tpu.losses import PITLossWrapper as JPIT
from sonicsim_tpu.train import Trainer as JTrainer
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.dataset import MovingDataModule
from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
from sonicsim_tpu_torch.models import ConvTasNet, from_pretrain
from sonicsim_tpu_torch.scripts import train as train_cli
from sonicsim_tpu_torch.train import Trainer
from sonicsim_tpu_torch.train import trainer as trainer_mod
from sonicsim_tpu_torch.utils import write_wav
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SR = 16000
CFG = dict(N=16, L=16, B=8, H=16, P=3, X=1, R=1, num_spks=2)
LOSS_REL, FWD_REL = 1e-5, 1e-5
DURATION = 0.25
CROP = int(SR * DURATION)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A train tree (leaf folders of the five generated tracks, 1 s) and a
    fixed val tree (mix, s1, s2), from a numpy seed."""
    root = tmp_path_factory.mktemp("split")
    rng = np.random.default_rng(0)
    for k in range(2):
        d = root / "train" / f"scene{k}" / f"mix{k}"
        d.mkdir(parents=True)
        for name in ("moving_audio_1", "moving_audio_2", "moving_audio_3", "noise_audio"):
            write_wav(d / f"{name}.wav", (0.1 * rng.standard_normal(SR)).astype(np.float32), SR)
    for k in range(3):
        d = root / "val" / f"sample{k}"
        d.mkdir(parents=True)
        s = (0.1 * rng.standard_normal((2, SR // 2))).astype(np.float32)
        for name, x in (("s1", s[0]), ("s2", s[1]), ("mix", s.sum(0))):
            write_wav(d / f"{name}.wav", x, SR)
    return root


def _dm_args(split):
    return dict(train_dir=str(split / "train"), val_dir=str(split / "val"),
                test_dir=str(split / "val"), duration=DURATION, num_samples=4, batch_size=2)


def _losses():
    return (PITLossWrapper(PairwiseNegSDR("snr"), threshold_byloss=False),
            PITLossWrapper(PairwiseNegSDR("sisdr"), threshold_byloss=False))


def _port_trainer(exp_dir, max_epochs, params=None, **kw):
    model = ConvTasNet(**CFG, device="cpu")
    if params is not None:
        model.load_state_dict(bridge.convtasnet_state_dict(params))
    loss, metric = _losses()
    return Trainer(model=model, loss_fn=loss, metric_fn=metric, lr=1e-3,
                   max_epochs=max_epochs, save_top_k=2, exp_dir=exp_dir, **kw)


def _records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_fit_matches_jax_and_jax_reads_the_best_model(split, tmp_path):
    key = jax.random.PRNGKey(0)
    init = jax.jit(JM.ConvTasNet(**CFG).init)  # init_params(key, CROP), jitted
    params = jax.tree.map(np.array, init(key, jax.numpy.zeros((1, CROP), np.float32)))
    jdmod = jdm.MovingDataModule(**_dm_args(split))
    jt = JTrainer(model=JM.ConvTasNet(**CFG),
                  loss_fn=JPIT(JNegSDR("snr"), threshold_byloss=False),
                  metric_fn=JPIT(JNegSDR("sisdr"), threshold_byloss=False),
                  lr=1e-3, max_epochs=2, save_top_k=2, exp_dir=tmp_path / "jax", n_devices=1)
    jt.fit(jdmod.train_batches, lambda: jdmod.val_batches(crop=CROP), rng=key, example_len=CROP)

    dm = MovingDataModule(**_dm_args(split))
    trainer = _port_trainer(tmp_path / "port", 2, params)
    state = trainer.fit(dm.train_batches, lambda: dm.val_batches(crop=CROP))
    assert state.step == 4

    ours, ref = _records(tmp_path / "port" / "metrics.jsonl"), _records(tmp_path / "jax" / "metrics.jsonl")
    assert [r["epoch"] for r in ours] == [r["epoch"] for r in ref] == [-1, 0, 1]
    for a, b in zip(ours, ref):
        assert set(a) == set(b) and a["lr"] == b["lr"]
        for k in ("train_loss", "val_loss"):
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=LOSS_REL), (a, b)
    top = json.loads((tmp_path / "port" / "best_k_models.json").read_text())
    assert len(top) == 2 and all(Path(p).exists() for p in top)
    best = min(top, key=top.get)
    assert (tmp_path / "port" / "best_model.pkl").read_bytes() == Path(best).read_bytes()
    assert {"meta.json", "state.pt"} <= {p.name for p in (tmp_path / "port" / "checkpoints" / "last").iterdir()}

    jmodel, jparams = JM.from_pretrain(tmp_path / "port" / "best_model.pkl")
    x = np.random.default_rng(5).standard_normal((2, CROP)).astype(np.float32)
    ref_out = np.asarray(jmodel.apply(jparams, x))
    with torch.inference_mode():
        got = from_pretrain(tmp_path / "port" / "best_model.pkl", device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref_out, rtol=0, atol=FWD_REL * np.abs(ref_out).max())


def test_resume_equals_an_uninterrupted_run(split, tmp_path):
    dm = MovingDataModule(**_dm_args(split))

    def fit(exp, epochs, resume=False):
        torch.manual_seed(0)
        trainer = _port_trainer(tmp_path / exp, epochs)
        return trainer, trainer.fit(dm.train_batches, lambda: dm.val_batches(crop=CROP),
                                    resume=resume)

    _, state = fit("cut", 2)
    meta = json.loads((tmp_path / "cut" / "checkpoints" / "last" / "meta.json").read_text())
    assert meta["epoch"] == 1 and meta["step"] == 4
    resumed, state = fit("cut", 3, resume=True)
    assert [r["epoch"] for r in resumed.history] == [-1, 0, 1, 2] and state.step == 6
    whole, _ = fit("whole", 3)
    assert resumed.history[-1]["train_loss"] == whole.history[-1]["train_loss"]
    for (name, a), b in zip(resumed.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.equal(a, b), name
    # resume=True with no resume point starts fresh.
    fresh, _ = fit("fresh", 1, resume=True)
    assert [r["epoch"] for r in fresh.history] == [-1, 0]


def test_nan_val_epoch_never_enters_top_k(tmp_path):
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((4, 800)).astype(np.float32)
    tgt = rng.standard_normal((4, 2, 800)).astype(np.float32)
    calls = {"n": 0}

    def val_batches():
        calls["n"] += 1  # calls 1 and 2: the epoch -1 baseline and epoch 0
        yield (np.full_like(mix, np.nan) if calls["n"] <= 2 else mix), tgt

    trainer = _port_trainer(tmp_path, 2)
    trainer.fit(lambda epoch: iter([(mix, tgt)]), val_batches)
    assert not np.isfinite(trainer.history[1]["val_loss"])
    top = json.loads((tmp_path / "best_k_models.json").read_text())
    assert len(top) == 1 and all(np.isfinite(v) for v in top.values())


def test_single_iterator_loader_trains_every_batch_once(tmp_path, monkeypatch):
    """The first batch, peeked to size the mesh, is trained on once: on one
    device, and over two with the device count patched (as the JAX tests'
    conftest forces 8 devices)."""
    rng = np.random.default_rng(1)
    mix = rng.standard_normal((4, 800)).astype(np.float32)
    tgt = rng.standard_normal((4, 2, 800)).astype(np.float32)
    stream = iter([(mix, tgt), (mix, tgt)])
    state = _port_trainer(tmp_path, 1).fit(lambda epoch: stream)
    assert state.step == 2
    monkeypatch.setattr(trainer_mod, "available_devices",
                        lambda device_type: [torch.device(device_type)] * 2)
    stream = iter([(mix, tgt), (mix, tgt)])
    trainer = _port_trainer(tmp_path / "mesh", 1, n_devices=2)
    assert trainer.fit(lambda epoch: stream).step == 2 and trainer._batch_divisor == 2


def _tiny_config(split, exp_root):
    with open(ROOT / "configs" / "separation" / "convtasnet.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["exp"] = {"dir": str(exp_root), "name": "ctn"}
    cfg["datas"].update(_dm_args(split))
    cfg["model"].update(CFG)
    cfg["trainer"].update(max_epochs=1, precision="bf16")
    return cfg


def test_train_cli_runs_without_jax(split, tmp_path):
    """``python -m sonicsim_tpu_torch.scripts.train`` on the repo's config
    (cut to a tiny model and split), with ``-X importtime`` listing every
    module the process imported: none is jax or the JAX package."""
    conf = tmp_path / "cfg.yaml"
    conf.write_text(yaml.safe_dump(_tiny_config(split, tmp_path / "exp")))
    r = subprocess.run([sys.executable, "-X", "importtime", "-m", "sonicsim_tpu_torch.scripts.train",
                        "--conf_dir", str(conf), "--device", "cpu", "--max_epochs", "2"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    imported = {line.split("|")[-1].strip() for line in r.stderr.splitlines()
                if line.startswith("import time:")}
    assert "sonicsim_tpu_torch.train.trainer" in imported
    loaded = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "sonicsim_tpu"))
    assert not loaded, loaded
    exp = tmp_path / "exp" / "ctn"
    assert f"best model at {exp / 'best_model.pkl'}" in r.stdout
    assert [rec["epoch"] for rec in _records(exp / "metrics.jsonl")] == [-1, 0, 1]
    assert {"best_model.pkl", "config.yaml", "best_k_models.json"} <= {p.name for p in exp.iterdir()}
    with open(exp / "best_model.pkl", "rb") as f:
        assert pickle.load(f)["framework"] == "sonicsim_tpu"


def test_train_cli_defaults_to_the_card(split, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    conf = tmp_path / "cfg.yaml"
    conf.write_text(yaml.safe_dump(_tiny_config(split, tmp_path / "exp")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--conf_dir", str(conf)])
    assert not (tmp_path / "exp").exists()
