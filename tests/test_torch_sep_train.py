"""Training the separation zoo with the port, against the JAX package, on
the CPU:

* one float32 train step per separation config's model at small width
  (TDANet in both attention modes), with the config's Adam (DPTNet's
  weight decay takes the adamw path in both packages) and PIT neg-SNR,
  against the JAX package's ``make_train_step`` over optax, from the same
  seeded weights carried across by the bridge: the losses over 3 steps,
  step 1's clipped gradients under a clip that fires, and the parameters
  after, with the keys the two trees train held equal;
* every configs/separation/*.yaml's loss, metric and optimizer built
  through the port and taking one finite step of its model at small width;
* ``scripts.train.train_from_config`` fitting a small zoo config over a
  generated-style split.

Tolerances, as tests/test_torch_train_step.py's DPRNN case: losses within
rel 1e-5; step 1's clipped gradients within 1e-5 · max|g|; parameters
after 3 steps within 1e-6, but an element whose step-1 gradient is float
noise (|g| < 1e-6 · max|g|) is held to 2 · lr · steps (Adam moves it by
about lr a step on the noise's sign). The targets are a tenth of the
mixture's scale, so the −SNR loss sits near 20 dB, away from 0 where a
relative bound is ill-posed.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import sonicsim_tpu.models as JM
from sonicsim_tpu.losses import PairwiseNegSDR as JNegSDR
from sonicsim_tpu.losses import PITLossWrapper as JPIT
from sonicsim_tpu.train import make_optimizer as j_make_optimizer
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.losses import PairwiseNegSDR, PITLossWrapper
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.scripts.train import train_from_config
from sonicsim_tpu_torch.train import make_optimizer, make_train_step
from sonicsim_tpu_torch.utils import instantiate, write_wav

from test_torch_skim import SMALL as SKIM_SMALL
from test_torch_train_step import _clip_fired, _optax_steps, _unclipped_norm
from test_torch_zoo_models import SMALL as ZOO_SMALL
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL, GRAD_REL, PARAM_ATOL, NOISE_REL = 1e-5, 1e-5, 1e-6, 1e-6
STEPS = 3
T = 1200
# The small widths of tests/test_torch_zoo_models.py and tests/test_torch_skim.py,
# by config, in porting order; TDANet in both attention modes.
CASES = {
    "sudormrf": ("SuDORMRF", ZOO_SMALL["SuDORMRF"]),
    "afrcnn": ("AFRCNN", ZOO_SMALL["AFRCNN"]),
    "tdanet": ("TDANet", ZOO_SMALL["TDANet"]),
    "tdanet-torch_compat": ("TDANet", dict(ZOO_SMALL["TDANet"], torch_compat=True)),
    "dptnet": ("DPTNetModel", ZOO_SMALL["DPTNetModel"]),
    "mossformer": ("MossFormer", ZOO_SMALL["MossFormer"]),
    "mossformer2": ("MossFormer2", ZOO_SMALL["MossFormer2"]),
    "bsrnn": ("BSRNN", ZOO_SMALL["BSRNN"]),
    "tfgridnet": ("TFGridNet", ZOO_SMALL["TFGridNet"]),
    "skim": ("SkiMNet", dict(SKIM_SMALL, causal=False, seg_overlap=True)),
    "dprnn": ("DPRNNTasNet", ZOO_SMALL["DPRNNTasNet"]),
}
SMALL_BY_CONFIG = {"convtasnet": dict(N=16, L=8, B=8, H=16, P=3, X=2, R=1),
                   **{stem.split("-")[0]: cfg for stem, (_, cfg) in CASES.items()}}


def _config(stem: str) -> dict:
    return yaml.safe_load((ROOT / "configs" / "separation" / f"{stem}.yaml").read_text())


def _batch(t=T):
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((2, t)).astype(np.float32)
    tgt = (0.1 * rng.standard_normal((2, 2, t))).astype(np.float32)
    return mix, tgt


def _seeded(name: str, cfg: dict):
    """The port's model at ``cfg`` with chip_smoke.py's seeded draw in the
    JAX package's flax layout (every leaf off its init), and that tree."""
    model = TM.get(name)(**cfg, device="cpu")
    args = model.model_args()
    params = chip_smoke.seeded_flax(TB.to_flax(name, model.state_dict(), args), 0)
    model.load_state_dict(TB.to_state_dict(name, params, args))
    return model, params


def _pit():
    return (PITLossWrapper(PairwiseNegSDR("snr"), pit_from="pw_mtx", threshold_byloss=False),
            JPIT(JNegSDR("snr"), pit_from="pw_mtx", threshold_byloss=False))


@pytest.mark.parametrize("case", list(CASES))
def test_f32_step_matches_optax(case):
    name, cfg = CASES[case]
    opt_cfg = _config(case.split("-")[0])["optimizer"]
    lr, wd = float(opt_cfg["lr"]), float(opt_cfg["weight_decay"])
    mix, tgt = _batch()
    loss, j_loss = _pit()
    model, p0 = _seeded(name, cfg)
    args = model.model_args()
    # A clip a quarter of the step-1 gradient norm: it fires on both sides.
    clip = float(np.float32(0.25 * _unclipped_norm(model, loss, mix, tgt)))
    opt = j_make_optimizer(lr, weight_decay=wd, clip_norm=clip)
    params, _, j_losses, j_clipped = _optax_steps(JM.get(name)(**cfg), j_loss, opt, p0, mix, tgt,
                                                  STEPS)
    assert _clip_fired(j_clipped, clip)

    optimizer = make_optimizer(model.parameters(), lr, wd)
    assert isinstance(optimizer, torch.optim.AdamW) == (wd > 0)
    step = make_train_step(model, loss, optimizer, clip_norm=clip)
    losses = []
    for i in range(STEPS):
        losses.append(float(step(torch.from_numpy(mix), torch.from_numpy(tgt))))
        if i == 0:
            # A parameter the forward never reads (TDANet's last
            # ``loc_glo_fus``, as in the reference) has no gradient: optax's
            # is 0 there, and neither Adam moves it.
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters() if p.requires_grad}
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_REL)

    # optax trains every leaf of the flax tree; the port every parameter but
    # the frozen LSTM ``bias_hh``, which the bridge keeps at 0 (flax's one
    # bias per gate sits in ``bias_ih``).
    want = TB.to_state_dict(name, jax.tree.map(np.asarray, j_clipped), args)
    frozen = sorted(n for n, p in model.named_parameters() if not p.requires_grad)
    assert all(".bias_hh_" in n for n in frozen)
    assert sorted(set(want) - set(grads)) == frozen
    assert not set(grads) - set(want)
    g_max = max(float(g.abs().max()) for g in want.values())
    for n, g in grads.items():
        np.testing.assert_allclose(g, want[n], rtol=0, atol=GRAD_REL * g_max, err_msg=n)

    final = TB.to_state_dict(name, jax.tree.map(np.asarray, params), args)
    for n, p in model.state_dict().items():
        if n not in want:  # buffers: running statistics, none in training
            continue
        atol = torch.where(want[n].abs() < NOISE_REL * g_max, 2 * lr * STEPS, PARAM_ATOL)
        err = (p - final[n]).abs()
        assert bool((err <= atol).all()), (n, float(err.max()))
        assert p.dtype == torch.float32


def _small_node(stem: str) -> dict:
    node = _config(stem)["model"]
    small = dict(SMALL_BY_CONFIG[stem])
    if stem == "convtasnet":  # its config node holds ConvTasNet's own fields
        small.update(num_spks=2)
    return {**node, **small}


@pytest.mark.parametrize("stem", sorted(p.stem for p in (ROOT / "configs" / "separation")
                                        .glob("*.yaml")))
def test_every_config_takes_a_step(stem):
    """The config's model node at small width, its loss and metric nodes and
    its optimizer and clip, built through the port; one step moves the
    weights with finite gradients, and the metric is finite."""
    cfg = _config(stem)
    torch.manual_seed(0)
    model = instantiate(_small_node(stem), device="cpu")
    loss_fn, metric_fn = instantiate(cfg["loss"]), instantiate(cfg["metrics"])
    for obj in (model, loss_fn, metric_fn):
        assert type(obj).__module__.startswith("sonicsim_tpu_torch.")
    ocfg = cfg.get("optimizer", {})
    optimizer = make_optimizer(model.parameters(), float(ocfg.get("lr", 1e-3)),
                               float(ocfg.get("weight_decay", 0.0)))
    step = make_train_step(model, loss_fn, optimizer,
                           clip_norm=cfg["trainer"]["gradient_clip_val"])
    mix, tgt = _batch(800)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert bool(torch.isfinite(step(torch.from_numpy(mix), torch.from_numpy(tgt))))
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert moved and all(p.grad is None or bool(torch.isfinite(p.grad).all())
                         for p in model.parameters())
    with torch.no_grad():
        assert bool(torch.isfinite(metric_fn(model(torch.from_numpy(mix)),
                                             torch.from_numpy(tgt))))


def _split(root: Path, seconds=0.5):
    """A generated split's train leaves (three moving tracks and a noise
    track) and a fixed val set (``mix.wav``, ``s1.wav``, ``s2.wav``)."""
    rng = np.random.default_rng(11)
    n = int(16000 * seconds)
    for i in range(2):
        d = root / "train" / f"scene{i}" / "0"
        d.mkdir(parents=True)
        for k in ("moving_audio_1", "moving_audio_2", "moving_audio_3", "noise_audio"):
            write_wav(d / f"{k}.wav", (0.1 * rng.standard_normal((1, n))).astype(np.float32),
                      16000)
    for i in range(2):
        d = root / "val" / f"{i}"
        d.mkdir(parents=True)
        s = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
        for k in range(2):
            write_wav(d / f"s{k + 1}.wav", s[k:k + 1], 16000)
        write_wav(d / "mix.wav", s.sum(0, keepdims=True), 16000)
    return root / "train", root / "val"


def test_train_from_config_fits_a_zoo_config(tmp_path):
    """dptnet.yaml (its adamw) at small width, one epoch over two 0.5 s
    samples, val on the fixed set; the best model reloads through
    ``from_pretrain`` as the trained one's function."""
    train, val = _split(tmp_path)
    cfg = _config("dptnet")
    cfg.update(model=_small_node("dptnet"), exp={"dir": str(tmp_path / "exp"), "name": "dpt"})
    cfg["datas"].update(train_dir=str(train), val_dir=str(val), test_dir=str(val),
                        num_samples=2, duration=0.5)
    trainer = train_from_config(cfg, "cpu", max_epochs=1)
    assert [r["epoch"] for r in trainer.history] == [-1, 0]
    assert all(np.isfinite(r["val_loss"]) for r in trainer.history)
    assert trainer.weight_decay == 1e-5 and trainer.lr == 4e-4
    best = TM.from_pretrain(tmp_path / "exp" / "dpt" / "best_model.pkl", device="cpu")
    x = torch.from_numpy(_batch(800)[0])
    with torch.no_grad():
        want = trainer.model.eval()(x)
        np.testing.assert_allclose(best(x), want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("stem", list(chip_smoke.SEP_OPTIMIZERS))
def test_chip_smoke_optimizers_are_the_configs(stem):
    """Phase 15's model, optimizer, clip and batch (written out for a host
    without pyyaml) are the config's."""
    cfg = _config(stem)
    name, lr, wd = chip_smoke.SEP_OPTIMIZERS[stem]
    assert cfg["model"] == {"_target_": f"sonicsim_tpu.models.{name}",
                            **chip_smoke.SEP_TRAIN["models"][name]}
    assert (lr, wd) == (cfg["optimizer"]["lr"], cfg["optimizer"]["weight_decay"])
    assert cfg["trainer"]["gradient_clip_val"] == chip_smoke.SEP_TRAIN["clip"]
    assert cfg["datas"]["batch_size"] == chip_smoke.SEP_TRAIN["batch"]
    assert cfg["loss"] == {"_target_": "sonicsim_tpu.losses.PITLossWrapper",
                           "loss_func": {"_target_": "sonicsim_tpu.losses.PairwiseNegSDR",
                                         "sdr_type": "snr"},
                           "pit_from": "pw_mtx", "threshold_byloss": False}


@pytest.mark.parametrize("stem", ["dprnn", "skim"])
def test_phase_15_step_check_on_the_cpu(stem):
    """Phase 15's check (``sep_train_fresh`` under ``enh_step_check``) with
    the CPU on both sides at small width: the sides agree exactly, the
    step-1 gradients are the ones ``make_train_step`` takes, the CPU's
    float32 distance from float64 is measured and the bound follows the
    rule; the "device" float64 side, the CPU again, equals the CPU's
    float64 step."""
    name = chip_smoke.SEP_OPTIMIZERS[stem][0]
    cfg = dict(chip_smoke.SEP_TRAIN, models={name: SMALL_BY_CONFIG[stem]})
    model, _ = _seeded(name, SMALL_BY_CONFIG[stem])
    fresh = chip_smoke.sep_train_fresh(stem, model.state_dict(), cfg)
    mix, tgt = (torch.from_numpy(a) for a in _batch(800))
    chk = chip_smoke.enh_step_check(fresh, mix, tgt, "cpu")
    assert chk["loss_rel"] == 0 and chk["grad_err"] == 0 and chk["device_f64_err"] == 0
    assert chk["kinks"] > 0 and chk["flip_rel"] <= chip_smoke.KINK_REL
    assert 0 < chk["cpu_vs_f64"] < 1e-3
    rel = max(chip_smoke.TRAIN_GRAD_REL, chip_smoke.ILL_FACTOR * chk["cpu_vs_f64"])
    assert chk["bound"] == rel * chk["grad_max"] and not chip_smoke.step_check_failures(chk)
    _, step = fresh("cpu")
    want = float(step(mix, tgt))
    assert chk["loss"] == (want, want)


def test_kink_tape_replays_functional_kinks():
    """``chip_smoke._kink_tape`` also records and replays the kinks a model
    calls as functions (``torch.relu``, ``F.relu``, ``Tensor.relu``, a
    captured ``torch.relu``, a comparison with 0 inside ``torch.where``),
    as the zoo's encoders, masks and TF-GridNet's per-head PReLU do."""
    import torch.nn.functional as F

    relu = torch.relu  # captured, as layers.get_activation holds it

    class Net(torch.nn.Module):
        def forward(self, x):
            x = torch.relu(x) - 0.5
            x = F.relu(x) - 0.25
            x = x.relu() - 0.125
            x = relu(x - 0.0625)
            return torch.where(x - 0.03125 >= 0, x, 0.5 * x)

    x = torch.tensor([[1.0, 0.5, 0.75, 0.9, 2.0]])
    tape: list = []
    net = Net()
    chip_smoke._kink_tape(net, tape, None)
    net(x)
    assert len(tape) == 5  # each kink's side, in call order
    assert tape[1].tolist() == [[True, False, True, True, True]]  # F.relu of [.5, 0, ...]
    flips = dict(n=0, rel=0.0)
    replay = Net()
    chip_smoke._kink_tape(replay, tape, flips)
    y = (x + torch.tensor([[0.0, 1e-6, 0.0, 0.0, 0.0]])).requires_grad_()
    out = replay(y)
    # 1e-6 reaches F.relu on the other side of 0 from the recording: it takes
    # the recorded branch, in value and in gradient; max|x| of that call 1.5
    crossed = float(torch.relu(y[0, 1].detach()) - 0.5)  # 1e-6 in float32
    assert flips["n"] == 1 and flips["rel"] == pytest.approx(crossed / 1.5, rel=1e-6)
    out.sum().backward()
    assert y.grad[0, 1] == 0.0 and y.grad[0, 0] == 1.0


def test_kink_tape_replays_the_loss_minimum():
    """The mode ``chip_smoke._kink_tape`` returns records the permutation
    PIT's ``amin`` / ``argmin`` pick and replays it where the candidates
    swap order within rounding: the replayed minimum is the recorded
    permutation's loss, in value and in gradient, and each call counts the
    row sent apart with the gap as a share of max|x|."""
    from sonicsim_tpu_torch.losses.pit import find_best_perm

    def pairwise(d):  # identity permutation 1 + d/2, swapped 1
        return torch.tensor([[[1.0, 1.0], [1.0, 1.0 + d]]], dtype=torch.float64)

    tape: list = []
    with chip_smoke._kink_tape(torch.nn.Identity(), tape, None):
        _, perm = find_best_perm(pairwise(-2e-6))
    assert perm.tolist() == [[0, 1]] and len(tape) == 2  # amin's minima, argmin's
    flips = dict(n=0, rel=0.0)
    pw = pairwise(2e-6).requires_grad_()
    with chip_smoke._kink_tape(torch.nn.Identity(), tape, flips):
        low, perm = find_best_perm(pw)
    assert perm.tolist() == [[0, 1]] and float(low.detach()) == pytest.approx(1 + 1e-6, rel=1e-12)
    assert flips["n"] == 2 and flips["rel"] == pytest.approx(1e-6 / (1 + 1e-6), rel=1e-6)
    low.sum().backward()
    assert pw.grad.tolist() == [[[0.5, 0.0], [0.0, 0.5]]]
