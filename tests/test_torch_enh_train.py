"""Training the enhancement zoo with the port, against the JAX package, on
the CPU:

* every loss and metric class of the enhancement configs, and the STFT,
  SI-SNRi and MixIT losses, on values and on the gradient with respect to
  the estimate (``jax.grad`` against ``torch.autograd.grad``), from the same
  seeded numpy estimates (spectra without zero bins);
* one float32 train step per loss family (cIRM, waveform SI-SNR, FRCRN,
  BSRNN-ESPnet, GaGNet, TaylorSENet) against the JAX package's
  ``make_train_step`` over its optax Adam with the configs' clip, from the
  same seeded weights: the loss, the clipped gradients and the parameters
  after the step. The waveform families train a small SuDORMRF (the
  SuDORMRF-enhancement config's model) and the FRCRN family a per-bin
  complex mask over FRCRN's own STFT pair, emitting FRCRN's output tuple:
  the loss is what the case holds (FRCRN's JAX train step at its fixed
  width takes minutes to compile; phase 14 of chip_smoke.py and
  tests/test_torch_enh_train_cuda.py step the full model);
* every configs/enhancement/*.yaml's loss and metric built through its
  ``_target_`` and taking one ``make_train_step`` step of its model at a
  small width; bf16 refused; ``train_from_config`` fitting one epoch of an
  enhancement config over a generated-style split.

Tolerances: loss values rel 1e-5 (float32 FFTs and sums in another order);
gradients 1e-5 · max|g| of the tensor; the train steps' losses rel 1e-5,
their clipped gradients 1e-5 · max|g| over the model, their parameters
after the step 1e-6, but where an element's gradient is under
1e-3 · max|g| over the model: Adam's first step moves a parameter by
lr · g / (|g| + eps), about lr times the gradient's sign, and a gradient
held to 1e-5 · max|g| fixes that sign only well above the bound (a conv
bias before an instance norm has a gradient of float noise alone); there,
2 · lr. FRCRN's loss weighs its mask error by the 642 mask channels and
goes through a (642 × 640) pseudo-inverse synthesis: its gradients are held
to 3e-5 · max|g| (measured 1.2e-5 in the train step).

FRCRN's loss is differentiated with respect to its estimates alone, not the
noisy waveform the model echoes (data in training): the ideal mask divides
by the noisy spectrum's power, and its gradient with respect to the noisy
input is ill-conditioned in float32 at weak bins.
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import sonicsim_tpu.losses as JL
import sonicsim_tpu.models as JM
from sonicsim_tpu.models import dccrn as JD
from sonicsim_tpu.train import make_optimizer as j_make_optimizer
from sonicsim_tpu.train import make_train_step as j_make_train_step
from sonicsim_tpu_torch import losses as TL
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.models import dccrn as TD
from sonicsim_tpu_torch.scripts.train import train_from_config
from sonicsim_tpu_torch.train import make_optimizer, make_train_step
from sonicsim_tpu_torch.utils import instantiate, write_wav

from test_torch_enh_models import SMALL as ENH_SMALL
from test_torch_gagnet import SMALL as GAG_SMALL
from test_torch_train_step import adam_mu
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL, GRAD_REL, PARAM_ATOL, NOISE_SHARE = 1e-5, 1e-5, 1e-6, 1e-3
FRCRN_GRAD_REL = 3e-5
LR, CLIP = 1e-3, 5.0  # the enhancement configs' Adam and clip
T = 3200
SUDORMRF = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=3,
                enc_kernel_size=21, enc_num_basis=32, num_sources=1)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


# --- losses: values and gradients ------------------------------------------

def _frcrn_out(rng, b=2):
    f2, frames = 642, (T - 640) // 320 + 1
    return (_normal(rng, (b, T), 0.3),
            [_normal(rng, (b, f2, frames)), _normal(rng, (b, T), 0.3), _normal(rng, (b, f2, frames)),
             _normal(rng, (b, f2, frames)), _normal(rng, (b, T), 0.3), _normal(rng, (b, f2, frames))])


def _cirm_out(rng):
    return (rng.uniform(-5, 5, (2, 2, 129, 26)).astype(np.float32),
            _normal(rng, (2, 129, 26)), _normal(rng, (2, 129, 26)))


def _loss_cases():
    """(id, JAX loss, port loss, estimates(rng), targets(rng)); a loss of
    (B,) values is summed."""
    wav = lambda rng: _normal(rng, (2, T), 0.3)  # noqa: E731
    clean = lambda rng: _normal(rng, (2, 1, T), 0.3)  # noqa: E731
    stft = dict(n_fft=256, hop_length=128, win_length=256)
    stages = lambda rng: [_normal(rng, (2, 2, 129, 26)) for _ in range(3)]  # noqa: E731
    multi = lambda rng: _normal(rng, (2, 2, T), 0.3)  # noqa: E731
    mix = _normal(_rng(99), (2, T), 0.3)
    bsrnn = dict(window_sz=(256, 512), normalize_variance=True, reduction="mean")
    return [
        ("FullbandLoss", JL.FullbandLoss(**stft), TL.FullbandLoss(**stft), _cirm_out, clean),
        ("FullbandLoss-win200", JL.FullbandLoss(256, 128, 200), TL.FullbandLoss(256, 128, 200),
         _cirm_out, clean),
        ("FullbandEval", JL.FullbandEval(**stft), TL.FullbandEval(**stft), _cirm_out, clean),
        ("DCCRNLoss", JL.DCCRNLoss(), TL.DCCRNLoss(), wav, clean),
        ("DCCRNEval-snr", JL.DCCRNEval("snr"), TL.DCCRNEval("snr"), wav, clean),
        ("FRCRNLoss", JL.FRCRNLoss(), TL.FRCRNLoss(), _frcrn_out, clean),
        ("FRCRNEval", JL.FRCRNEval(), TL.FRCRNEval(), _frcrn_out, clean),
        ("BSRNNESPNetLoss", JL.BSRNNESPNetLoss(), TL.BSRNNESPNetLoss(), wav, clean),
        ("BSRNNESPNetLoss-multires-mean", JL.BSRNNESPNetLoss(**bsrnn),
         TL.BSRNNESPNetLoss(**bsrnn), wav, clean),
        ("BSRNNESPNetEval", JL.BSRNNESPNetEval(), TL.BSRNNESPNetEval(), wav, clean),
        ("GaGNetLoss", JL.GaGNetLoss(**stft), TL.GaGNetLoss(**stft), stages, clean),
        ("GaGNetEval", JL.GaGNetEval(**stft), TL.GaGNetEval(**stft), stages, clean),
        ("TaylorSENetLoss", JL.TaylorSENetLoss(**stft), TL.TaylorSENetLoss(**stft),
         lambda rng: _normal(rng, (2, 2, 26, 129)), clean),
        ("TaylorSENetEval", JL.TaylorSENetEval(**stft), TL.TaylorSENetEval(**stft),
         lambda rng: _normal(rng, (2, 2, 26, 129)), clean),
        ("FreqMAE", JL.FreqMAE(256, 64), TL.FreqMAE(256, 64), multi, multi),
        ("FreqMAEWavL1", JL.FreqMAEWavL1(256, 64), TL.FreqMAEWavL1(256, 64), multi, multi),
        ("SISNRi", lambda e, r: JL.SISNRi()(jnp.asarray(mix), e, r),
         lambda e, r: TL.SISNRi()(torch.from_numpy(mix), e, r), multi, multi),
        ("MixIT", JL.MixITLossWrapper(JL.multisrc_neg_sdr),
         TL.MixITLossWrapper(TL.multisrc_neg_sdr), lambda rng: _normal(rng, (2, 3, T), 0.3),
         multi),
        ("MixIT-strict", JL.MixITLossWrapper(JL.multisrc_neg_sdr, generalized=False),
         TL.MixITLossWrapper(TL.multisrc_neg_sdr, generalized=False),
         lambda rng: _normal(rng, (2, 3, T), 0.3), multi),
    ]


LOSSES = _loss_cases()


def _scalar(v):
    return v.sum() if v.ndim else v


@pytest.mark.parametrize("case", range(len(LOSSES)), ids=[c[0] for c in LOSSES])
def test_loss_values_and_gradients(case):
    name, j_loss, t_loss, make_est, make_ref = LOSSES[case]
    est, ref = make_est(_rng(case)), make_ref(_rng(100 + case))
    first = 1 if name.startswith("FRCRN") else 0  # not the echoed noisy input
    j_est = _map(jnp.asarray, est)
    value_and_grad = jax.value_and_grad(lambda e: _scalar(j_loss(e, jnp.asarray(ref))))
    if name != "MixIT-strict":  # its JAX filter reads the matrices in numpy: eager only
        value_and_grad = jax.jit(value_and_grad)
    want, j_grad = value_and_grad(j_est)
    t_est = _map(lambda a: torch.from_numpy(a).requires_grad_(True), est)
    got = _scalar(t_loss(t_est, torch.from_numpy(ref)))
    grads = torch.autograd.grad(got, _leaves(t_est)[first:], allow_unused=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_REL)
    rel = FRCRN_GRAD_REL if first else GRAD_REL
    for g, w in zip(grads, _leaves(j_grad)[first:]):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max())


def test_mixit_best_remix():
    rng = _rng(7)
    ests, mixtures = _normal(rng, (2, 3, T)), _normal(rng, (2, 2, T))
    jl, jr = jax.jit(lambda e, m: JL.MixITLossWrapper(JL.multisrc_neg_sdr)(e, m, return_est=True))(
        jnp.asarray(ests), jnp.asarray(mixtures))
    tl, tr = TL.MixITLossWrapper(TL.multisrc_neg_sdr)(torch.from_numpy(ests),
                                                      torch.from_numpy(mixtures), return_est=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_REL)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# --- one float32 train step per loss family against optax --------------------

class JaxMaskNet(fnn.Module):
    """A per-bin complex mask over FRCRN's STFT pair (sqrt-Hann, no padding),
    emitting FRCRN's ``(noisy, [spec, wav, mask] × 2)``."""

    @fnn.compact
    def __call__(self, wav):
        re, im = JD.conv_stft(wav, 640, 320, 640, sqrt_window=True, pad_signal=False)
        f = re.shape[1]
        mr = jnp.tanh(self.param("mask_re", fnn.initializers.zeros, (f,)))[:, None]
        mi = jnp.tanh(self.param("mask_im", fnn.initializers.zeros, (f,)))[:, None]
        er, ei = re * mr - im * mi, re * mi + im * mr
        est = JD.conv_istft(er, ei, 640, 320, 640, wav.shape[-1], sqrt_window=True,
                            crop_pad=False)
        spec = jnp.concatenate([er, ei], 1)
        mask = jnp.concatenate([jnp.broadcast_to(mr, re.shape), jnp.broadcast_to(mi, re.shape)], 1)
        return wav, [spec, est, mask, spec, est, mask]


class MaskNet(torch.nn.Module):
    def __init__(self, f=321):
        super().__init__()
        self.mask_re = torch.nn.Parameter(torch.zeros(f))
        self.mask_im = torch.nn.Parameter(torch.zeros(f))

    def forward(self, wav):
        re, im = TD.conv_stft(wav, 640, 320, 640, sqrt_window=True, pad_signal=False)
        mr, mi = torch.tanh(self.mask_re)[:, None], torch.tanh(self.mask_im)[:, None]
        er, ei = re * mr - im * mi, re * mi + im * mr
        est = TD.conv_istft(er, ei, 640, 320, 640, wav.shape[-1], sqrt_window=True,
                            crop_pad=False)
        spec = torch.cat([er, ei], 1)
        mask = torch.cat([mr.expand_as(re), mi.expand_as(re)], 1)
        return wav, [spec, est, mask, spec, est, mask]


STEPS = {  # family: (model, model args, JAX loss, port loss)
    "cirm": ("Fullband", ENH_SMALL["Fullband"], JL.FullbandLoss(256, 128, 256),
             TL.FullbandLoss(256, 128, 256)),
    "waveform": ("SuDORMRF", SUDORMRF, JL.DCCRNLoss(), TL.DCCRNLoss()),
    "frcrn": ("MaskNet", {}, JL.FRCRNLoss(), TL.FRCRNLoss()),
    "bsrnn_espnet": ("SuDORMRF", SUDORMRF, JL.BSRNNESPNetLoss(), TL.BSRNNESPNetLoss()),
    "gagnet": ("GaGNet", GAG_SMALL["GaGNet"], JL.GaGNetLoss(256, 128, 256),
               TL.GaGNetLoss(256, 128, 256)),
    "taylorsenet": ("TaylorSENet", GAG_SMALL["TaylorSENet"], JL.TaylorSENetLoss(256, 128, 256),
                    TL.TaylorSENetLoss(256, 128, 256)),
}


def _batch():
    rng = _rng(5)
    clean = _normal(rng, (2, 1, T), 0.3)
    return (clean[:, 0] + _normal(rng, (2, T), 0.1)).astype(np.float32), clean


def _models(name, cfg):
    """The JAX model, its seeded params, and the port's model with them."""
    if name == "MaskNet":
        jm = JaxMaskNet()
        params = {"params": {k: _normal(_rng(3), (321,), 0.5) for k in ("mask_im", "mask_re")}}
        model = MaskNet()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in params["params"].items()})
        return jm, params, model, lambda tree: {k: torch.from_numpy(np.asarray(v))
                                                for k, v in tree["params"].items()}
    jm = JM.get(name)(**cfg)
    model = TM.get(name)(**cfg, device="cpu")
    args = model.model_args()
    params = chip_smoke.seeded_flax(TB.to_flax(name, model.state_dict(), args), 0)
    model.load_state_dict(TB.to_state_dict(name, params, args))
    return jm, params, model, lambda tree: TB.to_state_dict(
        name, jax.tree.map(np.asarray, tree), args)


@pytest.mark.parametrize("family", list(STEPS))
def test_f32_step_matches_optax(family):
    name, cfg, j_loss, t_loss = STEPS[family]
    mix, clean = _batch()
    jm, p0, model, to_port = _models(name, cfg)
    opt = j_make_optimizer(LR, clip_norm=CLIP)
    params, state, j_val = jax.jit(j_make_train_step(jm, j_loss, opt))(
        p0, opt.init(p0), jnp.asarray(mix), jnp.asarray(clean))
    want_g = to_port(jax.tree.map(lambda m: m / 0.1, adam_mu(state)))  # mu = (1 − b1) · g
    want_p = to_port(params)

    step = make_train_step(model, t_loss, make_optimizer(model.parameters(), LR), clip_norm=CLIP)
    val = float(step(torch.from_numpy(mix), torch.from_numpy(clean)))
    np.testing.assert_allclose(val, float(j_val), rtol=LOSS_REL)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    g_max = max(float(want_g[n].abs().max()) for n in grads)
    rel = FRCRN_GRAD_REL if family == "frcrn" else GRAD_REL
    for n, g in grads.items():
        np.testing.assert_allclose(g, want_g[n], rtol=0, atol=rel * g_max, err_msg=n)
        atol = torch.where(want_g[n].abs() < NOISE_SHARE * g_max, 2 * LR, PARAM_ATOL)
        p = dict(model.named_parameters())[n].detach()
        assert bool(((p - want_p[n]).abs() <= atol).all()), n


# --- every config's loss through the port's train step -----------------------

_SMALL_MODELS = {
    "fullband": ENH_SMALL["Fullband"], "fullsubnet": ENH_SMALL["FullSubnet"],
    "fastfullsubnet": ENH_SMALL["FastFullSubnet"], "fullsubnet_plus": ENH_SMALL["FullSubNet_Plus"],
    "inter_subnet": ENH_SMALL["Inter_SubNet"], "dccrn": ENH_SMALL["DCCRN"],
    "frcrn": ENH_SMALL["FRCRN"], "bsrnn_espnet": ENH_SMALL["BSRNNESPNet"],
    "sudormrf": SUDORMRF, "gagnet": GAG_SMALL["GaGNet"], "g2net": GAG_SMALL["G2Net"],
    "taylorsenet": GAG_SMALL["TaylorSENet"],
}


def _config(stem):
    return yaml.safe_load((ROOT / "configs" / "enhancement" / f"{stem}.yaml").read_text())


def _small_nodes(cfg, small):
    """The config's model node at ``small`` width, its loss and metric nodes
    on the model's STFT where they name one."""
    model = {**cfg["model"], **small}
    stft = {k: model[k] for k in ("n_fft", "hop_length", "win_length") if k in small}
    return model, *({**cfg[k], **{s: v for s, v in stft.items() if s in cfg[k]}}
                    for k in ("loss", "metrics"))


@pytest.mark.parametrize("stem", sorted(_SMALL_MODELS))
def test_every_config_loss_takes_a_step(stem):
    cfg = _config(stem)
    model_node, loss_node, metric_node = _small_nodes(cfg, _SMALL_MODELS[stem])
    torch.manual_seed(0)
    model = instantiate(model_node, device="cpu")
    loss_fn, metric_fn = instantiate(loss_node), instantiate(metric_node)
    assert type(model).__module__.startswith("sonicsim_tpu_torch.")
    assert type(loss_fn).__module__.startswith("sonicsim_tpu_torch.")
    mix, clean = _batch()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, loss_fn, make_optimizer(model.parameters(),
                                                          cfg["optimizer"]["lr"]),
                           clip_norm=cfg["trainer"]["gradient_clip_val"])
    loss = step(torch.from_numpy(mix), torch.from_numpy(clean))
    assert bool(torch.isfinite(loss))
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert moved and all(p.grad is None or bool(torch.isfinite(p.grad).all())
                         for p in model.parameters())
    with torch.no_grad():
        assert bool(torch.isfinite(metric_fn(model(torch.from_numpy(mix)),
                                             torch.from_numpy(clean))))
    with pytest.raises(NotImplementedError, match="bf16"):
        make_train_step(model, loss_fn, make_optimizer(model.parameters()), "bf16")


def _split(root: Path, n_train=2, n_val=2, seconds=1.0):
    """A generated split's train leaves (three moving tracks and a noise
    track) and a ``generate_fixed_eval --task enhancement`` style val set
    (``mix.wav``, ``clean.wav``)."""
    rng = _rng(11)
    n = int(16000 * seconds)
    for i in range(n_train):
        d = root / "train" / f"scene{i}" / "0"
        d.mkdir(parents=True)
        for k in (1, 2, 3):
            write_wav(d / f"moving_audio_{k}.wav", _normal(rng, (1, n), 0.1), 16000)
        write_wav(d / "noise_audio.wav", _normal(rng, (1, n), 0.05), 16000)
    for i in range(n_val):
        d = root / "val-enh" / f"{i}"
        d.mkdir(parents=True)
        clean = _normal(rng, (1, n), 0.1)
        write_wav(d / "clean.wav", clean, 16000)
        write_wav(d / "mix.wav", clean + _normal(rng, (1, n), 0.05), 16000)
    return root / "train", root / "val-enh"


def test_train_from_config_fits_an_enhancement_config(tmp_path):
    """fullsubnet.yaml at small width, one epoch over two 1 s samples, val
    on the fixed enhancement set (``target_names: [clean]``); the best model
    reloads through ``from_pretrain``."""
    train, val = _split(tmp_path)
    cfg = _config("fullsubnet")
    model, loss, metric = _small_nodes(cfg, _SMALL_MODELS["fullsubnet"])
    cfg.update(model=model, loss=loss, metrics=metric,
               exp={"dir": str(tmp_path / "exp"), "name": "fsn"})
    cfg["datas"].update(train_dir=str(train), val_dir=str(val), test_dir=str(val),
                        num_samples=2, duration=1.0, target_names=["clean"])
    trainer = train_from_config(cfg, "cpu", max_epochs=1)
    assert [r["epoch"] for r in trainer.history] == [-1, 0]
    assert all(np.isfinite(r["val_loss"]) for r in trainer.history)
    best = TM.from_pretrain(tmp_path / "exp" / "fsn" / "best_model.pkl", device="cpu")
    x = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        for a, b in zip(best(x), trainer.model.eval()(x)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("stem", sorted(_SMALL_MODELS))
def test_chip_smoke_losses_are_the_configs(stem):
    """Phase 14's loss and metric nodes (written out for a host without
    pyyaml) are the config's."""
    cfg = _config(stem)
    for node, (name, args) in zip((cfg["loss"], cfg["metrics"]), chip_smoke.ENH_LOSSES[stem]):
        assert node == {"_target_": f"sonicsim_tpu.losses.{name}", **args}


@pytest.mark.parametrize("stem", ["dccrn", "gagnet"])
def test_step_check_bound_from_float64(stem):
    """Phase 14's check (``chip_smoke.enh_step_check``) with the CPU on both
    sides, at small width: the sides agree exactly, every side replays the
    first one's branch at each kinked activation (DCCRN's PReLUs, GaGNet's
    channel PReLUs), the CPU float32 steps' distance from the float64 step
    is measured, the bound is the larger of phase 10's and ``ILL_FACTOR``
    times that distance, and the "device" float64 side (the CPU again)
    equals the CPU's float64 step."""
    name = chip_smoke.ENH_MODELS[stem][0]
    (loss_name, loss_args), _ = chip_smoke.ENH_LOSSES[stem]
    small = _SMALL_MODELS[stem]
    loss_fn = chip_smoke._instantiate_loss(
        (loss_name, {k: small.get(k, v) for k, v in loss_args.items()}))
    torch.manual_seed(0)
    weights = TM.get(name)(**small, device="cpu").state_dict()

    def fresh(dev):
        model = TM.get(name)(**small, device=dev)
        model.load_state_dict(weights)
        return model, make_train_step(model, loss_fn, make_optimizer(model.parameters(), LR),
                                      clip_norm=CLIP)

    mix, clean = _batch()
    chk = chip_smoke.enh_step_check(fresh, torch.from_numpy(mix), torch.from_numpy(clean), "cpu")
    assert chk["loss_rel"] == 0 and chk["grad_err"] == 0
    assert chk["kinks"] > 0 and chk["flip_rel"] <= chip_smoke.KINK_REL
    assert 0 < chk["device_vs_f64"] <= chk["cpu_vs_f64"] < 1e-2
    assert chk["ill"] == (chip_smoke.ILL_FACTOR * chk["cpu_vs_f64"] > chip_smoke.TRAIN_GRAD_REL)
    rel = max(chip_smoke.TRAIN_GRAD_REL, chip_smoke.ILL_FACTOR * chk["cpu_vs_f64"])
    assert chk["bound"] == rel * chk["grad_max"]
    assert chk["device_f64_err"] == 0  # the "device" float64 side: the CPU again


def test_kink_tape_replays_the_recorded_branch():
    """``chip_smoke._kink_tape``: a recorded pass keeps each kinked
    activation's side of 0 (``ChannelPReLU``: x ≥ 0; ``nn.PReLU``,
    ``nn.ReLU``: x > 0); a replayed pass on inputs moved across 0 takes the
    recorded side, in value and in gradient, and counts the elements sent
    apart with the largest |x| among them as a share of max|x|."""
    from sonicsim_tpu_torch.models.gagnet import ChannelPReLU

    net = torch.nn.Sequential(ChannelPReLU(2), torch.nn.PReLU(2, 0.5), torch.nn.ReLU())
    x = torch.tensor([[[1.0, -1e-7, 0.0], [2.0, 0.0, -3.0]]])
    tape: list = []
    chip_smoke._kink_tape(net, tape, None)
    net(x)
    assert [t.tolist() for t in tape] == [[[[True, False, True], [True, True, False]]],
                                          [[[True, False, False], [True, False, False]]],
                                          [[[True, False, False], [True, False, False]]]]
    replay = torch.nn.Sequential(ChannelPReLU(2), torch.nn.PReLU(2, 0.5), torch.nn.ReLU())
    flips = dict(n=0, rel=0.0)
    chip_smoke._kink_tape(replay, tape, flips)
    y = torch.tensor([[[1.0, 1e-7, 0.0], [2.0, 0.0, -3.0]]], requires_grad=True)
    out = replay(y)
    # 1e-7 crosses 0 and stays on the negative branch through all three
    # layers, sent apart at each; the largest share is the first's, of max|x| 3
    assert flips["n"] == 3 and flips["rel"] == pytest.approx(1e-7 / 3.0)
    assert out[0, 0, 1] == 0.0 and out[0, 0, 0] == 1.0
    out.sum().backward()
    assert y.grad[0, 0, 1] == 0.0 and y.grad[0, 0, 0] == 1.0


def test_a_served_model_still_trains():
    """DCCRN's synthesis matrix and the zoo's positional tables are cached on
    the first call; one made while serving (``inference_mode``) must not
    stop a later train step's backward."""
    from sonicsim_tpu_torch.models import dccrn as TD_
    from sonicsim_tpu_torch.models.zoo_layers import PrefixTable

    TD_._pinv_on.cache_clear()
    model = TM.DCCRN(**ENH_SMALL["DCCRN"], device="cpu")
    mix, clean = map(torch.from_numpy, _batch())
    with torch.inference_mode():
        model(mix)
    step = make_train_step(model, TL.DCCRNLoss(), make_optimizer(model.parameters(), LR))
    assert bool(torch.isfinite(step(mix, clean)))
    table = PrefixTable(lambda n: np.ones((n, 3), np.float32))
    with torch.inference_mode():
        table(4, "cpu")
    w = torch.ones(3, requires_grad=True)
    (table(4, "cpu") * w).sum().backward()
    assert torch.equal(w.grad, torch.full((3,), 4.0))
