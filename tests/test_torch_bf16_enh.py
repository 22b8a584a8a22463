"""bf16 for the enhancement zoo in the port, against the JAX package's bf16,
on the CPU, from the same seeded weights carried across by the bridge:
tests/test_torch_bf16_sep.py's checks (a)–(d) for each enhancement config's
model at small width:

* (a) the served output (``to_waveform``'s waveform) to rel-L2 0.05 three
  ways; (b) every mapped module's dtypes equal JAX's, every output leaf
  included, and the whole-model bfloat16 form fails (b) on an STFT model
  (TaylorSENet: the conv after its STFT computes in float32 in JAX);
* (c) the bf16 step, 3 steps each side, for every config whose JAX bf16
  step runs, with the config's loss on the model's STFT;
* (d) bf16 training refused for the FullSubnet family, whose JAX bf16 step
  raises at ``jnp.asarray(ests, jnp.float32)`` (outputs of mixed shapes),
  serving allowed; FRCRN (at its own width), GaGNet and G2Net (at their
  configs' widths, on a tone in noise) refused, their bf16 over the gate
  in both packages alike; a list of same-shape outputs (the GaGNet
  family's stage spectra) reaches the loss stacked, as in the JAX step,
  and the loss is the same.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import chip_smoke
import sonicsim_tpu.infer as JI
import sonicsim_tpu.models as JM
from sonicsim_tpu.infer.precision import bf16_forward as j_bf16_forward
from sonicsim_tpu.train import make_train_step as j_make_train_step
from sonicsim_tpu.utils import instantiate as j_instantiate
from sonicsim_tpu_torch.infer import to_waveform
from sonicsim_tpu_torch.infer.precision import (BF16_MODELS, BF16_REFUSED, BF16_TRAIN_REFUSED,
                                                bf16_call, cast_state, to_float32)
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.train import make_optimizer, make_train_step
from sonicsim_tpu_torch.train.trainer import stack_float32
from sonicsim_tpu_torch.utils import instantiate

from test_torch_bf16_sep import (Readings, T, check_forward, check_refused, check_schedule,
                                 check_step, rel_l2, schedule_mismatches, whole_model_bf16)
from test_torch_enh_models import SMALL as ENH_SMALL
from test_torch_enh_train import SUDORMRF, _small_nodes
from test_torch_gagnet import SMALL as GAG_SMALL
from test_torch_sep_train import _seeded as seeded
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# Config stem → (model, small width), in the order of the enhancement configs.
ENH = {
    "fullband": ("Fullband", ENH_SMALL["Fullband"]),
    "fullsubnet": ("FullSubnet", ENH_SMALL["FullSubnet"]),
    "fastfullsubnet": ("FastFullSubnet", ENH_SMALL["FastFullSubnet"]),
    "fullsubnet_plus": ("FullSubNet_Plus", ENH_SMALL["FullSubNet_Plus"]),
    "inter_subnet": ("Inter_SubNet", ENH_SMALL["Inter_SubNet"]),
    "dccrn": ("DCCRN", ENH_SMALL["DCCRN"]),
    "bsrnn_espnet": ("BSRNNESPNet", ENH_SMALL["BSRNNESPNet"]),
    "sudormrf": ("SuDORMRF", SUDORMRF),
    "taylorsenet": ("TaylorSENet", GAG_SMALL["TaylorSENet"]),
}
FRCRN = ("FRCRN", ENH_SMALL["FRCRN"])  # its own width; refused by the gate
STAGES = {"gagnet": ("GaGNet", GAG_SMALL["GaGNet"]), "g2net": ("G2Net", GAG_SMALL["G2Net"])}
TRAINS = [s for s, (n, _) in ENH.items() if n not in BF16_TRAIN_REFUSED]
REFUSED_TRAINING = [s for s, (n, _) in ENH.items() if n in BF16_TRAIN_REFUSED]

_READINGS = {}


def readings(stem) -> Readings:
    if stem not in _READINGS:
        name, cfg = FRCRN if stem == "frcrn" else {**ENH, **STAGES}[stem]
        model, params = seeded(name, cfg)
        _READINGS[stem] = Readings(name, cfg, params, model.eval(), JM.get(name)(**cfg), 1)
    return _READINGS[stem]


def _losses(stem):
    """The config's loss node on the small model's STFT: JAX's and the
    port's."""
    cfg = yaml.safe_load((ROOT / "configs" / "enhancement" / f"{stem}.yaml").read_text())
    _, loss_node, _ = _small_nodes(cfg, (FRCRN if stem == "frcrn" else {**ENH, **STAGES}[stem])[1])
    return j_instantiate(loss_node), instantiate(loss_node)


def test_the_enhancement_models_that_take_bf16():
    assert {n for n, _ in ENH.values()} <= set(BF16_MODELS)
    assert {"FRCRN", "GaGNet", "G2Net"} <= set(BF16_REFUSED)
    assert not {"FRCRN", "GaGNet", "G2Net"} & set(BF16_MODELS)
    assert sorted([n for s, (n, _) in ENH.items() if s in REFUSED_TRAINING] + ["FRCRN"]) == sorted(
        BF16_TRAIN_REFUSED)


@pytest.mark.parametrize("stem", list(ENH))
def test_bf16_forward_three_ways(stem):
    check_forward(readings(stem))


@pytest.mark.parametrize("stem", list(ENH))
def test_bf16_dtype_schedule_is_jax(stem):
    check_schedule(readings(stem))


@pytest.mark.parametrize("stem", TRAINS)
def test_bf16_step_tracks_f32_on_both_sides(stem):
    r = readings(stem)
    j_loss, t_loss = _losses(stem)
    check_step(r, j_loss, t_loss, lambda: seeded(r.name, r.cfg)[0])


def _jax_step_raises(r, stem):
    j_loss, _ = _losses(stem)
    opt = optax.adam(1e-3)
    j_step = j_make_train_step(r.jm, j_loss, opt, precision="bf16")
    spec = jax.ShapeDtypeStruct
    with pytest.raises(TypeError, match="Cannot concatenate"):
        jax.eval_shape(j_step, r.params, opt.init(r.params), spec((2, T), jnp.float32),
                       spec((2, 1, T), jnp.float32))


@pytest.mark.parametrize("stem", REFUSED_TRAINING)
def test_bf16_training_is_refused_where_the_jax_step_raises(stem):
    r = readings(stem)
    _jax_step_raises(r, stem)
    check_refused(r.name, r.model, "sonicsim_tpu/train/trainer.py:123", train_only=True)


def test_frcrn_is_refused_by_the_gate():
    """FRCRN's bf16 waveform lies over the gate from float32 on both sides
    (and as close to JAX's bf16 as the other models'); its JAX bf16 step
    raises as the FullSubnet family's does."""
    r = readings("frcrn")
    j32, j16, t32, t16 = r.served()
    assert rel_l2(j16, j32) > 0.05 and rel_l2(t16, t32) > 0.05
    assert rel_l2(t16, j16) < 1e-3
    _jax_step_raises(r, "frcrn")
    check_refused(r.name, r.model, "over the zoo's 0.05 gate")
    with pytest.raises(NotImplementedError, match="FRCRN.*sonicsim_tpu/train/trainer.py:123"):
        make_train_step(r.model, None, make_optimizer(r.model.parameters()), precision="bf16")


@pytest.mark.parametrize("stem", ["gagnet", "g2net"])
def test_over_the_gate_at_full_width_on_both_sides(stem):
    """GaGNet and G2Net at their configs' widths (chip_smoke.ENH_MODELS) on
    0.5 s of a 220 Hz tone in noise: bf16 lies over the gate from float32
    in both packages, which agree with each other; the port refuses both.
    (At the tests' small widths on noise they lie within it.)"""
    name, args = chip_smoke.ENH_MODELS[stem]
    model = chip_smoke.seeded_zoo(name, args, 0).eval()
    params = TB.to_flax(name, model.state_dict(), model.model_args())
    jm = JM.get(name)(**args)
    t = 8000
    rng = np.random.default_rng(0)
    x = (0.3 * np.sin(2 * np.pi * 220 * np.arange(t) / 16000)[None]
         + 0.01 * rng.standard_normal((1, t))).astype(np.float32)
    j32, j16 = (np.asarray(JI.to_waveform(jm, jax.jit(f)(params, x), t))
                for f in (jm.apply, j_bf16_forward(jm)))
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        t32 = to_waveform(model, model(xt), t).numpy()
        t16 = to_waveform(model, to_float32(bf16_call(model, cast_state(model), xt)), t).numpy()
    assert rel_l2(j16, j32) > 0.05 and rel_l2(t16, t32) > 0.05
    assert rel_l2(t16, j16) < 1e-3
    check_refused(name, model, "over the zoo's 0.05 gate")


@pytest.mark.parametrize("stem", ["gagnet", "g2net"])
def test_stage_spectra_reach_the_loss_stacked_as_in_jax(stem):
    """The JAX step stacks a list of same-shape outputs (the GaGNet
    family's stage spectra) before its loss; the port's bf16 step hands its
    loss the same stack (``stack_float32``), and the loss of the stack is
    the loss of the list on both sides."""
    r = readings(stem)
    j_loss, t_loss = _losses(stem)
    tgt = torch.from_numpy(r.tgt)
    ests = [o.float() for o in r.t16]
    stacked = stack_float32(r.t16)
    assert stacked.shape == (len(ests), *ests[0].shape) and stacked.dtype == torch.float32
    ours = float(t_loss(stacked, tgt))
    assert ours == pytest.approx(float(t_loss(ests, tgt)), rel=1e-6)
    theirs = float(j_loss(jnp.asarray(r.j16, jnp.float32), jnp.asarray(r.tgt)))
    assert theirs == pytest.approx(float(j_loss(list(r.j16), jnp.asarray(r.tgt))), rel=1e-6)
    assert abs(ours - theirs) < 0.1 * abs(theirs) + 0.5


def test_whole_model_bf16_fails_the_schedule_after_the_stft():
    """TaylorSENet, no LSTM: in bfloat16 throughout its first conv reads a
    bfloat16 spectrum, where JAX's reads the float32 one."""
    r = readings("taylorsenet")
    x = torch.from_numpy(r.mix)
    with torch.no_grad():
        out = whole_model_bf16(r.model, x)
    assert out.dtype == torch.bfloat16
    bad, _ = schedule_mismatches(r.name, r.model, r.jm, r.params, r.mix,
                                 lambda: whole_model_bf16(r.model, x))
    assert any(theirs == ["float32"] and ours == ["bfloat16"] for _, _, ours, theirs in bad), bad


def test_the_bf16_state_is_what_the_bridge_maps():
    """``cast_state`` casts the parameters and the frozen statistics, and
    FastFullSubnet's mel bank, which the JAX model computes, stays out."""
    model = seeded("FastFullSubnet", ENH["fastfullsubnet"][1])[0]
    state = cast_state(model)
    assert set(state) == {n for n, _ in model.named_parameters()}
    assert "mel_fb" not in state and model.mel_fb.dtype == torch.float32
    frozen = seeded("DCCRN", dict(ENH["dccrn"][1], torch_compat=True))[0]
    stats = {n for n, _ in frozen.named_buffers() if n.endswith(("running_mean", "running_var"))}
    assert stats and stats <= set(cast_state(frozen))
    assert all(v.dtype == torch.bfloat16 for v in cast_state(frozen).values())
