"""Data-parallel training with the port on meshes of repeated CPU devices,
against the JAX package's step under its own mesh (``make_mesh(2)`` of the
conftest's virtual CPU devices) and against the port's unsharded step.

* The sharded step (``make_train_step(mesh=)``): ConvTasNet under PIT's
  ``threshold_byloss=True`` on a batch whose mask differs between the
  shards (item 0's estimate lies 40 dB from its target), DCCRN (batch
  statistics) and the GRU FullSubnet (its ``bias_hh`` hook): the gradients
  of one step, in float64 and float32; FRCRN (batch statistics in both
  U-Nets) in float64. The cases also show the test's power: the mean of
  per-shard losses (ConvTasNet) and per-shard statistics (DCCRN) miss the
  bound (FRCRN's per-shard miss is checked on the card).
* ``Trainer.fit`` over the mesh with the device count patched, as the JAX
  tests force 8 devices: ``n_devices=2`` against the JAX ``Trainer`` at
  ``n_devices=2``; ``n_devices=16`` (the clamp), the peeked first batch, a
  ragged batch dropped and ``_val_shards``' mean; resume; and bf16.

Tolerances:

* float64 gradients: 1e-9 · max|g64| over the whole tree, never per leaf
  (chip_smoke.F64_REL; a bias in front of a batch norm has a gradient of
  rounding noise alone), against JAX's float64 sharded gradient under
  ``jax_float64()``;
* float32 gradients: JAX's float64 sharded gradient referees, as in
  tests/test_torch_variants.py's float64-refereed steps: within max(1e-5
  (the single-device step tests' bound), 2 x the port's unsharded float32
  step's distance from it) · max|g64|; the loss within rel 1e-5 of JAX's;
* FRCRN's JAX gradient takes minutes to compile on the CPU (154 s in
  float32, 230 s in float64 on an 8-core x86 host), so FRCRN
  is held to the port's unsharded step over the whole batch, which takes
  its statistics over the global batch as GSPMD does, in float64: 1e-9 ·
  max|g64| (its float32 step is ill-conditioned and held on the card);
* ``metrics.jsonl`` against the JAX ``Trainer``: ``LOSS_REL`` = 1e-5
  (tests/test_torch_train_fit.py); a sharded val mean against the
  unsharded one 1e-6 relative (float32 means of the same items);
  resume against an uninterrupted run: equal;
* bf16: the sharded fit's losses within 1e-2 relative of the unsharded bf16
  fit's (bf16 rounds at 2^-8; the shards' convolutions run at half the
  batch), and finite.
"""

import logging
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import chip_smoke
import sonicsim_tpu.losses as JL
import sonicsim_tpu.models as JM
from sonicsim_tpu.dataset import datamodule as jdm
from sonicsim_tpu.parallel import batch_sharding
from sonicsim_tpu.parallel import make_mesh as j_make_mesh
from sonicsim_tpu.train import Trainer as JTrainer
from sonicsim_tpu_torch import losses as TL
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.dataset import MovingDataModule
from sonicsim_tpu_torch.parallel import (Mesh, all_reduce_sum, gather, parallel_apply,
                                         replicate)
from sonicsim_tpu_torch.train import make_train_step
from sonicsim_tpu_torch.train import trainer as trainer_mod
from test_torch_enh_models import SMALL as ENH_SMALL
from test_torch_enh_models import jax_params, port
from test_torch_train_fit import (CFG, CROP, LOSS_REL, _dm_args, _port_trainer,  # noqa: F401
                                  _records, split)
from test_torch_variants import _dist as _leaf_dist
from test_torch_variants import _flax_leaves, _params, _to_f64, jax_float64
from torch_threads import one_intra_op_thread  # noqa: F401

F64_REL = 1e-9
GRAD_REL = 1e-5
FRCRN_T = 640
VAL_REL = 1e-6
BF16_REL = 1e-2
CTN = dict(N=16, L=16, B=8, H=16, P=3, X=1, R=1, num_spks=2)
GRU = dict(sequence_model="GRU")
DCCRN_DP = dict(rnn_units=16, kernel_num=(8, 16), rnn_layers=1)  # two encoder layers
STFT = (256, 128, 256)
CASES = {  # id: (model, arguments, JAX loss, port loss, samples)
    "convtasnet-threshold": ("ConvTasNet", CTN,
                             JL.PITLossWrapper(JL.PairwiseNegSDR("snr"), threshold_byloss=True),
                             TL.PITLossWrapper(TL.PairwiseNegSDR("snr"), threshold_byloss=True),
                             800),
    "dccrn": ("DCCRN", DCCRN_DP, JL.DCCRNLoss(), TL.DCCRNLoss(), 3200),
    "fullsubnet-gru": ("FullSubnet", dict(ENH_SMALL["FullSubnet"], **GRU),
                       JL.FullbandLoss(*STFT), TL.FullbandLoss(*STFT), 3200),
}


def cpu_mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n)


def _batch(name, model, n_samples):
    """4 items, 2 per shard. ConvTasNet's targets are two seeded tracks but
    for item 0, whose targets are the model's own estimates plus noise 40 dB
    down: its PIT loss (about −40 dB) falls under the −30 dB threshold, so
    shard 0 keeps one item and shard 1 two."""
    rng = np.random.default_rng(3)
    mix = (0.3 * rng.standard_normal((4, n_samples))).astype(np.float32)
    if name != "ConvTasNet":
        clean = (mix[:, None] + 0.1 * rng.standard_normal((4, 1, n_samples))).astype(np.float32)
        return mix, clean
    tgt = (0.3 * rng.standard_normal((4, 2, n_samples))).astype(np.float32)
    with torch.no_grad():
        est = model.double()(torch.from_numpy(mix[:1]).double()).float().numpy()
    model.float()
    noise = rng.standard_normal(est.shape).astype(np.float32)
    tgt[:1] = est + 0.01 * np.sqrt((est ** 2).mean()) * noise
    return mix, tgt


def _dist(grads, want) -> float:
    g_max = max(float(want[n].abs().max()) for n in grads)
    return max(float((grads[n] - want[n]).abs().max()) for n in grads) / g_max


def _port_grads(model, loss_fn, mix, tgt, mesh):
    """The gradient ``make_train_step`` leaves in ``.grad`` (no clip, a
    zero learning rate)."""
    step = make_train_step(model, loss_fn, torch.optim.SGD(model.parameters(), lr=0.0),
                           clip_norm=None, mesh=mesh)
    loss = step(mix, tgt)
    return loss, {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _plain_grads(model, loss_fn, mix, tgt, how):
    """Gradients of the functions a mesh step must not compute: the mean of
    per-shard losses (``per_shard_loss``) or per-shard statistics
    (``per_shard_stats``: each shard through the unsharded model)."""
    model.zero_grad(set_to_none=True)
    parts = list(zip(mix.chunk(2), tgt.chunk(2)))
    if how == "per_shard_loss":
        loss = sum(loss_fn(model(x), y) for x, y in parts) / len(parts)
    else:
        loss = loss_fn(gather([model(x) for x, _ in parts], mix.device), tgt)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _jax_grads64(name, cfg, params, j_loss, mix, tgt):
    """The JAX package's loss and gradient in float64, the batch sharded
    over its ``make_mesh(2)``."""
    jm = JM.get(name)(**cfg)
    mesh = j_make_mesh(2)
    rep = NamedSharding(mesh, PartitionSpec())
    shard = batch_sharding(mesh)
    fn = jax.value_and_grad(lambda p, x, y: j_loss(jm.apply(p, x), y))
    with jax_float64():
        val, grads = jax.jit(fn, in_shardings=(rep, shard, shard))(
            _to_f64(params), jnp.asarray(mix, jnp.float64), jnp.asarray(tgt, jnp.float64))
    return float(val), jax.tree.map(np.asarray, grads)


def _vs_jax(name, model, grads, tree) -> float:
    """The distance of the port's gradients from JAX's ``tree``, in the
    flax layout (float64), over max|g| of the tree."""
    ours, ref = _flax_leaves(name, model, grads), _params(tree)
    return _leaf_dist(ours, ref) / max(float(np.abs(r).max()) for r in ref)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_is_jaxs(case):
    name, cfg, j_loss, t_loss, n_samples = CASES[case]
    params = jax_params(name, cfg)
    model = port(name, cfg, params).train()
    mix, tgt = _batch(name, model, n_samples)
    x, y = torch.from_numpy(mix), torch.from_numpy(tgt)
    mesh = cpu_mesh(2)

    # float64: the JAX package's sharded gradient referees
    j_val64, j_g64 = _jax_grads64(name, cfg, params, j_loss, mix, tgt)
    model64 = port(name, cfg, params).train().double()
    val64, g64 = _port_grads(model64, t_loss, x.double(), y.double(), mesh)
    assert float(val64) == pytest.approx(j_val64, rel=F64_REL)
    assert _vs_jax(name, model64, g64, j_g64) <= F64_REL
    how = "per_shard_loss" if name == "ConvTasNet" else "per_shard_stats"
    if name != "FullSubnet":  # no batch coupling but the loss's mean
        plain = _plain_grads(model64, t_loss, x.double(), y.double(), how)
        assert _vs_jax(name, model64, plain, j_g64) > F64_REL
    if name == "FullSubnet":  # the hook acted once, on the summed gradient
        for n, g in g64.items():
            if "bias_hh" in n:
                hidden = g.shape[0] // 3
                assert not g[:2 * hidden].any() and g[2 * hidden:].any(), n

    # float32, JAX's float64 refereeing (tests/test_torch_variants.py's rule
    # for its float64-refereed steps): within max(1e-5, 2 x the port's
    # unsharded float32 step's distance) of it
    val, g = _port_grads(model, t_loss, x, y, mesh)
    _, one = _port_grads(port(name, cfg, params).train(), t_loss, x, y, None)
    assert float(val) == pytest.approx(j_val64, rel=LOSS_REL)
    bound = max(GRAD_REL, chip_smoke.ILL_FACTOR * _vs_jax(name, model, one, j_g64))
    assert _vs_jax(name, model, g, j_g64) <= bound


def test_sharded_frcrn_step_takes_global_statistics():
    """FRCRN at its fixed width from torch's seeded init, 1 item per shard,
    in float64. Its float32 step, ill-conditioned, and the per-shard
    statistics that step must miss are held on the card
    (tests/test_torch_mesh_cuda.py and chip_smoke.py phase 20); DCCRN shows
    the per-shard miss here."""
    torch.manual_seed(0)
    model64 = TM.FRCRN(device="cpu").train().double()
    rng = np.random.default_rng(4)
    mix = torch.from_numpy((0.3 * rng.standard_normal((2, FRCRN_T))).astype(np.float64))
    noise = torch.from_numpy(rng.standard_normal((2, 1, FRCRN_T)).astype(np.float64))
    clean = mix[:, None] + 0.1 * noise
    loss = TL.FRCRNLoss()
    _, want64 = _port_grads(model64, loss, mix, clean, None)
    _, g64 = _port_grads(model64, loss, mix, clean, cpu_mesh(2))
    assert _dist(g64, want64) <= F64_REL


def test_a_replica_outside_parallel_apply_raises():
    from sonicsim_tpu_torch.parallel import replicate

    model = TM.DCCRN(**DCCRN_DP, device="cpu")
    replica = replicate(model, cpu_mesh(2))[1]
    with pytest.raises(RuntimeError, match="replica context"):
        replica(torch.zeros(2, 3200))
    with pytest.raises(ValueError, match="does not divide"):
        _port_grads(model, TL.DCCRNLoss(), torch.zeros(3, 3200), torch.zeros(3, 1, 3200),
                    cpu_mesh(2))


class _Summer(torch.nn.Module):
    """Sums its input and a count over the replicas 20 times, checking each
    sum (``mesh.all_reduce_sum``, the norms' exchange)."""

    def forward(self, x):
        n = len(_STRESS_MESH.devices)
        for k in range(20):
            total = all_reduce_sum(x * (k + 1))
            assert all_reduce_sum(1) == n
            assert torch.equal(total, torch.full_like(x, (k + 1) * n * (n - 1) / 2))
        return total


_STRESS_MESH = Mesh(["cpu"] * 16)


def test_replicas_exchange_under_thread_switches():
    """16 replicas (more than an 8-core host's cores) exchange 40 values each
    with the interpreter switching threads every microsecond: every replica
    reads every sum whole, and the call ends."""
    mesh = _STRESS_MESH
    inputs = [torch.full((3,), float(i)) for i in range(mesh.size)]
    out = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(target=lambda: out.setdefault(
            "r", parallel_apply(replicate(_Summer(), mesh), inputs, mesh)))
        worker.start()
        worker.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not worker.is_alive() and len(out["r"]) == mesh.size


class _FailsOnReplica1(torch.nn.Module):
    def forward(self, x):
        if float(x[0]) == 1.0:
            raise ValueError("replica 1 fails")
        return all_reduce_sum(x)  # replica 0 waits here for replica 1


def test_a_failing_replica_releases_the_others():
    """The failing replica's own exception reaches the caller; the replica
    waiting for it at an exchange is released."""
    mesh = cpu_mesh(2)
    out = {}

    def call():
        try:
            parallel_apply(replicate(_FailsOnReplica1(), mesh), [torch.zeros(1), torch.ones(1)],
                           mesh)
        except ValueError as e:
            out["error"] = e

    worker = threading.Thread(target=call)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and "replica 1 fails" in str(out["error"])


# --- Trainer.fit over the mesh ----------------------------------------------------

@pytest.fixture
def eight_cpus(monkeypatch):
    """The port sees 8 CPU devices, as the JAX tests' conftest forces 8."""
    monkeypatch.setattr(trainer_mod, "available_devices",
                        lambda device_type: [torch.device(device_type)] * 8)


def test_fit_over_the_mesh_matches_jax(split, tmp_path, eight_cpus, monkeypatch):  # noqa: F811
    key = jax.random.PRNGKey(0)
    init = jax.jit(JM.ConvTasNet(**CFG).init)
    params = jax.tree.map(np.array, init(key, jnp.zeros((1, CROP), np.float32)))
    # the JAX Trainer's init_params(key, CROP) is this init, run op by op
    monkeypatch.setattr(JM.ConvTasNet, "init_params", lambda self, rng, example_len: params)
    jdmod = jdm.MovingDataModule(**_dm_args(split))
    jt = JTrainer(model=JM.ConvTasNet(**CFG),
                  loss_fn=JL.PITLossWrapper(JL.PairwiseNegSDR("snr"), threshold_byloss=False),
                  metric_fn=JL.PITLossWrapper(JL.PairwiseNegSDR("sisdr"), threshold_byloss=False),
                  lr=1e-3, max_epochs=1, save_top_k=2, exp_dir=tmp_path / "jax", n_devices=2)
    jt.fit(jdmod.train_batches, lambda: jdmod.val_batches(crop=CROP), rng=key, example_len=CROP)
    assert jt._batch_divisor == 2
    ref = _records(tmp_path / "jax" / "metrics.jsonl")

    dm = MovingDataModule(**_dm_args(split))
    trainer = _port_trainer(tmp_path / "port", 1, params, n_devices=2)
    state = trainer.fit(dm.train_batches, lambda: dm.val_batches(crop=CROP))
    assert trainer._batch_divisor == 2 and state.step == 2
    ours = _records(tmp_path / "port" / "metrics.jsonl")
    assert [r["epoch"] for r in ours] == [r["epoch"] for r in ref] == [-1, 0]
    for a, b in zip(ours, ref):
        assert a["lr"] == b["lr"]
        for k in ("train_loss", "val_loss"):
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=LOSS_REL), (a, b)


def _stream(rng, sizes, n=800):
    return [(rng.standard_normal((b, n)).astype(np.float32),
             rng.standard_normal((b, 2, n)).astype(np.float32)) for b in sizes]


def test_fit_peeks_drops_ragged_batches_and_weighs_val_shards(tmp_path, eight_cpus, caplog):
    """A single-iterator loader of batches of 4, 3 and 4 items, with
    ``n_devices=16`` clamped to the 8 devices with a warning: the mesh takes
    4 devices (the peeked first batch), trains on both batches of 4 and
    drops the 3 with a warning; the val batch of 3 is split by
    ``_val_shards`` and its mean is the unsharded one."""
    rng = np.random.default_rng(2)
    train = _stream(rng, (4, 3, 4))
    val = _stream(rng, (3,))
    torch.manual_seed(0)
    trainer = _port_trainer(tmp_path / "mesh", 1, n_devices=16)
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    stream = iter(train)
    with caplog.at_level(logging.WARNING, logger=trainer_mod.__name__):
        state = trainer.fit(lambda epoch: stream, lambda: iter(val))
    assert trainer._batch_divisor == 4 and state.step == 2
    assert "dropping ragged train batch of 3" in caplog.text
    assert "n_devices=16 exceeds available devices (8)" in caplog.text

    one = _port_trainer(tmp_path / "one", 0, n_devices=1)
    one.model.load_state_dict(init)
    one.fit(lambda epoch: iter(train), lambda: iter(val))
    assert one._batch_divisor == 1
    assert trainer.history[0]["val_loss"] == pytest.approx(one.history[0]["val_loss"], rel=VAL_REL)


def test_resume_over_the_mesh_equals_an_uninterrupted_run(split, tmp_path,  # noqa: F811
                                                          eight_cpus):
    dm = MovingDataModule(**_dm_args(split))

    def fit(exp, epochs, resume=False):
        torch.manual_seed(0)
        trainer = _port_trainer(tmp_path / exp, epochs, n_devices=2)
        return trainer, trainer.fit(dm.train_batches, lambda: dm.val_batches(crop=CROP),
                                    resume=resume)

    fit("cut", 1)
    resumed, state = fit("cut", 2, resume=True)
    assert [r["epoch"] for r in resumed.history] == [-1, 0, 1] and state.step == 4
    whole, _ = fit("whole", 2)
    assert resumed.history[-1]["train_loss"] == whole.history[-1]["train_loss"]
    for (name, a), b in zip(resumed.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_bf16_fit_over_the_mesh(split, tmp_path, eight_cpus):  # noqa: F811
    runs = {}
    for n in (1, 2):
        dm = MovingDataModule(**_dm_args(split))
        torch.manual_seed(0)
        trainer = _port_trainer(tmp_path / f"bf16_{n}", 1, n_devices=n, precision="bf16")
        trainer.fit(dm.train_batches, lambda: dm.val_batches(crop=CROP))
        assert trainer._batch_divisor == n
        runs[n] = trainer.history
    for a, b in zip(runs[2], runs[1]):
        for k in ("train_loss", "val_loss"):
            if k in b:
                assert np.isfinite(a[k]) and a[k] == pytest.approx(b[k], rel=BF16_REL), (a, b)
