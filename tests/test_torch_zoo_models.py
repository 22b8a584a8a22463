"""The separation zoo in the port against the JAX package, with the same
weights carried across by the bridge: each model's forward at small width
(TDANet in both modes), every separation config's model built through the
port's config resolution, the inference CLI on a zoo pack without jax, and
bf16 refused for the zoo.

Tolerance: max abs diff ≤ 1e-5 · max|ref| at these widths, as for
ConvTasNet (float32 convolutions, LSTMs and attention summed in another
order; measured 2e-7 to 1e-6).
"""

import pickle
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
import sonicsim_tpu.models as JM
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.utils import instantiate

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
# tests/test_model_zoo.py's small widths (every leaf moved off its init).
SMALL = {
    "DPRNNTasNet": dict(in_channels=32, out_channels=16, hidden_channels=16, K=20, num_layers=1),
    "SuDORMRF": dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=3,
                     enc_kernel_size=21, enc_num_basis=32),
    "AFRCNN": dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
                   enc_kernel_size=21, enc_num_basis=32),
    "TDANet": dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=4,
                   enc_kernel_size=2),
    "DPTNetModel": dict(channel=16, layer=1, unit=16, att_heads=4, segment_size=30),
    "BSRNN": dict(win=128, stride=32, feature_dim=16, num_repeat=1),
    "TFGridNet": dict(n_fft=128, stride=64, n_layers=1, lstm_hidden_units=32, emb_dim=16,
                      attn_approx_qk_dim=128),
    "MossFormer": dict(kernel_size=16, stride=8, out_channels=32, in_channels=32, num_blocks=1,
                       d_model=32, group_size=64, query_key_dim=32, expansion_factor=2.0),
    "MossFormer2": dict(kernel_size=16, stride=8, out_channels=32, in_channels=32, num_blocks=1,
                        d_model=32, group_size=64, query_key_dim=32, expansion_factor=2.0,
                        fsmn_inner=16),
}
CASES = [(n, c) for n, c in SMALL.items()] + [
    ("TDANet", dict(SMALL["TDANet"], torch_compat=True)),  # the reference checkpoints' mode
    ("DPRNNTasNet", dict(SMALL["DPRNNTasNet"], bidirectional=True, num_layers=2)),
    ("TFGridNet", dict(SMALL["TFGridNet"], emb_ks=2, emb_hs=2)),  # the Linear sub-band head
]


def jax_params(name, cfg, t=2001, seed=0):
    """The JAX model's parameter tree (its shapes, from ``jax.eval_shape`` of
    its init) filled by chip_smoke.py's seeded draw, which moves every leaf
    off its init value (kernels N(0, 1/fan_in), gains 1 + N(0, 0.01), PReLU
    slopes 0.25, biases N(0, 0.01))."""
    shapes = jax.eval_shape(JM.get(name)(**cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, t)))
    return chip_smoke.seeded_flax(shapes, seed)


def port(name, cfg, params):
    model = TM.get(name)(**cfg, device="cpu")
    model.load_state_dict(TB.to_state_dict(name, params, model.model_args()))
    return model.eval()


@pytest.mark.parametrize("name,cfg", CASES, ids=lambda v: v if isinstance(v, str) else "")
def test_small_width_forward(name, cfg):
    params = jax_params(name, cfg)
    x = np.random.default_rng(1).standard_normal((2, 2001)).astype(np.float32)
    ref = np.asarray(jax.jit(JM.get(name)(**cfg).apply)(params, x))
    with torch.inference_mode():
        ours = port(name, cfg, params)(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 2, 2001)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=REL * np.abs(ref).max())


def _model_nodes():
    for path in sorted((ROOT / "configs" / "separation").glob("*.yaml")):
        if path.stem not in ("skim", "convtasnet"):
            yield path.stem, yaml.safe_load(path.read_text())["model"]


@pytest.mark.parametrize("stem,node", list(_model_nodes()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_config_builds_through_the_port(stem, node):
    """Each separation config's ``_target_: sonicsim_tpu.models.X`` resolves to
    the port's class and builds at full width; chip_smoke.py's phase 11
    drives the same model node."""
    model = instantiate(node, device="cpu")
    name = node["_target_"].rsplit(".", 1)[1]
    assert type(model) is TM.get(name) and type(model).__module__.startswith("sonicsim_tpu_torch.")
    args = {k: v for k, v in node.items() if k != "_target_"}
    assert chip_smoke.ZOO_MODELS[name] == args
    assert {k: model.model_args()[k] for k in args} == args
    flax = TB.to_flax(name, model.state_dict(), model.model_args())
    assert (sum(a.size for a in jax.tree.leaves(flax))
            <= sum(p.numel() for p in model.parameters()))


def test_inference_cli_runs_a_zoo_pack_without_jax(tmp_path):
    """``python -m sonicsim_tpu_torch.scripts.inference`` on a small DPRNN
    pack, on the CPU, with ``-X importtime`` listing every module the
    process imported: none is jax or the JAX package."""
    from sonicsim_tpu_torch.utils import read_wav, write_wav

    cfg = SMALL["DPRNNTasNet"]
    model = port("DPRNNTasNet", cfg, jax_params("DPRNNTasNet", cfg))
    TM.save_model(model, tmp_path / "dprnn.pkl")
    mix = np.random.default_rng(2).standard_normal((2, 24000)).astype(np.float32) * 0.1
    write_wav(tmp_path / "mix.wav", mix, 16000, encoding="float32")
    r = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "sonicsim_tpu_torch.scripts.inference", "--model_path",
                        str(tmp_path / "dprnn.pkl"), "--mix", str(tmp_path / "mix.wav"),
                        "--out_dir", str(tmp_path / "out"), "--segment_seconds", "1.0",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    imported = {line.split("|")[-1].strip() for line in r.stderr.splitlines()
                if line.startswith("import time:")}
    assert "sonicsim_tpu_torch.models.dprnn" in imported
    loaded = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                               "sonicsim_tpu"))
    assert not loaded, loaded
    for i in (1, 2):
        est, sr = read_wav(tmp_path / "out" / f"s{i}_est.wav")
        assert sr == 16000 and est.shape == (1, 24000) and np.isfinite(est).all()
    with open(tmp_path / "dprnn.pkl", "rb") as f:
        assert pickle.load(f)["model_name"] == "DPRNNTasNet"


def test_bf16_is_refused_for_the_zoo():
    from sonicsim_tpu_torch.infer import bf16_forward
    from sonicsim_tpu_torch.train import make_optimizer, make_train_step

    model = TM.DPRNNTasNet(**SMALL["DPRNNTasNet"], device="cpu")
    with pytest.raises(NotImplementedError, match="bf16"):
        bf16_forward(model)
    with pytest.raises(NotImplementedError, match="bf16"):
        make_train_step(model, None, make_optimizer(model.parameters()), precision="bf16")


def test_zoo_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for name, cfg in SMALL.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.get(name)(**cfg)
