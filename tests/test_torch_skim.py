"""SkiM in the port against the JAX package: the offline forward in both
causal modes and both segmentations, the streamer step for step against the
JAX ``SkiMStreamer``, the streamed output against the offline causal
forward, ``stream(depth)`` against ``step``, the weight bridge against the
JAX converter and by round trips, skim.yaml through the port's config
resolution, and the streaming CLI on a pack without jax.

Tolerances: the forward and the streamer within 1e-5 · max|ref| of the JAX
package (float32 LSTMs summed in another order; measured 2e-7 to 1.1e-6);
streamed against offline within rtol 1e-3 / atol 1e-4 where both are
defined, as tests/test_model_zoo.py holds the JAX streamer; ``stream``
against ``step`` within 1e-6; the CLI's PCM16 tracks within 1e-5 · max|ref|
plus one PCM16 step.
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
import sonicsim_tpu.models as JM
from sonicsim_tpu.models.skim import SkiMStreamer as JaxStreamer
from sonicsim_tpu.models.torch_import import import_torch_checkpoint
from sonicsim_tpu_torch import models as TM
from sonicsim_tpu_torch.models import base as TB
from sonicsim_tpu_torch.utils import instantiate
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
PCM_STEP = 2.0 / 32768  # the CLI writes PCM16 tracks
SMALL = dict(input_dim=8, layer=3, unit=8, segment_size=10, kernel_size=4)
CASES = {
    "noncausal-overlap": dict(SMALL, causal=False, seg_overlap=True),  # skim.yaml's mode
    "causal-plain": dict(SMALL, causal=True, seg_overlap=False),  # the streaming mode
    "causal-overlap": dict(SMALL, causal=True, seg_overlap=True),
    "noncausal-plain-h": dict(SMALL, causal=False, seg_overlap=False, mem_type="h"),
}
STREAM = CASES["causal-plain"]
CHUNK = STREAM["segment_size"] * STREAM["kernel_size"] // 2


_PARAMS = {}


def jax_params(cfg, seed=0):
    """The JAX SkiM's parameter tree filled by chip_smoke.py's seeded draw,
    made once per configuration: the bridge's layout of the port's state
    dict, held leaf for leaf, path and shape, to the JAX init's own
    (``jax.eval_shape``, a trace without compiling)."""
    key = (repr(sorted(cfg.items())), seed)
    if key not in _PARAMS:
        model = TM.SkiMNet(**cfg, device="cpu")
        tree = TB.to_flax("SkiMNet", model.state_dict(), model.model_args())
        want = jax.eval_shape(JM.SkiMNet(**cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 4 * CHUNK), jnp.float32))
        assert _layout(tree) == _layout(want)
        _PARAMS[key] = chip_smoke.seeded_flax(tree, seed)
    return _PARAMS[key]


def _layout(tree) -> list:
    """A parameter tree's leaves as (path, shape), in path order."""
    return sorted((jax.tree_util.keystr(path), tuple(np.shape(v)))
                  for path, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def port(cfg, params):
    model = TM.SkiMNet(**cfg, device="cpu")
    model.load_state_dict(TB.to_state_dict("SkiMNet", params, model.model_args()))
    return model.eval()


def _leaves_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("case", list(CASES))
def test_offline_forward(case):
    cfg = CASES[case]
    params = jax_params(cfg)
    x = np.random.default_rng(1).standard_normal((2, 2001)).astype(np.float32)
    ref = np.asarray(jax.jit(JM.SkiMNet(**cfg).apply)(params, x))
    with torch.inference_mode():
        ours = port(cfg, params)(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 2, 2001)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=REL * np.abs(ref).max())


def _stream_setup(n_chunks, batch=1, seed=2):
    params = jax_params(STREAM)
    wav = np.random.default_rng(seed).standard_normal((batch, CHUNK * n_chunks)).astype(np.float32)
    return params, wav, [wav[:, c * CHUNK:(c + 1) * CHUNK] for c in range(n_chunks)]


@pytest.mark.parametrize("batch", [1, 3])
def test_streamer_steps_equal_the_jax_streamer(batch):
    params, _, chunks = _stream_setup(5, batch)
    ref = JaxStreamer(JM.SkiMNet(**STREAM), params)
    ref.reset(batch)
    ours = TM.SkiMStreamer(port(STREAM, params))
    ours.reset(batch)
    sizes = []
    for c in chunks + [np.zeros((batch, 2), np.float32)]:  # the last: the flush
        want = np.asarray(ref.step(jnp.asarray(c)))
        got = ours.step(torch.from_numpy(c)).numpy()
        assert got.shape == want.shape
        sizes.append(got.shape[-1])
        if want.size:
            np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    assert sizes == [0, CHUNK, CHUNK, CHUNK, CHUNK, CHUNK]


def test_streamed_equals_offline_causal():
    params, wav, chunks = _stream_setup(4)
    model = port(STREAM, params)
    with torch.inference_mode():
        offline = model(torch.from_numpy(wav)).numpy()
    streamer = TM.SkiMStreamer(model)
    streamed = np.concatenate([streamer.step(torch.from_numpy(c)).numpy() for c in chunks], -1)
    n = min(streamed.shape[-1], offline.shape[-1]) - streamer.hop
    np.testing.assert_allclose(streamed[..., :n], offline[..., :n], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("depth", [0, 3])
def test_stream_depth_yields_the_steps(depth):
    params, _, chunks = _stream_setup(6)
    streamer = TM.SkiMStreamer(port(STREAM, params))
    steps = [streamer.step(torch.from_numpy(c)).numpy() for c in chunks]
    streamer.reset()
    outs = list(streamer.stream([torch.from_numpy(c) for c in chunks], depth=depth))
    assert len(outs) == len(steps)
    for got, want in zip(outs, steps):
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_streaming_needs_the_causal_plain_hc_model():
    for cfg, err in ((CASES["noncausal-overlap"], ValueError), (CASES["causal-overlap"], ValueError),
                     (dict(STREAM, mem_type="h"), NotImplementedError)):
        with pytest.raises(err):
            TM.SkiMStreamer(TM.SkiMNet(**cfg, device="cpu"))


def _reference_state_dict(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    model = TM.SkiMNet(**cfg, device="cpu")
    return {k: (v + 0.1 * torch.randn(v.shape, generator=g)).numpy()
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("case", list(CASES))
def test_bridge_equals_the_jax_converter_and_round_trips(case):
    cfg = CASES[case]
    sd = _reference_state_dict(cfg)
    _, ref = import_torch_checkpoint({"model_name": "SkiMNet", "model_args": {}, "state_dict": sd},
                                     model=JM.SkiMNet(**cfg))
    _leaves_equal(TB.to_flax("SkiMNet", sd, dict(cfg)), jax.tree.map(np.asarray, ref))

    params = jax_params(cfg)
    model = port(cfg, params)
    _leaves_equal(TB.to_flax("SkiMNet", model.state_dict(), model.model_args()), params)
    other = TM.SkiMNet(**cfg, device="cpu").eval()
    other.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = port(cfg, TB.to_flax("SkiMNet", sd, dict(cfg)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 1601)).astype(np.float32))
    with torch.inference_mode():
        want, got = other(x), back(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def test_skim_config_builds_through_the_port():
    node = yaml.safe_load((ROOT / "configs" / "separation" / "skim.yaml").read_text())["model"]
    model = instantiate(node, device="cpu")
    assert type(model) is TM.SkiMNet
    args = {k: v for k, v in node.items() if k != "_target_"}
    assert chip_smoke.ZOO_MODELS["SkiMNet"] == args
    assert {k: model.model_args()[k] for k in args} == args


def test_stream_cli_runs_a_pack_without_jax(tmp_path):
    """``python -m sonicsim_tpu_torch.scripts.stream`` on a causal SkiM pack
    saved by the JAX package, on the CPU: its JSON stats, its tracks (the
    streamer's output, as the JAX package's streamer gives it), and no jax
    module imported (``-X importtime``)."""
    from sonicsim_tpu_torch.utils import read_wav, write_wav

    params = jax_params(STREAM)
    JM.save_model(JM.SkiMNet(**STREAM), jax.tree.map(jnp.asarray, params), tmp_path / "skim.pkl")
    n = CHUNK * 7 + 13
    mix = 0.1 * np.random.default_rng(4).standard_normal((1, n)).astype(np.float32)
    write_wav(tmp_path / "mix.wav", mix, 16000, encoding="float32")
    r = subprocess.run([sys.executable, "-X", "importtime", "-m", "sonicsim_tpu_torch.scripts.stream",
                        "--model_path", str(tmp_path / "skim.pkl"), "--mix",
                        str(tmp_path / "mix.wav"), "--out_dir", str(tmp_path / "out"),
                        "--chunks_per_step", "2", "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    stats = __import__("json").loads(r.stdout.strip().splitlines()[-1])
    assert stats["audio_seconds"] == n / 16000 and stats["chunk_ms"] == 2.5
    assert set(stats["chunk_latency_ms"]) == {"mean", "p50", "p95", "max"}
    imported = {line.split("|")[-1].strip() for line in r.stderr.splitlines()
                if line.startswith("import time:")}
    assert "sonicsim_tpu_torch.models.skim" in imported
    assert not sorted(m for m in imported
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sonicsim_tpu"))

    ref = JaxStreamer(JM.SkiMNet(**STREAM), params)
    step = 2 * CHUNK
    padded = np.pad(mix[0], (0, -n % step))
    outs = [np.asarray(ref.step(jnp.asarray(padded[None, s:s + step])))
            for s in range(0, len(padded), step)]
    outs.append(np.asarray(ref.step(jnp.zeros((1, 2)))))
    want = np.concatenate(outs, axis=-1)[0, :, :n]
    for s in range(2):
        got, sr = read_wav(tmp_path / "out" / f"stream_spk{s + 1}.wav")
        assert sr == 16000 and got.shape == (1, n)
        np.testing.assert_allclose(got[0], want[s], rtol=0,
                                   atol=REL * np.abs(want).max() + PCM_STEP)
