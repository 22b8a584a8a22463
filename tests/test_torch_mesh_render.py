"""The port's sharded render paths on meshes of repeated CPU devices,
against the port's unsharded call and the JAX package's own sharded call
on its conftest's virtual CPU devices (``make_mesh(n)``), from the same
numpy inputs.

Each sharded path: ``render_mixture_sources`` in both forms (3 sources on
8 devices: five shards empty; 5 sources on 2: uneven shards), the bank
render with a bank across shards, ``render_mixture`` with and without the
utterance cache and on the device sink, and ``wav_chunk_inference``.

Tolerances:

* against the port's unsharded call: 1e-6 absolute for tracks and banks
  (tests/test_pipeline_mesh.py's bound for JAX's mesh against its single
  device; the shards run the same float32 ops, measured equal); WAVs and
  device-sink tracks within one int16 step, 1.01/32768; chunked inference
  2e-5 absolute (tests/test_metrics_infer.py:88-113);
* against JAX's sharded call: the bounds the port's unsharded paths are
  held to against JAX's unsharded ones: tracks 1e-5 · max|ref|
  (tests/test_torch_pipeline.py), banks 5e-5 · peak and 1e-4 relative
  (tests/test_torch_bank_render.py), pcm16 WAVs 2 codes
  (tests/test_torch_gen_render.py), chunked ConvTasNet 1e-5 · max|ref|
  (tests/test_torch_eval_sidecars.py);
* DCCRN's chunked output sharded over 2 replicas equals the unsharded call
  at ``batch_size × 2`` within 1e-5 · max|ref| (float32 sums of the
  statistics in another order) and misses the unsharded call at
  ``batch_size`` (per-shard statistics) by more than that bound; against
  JAX's sharded DCCRN 1e-4 · max|ref| (tests/test_torch_enh_models.py's
  FRCRN bound for the complex U-Nets' forward).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.models as JM
from sonicsim_tpu.dataset.generate import plan_mixture as j_plan_mixture
from sonicsim_tpu.dataset.generate import render_mixture as j_render_mixture
from sonicsim_tpu.infer.chunked import wav_chunk_inference as j_chunked
from sonicsim_tpu.parallel import make_mesh as j_make_mesh
from sonicsim_tpu.parallel import pipeline as J
from sonicsim_tpu.sim import bank_render as JB
from sonicsim_tpu.sim.channels import ChannelModel as JChannel
from sonicsim_tpu.sim.image_source import ShoeboxRoom as JRoom
from sonicsim_tpu.sim.oracle import SyntheticRirOracle as JOracle
from sonicsim_tpu.sim.scene import Scene as JScene
from sonicsim_tpu.utils.wavio import read_wav as j_read_wav
from sonicsim_tpu_torch import bridge
from sonicsim_tpu_torch.dataset import UtteranceCache, plan_mixture, render_mixture
from sonicsim_tpu_torch.infer import wav_chunk_inference
from sonicsim_tpu_torch.models import ConvTasNet, DCCRN
from sonicsim_tpu_torch.models import base as TMB
from sonicsim_tpu_torch.parallel import Mesh
from sonicsim_tpu_torch.parallel.mesh import shard_slices
from sonicsim_tpu_torch.parallel import pipeline as T
from sonicsim_tpu_torch.sim import bank_render as TB
from sonicsim_tpu_torch.utils import read_wav
from test_torch_gen_render import _corpus
from test_torch_pipeline import _mixture
from torch_threads import one_intra_op_thread  # noqa: F401

SR = 16000
SHARD_ATOL = 1e-6
PCM_STEP = 1.01 / 32768
CHUNK_ATOL = 2e-5
TRACK_REL = 1e-5
BANK_ATOL, BANK_RTOL = 5e-5, 1e-4
PCM_CODES = 2
CHUNK_REL = 1e-5
DCCRN_JAX_REL = 1e-4
TRACKS = [f"moving_audio_{i}.wav" for i in (1, 2)] + ["noise_audio.wav", "music_audio.wav"]


def cpu_mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n)


# --- render_mixture_sources ---------------------------------------------------

def _sources(n_src):
    data = list(_mixture(np.random.default_rng(n_src), n_src=n_src))
    data[7] = np.asarray([-17.0 - 0.5 * i for i in range(n_src)], np.float32)
    return data


@pytest.mark.parametrize("weights_form", [False, True], ids=["fused", "weights"])
@pytest.mark.parametrize("n_src,n_dev", [(3, 8), (5, 2)])
def test_render_mixture_sources_sharded(n_src, n_dev, weights_form):
    speech, banks, weights, offs, lens, sa, srir, sl, stl = _sources(n_src)
    banks_p, w_p, off_p, len_p, max_seg = J.pad_moving_plans(banks, weights, offs, lens)
    args = (speech, banks_p, w_p if weights_form else None, off_p, len_p, max_seg,
            sa, srir, sl, stl, SR)
    single = T.render_mixture_sources(*args, device="cpu")
    sharded = T.render_mixture_sources(*args, mesh=cpu_mesh(n_dev))
    ref = J.render_mixture_sources(*args, mesh=j_make_mesh(n_dev))
    for got, one, want in zip(sharded, single, ref):
        want = np.asarray(want)
        assert got.shape == one.shape == want.shape and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0, atol=SHARD_ATOL)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TRACK_REL * np.abs(want).max())


# --- the bank render ------------------------------------------------------------

def test_bank_render_sharded_peak_across_shards():
    """tests/test_bank_render.py's mesh case: two banks of 3 and 2 sources,
    one Binaural mic, 10 items on 8 devices; bank 0 spans four shards, and
    its peak is the maximum of their partial maxima."""
    rng = np.random.default_rng(0)
    room = JRoom((6.0, 3.0, 5.0), absorption=0.3)
    ref_oracle = JOracle(room, n_bands=8, max_order=2, seed=5)
    srcs_a = [rng.uniform([1, 1, 1], [5, 2.5, 4]) for _ in range(3)]
    srcs_b = [rng.uniform([1, 1, 1], [5, 2.5, 4]) for _ in range(2)]
    recvs = [np.array([3.0, 1.5, 2.5])]
    channel = JChannel("Binaural")
    oracle, ours_ch = bridge.sim_from_fields(dataclasses.asdict(ref_oracle),
                                             dataclasses.asdict(channel), device="cpu")
    want = JB.render_rir_banks(ref_oracle, [srcs_a, srcs_b], recvs, channel,
                               mesh=j_make_mesh(8))
    single = TB.render_rir_banks(oracle, [srcs_a, srcs_b], recvs, ours_ch)
    sharded = TB.render_rir_banks(oracle, [srcs_a, srcs_b], recvs, ours_ch,
                                  mesh=cpu_mesh(8), out_device=True)
    for got, one, ref in zip(sharded, single, want):
        ref = np.asarray(ref)
        assert torch.is_tensor(got) and got.shape == one.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), one, rtol=0, atol=SHARD_ATOL)
        assert float(got.abs().max()) == pytest.approx(1.0, abs=SHARD_ATOL)
        np.testing.assert_allclose(got.numpy(), ref, rtol=BANK_RTOL,
                                   atol=BANK_ATOL * np.abs(ref).max())
    # the bank across shards: items 0-5 lie on devices 0-3 of 8
    sizes = [sl.stop - sl.start for _, sl in shard_slices(10, cpu_mesh(8))]
    assert sizes == [2, 2, 1, 1, 1, 1, 1, 1]


# --- generation ---------------------------------------------------------------

@pytest.fixture(scope="module")
def gen_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_gen")
    rng = np.random.default_rng(7)
    speech = [_corpus(root / f"spk{i}", 2, 1.0, rng, f"s{i}_") for i in range(2)]
    noise = _corpus(root / "noise", 1, 1.5, rng, "n")
    music = _corpus(root / "music", 1, 1.5, rng, "m")
    ref_scene = JScene.synthetic(room="r", dims=(8.0, 3.0, 6.0), channel_type="Mono", seed=1,
                                 max_order=2, n_bands=4)
    scene = bridge.scene_from_fields(dataclasses.asdict(ref_scene), device="cpu")
    kw = dict(duration=3.0, seed=7)
    ref_plan = j_plan_mixture(ref_scene, speech, noise, music, np.random.default_rng(0), **kw)
    plan = plan_mixture(scene, speech, noise, music, np.random.default_rng(0), **kw)
    return root, scene, plan, ref_scene, ref_plan


def test_render_mixture_sharded_both_sinks(gen_case):
    """tests/test_pipeline_mesh.py:141-193 in the port: the WAVs with and
    without a mesh, with the utterance cache through the sharded path, and
    the device sink's tracks; the sharded WAVs against JAX's."""
    root, scene, plan, ref_scene, ref_plan = gen_case
    mesh = cpu_mesh(8)
    render_mixture(scene, plan, root / "single", save_trace=False)
    render_mixture(scene, plan, root / "meshed", save_trace=False, mesh=mesh)
    render_mixture(scene, plan, root / "meshed_cache", save_trace=False, mesh=mesh,
                   cache=UtteranceCache(sample_rate=SR, device="cpu"))
    j_render_mixture(ref_scene, ref_plan, root / "jax_meshed", save_trace=False,
                     mesh=j_make_mesh(8))
    for name in TRACKS:
        a, _ = read_wav(root / "single" / name)
        for other in ("meshed", "meshed_cache"):
            b, _ = read_wav(root / other / name)
            np.testing.assert_allclose(b, a, rtol=0, atol=PCM_STEP, err_msg=(other, name))
        b, _ = read_wav(root / "meshed" / name)
        ref, _ = j_read_wav(root / "jax_meshed" / name)
        assert np.abs(b - ref).max() * 32768 <= PCM_CODES, name

    one = render_mixture(scene, plan, root / "dev1", sink="device")
    sharded = render_mixture(scene, plan, root / "dev8", sink="device", mesh=mesh)
    assert not any((root / "dev8").iterdir())
    a, b = one["tracks"], sharded["tracks"]
    assert torch.is_tensor(b) and b.shape == a.shape and b.dtype == a.dtype
    step = 1.01 if b.dtype == torch.int16 else PCM_STEP
    assert float((b.to(torch.float32) - a.to(torch.float32)).abs().max()) <= step


# --- chunked inference --------------------------------------------------------

def test_wav_chunk_inference_sharded_convtasnet():
    """tests/test_metrics_infer.py:88-113: 10 s at 1 kHz in 2 s windows at a
    1 s hop; 3 windows a call unsharded, 2 per replica on 8 replicas."""
    sr = 1000
    x = np.random.default_rng(0).standard_normal(sr * 10).astype(np.float32)
    cfg = dict(N=16, L=16, B=8, H=16, P=3, X=1, R=1, num_spks=2)
    jm = JM.ConvTasNet(**cfg)
    params = chip_smoke.seeded_convtasnet(cfg, 0)
    model = ConvTasNet(**cfg, device="cpu").eval()
    model.load_state_dict(bridge.convtasnet_state_dict(params))
    kw = dict(sample_rate=sr, target_length=2.0, hop_length=1.0, n_tracks=2)
    ref = j_chunked(jax.jit(lambda b: jm.apply(params, b)), x, batch_size=2,
                    mesh=j_make_mesh(8), **kw)
    one = wav_chunk_inference(model, x, batch_size=3, device="cpu", **kw)
    got = wav_chunk_inference(model, x, batch_size=2, mesh=cpu_mesh(8), device="cpu", **kw)
    assert got.shape == one.shape == ref.shape == (2, len(x))
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0, atol=CHUNK_ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=CHUNK_REL * np.abs(ref).max())
    with pytest.raises(TypeError, match="nn.Module"):
        wav_chunk_inference(lambda b: model(b), x, batch_size=2, mesh=cpu_mesh(2),
                            device="cpu", **kw)


DCCRN_SMALL = dict(rnn_units=16, kernel_num=(8, 16), rnn_layers=1)


def test_wav_chunk_inference_sharded_dccrn_batch_statistics():
    """DCCRN normalises by batch statistics: 2 replicas of 2 windows each
    normalise over all 4 windows of a call (zero-filled ones included), as
    an unsharded call of 4 does and as JAX's sharded call does, and not as
    an unsharded call of 2 (each shard's own statistics)."""
    args = dict(sample_rate=SR, target_length=0.5, hop_length=0.25, n_tracks=1)
    x = (0.1 * np.random.default_rng(1).standard_normal(int(2.3 * SR))).astype(np.float32)
    model = DCCRN(**DCCRN_SMALL, device="cpu").eval()
    jm = JM.get("DCCRN")(**DCCRN_SMALL)
    margs = model.model_args()
    params = chip_smoke.seeded_flax(TMB.to_flax("DCCRN", model.state_dict(), margs), 0)
    model.load_state_dict(TMB.to_state_dict("DCCRN", params, margs))

    got = wav_chunk_inference(model, x, batch_size=2, mesh=cpu_mesh(2), device="cpu", **args)
    whole = wav_chunk_inference(model, x, batch_size=4, device="cpu", **args)
    per_shard = wav_chunk_inference(model, x, batch_size=2, device="cpu", **args)
    bound = CHUNK_REL * float(whole.abs().max())
    assert float((got - whole).abs().max()) <= bound
    assert float((per_shard - whole).abs().max()) > bound
    apply = jax.jit(lambda b: jm.apply(params, b)[:, None, :])
    ref = j_chunked(apply, x, batch_size=2, mesh=j_make_mesh(2), **args)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=DCCRN_JAX_REL * np.abs(ref).max())
