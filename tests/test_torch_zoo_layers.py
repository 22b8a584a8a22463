"""The zoo's layers one by one against the JAX package's, on the CPU, with
the same weights carried across by the bridge's kinds: the norms, the
conv blocks, the LSTM layers and dual-path blocks, the chunking round trip
(lengths with and without a gap), the resizes and pools, and the blocks of
TDANet, DPTNet, TF-GridNet, MossFormer and MossFormer2; the free
filterbank.

Tolerance: max abs diff ≤ 1e-5 · max|ref| (float32 in another summation
order; measured ≤ 1e-6); the chunking is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sonicsim_tpu.models.dptnet as jdpt
import sonicsim_tpu.models.enc_dec as jencdec
import sonicsim_tpu.models.mossformer as jmf
import sonicsim_tpu.models.mossformer2 as jmf2
import sonicsim_tpu.models.sudormrf as jsudo
import sonicsim_tpu.models.tdanet as jtda
import sonicsim_tpu.models.tfgridnet as jtfg
import sonicsim_tpu.models.zoo_layers as jz
from sonicsim_tpu.models.layers import get_layer as j_get_layer
from sonicsim_tpu_torch import bridge as B
from sonicsim_tpu_torch.models import dptnet, enc_dec, mossformer, mossformer2, sudormrf
from sonicsim_tpu_torch.models import tdanet, tfgridnet
from sonicsim_tpu_torch.models import zoo_layers as tz
from sonicsim_tpu_torch.models.layers import get_activation, get_layer
from torch_threads import one_intra_op_thread  # noqa: F401

REL = 1e-5


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _hold(jmod, tmod, spec, x, cl=False, positive=()):
    """``jmod`` on channel-last ``x`` with seeded params against ``tmod``
    loaded through ``spec`` (the bridge's kinds); ``cl``: the port's module
    takes channel-first (B, C, T) where the JAX one takes (B, T, C);
    ``positive``: top-level leaves drawn positive (variances)."""
    params = chip_smoke.seeded_flax(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x), 0)
    for name in positive:
        params["params"][name] = 0.5 + np.abs(params["params"][name])
    ref = np.asarray(jax.jit(jmod.apply)(params, x))
    # The spec's paths below a root "w" on both sides ("" is the root itself).
    spec = [("/".join(filter(None, ("w", f))), ".".join(filter(None, ("w", t))), k)
            for f, t, k in spec]
    torch.nn.ModuleDict({"w": tmod}).load_state_dict(
        B._spec_to_torch({"w": params["params"]}, spec))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = tmod(xt.transpose(1, 2) if cl else xt)
        got = (got.transpose(1, 2) if cl else got).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())


CN = [("Conv_0", "conv", B._CONV1D), ("GlobalLayerNorm_0", "norm", B._GLN)]
ACT = [("PReLU_0", "act", B._PRELU)]


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 8), (1, 8)])
def test_conv_blocks(stride, groups):
    x = _x(2, 37, 8)
    _hold(jz.ConvNormAct(8, 5, stride, groups), tz.ConvNormAct(8, 8, 5, stride, groups), CN + ACT,
          x, cl=True)
    _hold(jz.ConvNorm(8, 5, stride, groups), tz.ConvNorm(8, 8, 5, stride, groups), CN, x, cl=True)
    _hold(jz.DilatedConvNorm(8, 5, stride, 2, groups),
          tz.DilatedConvNorm(8, 8, 5, stride, 2, groups), CN, x, cl=True)
    _hold(jz.NormAct(8), tz.NormAct(8), [("GlobalLayerNorm_0", "norm", B._GLN),
                                         ("PReLU_0", "act", B._PRELU)], x, cl=True)


def test_group_norms():
    x = _x(2, 9, 5, 6)
    _hold(jz.GroupNorm1(), tz.GroupNorm1(6, channel_last=True), [("", "", B._GN)], x)
    for running in (False, True):
        jm = jz.StatelessBatchNorm(6, use_running_stats=running)
        spec = [("scale", "weight", B._RAW), ("bias", "bias", B._RAW)]
        if running:
            spec += [("mean", "running_mean", B._RAW), ("var", "running_var", B._RAW)]
        _hold(jm, tz.StatelessBatchNorm(6, use_running_stats=running), spec, x,
              positive=("var",) if running else ())


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_blocks(bidirectional):
    _hold(jz.LSTMLayer(7, bidirectional), tz.LSTMLayer(5, 7, bidirectional), [("", "", B._LSTM)],
          _x(3, 11, 5))
    _hold(jz.ResRNN(6, 7, bidirectional), tz.ResRNN(6, 7, bidirectional),
          [("GroupNorm1_0", "norm", B._GN), ("LSTMLayer_0", "rnn", B._LSTM),
           ("Dense_0", "proj", B._LINEAR)], _x(2, 9, 6))
    _hold(jz.DualRNNBlock(6, 7, bidirectional), tz.DualRNNBlock(6, 7, bidirectional),
          [(f"{n}_{i}", f"{side}_{part}", kind) for i, side in enumerate(("intra", "inter"))
           for n, part, kind in (("LSTMLayer", "rnn", B._LSTM), ("Dense", "linear", B._LINEAR),
                                 ("GroupNorm1", "norm", B._GN))], _x(2, 5, 8, 6))


@pytest.mark.parametrize("t,chunk", [(37, 8), (36, 8), (44, 8), (51, 10), (20, 10)])
def test_segment_overlap_add_round_trip(t, chunk):
    """``segment_sequence`` equals the JAX package's, gap and all, and
    ``overlap_add_sequence`` gives back twice the input (each frame lies in
    two chunks), with and without a gap."""
    x = _x(2, t, 3)
    ref, ref_gap = jz.segment_sequence(jnp.asarray(x), chunk)
    got, gap = tz.segment_sequence(torch.from_numpy(x), chunk)
    assert gap == ref_gap and np.array_equal(got.numpy(), np.asarray(ref))
    back = tz.overlap_add_sequence(got, gap).numpy()
    assert np.array_equal(back, np.asarray(jz.overlap_add_sequence(ref, ref_gap)))
    np.testing.assert_allclose(back, 2 * x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("t,size", [(37, 19), (40, 10), (10, 37), (7, 7), (1000, 63)])
def test_resizes_and_pools(t, size):
    x = _x(2, t, 3)
    xt = torch.from_numpy(x).transpose(1, 2)
    got = sudormrf.nearest_resize(xt, size).transpose(1, 2).numpy()
    assert np.array_equal(got, np.asarray(jsudo.nearest_resize(jnp.asarray(x), size)))
    got = sudormrf.nearest_upsample_2x(xt).transpose(1, 2).numpy()
    assert np.array_equal(got, np.asarray(jsudo.nearest_upsample_2x(jnp.asarray(x))))
    if size <= t:
        ref = np.asarray(jtda.adaptive_avg_pool(jnp.asarray(x), size))
        got = tdanet.adaptive_avg_pool(xt, size).transpose(1, 2).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())
        want = torch.nn.functional.adaptive_avg_pool1d(xt, size).transpose(1, 2).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(ref).max())


def _mha_spec(f, t, heads):
    return [(f, t, B._mha(heads))]


@pytest.mark.parametrize("torch_compat", [False, True])
def test_tdanet_global_attention(torch_compat):
    ga = "attn"
    spec = [("attn_in_norm", f"{ga}.attn_in_norm", B._LN), ("attn_norm", f"{ga}.norm", B._LN),
            ("mlp_dwconv", "mlp.dwconv", B._CONV1D)]
    spec += ([("v_proj", f"{ga}.attn", B._VPROJ), ("out_proj", f"{ga}.attn.out_proj", B._LINEAR)]
             if torch_compat else _mha_spec("attn", f"{ga}.attn", 8))
    for part in ("fc1", "fc2"):
        spec += [(f"mlp_{part}/{a}", f"mlp.{part}.{b}", k) for a, b, k in CN]
    _hold(jtda.GlobalAttention(16, torch_compat=torch_compat),
          tdanet.GlobalAttention(16, torch_compat), spec, _x(2, 13, 16), cl=True)


def test_dptnet_transformer_layer():
    spec = _mha_spec("self_attn", "self_attn", 4) + [
        ("norm_attn", "norm_attn", B._DPGN), ("rnn", "rnn", B._LSTM),
        ("ff_linear", "feed_forward.2", B._LINEAR), ("norm_ff", "norm_ff", B._DPGN)]
    _hold(jdpt.ImprovedTransformerLayer(8, 4, 6, True),
          dptnet.ImprovedTransformerLayer(8, 4, 6, True), spec, _x(3, 10, 8))


@pytest.mark.parametrize("ks,hs", [(4, 1), (2, 2)])
def test_tfgridnet_block(ks, hs):
    spec = [s for s in B._tfgridnet_spec([0]) if s[0].startswith("block_0/")]
    spec = [(f.removeprefix("block_0/"), t.removeprefix("blocks.0."), k) for f, t, k in spec]
    _hold(jtfg.GridNetV2Block(8, ks, hs, 9, 6, 2, 20),
          tfgridnet.GridNetV2Block(8, ks, hs, 9, 6, 2, 20), spec, _x(2, 7, 9, 8))
    x = _x(5, 11, 3)
    ref = np.asarray(jtfg._unfold_1d(jnp.asarray(x), ks, hs))
    assert np.array_equal(tfgridnet._unfold_1d(torch.from_numpy(x), ks, hs).numpy(), ref)


def test_mossformer_blocks():
    x = _x(2, 23, 8)
    _hold(jmf.ScaleNorm(8), mossformer.ScaleNorm(8), [("g", "g", B._RAW)], x)
    for norm in ("scalenorm", "layernorm"):
        _hold(jmf.FFConvM(8, 12, norm), mossformer.FFConvM(8, 12, norm),
              [(f.removeprefix("m/"), t.removeprefix("m."), k)
               for f, t, k in B._ffconvm_spec("m", "m", norm == "scalenorm")], x)
    core = "mask_net.mdl.att_mdl.mossformerM.layers.0."
    spec = [(f.removeprefix("flash_0/"), t.removeprefix(core), k)
            for f, t, k in B._mossformer_spec([0], False) if f.startswith("flash_0/")]
    for expansion in (4.0, 2.0):
        _hold(jmf.FlashBlock(8, 10, 6, expansion), mossformer.FlashBlock(8, 10, 6, expansion),
              spec, x)
    ref = np.asarray(jmf._rotary(jnp.asarray(x), 4))
    np.testing.assert_allclose(mossformer._rotary(torch.from_numpy(x), 4).numpy(), ref,
                               rtol=0, atol=REL * np.abs(ref).max())
    scale = {"params": {"scale": np.ones(1, np.float32)}}
    ref = np.asarray(jmf.ScaledSinuEmbedding(8).apply(scale, 29))
    np.testing.assert_allclose(mossformer.ScaledSinuEmbedding(8)(29, "cpu").detach().numpy(), ref,
                               rtol=0, atol=1e-7)


def test_mossformer2_fsmn_blocks():
    core = "mask_net.mdl.intra_mdl.mossformerM.fsmn.0."
    spec = [(f.removeprefix("fsmn_0/"), t.removeprefix(core), k)
            for f, t, k in B._mossformer_spec([0], True) if f.startswith("fsmn_0/")]
    _hold(jmf2.GatedFSMNBlock(8, 6), mossformer2.GatedFSMNBlock(8, 6), spec, _x(2, 45, 8))
    sub = [(f.removeprefix("fsmn/"), t.removeprefix("gated_fsmn.fsmn."), k) for f, t, k in spec
           if f.startswith("fsmn/")]
    _hold(jmf2.UniDeepFsmnDilated(6, 5), mossformer2.UniDeepFsmnDilated(6, 5), sub, _x(2, 45, 6))


def test_free_filterbank():
    wav = _x(2, 401)
    spec = [("filterbank", "filterbank", B._CONV1D)]
    _hold(jencdec.FreeEncoder(12, 16, activation="relu"),
          enc_dec.FreeEncoder(12, 16, activation="relu"), spec, wav)
    rep = _x(2, 49, 12)
    jd, td = jencdec.FreeDecoder(16), enc_dec.FreeDecoder(16, n_filters=12)
    _hold(jd, td, [("filterbank", "filterbank", B._CONVT1D)], rep)
    params = chip_smoke.seeded_flax(jax.eval_shape(jd.init, jax.random.PRNGKey(0), rep), 0)
    td.load_state_dict(B._spec_to_torch(params, [("filterbank", "filterbank", B._CONVT1D)]))
    for length in (300, 500):
        ref = np.asarray(jd.apply(params, rep, length))
        got = td(torch.from_numpy(rep), length).detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())
    enc, dec = enc_dec.make_enc_dec(n_filters=12, kernel_size=16)
    assert dec.filterbank.in_channels == 12 and enc.filterbank.out_channels == 12


def test_activations():
    x = _x(3, 5)
    for name in ("relu", "sigmoid", "tanh", "gelu", "softmax", "linear"):
        ref = np.asarray(j_get_layer(name)(jnp.asarray(x)))
        got = get_layer(name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got, get_activation(name)(torch.from_numpy(x)).numpy())
