"""The port's losses and metrics against the JAX package's, on the same
numpy inputs: SI-SDR, SNR, BSS SDR and their improvements, the negative-SDR
losses, PIT, STOI, PESQ and the MetricsTracker's CSV.

Tolerances: SI-SDR, SNR and the losses within 1e-3 dB; BSS SDR within
1e-2 dB (a float32 512-tap Toeplitz solve on both sides); permutations
equal; STOI and PESQ (numpy copies) within 1e-6 of JAX's on equal inputs.
"""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonicsim_tpu.losses as JL
import sonicsim_tpu.metrics as JMet
import sonicsim_tpu_torch.losses as TL
import sonicsim_tpu_torch.metrics as TMet

SR = 16000
DB, BSS_DB = 1e-3, 1e-2


def _sources(seed, b=2, n=3, t=4000):
    """Targets, and estimates that are noisy, scaled and shuffled copies."""
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal((b, n, t)).astype(np.float32)
    est = np.stack([tgt[i, rng.permutation(n)] for i in range(b)])
    est = (est * rng.uniform(0.5, 2.0, (b, n, 1))
           + 0.3 * rng.standard_normal((b, n, t))).astype(np.float32)
    return est, tgt


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(ours, ref, atol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


def test_sdr_metrics():
    est, tgt = _sources(0)
    mix = tgt.sum(axis=1)[:, None, :] + 0.1
    for name, atol in (("si_sdr", DB), ("snr", DB), ("bss_sdr", BSS_DB)):
        _close(getattr(TMet, name)(_t(est), _t(tgt)),
               getattr(JMet, name)(jnp.asarray(est), jnp.asarray(tgt)), atol)
    for name, atol in (("si_sdr_improvement", DB), ("sdr_improvement", BSS_DB)):
        ours = getattr(TMet, name)(_t(est), _t(tgt), _t(mix))
        ref = getattr(JMet, name)(jnp.asarray(est), jnp.asarray(tgt), jnp.asarray(mix))
        for a, b in zip(ours, ref):
            _close(a, b, atol)


@pytest.mark.parametrize("sdr_type", ["snr", "sisdr", "sdsdr"])
@pytest.mark.parametrize("zero_mean,take_log", [(True, True), (False, False)])
def test_neg_sdr_losses(sdr_type, zero_mean, take_log):
    est, tgt = _sources(1)
    kw = dict(sdr_type=sdr_type, zero_mean=zero_mean, take_log=take_log)
    atol = DB if take_log else 1e-5
    _close(TL.pairwise_neg_sdr(_t(est), _t(tgt), **kw),
           JL.pairwise_neg_sdr(jnp.asarray(est), jnp.asarray(tgt), **kw), atol)
    flat_e, flat_t = est.reshape(-1, est.shape[-1]), tgt.reshape(-1, tgt.shape[-1])
    _close(TL.SingleSrcNegSDR(**kw)(_t(flat_e), _t(flat_t)),
           JL.SingleSrcNegSDR(**kw)(jnp.asarray(flat_e), jnp.asarray(flat_t)), atol)
    _close(TL.MultiSrcNegSDR(**kw)(_t(est), _t(tgt)),
           JL.MultiSrcNegSDR(**kw)(jnp.asarray(est), jnp.asarray(tgt)), atol)


@pytest.mark.parametrize("n_src", [2, 3, 7])
def test_find_best_perm_and_reorder(n_src):
    est, tgt = _sources(2, b=3, n=n_src, t=1000)
    pw = TL.pairwise_neg_sdr(_t(est), _t(tgt))
    loss, idx = TL.find_best_perm(pw)
    ref_loss, ref_idx = JL.find_best_perm(jnp.asarray(pw.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    _close(loss, ref_loss, 1e-5)
    np.testing.assert_array_equal(TL.reorder_sources(_t(est), idx).numpy(),
                                  np.asarray(JL.reorder_sources(jnp.asarray(est), ref_idx)))


@pytest.mark.parametrize("pit_from,loss", [("pw_mtx", "PairwiseNegSDR"),
                                           ("pw_pt", "SingleSrcNegSDR"),
                                           ("perm_avg", "MultiSrcNegSDR")])
@pytest.mark.parametrize("threshold_byloss", [True, False])
def test_pit_loss_wrapper(pit_from, loss, threshold_byloss):
    est, tgt = _sources(3)
    ours = TL.PITLossWrapper(getattr(TL, loss)("sisdr"), pit_from, threshold_byloss)
    ref = JL.PITLossWrapper(getattr(JL, loss)("sisdr"), pit_from, threshold_byloss)
    value, reordered = ours(_t(est), _t(tgt), return_ests=True)
    ref_value, ref_reordered = ref(jnp.asarray(est), jnp.asarray(tgt), return_ests=True)
    _close(value, ref_value, DB)
    np.testing.assert_array_equal(reordered.numpy(), np.asarray(ref_reordered))
    _close(ours(_t(est), _t(tgt)), ref(jnp.asarray(est), jnp.asarray(tgt)), DB)


def _speechy(seed, t=2 * SR):
    rng = np.random.default_rng(seed)
    n = np.arange(t) / SR
    ref = (0.3 * np.sin(2 * np.pi * 180 * n) * (1 + 0.5 * np.sin(2 * np.pi * 4 * n))
           + 0.02 * rng.standard_normal(t)).astype(np.float32)
    return ref, (ref + 0.05 * rng.standard_normal(t)).astype(np.float32)


def test_stoi_and_pesq():
    ref, est = _speechy(4)
    assert TMet.stoi(ref, est, SR) == pytest.approx(JMet.stoi(ref, est, SR), abs=1e-6)
    for mode in ("nb", "wb"):
        assert TMet.pesq(ref, est, SR, mode) == pytest.approx(
            JMet.pesq(ref, est, SR, mode), abs=1e-6)
        fn = TMet.make_pesq(mode)
        assert fn.backend == JMet.make_pesq(mode).backend
        assert fn(ref, est, SR) == pytest.approx(TMet.pesq(ref, est, SR, mode), abs=1e-6)


def test_tracker_csv_matches_jax(tmp_path):
    rows = []
    for seed in (5, 6, 7):
        ref, est = _speechy(seed, SR)
        other, other_est = _speechy(seed + 10, SR)
        clean = np.stack([ref, 0.5 * other[::-1]])
        rows.append((clean.sum(0), clean, np.stack([other_est[::-1] * 0.5, est])))
    rows.append((rows[0][0], np.stack([rows[0][1][0], np.zeros(SR, np.float32)]),
                 rows[0][2]))  # a silent reference: skipped by both
    trackers = {
        "port": TMet.MetricsTracker(tmp_path / "port.csv", extra_metrics={"pesq_nb": TMet.make_pesq("nb")},
                                    device="cpu"),
        "jax": JMet.MetricsTracker(tmp_path / "jax.csv", extra_metrics={"pesq_nb": JMet.make_pesq("nb")}),
    }
    for tr in trackers.values():
        for i, (mix, clean, est) in enumerate(rows):
            tr(mix, clean, est, f"seg{i}")
        assert tr.skipped_silent == 1
        tr.final()
    tables = {}
    for name in trackers:
        with open(tmp_path / f"{name}.csv") as f:
            tables[name] = list(csv.DictReader(f))
    assert [r["snt_id"] for r in tables["port"]] == ["seg0", "seg1", "seg2", "avg", "std"]
    assert tables["port"][0].keys() == tables["jax"][0].keys()
    for a, b in zip(tables["port"], tables["jax"]):
        assert a["snt_id"] == b["snt_id"]
        for col, atol in (("si-snr", DB), ("si-snr_i", DB), ("sdr", BSS_DB), ("sdr_i", BSS_DB),
                          ("stoi", 1e-6), ("pesq_nb", 1e-5)):
            assert float(a[col]) == pytest.approx(float(b[col]), abs=atol), col
    assert ((tmp_path / "port.meta.json").read_text()
            == (tmp_path / "jax.meta.json").read_text())
