"""Composite speech-quality measures: SSNR, LLR, WSS, CSIG/CBAK/COVL.

Port of ``sonicsim_tpu.metrics.composite`` (reference enhancement/
look2hear/metrics/wrapper_vctk.py:62-419): the Loizou objective measures
(Hu & Loizou 2008), numpy on the host, copied; the composite C-measures'
PESQ term comes from the port's ``metrics/pesq.py`` unless given.
"""

from __future__ import annotations

import numpy as np

_CENT_FREQ = np.array([
    50., 120, 190, 260, 330, 400, 470, 540, 617.372, 703.378, 798.717,
    904.128, 1020.38, 1148.30, 1288.72, 1442.54, 1610.70, 1794.16, 1993.93,
    2211.08, 2446.71, 2701.97, 2978.04, 3276.17, 3597.63,
])
_BANDWIDTH = np.array([
    70., 70, 70, 70, 70, 70, 70, 77.3724, 86.0056, 95.3398, 105.411,
    116.256, 127.914, 140.423, 153.823, 168.154, 183.457, 199.776, 217.153,
    235.631, 255.255, 276.072, 298.126, 321.465, 346.136,
])


def _frames(x: np.ndarray, winlength: int, skiprate: int) -> np.ndarray:
    num = int(len(x) / skiprate - (winlength / skiprate))
    idx = np.arange(num)[:, None] * skiprate + np.arange(winlength)[None, :]
    time = np.linspace(1, winlength, winlength) / (winlength + 1)
    window = 0.5 * (1 - np.cos(2 * np.pi * time))
    return x[idx] * window


def ssnr(ref: np.ndarray, deg: np.ndarray, srate: int = 16000, eps: float = 1e-10):
    """(overall SNR, mean segmental SNR), wrapper_vctk.py:62-110 parity."""
    ref = np.asarray(ref, np.float64).copy()
    deg = np.asarray(deg, np.float64).copy()
    clean = ref - ref.mean()
    proc = deg - deg.mean()
    proc = proc * (np.max(np.abs(clean)) / (np.max(np.abs(proc)) + eps))
    # The reference removes DC / rescales IN PLACE before taking dif
    # (wrapper_vctk.py:73-80), so the overall SNR sees the mutated
    # signals — a pure gain mismatch therefore scores near-infinite SNR,
    # not ~6 dB.
    dif = clean - proc
    overall = 10 * np.log10(np.sum(clean**2) / (np.sum(dif**2) + 1e-19))

    winlength = int(np.round(30 * srate / 1000))
    skiprate = winlength // 4
    cf = _frames(clean, winlength, skiprate)
    pf = _frames(proc, winlength, skiprate)
    sig = np.sum(cf**2, axis=1)
    noise = np.sum((cf - pf) ** 2, axis=1)
    seg = 10 * np.log10(sig / (noise + eps) + eps)
    seg = np.clip(seg, -10.0, 35.0)
    return overall, float(np.mean(seg)) if len(seg) else float("nan")


def wss(ref: np.ndarray, deg: np.ndarray, srate: int = 16000) -> float:
    """Mean weighted-spectral-slope distortion (wrapper_vctk.py:112-266)."""
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    winlength = round(30 * srate / 1000.0)
    skiprate = int(np.floor(winlength / 4))
    max_freq = srate / 2
    num_crit = 25
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    n_half = n_fft // 2
    kmax, klocmax = 20.0, 1.0

    bw_min = _BANDWIDTH[0]
    min_factor = np.exp(-30.0 / (2 * 2.303))
    j = np.arange(n_half)
    crit_filter = np.zeros((num_crit, n_half))
    for i in range(num_crit):
        f0 = np.floor((_CENT_FREQ[i] / max_freq) * n_half)
        bw = (_BANDWIDTH[i] / max_freq) * n_half
        norm = np.log(bw_min) - np.log(_BANDWIDTH[i])
        crit_filter[i] = np.exp(-11 * (((j - f0) / bw) ** 2) + norm)
        crit_filter[i] *= crit_filter[i] > min_factor

    cf = _frames(ref, winlength, skiprate)
    pf = _frames(deg, winlength, skiprate)
    cspec = np.abs(np.fft.fft(cf, n_fft, axis=1)) ** 2
    pspec = np.abs(np.fft.fft(pf, n_fft, axis=1)) ** 2
    ce = 10 * np.log10(np.maximum(cspec[:, :n_half] @ crit_filter.T, 1e-10))
    pe = 10 * np.log10(np.maximum(pspec[:, :n_half] @ crit_filter.T, 1e-10))

    distortion = []
    for frame in range(len(ce)):
        clean_energy, processed_energy = ce[frame], pe[frame]
        clean_slope = np.diff(clean_energy)
        processed_slope = np.diff(processed_energy)

        def loc_peaks(slope, energy):
            peaks = []
            for i in range(num_crit - 1):
                n = i
                if slope[i] > 0:
                    while n < num_crit - 1 and slope[n] > 0:
                        n += 1
                    peaks.append(energy[n - 1])
                else:
                    while n >= 0 and slope[n] <= 0:
                        n -= 1
                    peaks.append(energy[n + 1])
            return np.array(peaks)

        cp = loc_peaks(clean_slope, clean_energy)
        pp = loc_peaks(processed_slope, processed_energy)
        w_clean = (kmax / (kmax + clean_energy.max() - clean_energy[:-1])) * (
            klocmax / (klocmax + cp - clean_energy[:-1])
        )
        w_proc = (kmax / (kmax + processed_energy.max() - processed_energy[:-1])) * (
            klocmax / (klocmax + pp - processed_energy[:-1])
        )
        w = (w_clean + w_proc) / 2
        d = np.sum(w * (clean_slope[: num_crit - 1] - processed_slope[: num_crit - 1]) ** 2)
        distortion.append(d / np.sum(w))
    if not distortion:
        return float("nan")
    # The reference composites average only the lowest 95% of frame
    # distortions (wrapper_vctk.py:344-349); that trimmed mean is the
    # only wss value they ever consume.
    distortion = np.sort(np.nan_to_num(np.asarray(distortion)))
    keep = distortion[: int(round(len(distortion) * 0.95))]
    return float(np.mean(keep)) if len(keep) else float("nan")


def _lpcoeff(frame: np.ndarray, order: int):
    """Levinson-Durbin LPC prediction polynomial [1, a1..ap]."""
    r = np.array([np.dot(frame[: len(frame) - k], frame[k:]) for k in range(order + 1)])
    if r[0] <= 0:
        return np.concatenate([[1.0], np.zeros(order)])
    a = np.zeros(order + 1)
    a[0] = 1.0
    e = r[0]
    for i in range(1, order + 1):
        acc = r[i] + np.dot(a[1:i], r[i - 1 : 0 : -1])
        k = -acc / e
        a[1:i] = a[1:i] + k * a[i - 1 : 0 : -1]
        a[i] = k
        e *= 1 - k * k
        if e <= 0:
            break
    return a


def llr(ref: np.ndarray, deg: np.ndarray, srate: int = 16000) -> float:
    """Mean log-likelihood ratio (wrapper_vctk.py:269-330)."""
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    winlength = round(30 * srate / 1000.0)
    skiprate = int(np.floor(winlength / 4))
    order = 10 if srate < 10000 else 16
    cf = _frames(ref, winlength, skiprate)
    pf = _frames(deg, winlength, skiprate)
    vals = []
    for c, p in zip(cf, pf):
        a_clean = _lpcoeff(c, order)
        a_proc = _lpcoeff(p, order)
        r = np.array([np.dot(c[: len(c) - k], c[k:]) for k in range(order + 1)])
        toeplitz = r[np.abs(np.arange(order + 1)[:, None] - np.arange(order + 1)[None, :])]
        num = a_proc @ toeplitz @ a_proc
        den = a_clean @ toeplitz @ a_clean
        if den > 0 and num / den > 0:
            vals.append(np.log(num / den))
        else:
            # Reference parity: invalid frames become 0.0 via
            # np.nan_to_num (wrapper_vctk.py:316) and ARE included in
            # the sorted/trimmed mean, not dropped.
            vals.append(0.0)
    vals = np.sort(vals)
    vals = vals[: int(round(len(vals) * 0.95))]  # standard 95% trimming
    return float(np.mean(vals)) if len(vals) else float("nan")


def _trim_mos(v: float) -> float:
    return float(np.clip(v, 1.0, 5.0))


def composite_measures(
    ref: np.ndarray, deg: np.ndarray, srate: int = 16000, pesq_value: float | None = None
) -> dict:
    """CSIG/CBAK/COVL (+ raw SSNR/LLR/WSS), wrapper_vctk.py:44-120.

    ``pesq_value`` overrides the PESQ term (e.g. from the compiled ITU
    binding); by default it is computed with the native wideband P.862
    pipeline (metrics/pesq.py), matching the reference's use of
    pesq(..., 'wb') inside its VCTK composites."""
    wss_dist = wss(ref, deg, srate)
    llr_mean = llr(ref, deg, srate)
    _, seg_snr = ssnr(ref, deg, srate)
    out = {"ssnr": seg_snr, "llr": llr_mean, "wss": wss_dist}
    if pesq_value is None:
        from .pesq import pesq as _pesq

        try:
            pesq_value = _pesq(ref, deg, srate, "wb")
        except ValueError:  # too-short segment
            out.update(
                {"csig": float("nan"), "cbak": float("nan"), "covl": float("nan")}
            )
            return out
    p = pesq_value
    out["csig"] = _trim_mos(3.093 - 1.029 * llr_mean + 0.603 * p - 0.009 * wss_dist)
    out["cbak"] = _trim_mos(1.634 + 0.478 * p - 0.007 * wss_dist + 0.063 * seg_snr)
    out["covl"] = _trim_mos(1.594 + 0.805 * p - 0.512 * llr_mean - 0.007 * wss_dist)
    return out
