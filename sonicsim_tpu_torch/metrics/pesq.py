"""PESQ (ITU-T P.862), native NumPy implementation.

The reference scores every eval segment with PESQ-nb and PESQ-wb through
torchmetrics' binding of the compiled ITU reference C code
(separation/look2hear/metrics/wrapper.py:55-56,100-101). That binding is a
hard native dependency; here the P.862 pipeline is implemented directly so
the metric battery runs with no compiled sidecar.

Pipeline (P.862 clause 10, P.862.2 for wideband):

1.  level alignment — both signals scaled so the 300-3000 Hz band power
    equals the standard calibration power (1e7).
2.  input filtering — narrowband: IRS-receive-style FFT-domain bandpass;
    wideband: 100 Hz high-pass (the P.862.2 input filter).
3.  time alignment — envelope cross-correlation for the crude delay, then
    per-utterance fine alignment by cross-correlating the filtered signals.
4.  auditory transform — 32 ms Hann frames at 50% overlap, power spectra
    binned to a Bark scale (42 bands nb / 49 bands wb), partial frequency
    compensation of the reference and partial gain compensation of the
    degraded signal, then Zwicker-law specific loudness with per-band
    hearing thresholds (Terhardt threshold-in-quiet approximation).
5.  disturbance processing — center-clipped loudness difference (deadzone
    0.25*min), asymmetry factor ((B_deg+50)/(B_ref+50))^1.2 clipped to
    [0, 12] with values < 3 zeroed, frame weighting ((E+1e5)/1e7)^0.04,
    L6-over-split-second / L2-over-time aggregation for the symmetric
    disturbance and L1/L2 for the asymmetric one.
6.  MOS: raw = 4.5 - 0.1*D - 0.0309*DA, mapped to MOS-LQO with the
    published logistic (P.862.1 nb: -1.4945x+4.6607; P.862.2 wb:
    -1.3669x+3.8224).

Faithfulness notes: the loudness calibration constants (Sp, Sl) are derived
numerically at import from the standard's stated calibration (a 1 kHz tone
at 40 dB SPL maps to intensity 1e4 in its Bark band and total loudness
1 sone) instead of hard-coding the reference C tables; Bark band edges are
uniform on the Zwicker Hz->Bark curve rather than the C code's hand-tuned
tables; recursive utterance splitting and bad-interval realignment are not
implemented (segments scored here are short VAD spans, where a single
crude+fine delay suffices). Scores are therefore P.862-structured, not
bit-exact with the ITU binary — `sidecars.make_pesq` prefers the compiled
`pesq` package when it is importable and falls back to this implementation.

Backend disclosure: a numeric |ΔMOS| bound against the ITU code could not
be measured in this environment — the `pesq` wheel is not installed, the
build host has no network egress (`pip download pesq` → "no matching
distribution", 2026-08), and the ITU C sources are not vendored anywhere
in-tree. Until a compiled backend is available to golden-diff against,
every consumer discloses the backend: `make_pesq` exposes ``fn.backend``
("native-p862-approx"), the MetricsTracker records it in
``metrics.meta.json``, and `scripts/test.py` names the CSV columns
``pesq_nb_native``/``pesq_wb_native`` so the scores can never be confused
with ITU P.862 numbers.
"""

from __future__ import annotations

import numpy as np

from ..utils.wavio import resample

CAL_POWER = 1e7  # standard listening-level power after alignment (~79 dB SPL)
SPL_REF_DB = 79.0  # SPL assigned to CAL_POWER for threshold/calibration math
ZWICKER = 0.23
SPLIT_SEC_FRAMES = 20


def _bark_of_hz(f):
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _threshold_in_quiet_db(f):
    """Terhardt threshold-in-quiet approximation, dB SPL."""
    f = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (
        3.64 * f**-0.8
        - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
        + 1e-3 * f**4
    )


class _Band:
    """Per-mode constants: frame/FFT sizes, Bark binning, calibration."""

    def __init__(self, fs: int, n_bands: int):
        self.fs = fs
        self.frame = int(0.032 * fs)  # 32 ms
        self.hop = self.frame // 2
        self.nfft = self.frame
        freqs = np.fft.rfftfreq(self.nfft, 1.0 / fs)
        # Uniform Bark bands from 100 Hz to Nyquist.
        z_lo, z_hi = _bark_of_hz(100.0), _bark_of_hz(fs / 2)
        edges_z = np.linspace(z_lo, z_hi, n_bands + 1)
        z_bins = _bark_of_hz(freqs)
        self.band_of_bin = np.clip(
            np.searchsorted(edges_z, z_bins, side="right") - 1, -1, n_bands - 1
        )
        self.band_of_bin[z_bins < z_lo] = -1
        self.n_bands = n_bands
        centers_z = 0.5 * (edges_z[:-1] + edges_z[1:])
        # invert bark -> hz numerically on a dense grid
        grid = np.linspace(20.0, fs / 2, 4 * self.nfft)
        self.centers_hz = np.interp(centers_z, _bark_of_hz(grid), grid)
        self.widths_z = np.diff(edges_z)
        # Per-band absolute hearing threshold as intensity (power units of
        # the level-aligned domain: CAL_POWER <-> SPL_REF_DB).
        thr_db = _threshold_in_quiet_db(self.centers_hz)
        self.threshold = 10.0 ** ((thr_db - SPL_REF_DB) / 10.0) * CAL_POWER
        self.window = np.hanning(self.frame + 2)[1:-1]
        self.sp, self.sl = self._calibrate()

    def bark_spectrum(self, x: np.ndarray) -> np.ndarray:
        """(T,) -> (n_frames, n_bands) Bark power spectra (pre-Sp scale)."""
        n = max((len(x) - self.frame) // self.hop + 1, 0)
        if n == 0:
            return np.zeros((0, self.n_bands))
        idx = np.arange(self.frame)[None, :] + self.hop * np.arange(n)[:, None]
        spec = np.fft.rfft(x[idx] * self.window, self.nfft, axis=-1)
        power = (spec.real**2 + spec.imag**2) / np.sum(self.window**2)
        out = np.zeros((n, self.n_bands))
        valid = self.band_of_bin >= 0
        np.add.at(out.T, self.band_of_bin[valid], power[:, valid].T)
        # normalize by band width in bins so bands are densities, matching
        # the per-Bark-band intensity view of the standard
        counts = np.bincount(
            self.band_of_bin[valid], minlength=self.n_bands
        ).astype(np.float64)
        return out / np.maximum(counts, 1.0)[None, :]

    def loudness(self, bark: np.ndarray) -> np.ndarray:
        """Zwicker specific loudness per band (sone/Bark)."""
        p = bark  # intensity, already Sp-scaled by caller
        p0 = self.threshold[None, :]
        ratio = np.maximum(0.5 + 0.5 * p / p0, 0.5)
        loud = self.sl * (p0 / 0.5) ** ZWICKER * (ratio**ZWICKER - 1.0)
        return np.maximum(loud, 0.0)

    def _calibrate(self) -> tuple[float, float]:
        """Derive (Sp, Sl) from the 1 kHz / 40 dB SPL calibration tone."""
        dur = 0.5
        t = np.arange(int(self.fs * dur)) / self.fs
        # mean-square power for 40 dB SPL given CAL_POWER <-> SPL_REF_DB
        ms = 10.0 ** ((40.0 - SPL_REF_DB) / 10.0) * CAL_POWER
        tone = np.sqrt(2.0 * ms) * np.sin(2 * np.pi * 1000.0 * t)
        bark = self.bark_spectrum(tone).mean(axis=0)
        sp = 1e4 / bark.max()  # tone band intensity -> 10^(40/10)
        self.sp, self.sl = sp, 1.0  # temporarily, for loudness() below
        loud = self.loudness((bark * sp)[None, :])
        total = float(np.sum(loud * self.widths_z))
        return sp, 1.0 / max(total, 1e-30)


_BAND_CACHE: dict[tuple[int, int], _Band] = {}


def _band(fs: int, n_bands: int) -> _Band:
    key = (fs, n_bands)
    if key not in _BAND_CACHE:
        _BAND_CACHE[key] = _Band(fs, n_bands)
    return _BAND_CACHE[key]


def _band_power(x: np.ndarray, fs: int, lo: float, hi: float) -> float:
    """Mean-square contribution of the [lo, hi] Hz band (Parseval, rfft)."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    sel = (freqs >= lo) & (freqs <= hi)
    return float(np.sum(np.abs(spec[sel]) ** 2) * 2.0 / max(len(x), 1) ** 2)


def _align_level(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale so 300-3000 Hz band mean-square power equals CAL_POWER
    (P.862 cl. 10.1.2)."""
    p = _band_power(x, fs, 300.0, 3000.0)
    if p <= 1e-20:
        return x.astype(np.float64)
    return x * np.sqrt(CAL_POWER / p)


def _irs_receive_filter(x: np.ndarray, fs: int) -> np.ndarray:
    """FFT-domain IRS-receive-style bandpass (narrowband input filter).

    Piecewise-linear (in log-f / dB) approximation of the P.48 IRS receive
    characteristic used by P.862 for nb mode.
    """
    pts_hz = np.array(
        [0, 50, 100, 125, 160, 200, 250, 300, 350, 400, 500, 600, 700,
         800, 1000, 1300, 1600, 2000, 2500, 3000, 3250, 3500, 4000, 5000,
         6300, 8000]
    )
    pts_db = np.array(
        [-200.0, -40, -20, -12, -6, 0, 4, 6, 8, 10, 11, 12, 12, 12, 12,
         12, 12, 12, 12, 12, 10, 4, -200, -200, -200, -200]
    )
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    gain_db = np.interp(freqs, pts_hz, pts_db)
    return np.fft.irfft(spec * 10.0 ** (gain_db / 20.0), len(x))


def _wb_input_filter(x: np.ndarray, fs: int) -> np.ndarray:
    """P.862.2 wideband input filter: high-pass at 100 Hz, flat above 320."""
    pts_hz = np.array([0, 50, 100, 150, 200, 250, 300, 350, fs / 2])
    pts_db = np.array([-500.0, -40, -15, -7, -3, -1, 0, 0, 0])
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    gain_db = np.interp(freqs, pts_hz, pts_db)
    return np.fft.irfft(spec * 10.0 ** (gain_db / 20.0), len(x))


def _crude_delay(ref: np.ndarray, deg: np.ndarray, fs: int) -> int:
    """Envelope cross-correlation delay estimate, samples (deg vs ref)."""
    frame = max(fs // 250, 1)  # 4 ms frames
    n = min(len(ref), len(deg)) // frame

    def env(x):
        e = np.square(x[: n * frame]).reshape(n, frame).sum(axis=1)
        return np.log10(e + 1e4)

    er, ed = env(ref), env(deg)
    er = er - er.mean()
    ed = ed - ed.mean()
    if n < 4:
        return 0
    corr = np.correlate(ed, er, mode="full")
    lag = int(np.argmax(corr)) - (n - 1)
    return lag * frame


def _fine_delay(
    ref: np.ndarray, deg: np.ndarray, crude: int, fs: int
) -> int:
    """Refine the crude delay: exact FFT cross-correlation in a +-16 ms win."""
    span = int(0.016 * fs)
    n = min(len(ref), len(deg))
    if n <= fs // 50:
        return crude
    nfft = 1 << int(np.ceil(np.log2(n + span + 1)))
    r = ref[:n] - ref[:n].mean()
    d = deg[:n] - deg[:n].mean()
    corr = np.fft.irfft(
        np.fft.rfft(d, nfft) * np.conj(np.fft.rfft(r, nfft)), nfft
    )
    lags = np.arange(crude - span, crude + span + 1)
    vals = corr[lags % nfft]
    return int(lags[np.argmax(vals)])


def _lp(x: np.ndarray, p: float) -> float:
    if len(x) == 0:
        return 0.0
    return float(np.mean(np.abs(x) ** p) ** (1.0 / p))


def _aggregate(frame_d: np.ndarray, p_split: float, p_time: float) -> float:
    """Lp over 20-frame split-second intervals, then Lq over intervals."""
    if len(frame_d) == 0:
        return 0.0
    n_int = int(np.ceil(len(frame_d) / SPLIT_SEC_FRAMES))
    vals = np.array(
        [
            _lp(frame_d[i * SPLIT_SEC_FRAMES : (i + 1) * SPLIT_SEC_FRAMES], p_split)
            for i in range(n_int)
        ]
    )
    return _lp(vals, p_time)


def pesq(
    ref: np.ndarray,
    deg: np.ndarray,
    sample_rate: int,
    mode: str = "wb",
) -> float:
    """MOS-LQO per the P.862 pipeline (see module docstring).

    ref/deg: 1-D waveforms at ``sample_rate``. mode: "nb" (P.862 + P.862.1
    mapping, internal 8 kHz) or "wb" (P.862.2, internal 16 kHz).
    """
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    if mode == "nb":
        fs, n_bands = 8000, 42
    elif mode == "wb":
        fs, n_bands = 16000, 49
    else:
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
    if sample_rate != fs:
        ref = resample(ref.astype(np.float32), sample_rate, fs).astype(np.float64)
        deg = resample(deg.astype(np.float32), sample_rate, fs).astype(np.float64)
    if min(len(ref), len(deg)) < int(0.25 * fs):
        raise ValueError("PESQ needs at least 0.25 s of audio")

    # 1. level alignment
    ref = _align_level(ref, fs)
    deg = _align_level(deg, fs)

    # 2. input filter
    if mode == "nb":
        ref_f = _irs_receive_filter(ref, fs)
        deg_f = _irs_receive_filter(deg, fs)
    else:
        ref_f = _wb_input_filter(ref, fs)
        deg_f = _wb_input_filter(deg, fs)

    # 3. time alignment (single utterance: crude + fine)
    delay = _fine_delay(ref_f, deg_f, _crude_delay(ref_f, deg_f, fs), fs)
    if delay > 0:
        deg_f = deg_f[delay:]
    elif delay < 0:
        ref_f = ref_f[-delay:]
    n = min(len(ref_f), len(deg_f))
    ref_f, deg_f = ref_f[:n], deg_f[:n]

    band = _band(fs, n_bands)

    # 4. auditory transform
    bark_ref = band.bark_spectrum(ref_f) * band.sp
    bark_deg = band.bark_spectrum(deg_f) * band.sp
    if len(bark_ref) == 0:
        return float("nan")

    frame_pow_ref = bark_ref.sum(axis=1)
    frame_pow_deg = bark_deg.sum(axis=1)
    audible = frame_pow_ref > 1e-2 * frame_pow_ref.max()

    # partial frequency compensation: scale REF toward DEG's mean spectrum
    num = bark_deg[audible].mean(axis=0) + 1e3
    den = bark_ref[audible].mean(axis=0) + 1e3
    freq_comp = np.clip(num / den, 0.01, 100.0)
    bark_ref_c = bark_ref * freq_comp[None, :]

    # partial gain compensation: smooth per-frame gain applied to DEG
    g = (bark_ref_c.sum(axis=1) + 5e3) / (frame_pow_deg + 5e3)
    g = np.clip(g, 3e-4, 5.0)
    h = np.empty_like(g)
    acc = 1.0
    for i in range(len(g)):
        acc = 0.8 * acc + 0.2 * g[i]
        h[i] = acc
    bark_deg_c = bark_deg * h[:, None]

    loud_ref = band.loudness(bark_ref_c)
    loud_deg = band.loudness(bark_deg_c)

    # 5. disturbance
    d = loud_deg - loud_ref
    deadzone = 0.25 * np.minimum(loud_deg, loud_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - deadzone, 0.0)

    asym = ((bark_deg_c + 50.0) / (bark_ref_c + 50.0)) ** 1.2
    asym[asym < 3.0] = 0.0
    asym = np.minimum(asym, 12.0)

    w = band.widths_z[None, :]
    d_frame = np.sqrt(np.sum((d * w) ** 2, axis=1))
    da_frame = np.sum(np.abs(d) * asym * w, axis=1)

    weight = ((frame_pow_ref + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / weight, 45.0)
    da_frame = da_frame / weight

    d_ind = _aggregate(d_frame, 6.0, 2.0)
    da_ind = _aggregate(da_frame, 1.0, 2.0)

    # 6. map to MOS
    raw = 4.5 - 0.1 * d_ind - 0.0309 * da_ind
    raw = float(np.clip(raw, -0.5, 4.5))
    if mode == "nb":
        return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
