"""Metric sidecars: PESQ, DNSMOS, SigMOS and WER (port of
``sonicsim_tpu.metrics.sidecars``).

The tracker takes numeric sidecars as ``extra_metrics`` callables
``fn(ref, est, sr) -> float``. PESQ prefers the compiled ITU binding (the
``pesq`` package) where it imports, and otherwise runs the native P.862
pipeline of ``metrics/pesq.py``; ``fn.backend`` says which. DNSMOS and
SigMOS run the user's .onnx weights through ``metrics/onnx_torch.py`` on
the device they are given (the card unless given), as does the port's
Whisper behind :func:`make_whisper_asr`; :func:`wer` scores transcripts.
"""

from __future__ import annotations

from pathlib import Path


def make_pesq(mode: str = "wb", native: bool | None = None):
    """PESQ tracker extra-metric (ITU-T P.862 / P.862.2).

    Prefers the compiled ITU reference (the `pesq` package) when it is
    importable; otherwise falls back to the native NumPy implementation
    of the P.862 pipeline (metrics/pesq.py — P.862-structured, not
    bit-exact with the ITU binary). ``native=True`` forces the native
    path, ``native=False`` requires the compiled package.
    """
    import logging

    scorer, backend = None, None
    if native is not True:
        try:
            from pesq import pesq as _pesq

            scorer = lambda r, e, sr: _pesq(sr, r, e, mode)  # noqa: E731
            backend = "itu-p862-compiled"
        except ImportError:
            if native is False:
                raise ImportError(
                    "make_pesq(native=False) requires the compiled `pesq` "
                    "package; omit native to use the built-in P.862 pipeline."
                ) from None
    if scorer is None:
        from .pesq import pesq as _native_pesq

        scorer = lambda r, e, sr: _native_pesq(r, e, sr, mode)  # noqa: E731
        backend = "native-p862-approx"
    # The two backends are NOT interchangeable numerically (the native one
    # is P.862-structured, not bit-exact); disclose which produced the
    # scores so CSVs are comparable across machines.
    logging.getLogger(__name__).info(
        "pesq_%s backend: %s", mode, backend
    )

    def _fn(ref, est, sample_rate):
        import numpy as np

        return float(np.mean([
            scorer(r, e, sample_rate)
            for r, e in zip(np.atleast_2d(ref), np.atleast_2d(est))
        ]))

    _fn.backend = backend
    return _fn


def _estimate_mean(scorer, key: str):
    """A tracker column from a reference-free MOS scorer: it scores the
    ESTIMATE (reference wrapper.py:105-111), the mean over its tracks."""
    def metric(ref, est, sample_rate=16000):
        import numpy as np

        return float(np.mean([scorer(np.asarray(e), sample_rate)[key]
                              for e in np.atleast_2d(est)]))

    return metric


def make_dnsmos(model_dir: str | Path, key: str = "OVRL", device=None):
    """DNSMOS as a tracker extra-metric: ``model_dir`` holds model_v8.onnx
    and sig_bak_ovr.onnx (the files the reference commits at
    separation/DNSMOS/); ``key`` is the MOS axis the column records (OVRL |
    SIG | BAK | P808_MOS)."""
    from .dnsmos import DNSMOS

    return _estimate_mean(DNSMOS(model_dir, device), key)


def make_sigmos(model_path: str | Path, key: str = "MOS_OVRL", device=None):
    """SigMOS (P.804) as a tracker extra-metric: ``key`` is one of the 7 MOS
    axes (MOS_COL | MOS_DISC | MOS_LOUD | MOS_NOISE | MOS_REVERB | MOS_SIG |
    MOS_OVRL)."""
    from .sigmos import SigMOS

    if key not in SigMOS.AXES:
        raise ValueError(f"key must be one of {SigMOS.AXES}, got {key!r}")
    return _estimate_mean(SigMOS(model_path, device), key)


def make_sigmos_all(model_path: str | Path, device=None) -> dict:
    """All 7 SigMOS axes as tracker columns (reference wrapper.py:48), over
    one loaded model."""
    from .sigmos import SigMOS

    scorer = SigMOS(model_path, device)
    return {key: _estimate_mean(scorer, key) for key in SigMOS.AXES}


def make_whisper_asr(model_size: str = "medium.en", device=None,
                     download_root: str | None = None, native: bool | None = None):
    """Whisper transcription sidecar (metrics/asr.py:3-12 contract): a text
    callable ``fn(audio, sample_rate) -> str`` for the tracker's
    ``extra_text`` slot; WER against a reference transcript is
    :func:`wer`'s, downstream.

    Dispatch, as the JAX package's: a ``model_size`` that is a local HF or
    OpenAI checkpoint (not a CTranslate2 export, which carries
    ``model.bin``) transcribes through the port's Whisper
    (``models/whisper.py``) on ``device`` (the card unless given); model
    names and CTranslate2 exports go to faster-whisper where it imports.
    ``native=True`` forces the port, ``native=False`` requires
    faster-whisper.
    """
    p = Path(model_size)
    native_loadable = p.exists() and not (p.is_dir() and (p / "model.bin").exists())
    if native is None and native_loadable:
        native = True
    if native is True:
        from ..models.whisper import make_whisper_transcriber

        return make_whisper_transcriber(model_size, device=device)
    try:
        from faster_whisper import WhisperModel
    except ImportError:
        if native is False:
            raise ImportError(
                "make_whisper_asr(native=False) requires faster-whisper "
                "(CTranslate2); omit native to use the port's Whisper with a "
                "local checkpoint path.") from None
        raise ImportError(
            "faster-whisper is not importable and model_size is not a local "
            "checkpoint path; the port's Whisper needs a downloaded checkpoint "
            "(HF dir or OpenAI .pt + vocab.json).") from None
    import torch

    on_card = device is None or torch.device(device).type == "cuda"
    model = WhisperModel(model_size, device="cuda" if on_card else "cpu",
                         download_root=download_root)

    def transcribe(audio, sample_rate=16000) -> str:
        import numpy as np

        audio = np.asarray(audio, np.float32).reshape(-1)
        if sample_rate != 16000:
            from ..utils.wavio import resample

            audio = resample(audio, sample_rate, 16000)
        segments, _ = model.transcribe(audio, language="en", vad_filter=True)
        return " ".join(seg.text for seg in segments).strip()

    return transcribe


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate, (S + D + I) / N over the reference's words; an empty
    reference gives 0.0 against an empty hypothesis, else inf."""
    ref_words = reference.split()
    hyp_words = hypothesis.split()
    if not ref_words:
        return 0.0 if not hyp_words else float("inf")
    # Levenshtein over words, two-row DP.
    prev = list(range(len(hyp_words) + 1))
    for i, rw in enumerate(ref_words, 1):
        cur = [i] + [0] * len(hyp_words)
        for j, hw in enumerate(hyp_words, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (rw != hw))
        prev = cur
    return prev[-1] / len(ref_words)
