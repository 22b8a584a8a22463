"""Metric sidecars: PESQ (port of ``make_pesq`` from
``sonicsim_tpu.metrics.sidecars``).

The tracker takes numeric sidecars as ``extra_metrics`` callables
``fn(ref, est, sr) -> float``. PESQ prefers the compiled ITU binding (the
``pesq`` package) where it imports, and otherwise runs the native P.862
pipeline of ``metrics/pesq.py``; ``fn.backend`` says which. DNSMOS, SigMOS
and Whisper (ONNX and CTranslate2 sidecars) wait for ROADMAP A10.
"""

from __future__ import annotations


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
