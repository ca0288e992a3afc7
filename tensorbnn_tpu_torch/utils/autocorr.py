"""Autocorrelation and integrated autocorrelation time via FFT.

A copy of ``tensorbnn_tpu/utils/autocorr.py`` (numpy only; the port keeps
its own copy so that it never imports the JAX package). Sokal's windowed
integrated-time estimator, as the reference tensorBNN takes it from
``emcee.autocorr``, with numpy FFTs on host-resident sample chains.
Constant chains yield NaN (0/0 in the normalization).

ESS/sec derived from these is the sampler's quality-adjusted throughput.
"""

from __future__ import annotations

import numpy as np


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_function_1d(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation function of a 1-D series (FFT-based)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    if x.ndim != 1:
        raise ValueError("autocorr_function_1d needs a 1-D series")
    n = _next_pow_two(len(x))
    f = np.fft.fft(x - np.mean(x), n=2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    with np.errstate(invalid="ignore", divide="ignore"):
        acf = acf / acf[0]
    return acf


def _auto_window(taus: np.ndarray, c: float) -> int:
    """Sokal's automated windowing: smallest M with M >= c * tau(M)."""
    m = np.arange(len(taus)) < c * taus
    if np.any(m):
        return int(np.argmin(m))
    return len(taus) - 1


def integrated_time(x: np.ndarray, c: float = 5.0, tol: float = 50.0,
                    quiet: bool = False) -> float:
    """Integrated autocorrelation time of a 1-D chain.

    ``tau = 1 + 2 sum_k rho(k)`` with the window chosen by ``c``. If the
    chain is shorter than ``tol * tau`` the estimate is unreliable: raises
    unless ``quiet``, in which case the estimate is returned anyway (the
    behavior the reference relies on with ``tol=5, quiet=True``,
    predictor.py:283).
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    f = autocorr_function_1d(x)
    taus = 2.0 * np.cumsum(f) - 1.0
    window = _auto_window(taus, c)
    tau = float(taus[window])
    if not np.isnan(tau) and tol * tau > len(x):
        msg = (f"chain too short for reliable tau: tol*tau = "
               f"{tol * tau:.1f} > n = {len(x)}")
        if not quiet:
            raise RuntimeError(msg)
    return tau


def effective_sample_size(x: np.ndarray, c: float = 5.0) -> float:
    """ESS = n / tau, NaN-safe."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    tau = integrated_time(x, c=c, quiet=True)
    if np.isnan(tau) or tau <= 0:
        return float("nan")
    return len(x) / tau


def integrated_time_batch(x: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Per-row integrated autocorrelation times of a (rows, n) batch.

    One batched FFT + vectorized Sokal window instead of a Python loop of
    ``integrated_time`` calls — row-for-row identical results (including
    the all-True-window and NaN conventions); the wide-fleet ESS benches
    spend real wall in this extraction at 512-4096 chains.
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    rows, n = x.shape
    if rows == 0 or n == 0:
        return np.full((rows,), np.nan)
    m = _next_pow_two(n)
    f = np.fft.fft(x - x.mean(axis=1, keepdims=True), n=2 * m, axis=1)
    acf = np.fft.ifft(f * np.conjugate(f), axis=1)[:, :n].real
    with np.errstate(invalid="ignore", divide="ignore"):
        acf = acf / acf[:, :1]
    taus = 2.0 * np.cumsum(acf, axis=1) - 1.0
    mask = np.arange(n)[None, :] < c * taus
    # first False per row (argmin over bool), len-1 when nothing is True —
    # exactly _auto_window's conventions, NaN rows included (NaN
    # comparisons are all False -> window = n-1 -> tau stays NaN)
    win = np.where(mask.any(axis=1), np.argmin(mask, axis=1), n - 1)
    return taus[np.arange(rows), win]


def effective_sample_size_batch(x: np.ndarray, c: float = 5.0) -> float:
    """Total ESS summed over rows (chains), NaN/nonpositive rows skipped;
    each finite tau is floored at 1 (a chain cannot exceed one effective
    sample per draw)."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    taus = integrated_time_batch(x, c=c)
    ok = np.isfinite(taus) & (taus > 0)
    if not np.any(ok):
        return 0.0
    return float(np.sum(x.shape[1] / np.maximum(taus[ok], 1.0)))
