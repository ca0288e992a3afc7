"""The benchmark's yardstick: the card's published peaks, the operations
and bytes of a kernel's work from its shapes, the device's busy time from
a trace, and the ESS arithmetic. Frozen copies, each with the line it was
taken from, so that the yardstick does not move when the program or the
repository's scripts change.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 (chip_smoke.py:255-258)
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(seconds, what sets it): the least time for ``flops`` float32
    operations and ``nbytes`` moved, at the card's published peaks
    (chip_smoke.py:1557-1562, in seconds)."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def dense_widths(layers: Sequence[dict]) -> List[Tuple[int, int]]:
    """``(in, out)`` of each dense layer of a configuration's stack."""
    return [(l["in"], l["out"]) for l in layers if l["kind"] == "dense"]


def product_flops(layers: Sequence[dict], n: int) -> float:
    """Float32 operations of one likelihood value and gradient per chain
    over ``n`` rows: the multiply-adds of the forward products, the weight
    gradients and the input gradients (none for the first layer), 2 FLOP
    each, plus the bias adds and sums (activations and the tail, under
    1%, are left out) (chip_smoke.py:1565-1573)."""
    dense = dense_widths(layers)
    fwd = sum(2 * n * a * b + n * b for a, b in dense)
    return float(2 * fwd + sum(2 * n * a * b for a, b in dense[1:]))


def forward_flops(layers: Sequence[dict], n: int) -> float:
    """Float32 operations of one forward pass per network over ``n``
    rows: the products' multiply-adds, 2 FLOP each, and the bias adds
    (the forward half of ``product_flops``)."""
    return float(sum(2 * n * a * b + n * b for a, b in dense_widths(layers)))


def k1_shape_bound(layers, c: int, d: int, h: int, n: int, d_in: int,
                   evaluations: float) -> Tuple[float, str]:
    """K1's bound for one launch: ``evaluations`` (the sum over chains of
    each chain's L + 1) of the dense products plus ~10 FLOP per theta row
    and evaluation (priors, slopes, leapfrog); inputs theta, mom, eta, x,
    y, eps, L read once, outputs q, v, lp0, lp1 written once
    (chip_smoke.py:1576-1587)."""
    return bound(evaluations * (product_flops(layers, n) + 10 * d),
                 4 * (4 * c * d + c * h + n * (d_in + 1) + 4 * c))


def k3_shape_bound(layers, c: int, d: int, n: int,
                   d_in: int) -> Tuple[float, str]:
    """K3's bound for one call over ``n`` rows: the products (activations
    and tails under 1%); theta read and grad written, x and y read once,
    ll written (chip_smoke.py:1590-1596)."""
    return bound(c * product_flops(layers, n),
                 4 * (2 * c * d + n * (d_in + 1) + 2 * c))


def forward_bound(layers, networks: int, d: int, n: int, d_in: int,
                  d_out: int) -> Tuple[float, str]:
    """An ensemble forward's bound: ``networks`` forwards over ``n`` rows;
    the parameters and the inputs read once, the outputs written once."""
    return bound(networks * forward_flops(layers, n),
                 4 * (networks * d + n * d_in + networks * n * d_out))


def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of ``(start, end)`` intervals, in
    seconds (chip_smoke.py:1721-1733, ``busy_ms``)."""
    spans = sorted(intervals)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return busy + hi - lo


# -- ESS (tensorbnn_tpu_torch/utils/autocorr.py:87-112) -------------------
def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def integrated_time_batch(x: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Per-row integrated autocorrelation times of a (rows, n) batch by
    Sokal's window (one batched FFT)."""
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
    win = np.where(mask.any(axis=1), np.argmin(mask, axis=1), n - 1)
    return taus[np.arange(rows), win]


def effective_sample_size_batch(x: np.ndarray, c: float = 5.0) -> float:
    """Total ESS summed over rows (chains), NaN/nonpositive rows skipped;
    each finite tau floored at 1."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    taus = integrated_time_batch(x, c=c)
    ok = np.isfinite(taus) & (taus > 0)
    if not np.any(ok):
        return 0.0
    return float(np.sum(x.shape[1] / np.maximum(taus[ok], 1.0)))
