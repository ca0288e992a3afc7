"""Cross-chain convergence diagnostics.

A copy of ``tensorbnn_tpu/utils/diagnostics.py`` (numpy only) over the
port's own ``autocorr``: split-R-hat (Gelman-Rubin) and cross-chain ESS
over the ``(draws, chains, ...)`` sample stacks produced by
:func:`tensorbnn_tpu_torch.sampler.driver.sample_posterior`.
"""

from __future__ import annotations

import numpy as np

from tensorbnn_tpu_torch.utils.autocorr import integrated_time_batch


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-R-hat over a (draws, chains, ...) sample stack.

    Each chain is split in half (guarding against within-chain trends),
    giving 2C sequences; R-hat = sqrt(var_plus / W). Values near 1 indicate
    convergence; > 1.01 is suspect.
    """
    samples = np.asarray(samples, np.float64)
    n, c = samples.shape[:2]
    half = n // 2
    if half < 2:
        raise ValueError("need at least 4 draws per chain for split R-hat")
    halves = np.concatenate([samples[:half], samples[half:2 * half]], axis=1)
    m = halves.shape[1]          # 2C sequences
    k = half                     # draws per sequence

    chain_means = halves.mean(axis=0)            # (m, ...)
    chain_vars = halves.var(axis=0, ddof=1)      # (m, ...)
    w = chain_vars.mean(axis=0)
    b = k * chain_means.var(axis=0, ddof=1)
    var_plus = (k - 1) / k * w + b / k
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.sqrt(var_plus / w)


class PooledEss(float):
    """Minimum per-parameter pooled ESS, with the full breakdown attached.

    Behaves as a plain float equal to the *slowest-mixing* coordinate's
    pooled ESS (the conservative convergence summary: a run has only as
    many effective samples as its worst parameter). Extra attributes:

    - ``per_param``: (K,) pooled-over-chains ESS per examined coordinate
      (NaN where no chain produced a finite tau, e.g. constant traces)
    - ``param_index``: (K,) original flat-coordinate ids examined
    - ``min`` / ``median`` / ``max``: summaries over finite coordinates
    - ``argmin``: original coordinate id of the minimum
    """

    def __new__(cls, per_param: np.ndarray, param_index: np.ndarray):
        per_param = np.asarray(per_param, np.float64)
        param_index = np.asarray(param_index)
        finite = np.isfinite(per_param)
        val = float(per_param[finite].min()) if finite.any() else 0.0
        obj = super().__new__(cls, val)
        obj.per_param = per_param
        obj.param_index = param_index
        obj.min = val
        obj.median = (float(np.median(per_param[finite]))
                      if finite.any() else 0.0)
        obj.max = (float(per_param[finite].max()) if finite.any() else 0.0)
        obj.argmin = (int(param_index[np.nanargmin(
            np.where(finite, per_param, np.inf))]) if finite.any() else -1)
        return obj

    def __repr__(self):
        return (f"PooledEss(min={self.min:.1f} @ param {self.argmin}, "
                f"median={self.median:.1f}, max={self.max:.1f}, "
                f"{self.per_param.size} coords)")


def multichain_ess(samples: np.ndarray,
                   max_params: int = 256) -> PooledEss:
    """Per-parameter pooled ESS over a (draws, chains, ...) sample stack.

    For every examined flat coordinate d, sums n/tau over chains (tau from
    the batched Sokal estimator, chains with non-finite tau skipped, tau
    floored at 1). When the state has more than ``max_params`` coordinates
    an evenly-strided subsample is examined — the full (C*D, n) FFT batch
    at e.g. 512 chains x 600k params would dominate the run it diagnoses.

    Returns a :class:`PooledEss`: a float equal to the minimum (worst
    coordinate) with min/median/max and the per-coordinate array attached.
    The scalar used to be the pooled ESS of coordinate 0 only, blind to
    every other dimension; min over coordinates is strictly more honest.
    """
    samples = np.asarray(samples, np.float64)
    n, c = samples.shape[:2]
    flat = samples.reshape(n, c, -1)
    d = flat.shape[2]
    if d > max_params:
        idx = np.unique(np.linspace(0, d - 1, max_params).astype(np.intp))
    else:
        idx = np.arange(d, dtype=np.intp)
    sub = flat[:, :, idx]                            # (n, c, k)
    k = sub.shape[2]
    rows = np.ascontiguousarray(
        sub.transpose(1, 2, 0).reshape(c * k, n))    # chain-major rows
    taus = integrated_time_batch(rows).reshape(c, k)
    ok = np.isfinite(taus) & (taus > 0)
    ess_ck = np.where(ok, n / np.maximum(taus, 1.0), 0.0)
    per_param = ess_ck.sum(axis=0)                   # pooled over chains
    per_param = np.where(ok.any(axis=0), per_param, np.nan)
    return PooledEss(per_param, idx)


class Summary:
    """Per-parameter convergence table (the ArviZ-style one-call report).

    ``rows`` are (param_index, mean, sd, pooled ESS, split R-hat) over the
    examined coordinates; ``str()`` renders an aligned table — all rows
    when small, otherwise the worst-ESS rows (the ones a user must act
    on). The reference has no convergence reporting at all (its predictor
    exposes one autocorrelation helper, predictor.py:156-187).
    """

    def __init__(self, param_index, mean, sd, ess, rhat):
        self.param_index = np.asarray(param_index)
        self.mean = np.asarray(mean, np.float64)
        self.sd = np.asarray(sd, np.float64)
        self.ess = np.asarray(ess, np.float64)
        self.rhat = np.asarray(rhat, np.float64)

    @property
    def min_ess(self) -> float:
        finite = np.isfinite(self.ess)
        return float(self.ess[finite].min()) if finite.any() else 0.0

    @property
    def max_rhat(self) -> float:
        finite = np.isfinite(self.rhat)
        return float(self.rhat[finite].max()) if finite.any() else np.nan

    def as_dict(self) -> dict:
        return {"param": self.param_index, "mean": self.mean,
                "sd": self.sd, "ess": self.ess, "rhat": self.rhat}

    def __str__(self):
        k = self.param_index.size
        order = np.arange(k)
        note = ""
        if k > 20:
            # surface the slowest-mixing coordinates — the actionable ones
            order = np.argsort(np.where(np.isfinite(self.ess),
                                        self.ess, np.inf))[:10]
            note = (f"\n... ({k - order.size} more coordinates; showing "
                    f"the 10 worst by ESS)")
        lines = [f"{'param':>8} {'mean':>12} {'sd':>12} "
                 f"{'ess':>10} {'rhat':>8}"]
        for i in order:
            lines.append(
                f"{int(self.param_index[i]):>8} {self.mean[i]:>12.4g} "
                f"{self.sd[i]:>12.4g} {self.ess[i]:>10.1f} "
                f"{self.rhat[i]:>8.3f}")
        return "\n".join(lines) + note

    __repr__ = __str__


def summary(samples: np.ndarray, max_params: int = 256) -> Summary:
    """One-call per-parameter convergence report over a (draws, chains,
    ...) stack: posterior mean/sd, pooled cross-chain ESS (batched Sokal
    taus, :func:`multichain_ess`) and split R-hat per examined coordinate
    (evenly strided to ``max_params``, matching ``multichain_ess``)."""
    samples = np.asarray(samples, np.float64)
    n, c = samples.shape[:2]
    flat = samples.reshape(n, c, -1)
    ess = multichain_ess(samples, max_params=max_params)
    sub = flat[:, :, ess.param_index]                    # (n, c, k)
    pooled = sub.reshape(n * c, -1)
    return Summary(ess.param_index,
                   pooled.mean(axis=0),
                   pooled.std(axis=0, ddof=1),
                   ess.per_param,
                   split_rhat(sub))
