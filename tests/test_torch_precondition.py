"""The port's diagonal-metric preconditioning against the JAX package's
(``tensorbnn_tpu/sampler/driver.py:89-111``, ``:574-619``, ``:1060-1072``).

``precondition`` estimates a per-coordinate step scale from the fleet's
cross-chain spread at the first chunk boundary past each window's epoch
and runs the main block's leapfrog with ``eps * scale``. The port's
estimate is held against the JAX package's on the same fleet (rtol 1e-5:
float32 standard deviations in two summation orders), the epochs at which
the windows fire against the JAX driver's on the same configuration
(exactly: both chunk on the same GP-adapter cycles), the guards against
its messages, and a windowed run stopped between two windows and resumed
against the uninterrupted run (bit for bit).
"""

import json
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.sampler.driver import estimate_step_scale as j_estimate
from tensorbnn_tpu_torch.sampler.driver import estimate_step_scale as \
    t_estimate, precondition_epochs

torch.set_num_threads(1)

MCMC = dict(step_size_start=2e-3, step_size_min=5e-4, step_size_max=1e-2,
            step_size_options=8, leapfrog_start=8, leapfrog_min=4,
            leapfrog_max=16, leapfrog_increment=4, hyper_leapfrog=4,
            burnin=40, averaging_steps=5, random_steps=2, adapter_seed=0)


def _net(pkg=T, seed=5):
    """The JAX package's tests/test_precondition.py network in ``pkg``."""
    x = np.linspace(-1, 1, 16)
    y = np.sin(x * math.pi)
    if pkg is J:
        from tensorbnn_tpu.network import Network
        net = Network(jnp.float32, 1, x, y, x, y, seed=seed)
    else:
        net = T.Network(np.float32, 1, x, y, x, y, seed=seed, device="cpu")
    net.add(pkg.GaussianDenseLayer(1, 5)).add(pkg.Tanh())
    net.add(pkg.GaussianDenseLayer(5, 1))
    net.setup_mcmc(**MCMC)
    return net, pkg.FixedGaussianLikelihood(sd=0.1)


@pytest.mark.parametrize("clip", [(1e-2, 1e2), (0.5, 2.0)])
def test_estimate_step_scale_matches_jax(clip):
    """A fleet whose coordinates' spreads span four decades, clipped at the
    default and at a narrow range. A coordinate with no spread gets scale
    1; there the two packages differ by rounding, not by rule: XLA's
    float32 ``jnp.std`` of a constant column can come out ~1e-8 (column 3
    of this fleet with the spread set to 0), which counts as a spread, and
    torch's is exactly 0."""
    rng = np.random.default_rng(0)
    sds = 10.0 ** rng.uniform(-3, 1, 40)
    fleet = (rng.normal(size=(16, 40)) * sds + rng.normal(size=40)).astype(
        np.float32)
    want = j_estimate(jnp.asarray(fleet), *clip)
    got = t_estimate(torch.tensor(fleet), *clip)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    fleet[:, [3, 17]] = fleet[0, [3, 17]]
    got = t_estimate(torch.tensor(fleet), *clip)
    assert got[3] == got[17] == 1.0


def _fired(text):
    return [(int(k), int(n), int(e)) for k, n, e in re.findall(
        r"preconditioner estimate (\d+)/(\d+) at epoch (\d+)", text)]


@pytest.mark.parametrize("precondition,windows", [
    (True, 1), (10, 3), (5, 4), (60, 2)])
def test_windows_fire_where_the_jax_driver_fires_them(precondition, windows,
                                                      capsys):
    """Both drivers on the same configuration: the same estimates at the
    same epochs (a threshold past the burn-in fires once, there), and
    ``precondition_epochs`` is the JAX driver's schedule."""
    fired = []
    for pkg in (T, J):
        net, lik = _net(pkg, seed=11)
        capsys.readouterr()
        net.train(70, 4, lik, n_chains=8, chain_jitter=0.05,
                  precondition=precondition, precondition_windows=windows,
                  use_fused=False, verbose=True)
        fired.append(_fired(capsys.readouterr().out))
    assert fired[0] == fired[1] and fired[0], fired
    at = MCMC["burnin"] // 2 if precondition is True else precondition
    schedule = precondition_epochs(at, MCMC["burnin"], windows)
    assert fired[0][-1][1] == len(schedule)
    for k, _, epoch in fired[0]:
        assert epoch >= schedule[min(k, len(schedule)) - 1]


def test_precondition_guards_match_jax():
    """The errors in each package's words (the port says "fused kernels"
    where the JAX package says "Pallas kernels"): too few chains,
    use_fused=True, a reversed clip, no windows, tempering."""
    for kw in (dict(n_chains=2, precondition=True),
               dict(n_chains=8, precondition=True, use_fused=True),
               dict(n_chains=8, precondition=True,
                    precondition_clip=(2.0, 0.5)),
               dict(n_chains=8, precondition=True, precondition_windows=0),
               dict(n_chains=8, precondition=True, tempering=2)):
        msgs = []
        for pkg in (T, J):
            net, lik = _net(pkg)
            with pytest.raises(ValueError) as err:
                net.train(20, 4, lik, verbose=False, **kw)
            msgs.append(str(err.value).replace("Pallas", "fused")
                        .split(" (benchmarks/")[0])
        assert msgs[0] == msgs[1], msgs


def _run(tmp_path, name, epochs, windows=4, **kw):
    net, lik = _net(seed=13)
    return net.train(epochs, 4, lik, n_chains=8, chain_jitter=0.05,
                     precondition=5, precondition_windows=windows,
                     checkpoint_dir=str(tmp_path / name),
                     checkpoint_every=1, verbose=False, **kw)


def test_windowed_run_stopped_between_windows_resumes_bit_equal(tmp_path):
    """Windows at epochs 5, 13, 22 and 31 (burn-in 40); a run stopped at
    epoch 20 (two windows fired) and resumed to 120 is the uninterrupted
    run bit for bit: its step scale and fired-window count come back from
    the checkpoint."""
    first = _run(tmp_path, "a", 20)
    host = json.load(open(tmp_path / "a" / "resume.json"))
    assert host["precond_windows_fired"] == 2
    assert len(host["step_scale"]) == first.theta_samples.shape[2]
    resumed = _run(tmp_path, "a", 120)
    full = _run(tmp_path, "b", 120)
    assert resumed.resume_epoch == 20
    np.testing.assert_array_equal(resumed.theta_samples, full.theta_samples)
    np.testing.assert_array_equal(resumed.eta_samples, full.eta_samples)
    np.testing.assert_array_equal(resumed.main_accept,
                                  full.after_epoch(full.main_accept, 20))
    assert np.isfinite(full.theta_samples).all()
    assert 0.05 < full.main_accept[40:].mean() <= 1.0


def test_fingerprint_matches_jax_and_refuses_other_windows(tmp_path):
    """The windowed run's fingerprint equals the JAX driver's
    (``"5/w3/clip0.01,100"``); resuming under other windows is refused."""
    fps = []
    for pkg in (T, J):
        net, lik = _net(pkg, seed=14)
        net.train(10, 4, lik, n_chains=8, chain_jitter=0.05, precondition=5,
                  precondition_windows=3, use_fused=False, verbose=False,
                  checkpoint_dir=str(tmp_path / pkg.__name__))
        fps.append(json.load(open(tmp_path / pkg.__name__ / "resume.json"))[
            "fingerprint"])
    assert fps[0] == fps[1]
    assert fps[0]["precondition"] == "5/w3/clip0.01,100"
    with pytest.raises(ValueError, match="precondition"):
        _run(tmp_path, T.__name__, 20, windows=2)


def test_precondition_with_adapter_groups():
    """Per-chain step sizes (``n_adapters=2``) compose with the ``(D,)``
    scale on the plain path, as in tests/test_precondition.py."""
    net, lik = _net(seed=9)
    res = net.train(120, 4, lik, n_chains=8, n_adapters=2,
                    chain_jitter=0.05, precondition=True, verbose=False)
    assert res.main_path == "plain" and not res.fused_hyper
    assert np.isfinite(res.theta_samples).all()
    assert 0.05 < res.main_accept[40:].mean() <= 1.0
