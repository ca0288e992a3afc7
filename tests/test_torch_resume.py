"""Checkpoint and resume in the port's driver, and the driver options that
came with the sample store.

An interrupted run (stopped at a chunk boundary, its checkpoint written
every chunk) and resumed by a fresh ``Network`` of the same seed is bit
for bit the uninterrupted run: in its samples, its stores, and its
acceptance, which a resumed ``RunResult`` holds from the resume epoch on.
A changed configuration, a torn checkpoint and a checkpoint written by the
JAX package are refused; the resume fingerprint has the JAX driver's keys.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.network import Network as JNetwork
from tensorbnn_tpu_torch.io import checkpoint as t_ckpt
from tensorbnn_tpu_torch.sampler import driver
from tensorbnn_tpu_torch.utils.tracing import RunTracer

torch.set_num_threads(1)

X = np.linspace(-1, 1, 9).astype(np.float32)
Y = np.sin(X * math.pi).astype(np.float32)
MCMC = dict(step_size_start=1e-3, leapfrog_start=6, leapfrog_min=4,
            leapfrog_max=10, burnin=10, averaging_steps=5, hyper_leapfrog=5,
            random_steps=2, adapter_seed=0)


def _net(pkg=T, seed=5, width=5, learned_sd=False, **mcmc):
    if pkg is J:
        net = JNetwork(jnp.float32, 1, X, Y, X, Y, seed=seed)
    else:
        net = T.Network(torch.float32, 1, X, Y, X, Y, seed=seed,
                        device="cpu")
    net.add(pkg.GaussianDenseLayer(1, width)).add(pkg.Tanh())
    net.add(pkg.GaussianDenseLayer(width, 1))
    net.setup_mcmc(**(MCMC | mcmc))
    lik = (pkg.GaussianLikelihood if learned_sd
           else pkg.FixedGaussianLikelihood)(sd=0.1)
    return net, lik


CASES = {
    "buffered": dict(n_chains=2),
    "streamed": dict(n_chains=3, keep_samples=False),
    "tempered": dict(n_chains=2, tempering=2, tempering_beta_min=0.5),
    "uturn": dict(n_chains=2, trajectory="uturn"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resumed_run_is_bit_equal_to_the_uninterrupted_run(tmp_path, case):
    kw = CASES[case] | dict(verbose=False, networks_per_file=3,
                            chain_jitter=0.05)

    def train(epochs, tag, ckpt=None):
        net, lik = _net()
        return net.train(epochs, 2, lik, folder_name=str(tmp_path / tag),
                         checkpoint_dir=ckpt, checkpoint_every=1, **kw)

    full = train(30, "full")
    ckpt = str(tmp_path / "ckpt")
    first = train(15, "resumed", ckpt)
    assert first.resume_epoch == 0 and first.n_epochs == 15
    res = train(30, "resumed", ckpt)
    assert res.resume_epoch == 15 and res.n_epochs == 30
    np.testing.assert_array_equal(res.theta_samples, full.theta_samples)
    np.testing.assert_array_equal(res.eta_samples, full.eta_samples)
    if case != "streamed":
        assert res.theta_samples.shape[0] == 10
    # acceptance after a resume is sliced from the resume epoch
    for name in ("main_accept", "hyper_accept", "sjd", "leapfrog"):
        got, want = getattr(res, name), getattr(full, name)
        assert len(got) == 15
        np.testing.assert_array_equal(got, want[15:])
        np.testing.assert_array_equal(res.after_epoch(got, 20), want[20:])
    np.testing.assert_array_equal(full.after_epoch(full.main_accept, 10),
                                  full.main_accept[10:])
    assert (res.final_step_size, res.final_leapfrog) == \
        (full.final_step_size, full.final_leapfrog)
    if case == "tempered":
        np.testing.assert_array_equal(res.swap_accept_rung,
                                      full.swap_accept_rung[15:])
    # the stores, text and npz, byte for byte
    names = sorted(os.listdir(tmp_path / "full"))
    assert names == sorted(os.listdir(tmp_path / "resumed"))
    assert "chains.txt" in names
    assert ("samples.npz" in names) == (case != "streamed")
    for n in names:
        if n.endswith(".txt"):
            assert (tmp_path / "full" / n).read_bytes() == \
                (tmp_path / "resumed" / n).read_bytes(), n
    if case != "streamed":
        for a, b in zip(t_ckpt.load_samples_with_chains(
                str(tmp_path / "full"))[0], t_ckpt.load_samples_with_chains(
                str(tmp_path / "resumed"))[0]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_resume_refuses_a_changed_config_and_a_torn_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    net, lik = _net()
    net.train(10, 2, lik, verbose=False, checkpoint_dir=ckpt)
    for changed, match in ((dict(mcmc=dict(burnin=12)), "config"),
                           (dict(width=6), "eta_dim|layers|theta_dim"),
                           (dict(train=dict(n_chains=2)), "n_chains")):
        net, lik = _net(width=changed.get("width", 5),
                        **changed.get("mcmc", {}))
        with pytest.raises(ValueError, match=match):
            net.train(20, 2, lik, verbose=False, checkpoint_dir=ckpt,
                      **changed.get("train", {}))
    # a crash between the two renames pairs new arrays with old host state
    js = os.path.join(ckpt, "resume.json")
    state = json.load(open(js))
    state["__pair_token__"] = "0" * 16
    json.dump(state, open(js, "w"))
    net, lik = _net()
    with pytest.raises(ValueError, match="torn"):
        net.train(20, 2, lik, verbose=False, checkpoint_dir=ckpt)


def test_a_jax_checkpoint_is_refused_and_fingerprints_match(tmp_path):
    """A JAX package's checkpoint holds a threefry key and no generator
    state: the port refuses it by name. Both packages write the same
    fingerprint for the same run."""
    jnet, jlik = _net(J)
    jnet.train(10, 2, jlik, verbose=False, use_fused=False,
               checkpoint_dir=str(tmp_path / "jax"))
    net, lik = _net()
    net.train(10, 2, lik, verbose=False, checkpoint_dir=str(tmp_path / "pt"))
    fps = [json.load(open(tmp_path / d / "resume.json"))["fingerprint"]
           for d in ("jax", "pt")]
    assert fps[0] == fps[1]
    assert fps[1]["dtype"] == "float32"
    net, lik = _net()
    with pytest.raises(ValueError, match="JAX package.*generator state"):
        net.train(20, 2, lik, verbose=False,
                  checkpoint_dir=str(tmp_path / "jax"))


def test_store_options_are_carried():
    lifted = ("folder_name", "networks_per_file", "keep_samples",
              "checkpoint_dir", "checkpoint_every", "metric_list", "tracer")
    assert not set(lifted) & set(driver.NOT_CARRIED)
    net, lik = _net()
    with pytest.raises(ValueError, match="keep_samples=False"):
        net.train(20, 2, lik, verbose=False, keep_samples=False)
    # nothing is recorded before the burn-in ends: nothing to lose
    assert net.train(10, 2, lik, verbose=False,
                     keep_samples=False).theta_samples.shape[0] == 0


def test_metrics_display_and_tracer_through_train(capsys):
    """``metric_list`` and the likelihood's hypers print at display epochs
    from chain 0's sample; a tracer times every chunk; neither changes the
    run."""
    net, lik = _net(learned_sd=True)
    plain = net.train(20, 2, lik, n_chains=2, verbose=False)
    net, lik = _net(learned_sd=True)
    tracer = RunTracer()
    res = net.train(20, 2, lik, n_chains=2, display_skip=10,
                    metricList=[T.SquaredError()], tracer=tracer)
    np.testing.assert_array_equal(res.theta_samples, plain.theta_samples)
    out = capsys.readouterr().out
    assert out.count("training squared error") == 2
    assert out.count("Loss Standard Deviation: ") == 2
    summary = tracer.summary()
    assert summary["epochs"] == 20 and summary["chunks"] >= 4
    assert summary["leapfrog_steps"] == int(round(
        sum(c.epochs * c.leapfrog * 2 for c in tracer.chunks)))
    assert summary["leapfrog_steps_per_sec"] > 0
