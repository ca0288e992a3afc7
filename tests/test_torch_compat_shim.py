"""The port's tensorBNN compatibility shim against the JAX package's.

A user script written against the reference's API (its import paths,
constructor signatures, camelCase keywords and TF dtype objects) runs on
the port with its import prefix changed to ``tensorbnn_tpu_torch.`` (and,
on the CPU, ``device="cpu"``: the port's entry points run on the card by
default). The JAX shim's store is read by the port's ``predictor`` and
must predict what the JAX shim's ``predictor`` predicts.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

#: the two predictors over one store: float32 forwards of the same
#: networks in two orders of summation
PREDICT_RTOL, PREDICT_ATOL = 1e-5, 1e-6


def _trig():
    trainIn = np.linspace(-2, 2, num=11)
    valIn = np.linspace(-2 + 2 / 30, 2.0 - 2 / 30, num=30)
    trainOut = np.sin(trainIn * math.pi * 2) * trainIn \
        - np.cos(trainIn * math.pi)
    valOut = np.sin(valIn * math.pi * 2) * valIn - np.cos(valIn * math.pi)
    return trainIn, trainOut, valIn, valOut


def _reference_script(pkg, folder, **device):
    """``tests/test_compat_shim.py``'s reference-style script through the
    shim of ``pkg`` (``tensorBNN`` or ``tensorbnn_tpu_torch.tensorBNN``):
    the same lines, only the import prefix differs."""
    import importlib

    Tanh = importlib.import_module(
        f"{pkg}.activationFunctions").Tanh
    GaussianDenseLayer = importlib.import_module(
        f"{pkg}.layer").GaussianDenseLayer
    network = importlib.import_module(f"{pkg}.networkFinal").network
    FixedGaussianLikelihood = importlib.import_module(
        f"{pkg}.likelihood").FixedGaussianLikelihood
    metrics = importlib.import_module(f"{pkg}.metrics")

    trainIn, trainOut, valIn, valOut = _trig()
    dtype = np.float32
    likelihood = FixedGaussianLikelihood(sd=0.1)
    metricList = [metrics.SquaredError(mean=0, sd=1),
                  metrics.PercentError(mean=0, sd=1)]

    neuralNet = network(dtype, 1, trainIn, trainOut.T, valIn, valOut.T,
                        **device)
    seed = 1000
    neuralNet.add(GaussianDenseLayer(1, 10, seed=seed, dtype=dtype))
    neuralNet.add(Tanh())
    neuralNet.add(GaussianDenseLayer(10, 10, seed=seed + 1000, dtype=dtype))
    neuralNet.add(Tanh())
    neuralNet.add(GaussianDenseLayer(10, 1, seed=seed + 2000, dtype=dtype))

    neuralNet.setupMCMC(
        stepSizeStart=1e-3, stepSizeMin=1e-4, stepSizeMax=1e-2,
        stepSizeOptions=20, leapfrogStart=30, leapfogMin=10,
        leapFrogMax=60, leapfrogIncrement=2, hyperStepSize=0.001,
        hyperLeapfrog=15, burnin=40, cores=4, averagingSteps=5,
        randomSteps=3)

    neuralNet.train(
        120, 4, likelihood, metricList=metricList, adjustHypers=True,
        folderName=folder, networksPerFile=10, displaySkip=60)
    return folder, trainIn


@pytest.fixture(scope="module")
def shim_run(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("shim") / "TrigRegression")
    return _reference_script("tensorbnn_tpu_torch.tensorBNN", folder,
                             device="cpu")


@pytest.fixture(scope="module")
def jax_shim_run(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("jax_shim") / "TrigRegression")
    return _reference_script("tensorBNN", folder)


def test_reference_style_training_script_runs(shim_run):
    folder, _ = shim_run
    import os
    assert os.path.exists(os.path.join(folder, "summary.txt"))
    assert os.path.exists(os.path.join(folder, "architecture.txt"))


def test_reference_style_predictor(shim_run):
    folder, trainIn = shim_run
    from tensorbnn_tpu_torch.tensorBNN.likelihood import \
        FixedGaussianLikelihood
    from tensorbnn_tpu_torch.tensorBNN.predictor import predictor

    pred = predictor(folder + "/", likelihood=FixedGaussianLikelihood(
        sd=0.1), device="cpu")
    results = pred.predict(trainIn[:, None], n=1)
    assert isinstance(results, list)            # reference returns a list
    assert results[0].shape == (1, 11)          # (outputDims, batch)
    assert np.isfinite(np.stack(results)).all()

    tau = pred.autoCorrelationLength(trainIn[:, None], 50)
    assert np.isfinite(tau)
    mats = pred.extractParameters()
    assert mats[0].shape[1:] == (10, 1)         # reference (out, in) layout
    means, sds = pred.parameterStatistics()
    assert means[0].shape == (10, 1)


def test_shim_warm_start_and_pretraining():
    from tensorbnn_tpu_torch.tensorBNN.BNN_functions import \
        trainBasicRegression
    from tensorbnn_tpu_torch.tensorBNN.layer import GaussianDenseLayer
    from tensorbnn_tpu_torch.tensorBNN.network import network

    x = np.linspace(-1, 1, 20)
    y = np.sin(x * math.pi)
    weights, biases, _ = trainBasicRegression(
        1, 1, 1, 5, 1, 10, 0.1, x, y, x, y, name=None, device="cpu")
    assert weights[0].shape == (5, 1)           # reference (out, in)

    net = network(None, 1, x, y, x, y, device="cpu")
    net.add(GaussianDenseLayer(1, 5, weights=weights[0], biases=biases[0]))
    params, _ = net.init_state()
    np.testing.assert_allclose(params[0]["w"].numpy(),
                               np.asarray(weights[0]).T, rtol=1e-6)


def test_torch_shim_reads_the_jax_shims_store(jax_shim_run):
    """The JAX shim writes the store; both shims' predictors read it."""
    folder, trainIn = jax_shim_run
    from tensorBNN.likelihood import FixedGaussianLikelihood as JLik
    from tensorBNN.predictor import predictor as jpredictor
    from tensorbnn_tpu_torch.tensorBNN.likelihood import \
        FixedGaussianLikelihood
    from tensorbnn_tpu_torch.tensorBNN.predictor import predictor

    tp = predictor(folder + "/", likelihood=FixedGaussianLikelihood(sd=0.1),
                   device="cpu")
    jp = jpredictor(folder + "/", likelihood=JLik(sd=0.1))
    for n in (1, 3):
        got, want = tp.predict(trainIn[:, None], n), jp.predict(
            trainIn[:, None], n)
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (1, 11)
            np.testing.assert_allclose(g, w, rtol=PREDICT_RTOL,
                                       atol=PREDICT_ATOL)
    for g, w in zip(tp.extractParameters(), jp.extractParameters()):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tp.hyperStatistics(), jp.hyperStatistics()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tp.extractHyperParameters(),
                                  jp.extractHyperParameters())
    for g_list, w_list in zip(tp.parameterStatistics(),
                              jp.parameterStatistics()):
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    assert tp.autoCorrelationLength(trainIn[:, None], 50) == pytest.approx(
        jp.autoCorrelationLength(trainIn[:, None], 50), rel=1e-4)


def test_shim_activation_warm_start():
    """``Prelu(activation=...)`` and ``SquarePrelu(activation=...)`` feed
    the pretrained slopes through, ``Leaky_relu(activation=...)`` sets
    alpha, and a ``DenseLayer``'s weights reach the chain's start, as in
    the JAX shim."""
    import tensorBNN.activationFunctions as JA
    from tensorBNN.layer import DenseLayer as JDense
    from tensorBNN.network import network as jnetwork
    import tensorbnn_tpu_torch.tensorBNN.activationFunctions as TA
    from tensorbnn_tpu_torch.tensorBNN.layer import DenseLayer
    from tensorbnn_tpu_torch.tensorBNN.network import network

    x = np.linspace(-2, 2, 40)
    y = np.sin(x * math.pi) * x
    rng = np.random.default_rng(4)
    w = [rng.normal(size=(5, 1)), rng.normal(size=(5, 5)),
         rng.normal(size=(1, 5))]
    b = [rng.normal(size=(5, 1)), rng.normal(size=(5, 1)),
         rng.normal(size=(1, 1))]
    a = [rng.uniform(0.05, 0.5, 5), rng.uniform(0.05, 0.5, 5)]

    def build(net, act, dense):
        net.add(dense(1, 5, weights=w[0], biases=b[0]))
        net.add(act.Prelu(5, activation=a[0]))
        net.add(dense(5, 5, weights=w[1], biases=b[1]))
        net.add(act.SquarePrelu(5, activation=a[1]))
        net.add(act.Leaky_relu(activation=0.25))
        net.add(dense(5, 1, weights=w[2], biases=b[2]))
        return net.init_state()[0]

    params = build(network(torch.float32, 1, x, y, x, y, device="cpu"), TA,
                   DenseLayer)
    jparams = build(jnetwork(jnp.float32, 1, x, y, x, y), JA, JDense)
    np.testing.assert_allclose(params[1]["slopes"].numpy(), a[0],
                               rtol=1e-6)
    assert len(params) == len(jparams) == 6
    for p, q in zip(params, jparams):
        assert sorted(p) == sorted(q)
        for k in q:
            assert p[k].dtype == torch.float32
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(q[k]))


def test_log_probs_dtypes_and_metrics_match_the_jax_shim():
    from tensorBNN import BNN_functions as JF, _compat as JC, \
        metrics as JM
    from tensorbnn_tpu_torch.tensorBNN import BNN_functions as TF, \
        _compat as TC, metrics as TM

    rng = np.random.default_rng(0)
    sigma = rng.uniform(0.5, 2.0, 7)
    mu, x = rng.normal(size=7), rng.normal(size=7)
    np.testing.assert_allclose(
        float(TF.multivariateLogProb(sigma, mu, x)),
        float(JF.multivariateLogProb(sigma, mu, x)), rtol=1e-6)
    np.testing.assert_allclose(
        TF.cauchyLogProb(0.7, 0.1, x).numpy(),
        np.asarray(JF.cauchyLogProb(0.7, 0.1, x)), rtol=1e-6, atol=1e-6)
    for dtype in (None, np.float32, np.float64, "float64", "bfloat16",
                  "float16", jnp.float32):
        assert str(TC.to_torch_dtype(dtype)).split(".")[-1] == \
            jnp.dtype(JC.to_jnp_dtype(dtype)).name
    assert TC.ref_dense_warm_start(None, None) is None
    for name in ("SquaredError", "PercentError", "Accuracy"):
        t_m = getattr(TM, name)(scaleExp=True, mean=0.5, sd=2)
        j_m = getattr(JM, name)(scaleExp=True, mean=0.5, sd=2)
        assert (t_m.scale_exp, t_m.mean, t_m.sd) == (j_m.scale_exp,
                                                    j_m.mean, j_m.sd)
        assert type(t_m).__name__ == name
        assert getattr(TM, name)(scale_exp=True).scale_exp
    if not torch.cuda.is_available():
        from tensorbnn_tpu_torch.tensorBNN.network import network
        with pytest.raises(RuntimeError, match="device='cpu'"):
            network(None, 1, x, x, x, x)
