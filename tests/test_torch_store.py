"""The port's sample store against the JAX package's: the native text
parser and formatter, the reference text store (``save_run``,
``RunWriter``, ``load_run``), the npz store, the layers' reference-format
hooks and registry, the metrics and the run tracer.

The same samples, made with numpy from a seed, go through both packages;
files are compared byte for byte. The one stated difference: the port's
``save_run`` writes ``chains.txt`` for a multichain sample set.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.io import checkpoint as j_ckpt, fast_text as j_ft, \
    reference_format as j_ref
from tensorbnn_tpu.metrics import Accuracy as JAccuracy, \
    MulticlassAccuracy as JMulticlass, PercentError as JPercent, \
    SquaredError as JSquared
from tensorbnn_tpu.models.mlp import make_mlp as j_make_mlp
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.utils.tracing import RunTracer as JTracer
from tensorbnn_tpu_torch import metrics as t_metrics
from tensorbnn_tpu_torch.io import checkpoint as t_ckpt, \
    fast_text as t_ft, reference_format as t_ref
from tensorbnn_tpu_torch.models.mlp import make_mlp as t_make_mlp
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.utils import tracing
from tensorbnn_tpu_torch.utils.tracing import ChunkRecord, RunTracer

torch.set_num_threads(1)


def _read_dir(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


# -- fast_text ----------------------------------------------------------------


def test_fast_text_format_and_parse_byte_equal_to_jax(tmp_path):
    assert t_ft.native_available() == j_ft.native_available()
    rng = np.random.default_rng(0)
    cases = [rng.normal(size=(7, 3)) * (10.0 ** rng.integers(
                 -200, 200, size=(7, 3))),
             rng.normal(size=13).astype(np.float32),
             np.array([[0.0, -0.0], [np.inf, -np.inf]]),
             np.array([np.nan, 1e-310]),
             rng.normal(size=(4, 5)).astype(np.float32),
             np.array(3.5)]
    for i, a in enumerate(cases):
        got = t_ft.format_floats(a)
        assert got == j_ft.format_floats(a), f"case {i}"
        buf = io.BytesIO()
        np.savetxt(buf, np.atleast_1d(a))
        assert got is None or got == buf.getvalue(), f"case {i}"
        p = str(tmp_path / f"{i}.txt")
        with open(p, "wb") as f:
            f.write(buf.getvalue())
        for dtype in (np.float32, np.float64):
            np.testing.assert_array_equal(t_ft.load_floats(p, dtype),
                                          j_ft.load_floats(p, dtype))
    with pytest.raises(FileNotFoundError):
        t_ft.load_floats(str(tmp_path / "nope.txt"))


def test_fast_text_fallback_writes_savetxt_bytes(monkeypatch):
    """Without the native library the writer falls back to np.savetxt,
    byte for byte the native formatter's output."""
    a = np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32)
    native = io.BytesIO()
    t_ref._write_floats(native, a)
    monkeypatch.setattr(t_ft, "format_floats", lambda arr: None)
    fallback = io.BytesIO()
    t_ref._write_floats(fallback, a)
    assert fallback.getvalue() == native.getvalue()


# -- the layers' reference-format surface -----------------------------------


def _layer_pairs():
    return [(J.GaussianDenseLayer(3, 2), T.GaussianDenseLayer(3, 2)),
            (J.CauchyDenseLayer(2, 4), T.CauchyDenseLayer(2, 4)),
            (J.DenseLayer(4, 1), T.DenseLayer(4, 1)),
            (J.LeakyRelu(alpha=0.2), T.LeakyRelu(alpha=0.2)),
            (J.Prelu(3), T.Prelu(3)), (J.SquarePrelu(3), T.SquarePrelu(3)),
            (J.Tanh(), T.Tanh()), (J.Softmax(), T.Softmax())]


@pytest.mark.parametrize("k", range(8))
def test_layer_reference_hooks_match_jax(k):
    j_layer, t_layer = _layer_pairs()[k]
    assert t_layer.name == j_layer.name
    assert t_layer.n_ref_param_tensors == j_layer.n_ref_param_tensors
    assert t_layer.n_ref_hyper_scalars == j_layer.n_ref_hyper_scalars
    assert t_layer.has_hypers == j_layer.has_hypers
    rng = np.random.default_rng(k)
    params, hypers = j_layer.init(jax.random.key(k))
    # a leading sample axis of 5, as the store writes them
    params = {n: rng.normal(size=(5,) + np.shape(v)).astype(np.float32)
              for n, v in params.items()}
    hypers = {n: rng.normal(size=(5,)).astype(np.float32) for n in hypers}
    j_t = j_layer.ref_param_tensors(params)
    t_t = t_layer.ref_param_tensors(params)
    assert len(t_t) == len(j_t)
    for a, b in zip(t_t, j_t):
        np.testing.assert_array_equal(a, b)
    for a, b in ((t_layer.params_from_ref(t_t), j_layer.params_from_ref(j_t)),
                 (t_layer.hypers_from_ref(t_layer.ref_hyper_values(hypers)),
                  j_layer.hypers_from_ref(j_layer.ref_hyper_values(hypers)))):
        assert sorted(a) == sorted(b)
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])


def test_registry_alias_and_make_mlp_match_jax():
    assert sorted(T.LAYER_REGISTRY) == sorted(J.LAYER_REGISTRY)
    for name, make in T.LAYER_REGISTRY.items():
        assert make().name == J.LAYER_REGISTRY[name]().name == name
    assert T.DenseLayer is T.CauchyDenseLayer
    for kw in (dict(dims=(1, 10, 10, 1)),
               dict(dims=(4, 8, 2), activation="prelu", prior="cauchy",
                    final_activation="softmax"),
               dict(dims=(3, 5, 1), activation="squareprelu",
                    final_activation="sigmoid"),
               dict(dims=(2, 6, 1), activation="leakyrelu")):
        j_model, t_model = j_make_mlp(**kw), t_make_mlp(**kw)
        assert t_model.layer_names == j_model.layer_names
        assert [type(a).__name__ for a in t_model.layers] == \
            [type(a).__name__ for a in j_model.layers]
    with pytest.raises(ValueError, match="prior"):
        t_make_mlp((1, 2), prior="laplace")


# -- the reference text store -------------------------------------------------


def _trig_models(learned_sd=False):
    """The 1-10-10-1 trig net in both packages, and each likelihood."""
    widths = ((1, 10), (10, 10), (10, 1))
    j_layers, t_layers = [], []
    for i, (a, b) in enumerate(widths):
        j_layers.append(J.GaussianDenseLayer(a, b))
        t_layers.append(T.GaussianDenseLayer(a, b))
        if i < len(widths) - 1:
            j_layers.append(J.Tanh())
            t_layers.append(T.Tanh())
    lik = "GaussianLikelihood" if learned_sd else "FixedGaussianLikelihood"
    return (JSequential(j_layers), getattr(J, lik)(sd=0.1),
            TSequential(t_layers), getattr(T, lik)(sd=0.1))


def _samples(n, model_j, learned_sd, seed=0):
    """``n`` stacked numpy networks (params, hypers, lik hypers)."""
    rng = np.random.default_rng(seed)
    params, hypers = [], []
    for layer in model_j.layers:
        p, h = layer.init(jax.random.key(0))
        params.append({k: rng.normal(size=(n,) + np.shape(v)).astype(
            np.float32) for k, v in p.items()})
        hypers.append({k: rng.normal(size=(n,)).astype(np.float32)
                       for k in h})
    lik = ({"sd_root": rng.uniform(0.2, 0.4, size=n).astype(np.float32)}
           if learned_sd else {})
    return tuple(params), tuple(hypers), lik


@pytest.mark.parametrize("case", ["one chain", "4 chains", "learned sd"])
def test_save_run_byte_equal_to_jax(tmp_path, case):
    learned = case == "learned sd"
    j_model, j_lik, t_model, t_lik = _trig_models(learned)
    n_chains = 4 if case == "4 chains" else 1
    samples = _samples(23, j_model, learned)
    chain_ids = np.repeat(np.arange(n_chains), -(-23 // n_chains))[:23]
    d_j, d_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    kept = j_ref.save_run(d_j, j_model, j_lik, *samples, 5)
    assert t_ref.save_run(d_t, t_model, t_lik, *samples, 5,
                          chain_ids=chain_ids) == kept == 20
    files_j, files_t = _read_dir(d_j), _read_dir(d_t)
    if n_chains > 1:
        # the stated addition: the kept networks' chain ids
        assert files_t.pop("chains.txt") == "".join(
            f"{c}\n" for c in chain_ids[:20]).encode()
    assert files_t == files_j
    # a later one-chain save into the same folder drops the stale ids
    t_ref.save_run(d_t, t_model, t_lik, *samples, 5)
    assert "chains.txt" not in os.listdir(d_t)
    # the port's reader gives the JAX reader's arrays
    for got, want in zip(t_ref.load_run(d_j), j_ref.load_run(d_j)):
        if isinstance(want, list) and not isinstance(want[0], str):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        elif want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("resume", [False, True])
def test_run_writer_byte_equal_to_jax(tmp_path, resume):
    """Streamed appends (time-major, 3 chains, 4 networks a file with a
    partial last file) write the JAX writer's bytes, chains.txt included;
    with ``resume``, each writer is restored from its own state_dict after
    a crash streamed past the checkpoint, and both truncate alike."""
    j_model, j_lik, t_model, t_lik = _trig_models(learned_sd=True)
    params, hypers, lik = _samples(19, j_model, True, seed=3)

    def drive(writer_cls, model, likelihood, path):
        def one(i):
            return (tuple({k: v[i] for k, v in p.items()} for p in params),
                    tuple({k: v[i] for k, v in h.items()} for h in hypers),
                    {k: v[i] for k, v in lik.items()})
        w = writer_cls(path, model, likelihood, 4)
        for i in range(11):
            w.append(*one(i), chain=i % 3)
        if resume:
            state = w.state_dict()
            for i in range(11, 14):     # streamed past the checkpoint
                w.append(*one(i), chain=i % 3)
            w = writer_cls(path, model, likelihood, 4, resume_state=state)
        for i in range(11, 19):
            w.append(*one(i), chain=i % 3)
        return w.close()

    d_j, d_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert drive(t_ref.RunWriter, t_model, t_lik, d_t) == \
        drive(j_ref.RunWriter, j_model, j_lik, d_j) == 16
    files_t = _read_dir(d_t)
    assert "chains.txt" in files_t and files_t == _read_dir(d_j)


def test_npz_store_carries_chain_ids_and_jax_reads_it(tmp_path):
    j_model, _, _, _ = _trig_models(learned_sd=True)
    samples = _samples(12, j_model, True, seed=4)
    chains = np.repeat(np.arange(3), 4)
    t_ckpt.save_samples(str(tmp_path), *samples, chain_index=chains)
    j_params, j_hypers, j_lik = j_ckpt.load_samples(str(tmp_path))
    t_params, t_hypers, t_lik, t_chains = \
        t_ckpt.load_samples_with_chains(str(tmp_path))
    np.testing.assert_array_equal(t_chains, chains)
    for got, want, orig in ((t_params, j_params, samples[0]),
                            (t_hypers, j_hypers, samples[1])):
        assert len(got) == len(want) == len(orig)
        for g, w, o in zip(got, want, orig):
            assert sorted(g) == sorted(w) == sorted(o)
            for k in g:
                np.testing.assert_array_equal(g[k], o[k])
                np.testing.assert_array_equal(w[k], o[k])
    assert sorted(t_lik) == sorted(j_lik) == ["sd_root"]
    # a JAX npz store has no chain ids
    j_ckpt.save_samples(str(tmp_path / "j"), *samples)
    assert t_ckpt.load_samples_with_chains(str(tmp_path / "j"))[3] is None


# -- metrics and the tracer -------------------------------------------------------

_rng = np.random.default_rng(7)
PT = _rng.normal(size=(12, 1)).astype(np.float32)
PV = _rng.normal(size=(8, 1)).astype(np.float32)
RT = _rng.normal(size=(12,)).astype(np.float32)
RV = _rng.normal(size=(8,)).astype(np.float32)


def _unscale(a, mean, sd, scale_exp):
    a = a * sd + mean
    return np.exp(a) if scale_exp else a


@pytest.mark.parametrize("mean,sd,scale_exp", [
    (0.0, 1.0, False), (1.5, 0.3, False), (0.2, 0.4, True)])
def test_squared_and_percent_error_golden(mean, sd, scale_exp):
    """The golden values of tests/test_metrics.py, on tensors."""
    pt = _unscale(PT, mean, sd, scale_exp)
    rt = _unscale(RT, mean, sd, scale_exp).reshape(pt.shape)
    pv = _unscale(PV, mean, sd, scale_exp)
    rv = _unscale(RV, mean, sd, scale_exp).reshape(pv.shape)
    for t_cls, j_cls, fn, rtol in (
            (t_metrics.SquaredError, JSquared,
             lambda p, r: np.mean((p - r) ** 2), 1e-5),
            (t_metrics.PercentError, JPercent,
             lambda p, r: np.mean(np.abs((p - r) / r)) * 100.0, 1e-4)):
        m = t_cls(scale_exp=scale_exp, mean=mean, sd=sd)
        m.calculate(*map(torch.as_tensor, (PT, PV, RT, RV)))
        jm = j_cls(scale_exp=scale_exp, mean=mean, sd=sd)
        jm.calculate(*map(jnp.asarray, (PT, PV, RT, RV)))
        np.testing.assert_allclose(m.train, fn(pt, rt), rtol=rtol)
        np.testing.assert_allclose(m.validate, fn(pv, rv), rtol=rtol)
        np.testing.assert_allclose([m.train, m.validate],
                                   [jm.train, jm.validate], rtol=rtol)
        assert m.display() == jm.display()


def test_accuracy_metrics_and_percent_error_quirk_match_jax():
    pt = np.array([[0.9], [0.2], [0.6], [0.4]], np.float32)
    rt = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    pv = np.array([[0.1], [0.8]], np.float32)
    rv = np.array([0.0, 1.0], np.float32)
    m = t_metrics.Accuracy()
    m.calculate(*map(torch.as_tensor, (pt, pv, rt, rv)))
    assert (m.train, m.validate) == (0.75, 1.0)
    assert "accuracy" in m.display()
    # the rounding happens on the un-normalized scale
    m = t_metrics.Accuracy(mean=0.5, sd=0.25)
    jm = JAccuracy(mean=0.5, sd=0.25)
    x, y = np.array([[-1.0], [1.0]], np.float32), np.array([0.0, 1.0],
                                                          np.float32)
    m.calculate(*map(torch.as_tensor, (x, x, y, y)))
    jm.calculate(*map(jnp.asarray, (x, x, y, y)))
    np.testing.assert_allclose(m.train, jm.train, rtol=1e-6)
    # argmax accuracy on ids and on one-hot rows
    probs = np.array([[0.1, 0.7, 0.2], [0.8, 0.1, 0.1], [0.2, 0.3, 0.5]],
                     np.float32)
    ids = np.array([1, 0, 1])
    for real in (ids, ids[:, None], np.eye(3, dtype=np.float32)[ids]):
        m, jm = t_metrics.MulticlassAccuracy(), JMulticlass()
        m.calculate(*map(torch.as_tensor, (probs, probs, real, real)))
        jm.calculate(*map(jnp.asarray, (probs, probs, real, real)))
        assert m.train == pytest.approx(2 / 3) == jm.train
    # kept quirk: a zero target makes the percent error non-finite
    p, r = np.array([[1.0], [2.0]], np.float32), np.array([0.0, 2.0],
                                                          np.float32)
    m = t_metrics.PercentError()
    m.calculate(*map(torch.as_tensor, (p, p, r, r)))
    assert not np.isfinite(m.train)


def test_run_tracer_summary_matches_jax(monkeypatch, tmp_path):
    clock = iter([0.0, 0.5, 1.0, 1.25])
    tracers = (RunTracer(), JTracer())
    for tr in tracers:
        tr.chunks = [ChunkRecord(10, 20.0, 8, 0.5),
                     ChunkRecord(5, 15.0, 8, 0.25, max_leapfrog=30.0)]
    assert tracers[0].chunks[0].max_leapfrog == 20.0
    summaries = [tr.summary() for tr in tracers]
    assert summaries[0] == summaries[1]
    assert set(summaries[0]) == {"chunks", "epochs", "total_seconds",
                                 "leapfrog_steps", "leapfrog_steps_per_sec",
                                 "straggler_efficiency"}
    assert summaries[0]["leapfrog_steps"] == 10 * 20 * 8 + 5 * 15 * 8
    assert summaries[0]["straggler_efficiency"] == round(275 / 350, 4)
    # profile: a torch.profiler trace of the block, or nothing
    with tracing.profile(None) as prof:
        assert prof is None
    with tracing.profile(str(tmp_path / "trace")) as prof:
        torch.ones(3).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").exists()
    # start/end around a chunk, on the tracer's clock
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: next(clock))
    tr = RunTracer()
    tr.end_chunk(1, 1.0, 1)                 # no start: ignored
    tr.start_chunk()
    tr.end_chunk(4, 10.0, 2)
    assert len(tr.chunks) == 1 and tr.chunks[0].seconds == 0.5
    assert tr.leapfrog_steps_per_sec == 80 / 0.5
    series = np.random.default_rng(0).normal(size=(200, 4))
    assert np.isfinite(tr.ess_per_sec(series))
