"""The port's examples against the JAX package's ``examples/``.

Each torch example is held against its JAX counterpart by recording what
both build at ``--smoke``: the data (bit for bit), the model, the warm
starts' shapes, the ``setup_mcmc`` arguments, the ``train`` call and the
pretraining call. The copied data builders are compared bit for bit as
functions too. Then each torch example runs through ``main([... "--cpu"
...])``: in full where that takes a few seconds here (the tempering
example), else its build-and-pretrain half plus three sampling epochs.
"""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tensorbnn_tpu_torch
from tensorbnn_tpu_torch.network import Network as TNetwork
from tensorbnn_tpu_torch.training import pretrain as t_pretrain

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("extended_regression", "classification", "train_regression",
            "tempering_bimodal", "digits_classification",
            "surrogate_regression")


def _argv(name, tmp_path):
    """The example's ``--cpu --smoke`` flags here: a folder for those that
    write one, 4,096 points for the 1M-point surrogate."""
    argv = ["--cpu", "--smoke"]
    if name == "surrogate_regression":
        return argv + ["--points", "4096"]
    if name != "tempering_bimodal":
        argv += ["--folder", str(tmp_path / name)]
    return argv


class _Stop(Exception):
    """Raised by the recording stand-ins at ``train``."""


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_example(name):
    return importlib.import_module(f"tensorbnn_tpu_torch.examples.{name}")


def _fake_pretrain(rec):
    def fake(hidden, input_dims, output_dims, width, cycles, epochs, alpha,
             train_in, train_out, val_in, val_out, **kw):
        kw.pop("device", None)
        rec["pretrain"] = dict(
            args=(hidden, input_dims, output_dims, width, cycles, epochs,
                  alpha), data=(train_in, train_out, val_in, val_out),
            kw=kw)
        dims = [input_dims] + [width] * hidden + [output_dims]
        return ([np.zeros((b, a), np.float32)
                 for a, b in zip(dims[:-1], dims[1:])],
                [np.zeros((b, 1), np.float32) for b in dims[1:]],
                [np.full((width,), alpha, np.float32)] * hidden)
    return fake


def _plain(value):
    """Numbers, strings and lists as they are; any other object by the
    name of its class and its public data attributes, its class's
    included."""
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    attrs = {k: getattr(value, k) for k in dir(value)
             if not k.startswith("_")}
    return type(value).__name__, sorted(
        (k, _plain(v)) for k, v in attrs.items() if not callable(v))


def _fake_network(rec):
    class Recorder:
        def __init__(self, dtype, input_dims, *data, seed=0, device=None):
            rec["net"] = dict(input_dims=input_dims, data=data, seed=seed,
                              layers=[])
            rec["device"] = device

        def add(self, layer, parameters=None):
            rec["net"]["layers"].append((layer, parameters))
            return self

        def setup_mcmc(self, **kw):
            rec["net"]["config"] = kw

        def train(self, epochs, sampling_step, likelihood, **kw):
            rec["net"]["train"] = (epochs, sampling_step,
                                   _plain(likelihood),
                                   sorted((k, _plain(v))
                                          for k, v in kw.items()))
            raise _Stop

    return Recorder


def _record(monkeypatch, name, argv, package):
    """What the example ``name`` of ``package`` ("jax" or "torch") hands
    the pretraining and the Network at ``argv``, up to its first
    ``train``."""
    rec = {}
    if package == "jax":
        import tensorbnn_tpu.network as net_mod
        import tensorbnn_tpu.training.pretrain as pre_mod
        monkeypatch.setattr(net_mod, "Network", _fake_network(rec))
        monkeypatch.setattr(sys, "argv", [name] + argv)
        call = _jax_example(name).main
    else:
        net_mod, pre_mod = tensorbnn_tpu_torch, t_pretrain
        monkeypatch.setattr(net_mod, "Network", _fake_network(rec))
        main = _torch_example(name).main

        def call():
            main(argv)
    for fn in ("train_basic_regression", "train_basic_classification"):
        monkeypatch.setattr(pre_mod, fn, _fake_pretrain(rec))
    with pytest.raises(_Stop):
        call()
    return rec


def _same_layer(got, want):
    """The same class with the same fields (a field the port's layer lacks
    must be at the JAX layer's default)."""
    assert type(got).__name__ == type(want).__name__
    fields = {k: v for k, v in vars(got).items() if not k.startswith("_")}
    for k, v in fields.items():
        assert getattr(want, k) == v, (k, v, getattr(want, k))
    for k in set(vars(want)) - set(fields):
        if k.startswith("_"):
            continue
        assert getattr(want, k) == type(want).__dataclass_fields__[
            k].default, k


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_builds_what_the_jax_example_builds(name, monkeypatch,
                                                    tmp_path):
    if name == "digits_classification":
        pytest.importorskip("sklearn")
    argv = _argv(name, tmp_path)
    want = _record(monkeypatch, name, argv, "jax")
    got = _record(monkeypatch, name, argv, "torch")
    assert got["device"] == "cpu"
    assert ("pretrain" in got) == ("pretrain" in want)
    if "pretrain" in want:
        assert got["pretrain"]["args"] == want["pretrain"]["args"]
        assert got["pretrain"]["kw"] == want["pretrain"]["kw"]
        for g, w in zip(got["pretrain"]["data"], want["pretrain"]["data"]):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)
    g_net, w_net = got["net"], want["net"]
    assert (g_net["input_dims"], g_net["seed"]) == (w_net["input_dims"],
                                                   w_net["seed"])
    for g, w in zip(g_net["data"], w_net["data"]):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
    assert len(g_net["layers"]) == len(w_net["layers"])
    for (g_layer, g_par), (w_layer, w_par) in zip(g_net["layers"],
                                                  w_net["layers"]):
        _same_layer(g_layer, w_layer)
        assert (g_par is None) == (w_par is None)
        for k in (w_par or {}):
            np.testing.assert_array_equal(g_par[k], w_par[k])
    assert g_net["config"] == w_net["config"]
    assert g_net["train"] == w_net["train"]


def test_data_builders_equal_the_jax_examples():
    jc, tc = _jax_example("classification"), _torch_example("classification")
    for n, seed in ((200, 0), (100, 1), (37, 5)):
        for g, w in zip(tc.two_moons(n, seed=seed), jc.two_moons(n,
                                                                 seed=seed)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    pytest.importorskip("sklearn")
    jd = _jax_example("digits_classification")
    td = _torch_example("digits_classification")
    for g, w in zip(td.digits_3v8(), jd.digits_3v8()):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _short_train(monkeypatch, epochs=3):
    """``Network.train`` for ``epochs`` epochs, then stop the example: its
    build-and-pretrain half and a few sampling epochs."""
    runs = []
    real = TNetwork.train

    def short(self, _epochs, sampling_step, likelihood, **kw):
        runs.append(real(self, epochs, sampling_step, likelihood, **kw))
        raise _Stop
    monkeypatch.setattr(TNetwork, "train", short)
    return runs


@pytest.mark.parametrize("name,path", [
    ("extended_regression", "K1"), ("classification", "K1"),
    ("train_regression", "K1"), ("digits_classification", "K3"),
    ("surrogate_regression", "plain")])
def test_example_runs_its_build_and_first_epochs_on_the_cpu(
        name, path, monkeypatch, tmp_path):
    if name == "digits_classification":
        pytest.importorskip("sklearn")
    runs = _short_train(monkeypatch)
    with pytest.raises(_Stop):
        _torch_example(name).main(_argv(name, tmp_path))
    res = runs[0]
    assert res.main_path == path, res.main_path
    assert res.main_accept.shape == (3,)
    assert np.isfinite(res.main_accept).all()
    assert np.isfinite(res.hyper_accept).all()


def test_tempering_example_runs_on_the_cpu(capsys):
    out = _torch_example("tempering_bimodal").main(["--cpu", "--smoke"])
    text = capsys.readouterr().out
    assert "replica swap acceptance" in text
    assert out["plain_path"] == out["tempered_path"] == "K1"
    assert 0.0 < out["swap_accept"] < 1.0
    # the warm start's mirrored mode: the plain chains stay where they start
    assert out["plain_negative"] == 0.0
    assert 0.0 <= out["tempered_negative"] <= 1.0


def test_surrogate_example_runs_on_the_cpu():
    """``surrogate_regression --cpu --smoke --points 4096`` in full (60
    epochs, one chain, the plain path under ``numerics="exact"``): 8
    samples, acceptance in (0, 1], a finite learned sd. Its 100,000-point
    ``--smoke`` runs on the card in ``chip_smoke.py``, held against the
    JAX example's figures. ``--data-devices 2`` on one device (the CPU
    under ``--cpu``) raises ``make_mesh``'s error, as the JAX example does
    on one chip."""
    module = _torch_example("surrogate_regression")
    out = module.main(["--cpu", "--smoke", "--points", "4096"])
    assert out["samples"] == 8 and out["main_path"] == "plain"
    assert not out["fused_hyper"]
    assert 0.0 < out["main_accept"] <= 1.0
    assert np.isfinite(out["learned_sd"]) and out["learned_sd"] > 0
    with pytest.raises(ValueError, match=r"^mesh 0x2 != 1 devices$"):
        module.main(["--cpu", "--smoke", "--data-devices", "2"])


def test_digits_example_exits_with_the_jax_message_without_sklearn(
        monkeypatch):
    jd = _jax_example("digits_classification")
    td = _torch_example("digits_classification")
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(SystemExit) as got:
        td.digits_3v8()
    with pytest.raises(SystemExit) as want:
        jd.digits_3v8()
    assert str(got.value) == str(want.value)


def test_new_modules_import_no_jax():
    code = ("import sys, tensorbnn_tpu_torch.training.pretrain, "
            + ", ".join(f"tensorbnn_tpu_torch.tensorBNN.{m}" for m in (
                "BNN_functions", "activationFunctions", "layer",
                "likelihood", "metrics", "network", "networkFinal",
                "predictor"))
            + ", " + ", ".join(f"tensorbnn_tpu_torch.examples.{m}"
                               for m in EXAMPLES)
            + "; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'tensorbnn_tpu', 'tensorBNN')); "
              "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
