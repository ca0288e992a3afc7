"""The port's MAP pretraining against the JAX package's, on the CPU.

The amsgrad update (its step count, bias corrections and learning rate
device scalars, its state refilled in place each cycle) is held against
``optax.amsgrad``; the trainer (``_train_mlp``) against the JAX trainer
from the same glorot init (the JAX ``_mlp_init``, injected through
``init_params``) and the same numpy permutations, case by case, eagerly
and through a stand-in for the CUDA graph of an optimizer step
(``RecordingGraph``: the graph path's first epoch as the warm-up, one
capture, a replay a step, bit-equal to the eager path), with the epoch
body's static buffers held across replays; the returned layout and the
warm-start converters bit for bit. Then ports of ``tests/test_pretrain.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorbnn_tpu.training import pretrain as J
from tensorbnn_tpu_torch.parallel import graphs
from tensorbnn_tpu_torch.training import pretrain as T

torch.set_num_threads(1)

#: the amsgrad step against optax's (both float32)
AMSGRAD_ATOL = 1e-6
#: trained parameters against the JAX trainer's after 15-30 epochs: the two
#: differ only in float32 summation orders (measured ~1e-7)
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 2e-6


def _toy():
    x = np.linspace(-2, 2, 40)
    y = np.sin(x * math.pi) * x
    return x, y


def _moons(n, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, n)
    x = np.stack([np.cos(t), np.sin(t)], 1) + rng.normal(0, 0.2, (n, 2))
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    x[y > 0.5] = 1 - x[y > 0.5]
    return x.astype(np.float32), y


def _amsgrad_pair(n_updates, lr, p_j, state_j, p_t, state_t, rng):
    """``n_updates`` steps of ``optax.amsgrad(lr)`` from ``(p_j,
    state_j)`` and of the port's from ``(p_t, state_t)`` on the same
    gradients; returns both ends."""
    opt = optax.amsgrad(lr)
    for _ in range(n_updates):
        # gradients spread over four decades, so the running max moves
        g = [(rng.normal(size=a.shape) * 10 ** rng.uniform(-3, 1)).astype(
            np.float32) for a in p_j]
        upd, state_j = opt.update([jnp.asarray(a) for a in g], state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        T.amsgrad_update(p_t, [torch.tensor(a) for a in g], state_t)
    return p_j, state_j


def _amsgrad_close(p_j, state_j, p_t, state_t):
    for a, b in zip(p_j, p_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=AMSGRAD_ATOL)
    for a, b in zip(state_j[0].nu_max, state_t["nu_max"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


@pytest.mark.parametrize("n_updates", [1, 8])
def test_amsgrad_update_matches_optax(n_updates):
    rng = np.random.default_rng(n_updates)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(3,)).astype(np.float32)]
    p_j = [jnp.asarray(a) for a in p0]
    p_t = [torch.tensor(a) for a in p0]
    state_t = T.amsgrad_init(p_t, 1e-2)
    # the count and the rate are float32 scalars on the parameters' device
    for k in ("count", "lr"):
        assert state_t[k].shape == () and state_t[k].dtype == torch.float32
    p_j, state_j = _amsgrad_pair(n_updates, 1e-2, p_j,
                                 optax.amsgrad(1e-2).init(p_j), p_t, state_t,
                                 rng)
    assert state_t["count"].item() == n_updates
    _amsgrad_close(p_j, state_j, p_t, state_t)


@pytest.mark.parametrize("n_updates", [1, 8])
def test_amsgrad_restart_in_place_matches_optax(n_updates):
    """A second cycle: ``amsgrad_init(params, lr, state)`` zeroes the count
    and the moments and sets the rate in the same tensors, and the steps
    from there match a fresh ``optax.amsgrad`` at the new rate."""
    rng = np.random.default_rng(10 + n_updates)
    p0 = [rng.normal(size=(4, 6)).astype(np.float32),
          rng.normal(size=(6,)).astype(np.float32)]
    p_j = [jnp.asarray(a) for a in p0]
    p_t = [torch.tensor(a) for a in p0]
    state_t = T.amsgrad_init(p_t, 1e-2)
    p_j, _ = _amsgrad_pair(5, 1e-2, p_j, optax.amsgrad(1e-2).init(p_j), p_t,
                           state_t, rng)
    tensors = [state_t["count"], state_t["lr"]] + [
        t for k in ("mu", "nu", "nu_max") for t in state_t[k]]
    addresses = [t.data_ptr() for t in tensors]
    assert T.amsgrad_init(p_t, 1e-3, state_t) is state_t
    assert [t.data_ptr() for t in tensors] == addresses
    assert state_t["count"].item() == 0
    assert state_t["lr"].item() == np.float32(1e-3)
    assert all(not t.any() for k in ("mu", "nu", "nu_max")
               for t in state_t[k])
    # the cycles start from the same parameters (within the tolerance)
    p_t = [torch.tensor(np.asarray(a)) for a in p_j]
    p_j, state_j = _amsgrad_pair(n_updates, 1e-3, p_j,
                                 optax.amsgrad(1e-3).init(p_j), p_t, state_t,
                                 rng)
    assert state_t["count"].item() == n_updates
    _amsgrad_close(p_j, state_j, p_t, state_t)


def _counting_rng(monkeypatch):
    """Counts ``permutation`` calls (one an epoch in both trainers)."""
    calls = []
    real = np.random.default_rng

    class Counting(np.random.Generator):
        def permutation(self, *a, **k):
            calls.append(1)
            return super().permutation(*a, **k)

    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed: Counting(real(seed).bit_generator))
    return calls


_X, _Y = _toy()
_XC, _YC = _moons(60, 0)
_XCV, _YCV = _moons(30, 1)
# (positional args after the widths: cycles, epochs, alpha, data), kwargs
CASES = {
    "regression": ((2, 1, 1, 6, 2, 15, 0.1, _X, _Y, _X, _Y),
                   dict(classification=False, base_lr=0.01)),
    "classification": ((2, 2, 1, 8, 2, 15, 0.1, _XC, _YC, _XCV, _YCV),
                       dict(classification=True, base_lr=0.001)),
    "train_slopes": ((2, 1, 1, 6, 2, 15, 0.1, _X, _Y, _X, _Y),
                     dict(classification=False, base_lr=0.01,
                          train_slopes=True)),
    "classification_slopes": ((2, 2, 1, 8, 1, 20, 0.1, _XC, _YC, _XCV,
                               _YCV),
                              dict(classification=True, base_lr=0.001,
                                   train_slopes=True)),
    "tanh": ((2, 1, 1, 6, 2, 15, 0.1, _X, _Y, _X, _Y),
             dict(classification=False, base_lr=0.01,
                  hidden_activation="tanh")),
    "n_below_batch": ((1, 1, 1, 5, 2, 20, 0.1, _X[:20], _Y[:20], _X, _Y),
                      dict(classification=False, base_lr=0.01)),
    "batch_size_8": ((2, 1, 1, 6, 1, 15, 0.1, _X, _Y, _X, _Y),
                     dict(classification=False, base_lr=0.01,
                          batch_size=8)),
    # validation on the mirrored curve: its loss rises, and patience 2
    # stops the first cycle early and restores its best weights
    "early_stop": ((2, 1, 1, 6, 2, 30, 0.1, _X, _Y, _X, -_Y),
                   dict(classification=False, base_lr=0.01, patience=2,
                        batch_size=8)),
}


def _init(case, seed=3):
    """The JAX ``_mlp_init`` at ``case``'s widths, as numpy pairs."""
    hidden, d_in, d_out, width = CASES[case][0][:4]
    dims = [d_in] + [width] * hidden + [d_out]
    return [(np.asarray(p["w"]), np.asarray(p["b"]))
            for p in J._mlp_init(jax.random.key(seed), dims)]


@functools.lru_cache(maxsize=None)
def _jax_trained(case, seed=3):
    """The JAX trainer's result at ``case`` and the permutations it drew
    (one an epoch)."""
    args, kw = CASES[case]
    calls = []
    real = np.random.default_rng

    class Counting(np.random.Generator):
        def permutation(self, *a, **k):
            calls.append(1)
            return super().permutation(*a, **k)

    np.random.default_rng = lambda s: Counting(real(s).bit_generator)
    try:
        want = J._train_mlp(*args, seed=seed, **kw)
    finally:
        np.random.default_rng = real
    return want, len(calls)


def _close_to_jax(got, want):
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list)
        for g, w in zip(g_list, w_list):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL)


def _bits(arrays):
    """Every returned array's float32 bits, in order."""
    return [np.asarray(a, np.float32).view(np.uint32)
            for part in arrays for a in part]


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_mlp_matches_jax(case, monkeypatch):
    args, kw = CASES[case]
    seed = 3
    init = _init(case, seed)
    want, epochs_j = _jax_trained(case, seed)
    calls = _counting_rng(monkeypatch)
    got = T._train_mlp(*args, seed=seed, device="cpu", init_params=init,
                       **kw)
    assert len(calls) == epochs_j
    if case == "early_stop":
        assert epochs_j < 2 * args[5], epochs_j   # stopped before the end
    _close_to_jax(got, want)
    # and the run moved the weights off their init
    assert np.abs(got[0][0] - init[0][0].T).max() > 1e-3


def _body_tensors(body):
    """Every tensor an epoch body reads or writes: its buffers, the
    amsgrad state and the parameters."""
    state = body.state
    return ([body.perm, body.bx, body.by, body.i, body.losses, body.val,
             body.x, body.y, body.xv, body.yv, state["count"], state["lr"]]
            + list(body.params)
            + [t for k in ("mu", "nu", "nu_max") for t in state[k]])


class RecordingGraph:
    """A stand-in for ``graphs.CudaGraph`` on the CPU, as strict as a
    graph about addresses: capture keeps the step (``fn``, a bound
    ``_EpochBody.step``) and the address of every tensor of its body, each
    replay holds those addresses unchanged and runs the step again, the
    warm-up runs its function once. ``steps`` records, for each replay,
    the step count and whether the moments were all zero before it, and
    at a count of 0 the parameters it found."""

    made, steps = [], []

    def __init__(self, fn, generator, device):
        assert generator is None  # pretraining draws nothing on the device
        self.fn, self.body = fn, fn.__self__
        self.addresses = [t.data_ptr() for t in _body_tensors(self.body)]
        RecordingGraph.made.append(self)

    def replay(self):
        body = self.body
        assert [t.data_ptr() for t in _body_tensors(body)] == self.addresses
        count = body.state["count"].item()
        RecordingGraph.steps.append({
            "count": count,
            "moments_zero": all(not t.any() for k in ("mu", "nu", "nu_max")
                                for t in body.state[k]),
            "before": ([p.detach().clone() for p in body.params]
                       if count == 0 else None)})
        self.fn()

    @staticmethod
    def warm_up(fn, device):
        fn()

    @classmethod
    def reset(cls):
        cls.made, cls.steps = [], []


def _n_batches(case):
    args, kw = CASES[case]
    return max(len(args[7]) // kw.get("batch_size", 32), 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_mlp_graph_matches_eager_and_jax(case, monkeypatch):
    """Each case through the graph path (the stand-in graph of a step):
    bit-equal to the eager path (every returned array, every epoch's
    validation loss, the epochs run), within the JAX trainer's tolerance,
    one warm-up epoch, one capture and a replay for every step of every
    later epoch."""
    args, kw = CASES[case]
    init = _init(case)
    want, epochs_j = _jax_trained(case)
    eager_vals, graph_vals = [], []
    eager = T._train_mlp(*args, seed=3, device="cpu", init_params=init,
                         epoch_hook=eager_vals.append, **kw)
    graphs.COUNTS.reset()
    RecordingGraph.reset()
    calls = _counting_rng(monkeypatch)
    got = T._train_mlp(*args, seed=3, device="cpu", init_params=init,
                       graph_type=RecordingGraph,
                       epoch_hook=graph_vals.append, **kw)
    assert len(calls) == epochs_j == len(graph_vals)
    assert graph_vals == eager_vals
    for g, e in zip(_bits(got), _bits(eager)):
        np.testing.assert_array_equal(g, e)
    _close_to_jax(got, want)
    replays = (epochs_j - 1) * _n_batches(case)
    counts = graphs.COUNTS.as_dict()
    assert (counts["warmups"], counts["captures"], counts["replays"]) == (
        1, 1, replays), counts
    assert len(RecordingGraph.made) == 1
    assert len(RecordingGraph.steps) == replays
    # eager, nothing is captured
    graphs.COUNTS.reset()
    T._train_mlp(*args, seed=3, device="cpu", init_params=init, eager=True,
                 graph_type=RecordingGraph, **kw)
    assert graphs.COUNTS.as_dict()["captures"] == 0


def test_step_graph_keeps_its_buffers(monkeypatch):
    """The early-stopping case (two cycles, the first stopped early) on
    the stand-in graph: each epoch's permutation is the one numpy drew
    for it and its batches are gathered from it, every batch is stepped,
    the step count restarts at each cycle and counts its steps, the
    moments are zero exactly at a cycle's first step, the first cycle's
    best weights are what the second starts from, the second's are what
    the call returns, and one graph is captured for the call."""
    args, kw = CASES["early_stop"]
    n_batches = _n_batches("early_stop")
    drawn, bodies, epochs = [], [], []
    real = np.random.default_rng

    class Recording(np.random.Generator):
        def permutation(self, *a, **k):
            out = super().permutation(*a, **k)
            drawn.append((self.seed, out))
            return out

    def make(seed):
        g = Recording(real(seed).bit_generator)
        g.seed = seed
        return g

    class Body(T._EpochBody):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            bodies.append(self)

    def hook(val):
        body = bodies[0]
        epochs.append({"val": val, "perm": body.perm.clone(),
                       "bx": body.bx.clone(), "i": body.i.item(),
                       "after": [p.detach().clone() for p in body.params]})

    monkeypatch.setattr(np.random, "default_rng", make)
    monkeypatch.setattr(T, "_EpochBody", Body)
    RecordingGraph.reset()
    w, b, a = T._train_mlp(*args, seed=3, device="cpu",
                           init_params=_init("early_stop"),
                           graph_type=RecordingGraph, epoch_hook=hook, **kw)
    assert len(bodies) == len(RecordingGraph.made) == 1
    assert len(epochs) == len(drawn)
    cycle = [s - 3 for s, _ in drawn]
    first = cycle.count(0)
    assert first < args[5] and cycle == [0] * first + [1] * (
        len(drawn) - first)
    x = bodies[0].x
    for entry, (_, perm) in zip(epochs, drawn):
        perm = perm[: len(entry["perm"])]
        np.testing.assert_array_equal(entry["perm"].numpy(), perm)
        assert torch.equal(entry["bx"].reshape(len(perm), -1), x[perm])
        assert entry["i"] == n_batches
    # every step after the warm-up epoch a replay, each cycle counting its
    # steps from 0
    steps = RecordingGraph.steps
    counts = [r["count"] for r in steps]
    assert counts == list(range(n_batches, first * n_batches)) + list(
        range((len(drawn) - first) * n_batches))
    assert [r["moments_zero"] for r in steps] == [c == 0 for c in counts]
    # the first cycle's best weights start the second cycle
    vals = [e["val"] for e in epochs]
    best0 = int(np.argmin(vals[:first]))
    start = steps[(first - 1) * n_batches]["before"]
    for p, q in zip(start, epochs[best0]["after"]):
        assert torch.equal(p, q)
    # and the second cycle's best are returned, in the reference layout
    best1 = first + int(np.argmin(vals[first:]))
    got = [t for pair in zip(w, b) for t in pair]
    for g, p in zip(got, epochs[best1]["after"]):
        np.testing.assert_array_equal(np.asarray(g).reshape(-1),
                                      p.numpy().T.reshape(-1))


@pytest.mark.parametrize("train_slopes", [False, True])
def test_layout_and_converters_bit_equal(train_slopes):
    """With no epoch the trainer returns its init: the returned layout
    (W (out, in), b (out, 1), the slope vectors) equals the JAX trainer's
    bit for bit, and so do the three warm-start converters."""
    x, y = _toy()
    dims = [1, 4, 4, 1]
    init = [(np.asarray(p["w"]), np.asarray(p["b"]))
            for p in J._mlp_init(jax.random.key(7), dims)]
    args = (2, 1, 1, 4, 1, 0, 0.1, x, y, x, y)
    kw = dict(classification=False, base_lr=0.01, seed=7,
              train_slopes=train_slopes)
    want = J._train_mlp(*args, **kw)
    got = T._train_mlp(*args, device="cpu", init_params=init, **kw)
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    w, b, a = got
    # slopes below the SquarePrelu floor, negative ones among them
    a = [a[0] - np.float32([0.2, 0.0, 0.15, -0.3]), a[1]]
    for i in range(3):
        for k, v in T.dense_warm_start(w, b, i).items():
            ref = J.dense_warm_start(w, b, i)[k]
            assert v.shape == ref.shape and v.dtype == ref.dtype
            np.testing.assert_array_equal(v, ref)
    for i in range(2):
        np.testing.assert_array_equal(T.prelu_warm_start(a, i)["slopes"],
                                      J.prelu_warm_start(a, i)["slopes"])
        for floor in (1e-4, 1e-2):
            s_t = T.squareprelu_warm_start(a, i, floor)["slopes"]
            s_j = J.squareprelu_warm_start(a, i, floor)["slopes"]
            assert s_t.dtype == s_j.dtype
            np.testing.assert_array_equal(s_t, s_j)


def test_entry_points_keep_matmul_precision_and_need_a_card():
    x, y = _toy()
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cuda.matmul.allow_tf32)
    T.train_basic_classification(1, 1, 1, 3, 1, 2, 0.1, x, y > 0, x, y > 0,
                                 device="cpu")
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32) == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.train_basic_regression(1, 1, 1, 3, 1, 2, 0.1, x, y, x, y)


# -- ports of tests/test_pretrain.py ---------------------------------------


def test_returns_all_three_with_shapes():
    x, y = _toy()
    w, b, a = T.train_basic_regression(2, 1, 1, 6, 1, 15, 0.1,
                                       x, y, x, y, seed=0, device="cpu")
    wj, bj, aj = J.train_basic_regression(2, 1, 1, 6, 1, 15, 0.1,
                                          x, y, x, y, seed=0)
    assert len(w) == 3 and len(b) == 3 and len(a) == 2
    assert w[0].shape == (6, 1) and b[0].shape == (6, 1)  # reference layout
    assert a[0].shape == (6,)
    assert [v.shape for v in w + b + a] == [v.shape for v in wj + bj + aj]
    # untrained slopes are the constant alpha vectors
    np.testing.assert_allclose(a[0], 0.1)
    np.testing.assert_array_equal(np.stack(a), np.stack(aj))


def test_trained_slopes_move_and_fit_improves():
    """From the JAX test's own start (the JAX package's seed-1 glorot init:
    the fit's MSE depends on the init draw, and the port draws its own
    from a torch generator), through the public entry point's trainer."""
    x, y = _toy()
    init = [(np.asarray(p["w"]), np.asarray(p["b"]))
            for p in J._mlp_init(jax.random.key(1), [1, 8, 8, 1])]
    w, b, a = T._train_mlp(2, 1, 1, 8, 1, 60, 0.1, x, y, x, y,
                           classification=False, base_lr=0.01, seed=1,
                           train_slopes=True, device="cpu",
                           init_params=init)
    assert len(a) == 2 and a[0].shape == (8,)
    # jointly-trained slopes actually moved off the init
    assert np.abs(np.concatenate(a) - 0.1).max() > 1e-4

    # and the MAP fit is sane: reconstruct the net and check train MSE
    def apply(xv):
        h = xv.reshape(-1, 1)
        for i in range(3):
            h = h @ np.asarray(w[i]).T + np.asarray(b[i]).reshape(-1)
            if i < 2:
                h = np.where(h < 0, a[i] * h, h)
        return h[:, 0]

    mse = np.mean((apply(x) - y) ** 2)
    assert mse < 0.25


def test_warm_start_converters():
    x, y = _toy()
    w, b, a = T.train_basic_regression(1, 1, 1, 4, 1, 10, 0.1,
                                       x, y, x, y, seed=2, train_slopes=True,
                                       device="cpu")
    d = T.dense_warm_start(w, b, 0)
    assert d["w"].shape == (1, 4) and d["b"].shape == (4,)
    p = T.prelu_warm_start(a, 0)
    np.testing.assert_allclose(p["slopes"], np.asarray(a[0]).reshape(-1))
    s = T.squareprelu_warm_start(a, 0)
    # squared parameter reproduces the (floored) effective slope
    np.testing.assert_allclose(s["slopes"] ** 2,
                               np.maximum(a[0], 1e-4), rtol=1e-6)


def test_prelu_warm_start_end_to_end():
    """The warm-started slopes appear verbatim in the chain's initial state
    and the sampler runs (``Network.add(parameters=...)`` for a trainable
    activation), on the CPU."""
    from tensorbnn_tpu_torch import FixedGaussianLikelihood, \
        GaussianDenseLayer, Network, Prelu

    x, y = _toy()
    w, b, a = T.train_basic_regression(1, 1, 1, 5, 1, 20, 0.1,
                                       x, y, x, y, seed=3, train_slopes=True,
                                       device="cpu")
    net = Network(torch.float32, 1, x, y, x, y, seed=0, device="cpu")
    net.add(GaussianDenseLayer(1, 5), parameters=T.dense_warm_start(w, b, 0))
    net.add(Prelu(5), parameters=T.prelu_warm_start(a, 0))
    net.add(GaussianDenseLayer(5, 1), parameters=T.dense_warm_start(w, b, 1))

    params, _ = net.init_state()
    np.testing.assert_allclose(params[1]["slopes"].numpy(),
                               np.asarray(a[0]), rtol=1e-6)
    np.testing.assert_allclose(params[0]["w"].numpy(), np.asarray(w[0]).T,
                               rtol=1e-6)

    net.setup_mcmc(step_size_start=1e-3, leapfrog_start=8, leapfrog_min=4,
                   leapfrog_max=16, burnin=10, averaging_steps=5,
                   hyper_leapfrog=4, random_steps=1)
    res = net.train(20, 4, FixedGaussianLikelihood(sd=0.1), verbose=False)
    assert np.isfinite(res.theta_samples).all()


def test_shim_activation_warm_start():
    """Reference-style script through the port's shim: Prelu(activation=
    ...) feeds the pretrained slopes through, and the dense layers their
    weights, as the JAX shim does."""
    from tensorBNN.activationFunctions import Prelu as JPrelu
    from tensorBNN.layer import DenseLayer as JDense
    from tensorBNN.network import network as jnetwork
    from tensorbnn_tpu_torch.tensorBNN.activationFunctions import Prelu
    from tensorbnn_tpu_torch.tensorBNN.layer import DenseLayer
    from tensorbnn_tpu_torch.tensorBNN.network import network

    x, y = _toy()
    w, b, a = T.train_basic_regression(1, 1, 1, 5, 1, 15, 0.1,
                                       x, y, x, y, seed=4, train_slopes=True,
                                       device="cpu")
    net = network(torch.float32, 1, x, y, x, y, device="cpu")
    net.add(DenseLayer(1, 5, weights=w[0], biases=b[0]))
    net.add(Prelu(5, activation=a[0]))
    net.add(DenseLayer(5, 1, weights=w[1], biases=b[1]))
    params, _ = net.init_state()
    np.testing.assert_allclose(params[1]["slopes"].numpy(),
                               np.asarray(a[0]).reshape(-1), rtol=1e-6)
    jnet = jnetwork(jnp.float32, 1, x, y, x, y)
    jnet.add(JDense(1, 5, weights=w[0], biases=b[0]))
    jnet.add(JPrelu(5, activation=a[0]))
    jnet.add(JDense(5, 1, weights=w[1], biases=b[1]))
    jparams, _ = jnet.init_state()
    for p, q in zip(params, jparams):
        for k in q:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(q[k]))
