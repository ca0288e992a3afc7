"""The ``Predictor``'s graph route (``parallel/graphs.py::ForwardGraph``) on
the CPU, against its eager route and the JAX package's ``Predictor``.

A CUDA graph runs only on a card, so the graph route is forced here with a
stand-in graph (``StaticGraph``: a capture keeps the body and the address
of its static input, each replay checks that address, runs the body again
and writes its output into the one tensor its first replay made, as a
graph's replays do). A store of 240 networks of the 1-10-10-1 trig net,
around the JAX package's init (numpy, from a seed), is read by the port's
``Predictor`` on both routes and by the JAX one; held:

* the graph route bit-equal to the eager route at n = 1 and 2 and two
  batch sizes, interleaved, and within ``tests/test_torch_predictor.py``'s
  tolerance of the JAX ``Predictor``; one warm-up and one capture a key,
  replays after;
* each result of ``predict`` and ``predict_tensor`` unchanged by the calls
  after it (a replay overwrites the graph's output, never a result);
* a 2x2 mesh of CPU entries on the graph route: the unsharded predictions,
  the eager sharded ones bit for bit, a graph an entry replayed in capture
  order, and a new mesh dropping the old one's graphs;
* a failed capture raising, with no graph kept and no eager fallback;
* the route, decided from the configuration alone.

tests/test_torch_cuda.py holds the real graphs against the eager route on
the card.
"""

import jax
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.predictor import Predictor as JPredictor
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten
from tensorbnn_tpu_torch.io import checkpoint as t_ckpt
from tensorbnn_tpu_torch.parallel import graphs
from tensorbnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from tensorbnn_tpu_torch.predictor import Predictor as TPredictor

torch.set_num_threads(1)

# tests/test_torch_predictor.py's tolerance against the JAX Predictor
RTOL, ATOL = 1e-5, 1e-6
N_NETS = 240
ROWS = (24, 37)


class StaticGraph:
    """A stand-in for ``graphs.CudaGraph`` on the CPU, as strict as a graph
    about its buffers (see the module docstring). ``made`` records each
    capture, ``order`` each replay's graph."""

    made, order = [], []

    def __init__(self, fn):
        self.fn, self.owner, self.out = fn, fn.__self__, None
        self.x_ptr = self.owner.x.data_ptr()
        StaticGraph.made.append(self)

    @classmethod
    def segment(cls, fn, device, pool):
        assert pool is None and device == torch.device("cpu")
        return cls(fn)

    @staticmethod
    def warm_up(fn, device):
        fn()

    @staticmethod
    def new_pool():
        return None

    def replay(self):
        assert self.owner.x.data_ptr() == self.x_ptr
        StaticGraph.order.append(self)
        self.fn()
        if self.out is None:
            self.out = self.owner.out
        else:
            self.out.copy_(self.owner.out)
            self.owner.out = self.out

    @classmethod
    def reset(cls):
        cls.made, cls.order = [], []


class FailingGraph(StaticGraph):
    """A stand-in whose capture fails, as a forbidden call under capture
    makes a real one fail."""

    @classmethod
    def segment(cls, fn, device, pool):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def _layers(pkg):
    return [pkg.GaussianDenseLayer(1, 10), pkg.Tanh(),
            pkg.GaussianDenseLayer(10, 10), pkg.Tanh(),
            pkg.GaussianDenseLayer(10, 1)]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """An npz store of ``N_NETS`` networks around the JAX init (sd 0.1)."""
    model = JSequential(_layers(J))
    params, hypers = model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    rng = np.random.default_rng(4)
    theta = (np.asarray(flat.theta)[None] + 0.1 * rng.normal(
        size=(N_NETS, flat.theta.size))).astype(np.float32)
    p_s = jax.tree.map(np.asarray, jax.vmap(flat.unravel_theta)(theta))
    h_s = tuple(jax.tree.map(lambda v: np.broadcast_to(
        np.asarray(v), (N_NETS,) + np.shape(v)).copy(), h) for h in hypers)
    d = str(tmp_path_factory.mktemp("graph_store"))
    t_ckpt.save_samples(d, p_s, h_s, {})
    return d


def _inputs(rows, seed):
    return np.random.default_rng(seed).normal(size=(rows, 1)).astype(
        np.float32)


def _predictors(store, graph_type=StaticGraph, **kw):
    """The port's Predictor on the graph route (``graph_type``) and on the
    eager route, both on the CPU."""
    lik = T.FixedGaussianLikelihood(0.1)
    graphed = TPredictor(store, likelihood=lik, layers=_layers(T),
                         device="cpu", **kw)
    graphed._graph_type = graph_type
    return graphed, TPredictor(store, likelihood=lik, layers=_layers(T),
                               device="cpu", **kw)


@pytest.fixture(autouse=True)
def _fresh_counts():
    graphs.COUNTS.reset()
    StaticGraph.reset()
    yield
    graphs.COUNTS.reset()


def _counts():
    c = graphs.COUNTS
    return c.warmups, c.captures, c.replays


@pytest.mark.parametrize("n", [1, 2])
def test_graph_route_is_eager_bit_for_bit_and_jax_within_tolerance(store, n):
    """Two batch sizes interleaved, three calls each, each with new inputs:
    every result the eager route's bit for bit and the JAX Predictor's
    within ``RTOL``; a key's first call warms up and captures, the later
    ones replay."""
    graphed, eager = _predictors(store)
    jp = JPredictor(store, likelihood=J.FixedGaussianLikelihood(0.1),
                    layers=_layers(J))
    calls = [(rows, seed) for seed in range(3) for rows in ROWS]
    for i, (rows, seed) in enumerate(calls):
        x = _inputs(rows, seed)
        got = graphed.predict(x, n)
        assert got.shape == (N_NETS // n, rows, 1)
        np.testing.assert_array_equal(got, eager.predict(x, n))
        np.testing.assert_allclose(got, jp.predict(x, n), rtol=RTOL,
                                   atol=ATOL)
        keys = min(i + 1, len(ROWS))
        assert _counts() == (keys, keys, i + 1 - keys), (i, _counts())
    assert sorted(graphed._graphs) == [(n, rows, 1) for rows in ROWS]


@pytest.mark.parametrize("method", ["predict", "predict_tensor"])
def test_results_survive_later_calls(store, method):
    """Three calls with other inputs (one key): each earlier result keeps
    its values, and none shares memory with the graph's output."""
    graphed, eager = _predictors(store)
    results, wants = [], []
    for seed in range(3):
        x = _inputs(ROWS[0], seed)
        results.append(getattr(graphed, method)(x))
        wants.append(eager.predict(x))
        for got, want in zip(results, wants):
            np.testing.assert_array_equal(np.asarray(got), want)
    out = graphed._graphs[(1, ROWS[0], 1)].out
    for got in results:
        assert not np.shares_memory(np.asarray(got), out.numpy())
    assert _counts() == (1, 1, 2)


def test_predict_mean_sd_and_quantiles_take_the_graph_route(store):
    """The ensemble statistics read the graph route's predictions: equal to
    the eager route's, one capture for the three calls."""
    graphed, eager = _predictors(store)
    x = _inputs(ROWS[1], 7)
    for got, want in zip(graphed.predict_mean_sd(x, 2),
                         eager.predict_mean_sd(x, 2)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(graphed.predict_quantiles(x, 2),
                                  eager.predict_quantiles(x, 2))
    assert _counts() == (1, 1, 1)


@pytest.mark.parametrize("on", ["constructor", "call"])
def test_mesh_graph_route_replays_each_entry_in_capture_order(store, on):
    """A 2x2 mesh of CPU entries (240 networks over two rows, 37 rows over
    two blocks of 19, the second padded) on the graph route: the
    eager sharded predictions bit for bit, the unsharded ones within 1e-6
    (other batched shapes may sum in another order); a graph an entry,
    captured at its first call, replayed in that order at every later
    call, each a graph of its own."""
    mesh = make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    kw = {"mesh": mesh} if on == "constructor" else {}
    call = {} if on == "constructor" else {"mesh": mesh}
    graphed, eager = _predictors(store, **kw)
    plain = _predictors(store)[1]
    for seed in range(3):
        x = _inputs(ROWS[1], seed)
        got = graphed.predict(x, 1, **call)
        np.testing.assert_array_equal(got, eager.predict(x, 1, **call))
        np.testing.assert_allclose(got, plain.predict(x), rtol=1e-6,
                                   atol=1e-7)
    assert _counts() == (4, 4, 8)
    assert sorted(graphed._mesh_cache[2]) == [
        (1, i, j, 19, 1) for i in range(2) for j in range(2)]
    assert StaticGraph.order == 2 * StaticGraph.made
    assert len(set(map(id, StaticGraph.made))) == 4


def test_a_new_mesh_drops_the_old_meshs_graphs(store):
    """Each mesh's graphs live and die with its blocks of networks: a call
    on a new mesh drops them (and captures its own), a call back on the
    first mesh captures anew; the single-device graphs stay."""
    cpu = [torch.device("cpu")] * 4
    first, second = make_mesh(2, 2, devices=cpu), make_mesh(4, 1,
                                                            devices=cpu)
    graphed, eager = _predictors(store)
    x = _inputs(ROWS[0], 3)
    graphed.predict(x)
    for mesh in (first, first, second, first):
        np.testing.assert_array_equal(graphed.predict(x, mesh=mesh),
                                      eager.predict(x, mesh=mesh))
        assert graphed._mesh_cache[0] is mesh
        assert len(graphed._mesh_cache[2]) == 4
    old = StaticGraph.made[1:5]
    assert all(g.owner not in graphed._mesh_cache[2].values() for g in old)
    # the single-device key, then 4 + 4 + 4 mesh entries, one set reused
    assert _counts() == (13, 13, 4)
    assert list(graphed._graphs) == [(1, ROWS[0], 1)]


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_a_failed_capture_raises_and_keeps_no_graph(store, mesh):
    """A capture that fails raises at every call: no graph is kept and the
    call never carries on eagerly."""
    m = None if mesh is None else make_mesh(
        *mesh, devices=[torch.device("cpu")] * 4)
    graphed, _ = _predictors(store, graph_type=FailingGraph)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            graphed.predict(_inputs(ROWS[0], 0), mesh=m)
    assert not graphed._graphs
    assert m is None or not graphed._mesh_cache[2]
    assert graphs.COUNTS.captures == 0


def test_the_cpu_takes_the_eager_route(store):
    """Without a stand-in the CPU runs eagerly: no warm-up, capture or
    replay; ``_eager`` keeps a stand-in's Predictor eager too."""
    graphed, eager = _predictors(store)
    x = _inputs(ROWS[0], 1)
    np.testing.assert_array_equal(eager.predict(x), graphed.predict(x))
    graphed._eager = True
    graphed.predict(x)
    assert _counts() == (1, 1, 0)
    eager.predict(x, mesh=make_mesh(2, 2, devices=[torch.device("cpu")] * 4))
    assert _counts() == (1, 1, 0) and eager._graph_type_of(None) is None


CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")


@pytest.mark.parametrize("device,mesh,want", [
    (CUDA, None, "graph"),
    (CPU, None, "eager"),
    (CUDA, [[CUDA, torch.device("cuda", 1)]] * 2, "graph"),
    (CUDA, [[CUDA] * 2, [CUDA, CPU]], "eager"),
    (CPU, [[CPU] * 2] * 2, "eager"),
])
def test_predict_route_from_the_configuration(device, mesh, want):
    """The graph route wherever the Predictor's device, or every entry of
    the call's mesh, is a CUDA card (no card is asked anything)."""
    assert graphs.predict_route(
        device, None if mesh is None else Mesh(mesh)) == want
