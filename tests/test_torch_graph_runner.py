"""The graph chunk runner of the torch port (parallel/graphs.py) on the CPU.

A CUDA graph runs only on a card, so these tests drive the runner with a
stand-in graph (``EagerGraph``: capture keeps the body, each replay runs it
again) and hold:

* the runner against the eager runner bit for bit over two chunks whose
  (eps, L) differ, the generator's state included, in the K1 twins'
  shared, per-chain, tempered, U-turn and variant (d) paths (the
  ``classification`` stack's plain hyper block takes one-epoch graphs);
* the body (``StaticChunk``, every chunk argument read from its buffers)
  against the JAX package's epochs fed the JAX package's own draws, with
  the tolerances of the injected-draw tests of test_torch_sampler.py;
* one body run at (eps, L) = A and then, its buffers refilled, at B
  against a fresh body at B (a value baked into the body at its first run
  would show);
* the graph-or-eager decision, from the configuration alone.

The stepped runner (K3 and the plain main block: a head, a step and a
tail graph of the epoch, the step replayed L times) is held the same way
in the ``STEPPED`` cases: shared, per-chain and U-turn per-epoch counts on
K3's twin with K2's coupled block (a learned sd), the Kahan leapfrog with
a step scale and ``data_chunk`` on the plain path, the plain hyper block
(SquarePrelu) behind K3's twin, and a tempered plain-path run; its body
(``SteppedChunk``) against the JAX package's epochs on its plain route;
and one capture set serving chunks of other lengths and counts.

tests/test_torch_cuda.py holds the real graphs against the eager runner on
the card.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorbnn_tpu.parallel.chains import init_multichain_state as j_init
from tensorbnn_tpu.sampler import tempering as j_tempering
from tensorbnn_tpu.sampler.gibbs import make_epoch_fn as j_epoch
from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
from tensorbnn_tpu_torch.parallel import graphs
from tensorbnn_tpu_torch.parallel.chains import make_multichain_chunk_runner
from tensorbnn_tpu_torch.parallel.graphs import GraphChunkRunner, \
    StaticChunk, SteppedChunk, SteppedChunkRunner, chunk_runner_kind, \
    leap_mode, whole_chunk
from tensorbnn_tpu_torch.parallel.mesh import Mesh
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochDraws, \
    EpochTrace, make_epoch_fn as t_epoch
from test_torch_classification import _classification, _data, _flats, \
    _lik, _multiclass
from test_torch_data_chunk import _problem
from test_torch_sampler import _flagship, _jax_draws
from test_torch_tempering import _jax_tempered_draws, _pair

torch.set_num_threads(1)

MU = math.log(100 * 1e-3)


class EagerGraph:
    """A stand-in for ``graphs.CudaGraph`` on the CPU: capture keeps the
    body, each replay runs it again, the warm-up runs it once."""

    def __init__(self, fn, generator, device, pool=None):
        self.fn = fn

    def replay(self):
        self.fn()

    @staticmethod
    def warm_up(fn, device):
        fn()

    @staticmethod
    def new_pool():
        return None


def _case(name, n_data=1):
    """A model, its data and both packages' pieces for one runner path:
    ``a`` and ``b`` are two chunks' (eps, L), the U-turn case's L one
    count an epoch; ``n_data`` the data axis a stepped case's runners are
    built for (``_stepped_case``)."""
    if name in STEPPED:
        return _stepped_case(name, n_data)
    tempering_beta = None
    if name in ("shared", "per_chain"):
        j_model, j_lik, t_model, t_lik, x, y = _flagship()
        c, hyper_steps = 4, 10
    elif name in ("tempered", "uturn"):
        j_model, j_lik, t_model, t_lik = _pair([(1, 6), (6, 1)])
        x = np.linspace(-1, 1, 9).astype(np.float32)[:, None]
        y = np.sin(np.pi * x[:, 0]).astype(np.float32)
        c, hyper_steps = (6, 6) if name == "tempered" else (8, 10)
        if name == "tempered":
            tempering_beta = (3, np.repeat(j_tempering.make_ladder(3, 0.3),
                                           2))
    elif name == "classification":
        (j_model, t_model), (j_lik, t_lik) = _classification(4, 6), _lik(
            "BernoulliLikelihood")
        x, y = _data(j_lik, 16, 4, seed=2)
        c, hyper_steps = 4, 10
    else:
        (j_model, t_model), (j_lik, t_lik) = _multiclass(), _lik(
            "CategoricalLikelihood")
        x, y = _data(j_lik, 16, 2, seed=3, n_classes=3)
        c, hyper_steps = 4, 5
    args = {"shared": ((3e-3, 8), (2e-3, 5)),
            "per_chain": ((np.asarray([2e-3, 2e-3, 4e-3, 4e-3], np.float32),
                           np.asarray([8, 8, 5, 5])),
                          (np.asarray([3e-3, 3e-3, 1e-3, 1e-3], np.float32),
                           np.asarray([4, 4, 9, 9]))),
            "tempered": ((np.repeat(np.asarray([5e-3, 1e-2, 2e-2],
                                               np.float32), 2),
                          np.repeat([9, 6, 4], 2)),
                         (np.repeat(np.asarray([4e-3, 8e-3, 1e-2],
                                               np.float32), 2),
                          np.repeat([7, 8, 5], 2))),
            "uturn": ((5e-3, np.asarray([60, 40, 60])),
                      (4e-3, np.asarray([30, 60, 50]))),
            "classification": ((2e-2, 8), (1e-2, 10)),
            "multiclass": ((1e-2, 10), (5e-3, 6))}[name]
    params, hypers, j_flat, t_flat = _flats(j_model, j_lik)
    h = j_flat.eta.size
    uturn = name == "uturn"
    kw = dict(adjust_hypers=True, hyper_leapfrog=hyper_steps, burnin=100.0,
              mu=MU, eta_dim=h, tempering_beta=tempering_beta,
              record_uturn=uturn)
    xt, yt = torch.tensor(x), torch.tensor(y)
    traj = fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt, h,
        tempered=tempering_beta is not None, record_uturn=uturn)
    hyper = fused_hyper.try_build_fused_hyper_trajectory(
        t_model, t_lik, t_flat.unravel_eta, h, hyper_steps)
    assert traj is not None
    assert (hyper is None) == (name == "classification")
    epoch_fn = t_epoch(t_model, t_lik, xt, yt, t_flat.unravel_theta,
                       t_flat.unravel_eta, batched_main_traj=traj,
                       batched_hyper_traj=hyper, **kw)
    j_carry = j_init(j_flat.theta, j_flat.eta, jax.random.key(1), 1e-3, c,
                     jitter=0.05 if name != "tempered" else 0.3)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))

    def eager_runner(mesh=None):
        return make_multichain_chunk_runner(
            t_model, t_lik, xt, yt, t_flat.unravel_theta,
            t_flat.unravel_eta, adjust_hypers=True,
            hyper_leapfrog=hyper_steps, burnin=100.0,
            hyper_step_size_init=1e-3, eta_dim=h, batched_main_traj=traj,
            batched_hyper_traj=hyper, tempering_beta=tempering_beta,
            record_uturn=uturn, per_epoch_leapfrog=uturn, mesh=mesh)

    def graph_runner():
        return GraphChunkRunner([epoch_fn], [xt.device], h=h,
                                tempered=tempering_beta is not None,
                                per_epoch_leapfrog=uturn,
                                whole=whole_chunk(True, hyper),
                                graph_type=EagerGraph)

    return SimpleNamespace(
        name=name, j_model=j_model, j_lik=j_lik, x=x, y=y, j_flat=j_flat,
        kw=kw, j_kw=kw, epoch_fn=epoch_fn, j_carry=j_carry, t_carry=t_carry,
        a=args[0], b=args[1], h=h, tempered=tempering_beta is not None,
        uturn=uturn, eager_runner=eager_runner, graph_runner=graph_runner,
        hyper=hyper, kind="graph", scale=None)


#: the stepped runner's cases (K3's twin or the plain main block)
STEPPED = ["k3_shared", "k3_per_chain", "k3_uturn", "compensated",
           "plain_hyper", "tempered_plain"]


def _stepped_case(name, n_data=1):
    """``_case``'s pieces where K3 (its CPU twin) or the plain path runs
    the main block: the ``k3_*`` cases a 4-16-16-1 learned-sd model over
    600 rows (past K1's shared memory) with K2's coupled block;
    ``compensated`` the plain path with ``data_chunk=8``, the Kahan
    leapfrog and a step scale; ``plain_hyper`` the ``classification``
    stack on K3's twin and the plain hyper block; ``tempered_plain`` a
    tempered run (the plain main block, K2). For a data axis ``n_data``
    above 1, K3 is built for a peer's rows, ``compensated`` takes two row
    chunks a peer and ``tempered_plain`` 12 rows (its 9 divide no data
    axis)."""
    tempering_beta, scale, extra, vg = None, None, {}, True
    if name.startswith("k3"):
        j_model, j_lik, t_model, t_lik = _pair(
            [(4, 16), (16, 16), (16, 1)], ("GaussianLikelihood", 0.3))
        rng = np.random.default_rng(2)
        x = rng.normal(size=(600, 4)).astype(np.float32)
        y = rng.normal(size=(600,)).astype(np.float32)
        c, hyper_steps = 4, 10
    elif name == "compensated":
        j_model, t_model, j_lik, t_lik, _, _, x, y = _problem("gaussian")
        c, hyper_steps, vg = 4, 5, False
        extra = dict(data_chunk=8 if n_data == 1 else len(x) // n_data // 2,
                     compensated=True)
    elif name == "plain_hyper":
        (j_model, t_model), (j_lik, t_lik) = _classification(4, 6), _lik(
            "BernoulliLikelihood")
        x, y = _data(j_lik, 16, 4, seed=2)
        c, hyper_steps = 4, 10
    else:
        j_model, j_lik, t_model, t_lik = _pair([(1, 6), (6, 1)])
        x = np.linspace(-1, 1, 9 if n_data == 1 else 12).astype(
            np.float32)[:, None]
        y = np.sin(np.pi * x[:, 0]).astype(np.float32)
        c, hyper_steps, vg = 6, 6, False
        tempering_beta = (3, np.repeat(j_tempering.make_ladder(3, 0.3), 2))
    args = {"k3_shared": ((3e-3, 6), (2e-3, 8)),
            "k3_per_chain": (
                (np.asarray([3e-3, 3e-3, 2e-3, 2e-3], np.float32),
                 np.asarray([6, 6, 4, 4])),
                (np.asarray([2e-3, 2e-3, 1e-3, 1e-3], np.float32),
                 np.asarray([3, 3, 7, 7]))),
            "k3_uturn": ((3e-3, np.asarray([6, 4, 8])),
                         (2e-3, np.asarray([5, 9, 3]))),
            "compensated": ((2e-2, 6), (1e-2, 4)),
            "plain_hyper": ((2e-2, 8), (1e-2, 10)),
            "tempered_plain": ((np.repeat(np.asarray([5e-3, 1e-2, 2e-2],
                                                     np.float32), 2),
                                np.repeat([9, 6, 4], 2)),
                               (np.repeat(np.asarray([4e-3, 8e-3, 1e-2],
                                                     np.float32), 2),
                                np.repeat([7, 8, 5], 2)))}[name]
    params, hypers, j_flat, t_flat = _flats(j_model, j_lik)
    d, h = j_flat.theta.size, j_flat.eta.size
    uturn = name == "k3_uturn"
    kw = dict(adjust_hypers=True, hyper_leapfrog=hyper_steps, burnin=100.0,
              mu=MU, eta_dim=h, tempering_beta=tempering_beta,
              record_uturn=uturn, **extra)
    j_kw = dict(kw)
    if name == "compensated":
        scale = np.random.default_rng(3).uniform(0.5, 1.5, d).astype(
            np.float32)
        j_kw["step_scale"] = jnp.asarray(scale)
    xt, yt = torch.tensor(x), torch.tensor(y)
    main_vg = None
    if vg:
        main_vg = fused_mlp.try_build_fused_main_vg(
            t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt,
            yt, h, n_rows=len(x) // n_data)
        assert main_vg is not None
    hyper = fused_hyper.try_build_fused_hyper_trajectory(
        t_model, t_lik, t_flat.unravel_eta, h, hyper_steps)
    assert (hyper is None) == (name == "plain_hyper")
    epoch_fn = t_epoch(t_model, t_lik, xt, yt, t_flat.unravel_theta,
                       t_flat.unravel_eta, batched_main_vg=main_vg,
                       batched_hyper_traj=hyper, **kw)
    assert epoch_fn.parts is not None
    j_carry = j_init(j_flat.theta, j_flat.eta, jax.random.key(1), 1e-3, c,
                     jitter=0.05 if tempering_beta is None else 0.3)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))

    def eager_runner(mesh=None):
        return make_multichain_chunk_runner(
            t_model, t_lik, xt, yt, t_flat.unravel_theta,
            t_flat.unravel_eta, adjust_hypers=True,
            hyper_leapfrog=hyper_steps, burnin=100.0,
            hyper_step_size_init=1e-3, eta_dim=h, batched_main_vg=main_vg,
            batched_hyper_traj=hyper, tempering_beta=tempering_beta,
            record_uturn=uturn, per_epoch_leapfrog=uturn, mesh=mesh,
            **extra)

    def graph_runner():
        return SteppedChunkRunner([epoch_fn], [xt.device], h=h,
                                  tempered=tempering_beta is not None,
                                  per_epoch_leapfrog=uturn, n_chains=c,
                                  graph_type=EagerGraph)

    return SimpleNamespace(
        name=name, j_model=j_model, j_lik=j_lik, x=x, y=y, j_flat=j_flat,
        kw=kw, j_kw=j_kw, epoch_fn=epoch_fn, j_carry=j_carry,
        t_carry=t_carry, a=args[0], b=args[1], h=h,
        tempered=tempering_beta is not None, uturn=uturn,
        eager_runner=eager_runner, graph_runner=graph_runner, hyper=hyper,
        kind="stepped", scale=None if scale is None else torch.tensor(scale))


def _steps(case, leap, n):
    """The leapfrog steps each of ``n`` epochs of a chunk runs at
    ``leap``: a U-turn run's counts, else the largest count."""
    if case.uturn:
        return [int(v) for v in np.asarray(leap)[:n]]
    return [int(np.max(leap))] * n


def _equal(got, want, what):
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), (what, field)
        if g is not None:
            assert torch.equal(g, w), (what, field)


CASES = ["shared", "per_chain", "tempered", "uturn", "classification",
         "multiclass"]


@pytest.mark.parametrize("name", CASES + STEPPED)
def test_graph_runner_matches_eager_runner(name):
    """Two chunks through the graph runner (one capture, replayed; the
    stepped runner's three, the step replayed L times an epoch) and
    through the eager runner from one carry and one generator seed: carry,
    traces and the generator's state bit-equal after each. The second
    chunk's (eps, L) differ from the first's, and (classification's
    one-epoch graphs, the stepped runner) so does its length."""
    case = _case(name)
    graphs.COUNTS.reset()
    eager, graph = case.eager_runner(), case.graph_runner()
    assert eager.runner == "eager" and graph.runner == case.kind
    ge, gg = (torch.Generator().manual_seed(5) for _ in range(2))
    ce = cg = case.t_carry
    stepped = case.kind == "stepped"
    lengths = (3, 2) if name == "classification" or stepped else (3, 3)
    replays = 0
    for (eps, leap), n in zip((case.a, case.b), lengths):
        leap = leap[:n] if case.uturn else leap
        ce, te = eager(ce, eps, leap, n, ge, step_scale=case.scale)
        cg, tg = graph(cg, eps, leap, n, gg, step_scale=case.scale)
        _equal(cg, ce, "carry")
        _equal(tg, te, "trace")
        assert torch.equal(gg.get_state(), ge.get_state())
        replays += sum(2 + s for s in _steps(case, leap, n))
    counts = graphs.COUNTS.as_dict()
    if stepped:
        assert (counts["captures"], counts["warmups"]) == (3, 1), counts
        assert counts["replays"] == replays, counts
    else:
        whole = name != "classification"
        assert graph.whole == whole
        assert (counts["captures"], counts["warmups"]) == (1, 1), counts
        assert counts["replays"] == (2 if whole else sum(lengths)), counts
    if case.tempered:
        assert tg.swap_accept is not None
    if case.uturn:
        assert tg.uturn.dtype == torch.int32


def body_against_jax(case, epoch_fn, monkeypatch, shard=(0, 1),
                     peers=None):
    """Two epochs of a body (``StaticChunk`` of ``epoch_fn``, running
    chain shard ``shard = (i, k)``: block i of the case's chains) against
    two of the JAX package's ``make_epoch_fn`` (its XLA path) on the same
    chains from one state, fed the JAX package's own draws for them. A
    shard's body draws the fleet's epoch and keeps its rows: the other
    shards' rows are NaN here, so a body that took them fails. With
    ``peers`` (the shard's ``DataPeers``, which ``epoch_fn`` sums over) a
    stepped body's parts run as ``SegmentedPart``s of the stand-in graph,
    split at their sums, against the JAX epochs on the whole rows.
    Tolerances of test_torch_sampler.py::test_three_epochs_match_jax_with_
    injected_draws; U-turn steps and swap decisions equal."""
    i, k = shard
    c = case.t_carry.theta.shape[0] // k
    rows = slice(i * c, (i + 1) * c)
    j_fn = jax.jit(j_epoch(case.j_model, case.j_lik, jnp.asarray(case.x),
                           jnp.asarray(case.y), case.j_flat.unravel_theta,
                           case.j_flat.unravel_eta, **case.j_kw))
    eps, leap = case.a
    eps = eps[rows] if np.ndim(eps) else eps
    leap = leap[rows] if np.ndim(leap) and not case.uturn else leap
    n = 2
    leaps = leap[:n] if case.uturn else leap
    mode = leap_mode(leaps, case.uturn)
    block = ChainState(*(f[rows] for f in case.t_carry))
    if case.kind == "stepped":
        chunk = SteppedChunk(epoch_fn, block, mode, case.h, case.tempered,
                             case.scale, shard=shard)
    else:
        chunk = StaticChunk(epoch_fn, block, n, mode, case.h, case.tempered,
                            shard=shard)
    chunk.fill(block, eps, leaps if case.kind == "graph" or not case.uturn
               else leaps[:1], case.scale)
    j_carry = jax.tree.map(lambda f: f[rows], case.j_carry)
    draws, j_traces = [], []
    d = case.j_flat.theta.size
    for j in range(n):
        draw = _jax_tempered_draws if case.tempered else _jax_draws
        own = draw(j_carry.key, d, case.h)
        fleet = [None if f is None else torch.full(
            (c * k,) + f.shape[1:], float("nan")) for f in own]
        for dst, src in zip(fleet, own):
            if dst is not None:
                dst[rows] = src
        draws.append(EpochDraws(*fleet))
        l_j = leap[j] if case.uturn else leap
        j_carry, j_tr = j_fn(j_carry, jnp.asarray(eps, jnp.float32),
                             jnp.asarray(l_j, jnp.int32))
        j_traces.append(j_tr)
    monkeypatch.setattr(graphs, "draw_epoch", lambda *a: draws.pop(0))
    if case.kind == "stepped":
        head, step, tail = (lambda: chunk.head(None)), chunk.step, chunk.tail
        if peers is not None:
            head, step, tail = (graphs.SegmentedPart(
                body, None, peers, EagerGraph, lambda d: None).replay
                for body in (head, step, tail))
        trace = None
        for j, steps in enumerate(_steps(case, leaps, n)):
            head()
            for _ in range(steps):
                step()
            if not steps:
                chunk.skip()
            tail()
            trace = graphs._row(trace, chunk.trace, j, n)
        t_carry, t_trace = chunk.result(leaps, chunk.unpack(trace))
    else:
        chunk.run(None)
        t_carry, t_trace = chunk.result(leaps)
    assert not draws
    for field, rtol, atol in (("theta", 1e-3, 1e-4), ("eta", 1e-3, 1e-4),
                              ("hyper_step", 1e-4, 0.0),
                              ("log_eps_bar", 1e-4, 1e-5), ("h", 1e-4, 1e-5)):
        np.testing.assert_allclose(getattr(t_carry, field).numpy(),
                                   np.asarray(getattr(j_carry, field)),
                                   rtol=rtol, atol=atol, err_msg=field)
    for j, j_tr in enumerate(j_traces):
        for field in ("main_accept", "hyper_accept", "sjd"):
            np.testing.assert_allclose(
                getattr(t_trace, field)[j].numpy(),
                np.asarray(getattr(j_tr, field)), rtol=1e-3, atol=1e-3,
                err_msg=f"{field} epoch {j}")
        np.testing.assert_allclose(t_trace.theta[j].numpy(),
                                   np.asarray(j_tr.theta), rtol=1e-3,
                                   atol=1e-4)
        if case.tempered:
            np.testing.assert_array_equal(t_trace.swap_accept[j].numpy(),
                                          np.asarray(j_tr.swap_accept))
        if case.uturn:
            np.testing.assert_array_equal(t_trace.uturn[j].numpy(),
                                          np.asarray(j_tr.uturn))


@pytest.mark.parametrize("name", CASES + STEPPED)
def test_static_chunk_matches_jax(name, monkeypatch):
    """Two epochs of the body (K1's twin, K2's or the plain hyper block;
    the stepped runner's ``SteppedChunk`` on K3's twin or the plain main
    block) against two of the JAX package's ``make_epoch_fn`` (its plain
    route) from one state, fed the JAX package's own draws
    (``body_against_jax``; states to rtol 1e-3 / atol 1e-4, acceptance
    and SJD to 1e-3)."""
    case = _case(name)
    body_against_jax(case, case.epoch_fn, monkeypatch)


@pytest.mark.parametrize("name", ["shared", "per_chain", "uturn"])
def test_body_refilled_matches_a_fresh_body(name):
    """One body run at (eps, L) = A, then refilled and run at B, equals a
    fresh body run at B from the same carry and generator state; and B's
    run differs from A's (the arguments reach the body)."""
    case = _case(name)
    n = 2

    def args(pair):
        eps, leap = pair
        return eps, (leap[:n] if case.uturn else leap)

    mode = leap_mode(args(case.a)[1], case.uturn)
    body = StaticChunk(case.epoch_fn, case.t_carry, n, mode, case.h,
                       case.tempered)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    body.fill(case.t_carry, *args(case.a))
    body.run(gen)
    at_a = body.result(args(case.a)[1])
    gen.set_state(state)
    body.fill(case.t_carry, *args(case.b))
    body.run(gen)
    got = body.result(args(case.b)[1])
    fresh = StaticChunk(case.epoch_fn, case.t_carry, n, mode, case.h,
                        case.tempered)
    gen.set_state(state)
    fresh.fill(case.t_carry, *args(case.b))
    fresh.run(gen)
    want = fresh.result(args(case.b)[1])
    _equal(got[0], want[0], "carry")
    _equal(got[1], want[1], "trace")
    assert not torch.equal(at_a[0].theta, got[0].theta)


#: the card's memory in the routing table, and the workspaces its K3 rows
#: give the gate: "K3" fits twice, "K3 wide" does not
CARD_BYTES = 80 << 30
WORKSPACE = {"K1": 0, "plain": 0, "K3": 1 << 30, "K3 wide": 41 << 30}


@pytest.mark.parametrize("path,mesh,device,want", [
    ("K1", None, "cuda", "graph"),
    ("K1", (1, 1), "cuda", "graph"),
    ("K1", None, "cuda:0", "graph"),
    ("K3", None, "cuda", "stepped"),
    ("plain", None, "cuda", "stepped"),
    ("K1", (2, 1), "cuda", "graph"),
    ("K1", (4, 1), "cuda", "graph"),
    ("K1", (1, 2), "cuda", "eager"),
    ("K1", (2, 2), "cuda", "eager"),
    ("K3", (2, 1), "cuda", "stepped"),
    ("plain", (4, 1), "cuda", "stepped"),
    ("K3", (1, 2), "cuda", "stepped"),
    ("plain", (2, 2), "cuda", "stepped"),
    ("K3 wide", None, "cuda", "eager"),
    ("K3 wide", (2, 1), "cuda", "eager"),
    ("K3 wide", (1, 2), "cuda", "eager"),
    ("plain", (1, 4), "cpu", "eager"),
    ("K1", (2, 1), "cpu", "eager"),
    ("K1", None, "cpu", "eager"),
    ("K1", (1, 1), "cpu", "eager"),
    ("K3", None, "cpu", "eager"),
    ("plain", (2, 1), "cpu", "eager"),
])
def test_graph_or_eager_follows_the_configuration(path, mesh, device, want,
                                                  monkeypatch):
    """A graph of the chunk where K1 runs the main block on CUDA chains
    without a mesh or on a mesh whose data axis is 1 (here a card
    repeated); the stepped runner where K3 or the plain path runs it,
    over any mesh of CUDA cards, data axes above 1 included, and K3's
    workspace fits the card twice (``stepped_fits``); K1 over a data axis
    above 1, a workspace that does not fit and the CPU run eagerly. The
    decision reads the configuration only (no card is needed to make
    it)."""
    monkeypatch.setattr(graphs, "card_memory", lambda i: CARD_BYTES)
    m = None if mesh is None else Mesh(
        [[torch.device(device)] * mesh[1]] * mesh[0])
    assert chunk_runner_kind(object() if path == "K1" else None, m,
                             torch.device(device), WORKSPACE[path]) == want


def test_stepped_gate_decides_from_the_workspace(monkeypatch):
    """The gate passes a workspace that fits the card twice, to the byte,
    and the plain path (no workspace) whatever the card; the factory
    reads K3's workspace at its fleet's chains a shard."""
    monkeypatch.setattr(graphs, "card_memory", lambda i: 1000)
    assert graphs.stepped_fits(500, {0}) and graphs.stepped_fits(0, {0})
    assert not graphs.stepped_fits(501, {0})
    j_model, j_lik, t_model, t_lik = _pair([(4, 16), (16, 16), (16, 1)],
                                           ("GaussianLikelihood", 0.3))
    t_flat = _flats(j_model, j_lik)[3]
    x = torch.zeros(600, 4)
    vg = fused_mlp.try_build_fused_main_vg(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, x,
        x[:, 0], t_flat.eta.numel())
    # every layer's output plane and two gradient planes, at least
    assert vg.workspace_bytes(8) >= 4 * 8 * 600 * (16 + 16 + 1 + 2 * 16)
    assert vg.workspace_bytes(16) > vg.workspace_bytes(8)


def test_stepped_key_holds_neither_l_nor_the_chunk_length():
    """One capture set (head, step, tail) serves chunks of 10 and 3 epochs
    at L = 20 and 25, bit-equal to the eager runner: neither the count
    nor the chunk's length is part of a key."""
    case = _case("compensated")
    graphs.COUNTS.reset()
    eager, graph = case.eager_runner(), case.graph_runner()
    ge, gg = (torch.Generator().manual_seed(6) for _ in range(2))
    ce = cg = case.t_carry
    for eps, leap, n in ((1e-2, 20, 10), (5e-3, 25, 3)):
        ce, te = eager(ce, eps, leap, n, ge, step_scale=case.scale)
        cg, tg = graph(cg, eps, leap, n, gg, step_scale=case.scale)
        _equal(cg, ce, "carry")
        _equal(tg, te, "trace")
    assert len(graph.graphs) == 1
    counts = graphs.COUNTS.as_dict()
    assert (counts["captures"], counts["warmups"]) == (3, 1), counts
    assert counts["replays"] == 10 * 22 + 3 * 27, counts


@pytest.mark.parametrize("name", ["compensated", "k3_per_chain"])
def test_stepped_epochs_of_no_step_match_eager(name):
    """Epochs whose count is 0 (no step replayed: the tail reads the
    head's evaluation), first in a run and after epochs with steps,
    bit-equal to the eager runner (a shared count of 0 makes the SJD
    0 / 0: NaN bits compared as bits)."""

    def bits(nt):
        return type(nt)(*(f.view(torch.int32) if f is not None
                          and f.dtype == torch.float32 else f for f in nt))

    case = _case(name)
    eager, graph = case.eager_runner(), case.graph_runner()
    ge, gg = (torch.Generator().manual_seed(7) for _ in range(2))
    ce = cg = case.t_carry
    c = ce.theta.shape[0]
    per_chain = name == "k3_per_chain"
    for leap, n in ((0, 2), (3, 2), (0, 1)):
        if per_chain:
            leap = np.full(c, leap)
            leap[0] = 0
        ce, te = eager(ce, 1e-2, leap, n, ge, step_scale=case.scale)
        cg, tg = graph(cg, 1e-2, leap, n, gg, step_scale=case.scale)
        _equal(cg, ce, "carry")
        _equal(bits(tg), bits(te), "trace")


def test_whole_chunk_unless_the_hyper_block_is_plain():
    """A graph holds the whole chunk unless the hyper block runs the plain
    potential (it runs, without K2); and the counts' forms."""
    assert whole_chunk(True, object()) and whole_chunk(False, None)
    assert not whole_chunk(True, None)
    assert leap_mode(8, False) == "shared"
    assert leap_mode(np.asarray([8, 5]), False) == "per_chain"
    assert leap_mode(np.asarray([8, 5]), True) == "per_epoch"


def test_cpu_runs_stay_eager():
    """On the CPU the factory builds the eager loop even for K1, and a
    run through ``Network.train`` reports it."""
    case = _case("shared")
    assert case.eager_runner().runner == "eager"
    import tensorbnn_tpu_torch as T
    x = np.linspace(-2, 2, 11).astype(np.float32)
    y = np.sin(x)
    net = T.Network(torch.float32, 1, x, y, x, y, device="cpu")
    net.add(T.GaussianDenseLayer(1, 6)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(6, 1))
    net.setup_mcmc(burnin=0, leapfrog_start=5, leapfrog_min=5,
                   leapfrog_max=5, hyper_leapfrog=5)
    res = net.train(2, 1, T.FixedGaussianLikelihood(sd=0.1), n_chains=2,
                    verbose=False)
    assert res.main_path == "K1" and res.chunk_runner == "eager"


def test_graph_runner_refuses_a_missing_generator():
    """The graph runner registers the run's generator with its graphs: it
    needs one."""
    case = _case("shared")
    with pytest.raises(ValueError, match="torch.Generator"):
        case.graph_runner()(case.t_carry, *case.a, 2, None)


def test_trace_is_a_copy():
    """The traces and the carry the runner hands out are copies: the next
    replay does not overwrite them."""
    case = _case("shared")
    graph = case.graph_runner()
    gen = torch.Generator().manual_seed(5)
    carry, trace = graph(case.t_carry, *case.a, 2, gen)
    kept = EpochTrace(*(None if f is None else f.clone() for f in trace))
    kept_theta = carry.theta.clone()
    graph(carry, *case.a, 2, gen)
    _equal(trace, kept, "trace")
    assert torch.equal(carry.theta, kept_theta)
