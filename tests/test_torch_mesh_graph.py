"""The graph chunk runners over ``(chains, data)`` meshes
(parallel/graphs.py: a graph a chain shard on its home card; the stepped
runner's parts, split at their sums over the data peers where the data
axis is above 1) on the CPU.

A CUDA graph runs only on a card, so these tests build the mesh graph
runner through ``make_multichain_chunk_runner`` with the decision forced
and the stand-in graph of tests/test_torch_graph_runner.py
(``EagerGraph``), on meshes of repeated CPU entries, and hold:

* the mesh graph runner against the eager mesh runner on the same mesh,
  bit for bit over two chunks whose (eps, L) differ, every shard's
  generator state included, in the shared, per-chain, U-turn and
  one-epoch (``classification``) modes and ``multiclass``, on 2x1 and 4x1;
  and the stepped runner (three graphs a shard) where K3's twin runs the
  main block with per-chain counts and with the plain hyper block;
* each shard's body (``StaticChunk`` of the shard's epoch function)
  against the JAX package's ``make_epoch_fn`` on that shard's chains, fed
  the JAX package's own draws (``body_against_jax``);
* the stepped runner over data meshes (1x2, 2x2, 1x4) against the eager
  mesh runner, bit for bit over two chunks whose (eps, L) differ, every
  generator's state included, where K3's twin runs the main block with
  per-chain counts and with the plain hyper block, on a tempered plain
  run and on the Kahan leapfrog with ``data_chunk``; its captures,
  replays and copies as each part's sums give them; one data shard's
  body, its parts split at their sums, against the JAX package's epochs
  on the whole rows;
* the graph-or-eager decision over distinct cards (alike or not) and for
  tempered runs;
* a run stopped and resumed under a 2x1 mesh on the graph runner, and
  under a 1x2 data mesh on the stepped runner, bit-equal to the
  uninterrupted one and to the eager mesh run.

tests/test_torch_cuda.py holds the real graphs against the eager mesh
runner on the card.
"""

import functools

import numpy as np
import pytest
import torch

from tensorbnn_tpu_torch.parallel import chains, graphs
from tensorbnn_tpu_torch.parallel.graphs import GraphChunkRunner, \
    SteppedChunkRunner, chunk_runner_kind
from tensorbnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from test_torch_graph_runner import CARD_BYTES, WORKSPACE, EagerGraph, \
    _case, _equal, _steps, body_against_jax
from test_torch_mesh import _net

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _graphs_on_the_cpu(monkeypatch):
    """Makes the factory take the graph runners on the CPU (K1's, else the
    stepped one), with the stand-in graph."""
    monkeypatch.setattr(chains, "chunk_runner_kind", lambda traj, *a: (
        "graph" if traj is not None else "stepped"))
    monkeypatch.setattr(chains, "GraphChunkRunner", functools.partial(
        GraphChunkRunner, graph_type=EagerGraph))
    monkeypatch.setattr(chains, "SteppedChunkRunner", functools.partial(
        SteppedChunkRunner, graph_type=EagerGraph))


def _runners(case, shape, monkeypatch):
    """The eager and the graph runner of ``case`` on a mesh of ``shape``
    whose entries are all the CPU (the case built for its data axis)."""
    mesh = make_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))
    eager = case.eager_runner(mesh)
    _graphs_on_the_cpu(monkeypatch)
    return eager, case.eager_runner(mesh)


MODES = ["shared", "per_chain", "uturn", "classification", "multiclass",
         "k3_per_chain", "plain_hyper"]


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)])
@pytest.mark.parametrize("name", MODES)
def test_mesh_graph_runner_matches_eager_mesh_runner(name, shape,
                                                     monkeypatch):
    """Two chunks through the mesh graph runner (a capture a shard,
    replayed; the stepped runner's three a shard, each shard's step
    replayed to its own largest count) and the eager mesh runner from one
    carry and one generator seed: carry, traces, the run generator's state
    and every shard generator's bit-equal after each chunk."""
    case = _case(name)
    graphs.COUNTS.reset()
    eager, graph = _runners(case, shape, monkeypatch)
    k = shape[0]
    assert eager.runner == "eager" and graph.runner == case.kind
    assert len(graph.homes) == len(graph.epoch_fns) == k
    ge, gg = (torch.Generator().manual_seed(5) for _ in range(2))
    ce = cg = case.t_carry
    stepped = case.kind == "stepped"
    lengths = (3, 2) if name == "classification" or stepped else (3, 3)
    replays = 0
    for (eps, leap), n in zip((case.a, case.b), lengths):
        ce, te = eager(ce, eps, leap, n, ge)
        cg, tg = graph(cg, eps, leap, n, gg)
        _equal(cg, ce, "carry")
        _equal(tg, te, "trace")
        assert graph.generators[0] is gg
        for g in graph.generators:
            assert torch.equal(g.get_state(), ge.get_state())
        if stepped:
            blocks = (np.split(np.asarray(leap), k) if np.ndim(leap)
                      else [leap] * k)
            replays += sum(sum(2 + s for s in _steps(case, b, n))
                           for b in blocks)
    counts = graphs.COUNTS.as_dict()
    if stepped:
        assert (counts["captures"], counts["warmups"]) == (3 * k, k), counts
        assert counts["replays"] == replays, counts
    else:
        assert (counts["captures"], counts["warmups"]) == (k, k), counts
        replays = 2 if graph.whole else sum(lengths)
        assert counts["replays"] == k * replays, counts
    assert tg.theta.shape == (lengths[1],) + tuple(case.t_carry.theta.shape)


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("name", MODES)
def test_shard_body_matches_jax(name, shard, monkeypatch):
    """Each shard's body of the 2x1 mesh graph runner against the JAX
    package's epochs on that shard's chains, fed the JAX package's own
    draws."""
    case = _case(name)
    _, graph = _runners(case, (2, 1), monkeypatch)
    body_against_jax(case, graph.epoch_fns[shard], monkeypatch,
                     shard=(shard, 2))


@pytest.mark.parametrize("kinds,want", [
    ((("H100", 132),) * 4, True),
    ((("H100", 132),) * 3 + (("H100", 114),), False),
    ((("H100", 132), ("A100", 108)), False),
])
def test_distinct_cards_take_graphs_if_alike(kinds, want, monkeypatch):
    """On distinct cards the graph runners apply only where every card of
    the mesh is of one kind (name and multiprocessor count, which set the
    draws' bits), its data peers' cards included: a data axis above 1
    takes the stepped runner where K3 or the plain path runs the main
    block (K1, which a data mesh never builds, stays eager)."""
    monkeypatch.setattr(graphs, "card_kind", lambda i: kinds[i])
    cards = [torch.device("cuda", i) for i in range(len(kinds))]
    for traj, kind in ((object(), "graph"), (None, "stepped")):
        assert chunk_runner_kind(traj, Mesh([[d] for d in cards]),
                                 cards[0]) == (kind if want else "eager")
        if len(cards) % 2 == 0:
            data = Mesh([cards[j:j + 2] for j in range(0, len(cards), 2)])
            assert chunk_runner_kind(traj, data, cards[0]) == (
                "stepped" if want and traj is None else "eager")
            # the homes alike, a data peer of another kind: eager
            monkeypatch.setattr(graphs, "card_kind", lambda i: (
                ("A100", 108) if i == 1 else ("H100", 132)))
            assert chunk_runner_kind(traj, data, cards[0]) == "eager"
            monkeypatch.setattr(graphs, "card_kind", lambda i: kinds[i])


def test_tempered_mesh_runs_stay_eager(monkeypatch):
    """A tempered run needs a chains axis of 1: the factory refuses a 2x1
    mesh before it builds anything. The 1 x n meshes it takes have a data
    axis above 1, which now takes the stepped runner on CUDA cards of one
    kind that pass the workspace gate (the tempered main block is the
    plain one); they stay eager on the CPU, on cards of two kinds and on
    a failed gate (K1, which no data mesh builds, too)."""
    case = _case("tempered")
    with pytest.raises(ValueError, match="chains axis to be 1"):
        case.eager_runner(make_mesh(2, 1, devices=[CPU] * 2))
    monkeypatch.setattr(graphs, "card_memory", lambda i: CARD_BYTES)
    cuda = torch.device("cuda", 0)
    assert chunk_runner_kind(object(), Mesh([[cuda, cuda]]), cuda) == "eager"
    for n in (2, 4):
        assert chunk_runner_kind(None, Mesh([[cuda] * n]), cuda) == "stepped"
        assert chunk_runner_kind(None, Mesh([[CPU] * n]), CPU) == "eager"
        assert chunk_runner_kind(None, Mesh([[cuda] * n]), cuda,
                                 WORKSPACE["K3 wide"]) == "eager"
    monkeypatch.setattr(graphs, "card_kind", lambda i: (("H100", 132),
                                                        ("A100", 108))[i])
    two = Mesh([[cuda, torch.device("cuda", 1)]])
    assert chunk_runner_kind(None, two, cuda) == "eager"


#: the data-mesh cases of the stepped runner, and the sums over the data
#: peers each epoch's tail reaches (the head and each step reach one: the
#: main block's evaluation): the stats' (R, K) of a coupled K2 block, the
#: tempered swap's log-likelihood; the plain hyper block of an uncoupled
#: likelihood sums nothing
DATA_MODES = {"k3_per_chain": 1, "plain_hyper": 0, "tempered_plain": 1,
              "compensated": 1}


def _part_counts(k, n_data, tail_sums, steps_per_shard):
    """The stepped runner's captures, and the replays and copies of a
    chunk, over ``k`` chain shards of ``n_data`` peers: a part is one
    capture and replay, and each of its sums one more home segment, a
    peer's graph each and ``2 (n_data - 1)`` copies; ``steps_per_shard``
    each shard's steps an epoch."""
    per = n_data + 1
    sums = 2 + tail_sums
    captures = k * (3 + sums * per)
    replays = copies = 0
    for steps in steps_per_shard:
        for s in steps:
            replays += (1 + per) + s * (1 + per) + (1 + tail_sums * per)
            copies += 2 * (n_data - 1) * (1 + s + tail_sums)
    return captures, replays, copies


@pytest.mark.parametrize("name,shape", [
    (name, shape) for name in DATA_MODES
    for shape in ((1, 2), (2, 2), (1, 4))
    # tempering needs a chains axis of 1
    if name != "tempered_plain" or shape[0] == 1])
def test_data_mesh_stepped_runner_matches_eager_mesh_runner(name, shape,
                                                            monkeypatch):
    """Two chunks through the stepped runner over a data mesh (each part
    split at its sums over the data peers; the stand-in graph reruns a
    whole part, whose sums go through the same static buffers, copies and
    peers' graphs as a real replay) and the eager mesh runner from one
    carry and one generator seed: carry, traces and every generator's
    state bit-equal after each chunk; captures, replays and copies as the
    parts' sums give them (``_part_counts``)."""
    case = _case(name, n_data=shape[1])
    graphs.COUNTS.reset()
    eager, graph = _runners(case, shape, monkeypatch)
    k, n_data = shape
    assert eager.runner == "eager" and graph.runner == "stepped"
    assert all(len(p) == n_data for p in graph.peers)
    ge, gg = (torch.Generator().manual_seed(5) for _ in range(2))
    ce = cg = case.t_carry
    replays = copies = 0
    for (eps, leap), n in zip((case.a, case.b), (3, 2)):
        leap = leap[:n] if case.uturn else leap
        ce, te = eager(ce, eps, leap, n, ge, step_scale=case.scale)
        cg, tg = graph(cg, eps, leap, n, gg, step_scale=case.scale)
        _equal(cg, ce, "carry")
        _equal(tg, te, "trace")
        for g in graph.generators:
            assert torch.equal(g.get_state(), ge.get_state())
        blocks = (np.split(np.asarray(leap), k) if np.ndim(leap)
                  else [leap] * k)
        captures, r, c = _part_counts(k, n_data, DATA_MODES[name], [
            _steps(case, b, n) for b in blocks])
        replays, copies = replays + r, copies + c
    counts = graphs.COUNTS.as_dict()
    assert (counts["captures"], counts["warmups"]) == (captures, k), counts
    assert (counts["replays"], counts["copies"]) == (replays, copies), \
        counts
    assert all(p.mode is None for p in graph.peers)


@pytest.mark.parametrize("name", list(DATA_MODES))
def test_data_shard_body_matches_jax(name, monkeypatch):
    """The body of a 1x2 data mesh's chain shard, each of its parts split
    at its sums over the two data peers (``SegmentedPart`` with the
    stand-in graph), against the JAX package's epochs on the whole rows,
    fed the JAX package's own draws (``body_against_jax``; states to rtol
    1e-3 / atol 1e-4, acceptance and SJD to 1e-3)."""
    case = _case(name, n_data=2)
    _, graph = _runners(case, (1, 2), monkeypatch)
    body_against_jax(case, graph.epoch_fns[0], monkeypatch,
                     peers=graph.peers[0])
    assert graph.peers[0].mode is None


def test_resume_under_a_chains_mesh_on_the_graph_runner(tmp_path,
                                                        monkeypatch):
    """A run on the mesh graph runner (2x1) stopped at epoch 15 and
    resumed by a fresh Network of the same seed under the same mesh
    equals the uninterrupted run bit for bit, which equals the same run
    on the eager mesh runner: the checkpoint stores the run generator's
    state, where the replays leave it."""
    kw = dict(n_chains=4, verbose=False, chain_jitter=0.05,
              checkpoint_every=1)

    def train(epochs, ckpt=None):
        net, lik = _net()
        return net.train(epochs, 2, lik, checkpoint_dir=ckpt,
                         mesh=make_mesh(2, 1, devices=[CPU] * 2), **kw)

    eager = train(30)
    assert eager.main_path == "K1" and eager.chunk_runner == "eager"
    _graphs_on_the_cpu(monkeypatch)
    graphs.COUNTS.reset()
    full = train(30)
    assert full.chunk_runner == "graph" and graphs.COUNTS.replays > 0
    ckpt = str(tmp_path / "ckpt")
    assert train(15, ckpt).n_epochs == 15
    res = train(30, ckpt)
    assert res.resume_epoch == 15 and res.chunk_runner == "graph"
    for name in ("theta_samples", "eta_samples"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(full, name))
        np.testing.assert_array_equal(getattr(full, name),
                                      getattr(eager, name))
    for name in ("main_accept", "hyper_accept", "sjd", "leapfrog"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(full, name)[15:])
        np.testing.assert_array_equal(getattr(full, name),
                                      getattr(eager, name))


def test_resume_under_a_data_mesh_on_the_stepped_runner(tmp_path,
                                                        monkeypatch):
    """A run of K3's twin under a 1x2 data mesh on the stepped runner (its
    parts split at their sums) stopped at epoch 10 and resumed by a fresh
    Network of the same seed under the same mesh equals the uninterrupted
    run bit for bit, which equals the same run on the eager mesh runner:
    the checkpoint stores the run generator's state, where the replays
    leave it."""
    kw = dict(n_chains=4, verbose=False, chain_jitter=0.05,
              checkpoint_every=1)

    def train(epochs, ckpt=None):
        net, lik = _net()
        return net.train(epochs, 2, lik, checkpoint_dir=ckpt,
                         mesh=make_mesh(1, 2, devices=[CPU] * 2), **kw)

    eager = train(20)
    assert eager.main_path == "K3" and eager.chunk_runner == "eager"
    _graphs_on_the_cpu(monkeypatch)
    graphs.COUNTS.reset()
    full = train(20)
    assert full.chunk_runner == "stepped" and graphs.COUNTS.copies > 0
    ckpt = str(tmp_path / "ckpt")
    assert train(10, ckpt).n_epochs == 10
    res = train(20, ckpt)
    assert res.resume_epoch == 10 and res.chunk_runner == "stepped"
    for name in ("theta_samples", "eta_samples"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(full, name))
        np.testing.assert_array_equal(getattr(full, name),
                                      getattr(eager, name))
    for name in ("main_accept", "hyper_accept", "sjd", "leapfrog"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(full, name)[10:])
        np.testing.assert_array_equal(getattr(full, name),
                                      getattr(eager, name))
