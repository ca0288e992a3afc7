"""The chunk runner as captured CUDA graphs.

Counterpart of the JAX package's compiled chunk: there a chunk of epochs
(one GP-adapter cycle) is ``jax.jit`` of a ``lax.scan`` over ``epoch_fn``
with ``n_epochs`` static (``tensorbnn_tpu/parallel/chains.py:207-228``,
``:272-274``), compiled once for each ``n_epochs`` and dispatched once;
over a mesh, ``jax.jit`` of ``shard_map`` of that scan (``:234-284``),
each chip running its chain shard's chunk. Here a chunk is captured once
for each key as a ``torch.cuda.CUDAGraph`` a chain shard, on the shard's
home card, and replayed, so the host issues one launch a shard where the
eager runner issues every kernel and glue operation of every epoch.

Which runner a chunk takes is decided from the configuration when the
runner is built (``chunk_runner_kind``): either graph runner needs every
entry of the mesh (if any) on a CUDA device, the cards of one kind; then
K1's main block takes ``GraphChunkRunner`` (below) where the data axis is
1 (K1 is never built over data peers), and K3's or the plain path's
``SteppedChunkRunner``, over any data axis, unless K3's workspace fails
the gate ``stepped_fits``. Cards of two kinds, a failed gate and the CPU
keep the eager runner (parallel/chains.py). A tempered run needs a chains
axis of 1 (``check_tempering_mesh``), so on a mesh it has a data axis
above 1, and runs on the stepped runner (its main block is the plain one).

A key is the graph's epochs, the carry's shape, the form of the leapfrog
counts (shared, per chain or per epoch) and whether a step scale is given;
the run's generator is registered with the graphs, so another generator
captures anew. A graph holds the whole chunk, the port of ``jit(scan)``,
unless the hyper block runs the plain ``torch.func`` potential
(``whole_chunk``): that block issues ~6,300 launches an epoch at the JAX
bench's ``classification``, so a graph of its 60-epoch chunk would take as
long to capture as the chunk takes to run eagerly. There a graph holds one
epoch, replayed ``n_epochs`` times, each replay's trace copied into the
chunk's.

``StaticChunk`` is the body a graph captures. Every chunk argument enters
through its static buffers, which the runner fills before each replay: the
shard's block of the carry, of the step size ``(C,)`` float32 and of the
leapfrog counts (``(C,)`` int32, or the ``(n,)`` per-epoch counts of a
U-turn run, epoch j reading slot j, which every shard shares) and the step
scale. Nothing of a chunk is baked into a graph as a Python scalar, so a
graph captured at one ``(eps, L)`` runs another. The body's last
operations copy the new carry into the static carry; the traces are the
graph's outputs, and the runner hands out copies of both, gathered in
chain order on the first device.

Four things keep a replay bit-equal to the eager runner:

* the epochs draw inside the graph, in ``draw_epoch``'s order (the JAX
  package's replicated keys in the port's scheme): each shard's graph
  draws the whole fleet's epoch from its own generator and keeps its own
  rows, as the eager runner draws the fleet's epoch once on the first
  device and hands each shard its rows. The first shard's generator is the
  run's; every other shard's is a generator of its home card set to the
  run's state before each chunk. Each is registered with its graphs
  (``CUDAGraph.register_generator_state``), so a replay draws what the
  eager runner draws and leaves every generator's state (the run's is
  what a checkpoint stores) where the eager run leaves the run's. The
  draws of a state are those of the card's launch grid, so the cards of
  a mesh must be of one kind;
* the SJD of a shared or per-epoch count is divided after the replay by
  the count's square root as a Python float, the eager epoch's own
  operation (torch on CUDA multiplies by the float's float32 reciprocal,
  which a division by a device tensor does not reproduce); per-chain counts
  divide inside the graph, as the eager epoch does;
* the kernel wrappers count their launches in Python, so at capture: the
  runner takes the capture's counts back out and adds them at each replay,
  so the counters read as the eager runner's. ``COUNTS`` keeps the
  captures (one a shard and key, with their seconds), replays and warm-up
  epochs;
* a chunk fills every shard's buffers (a copy of its block of the carry
  from the first device), then replays every shard's graph before the host
  waits on anything: graphs on distinct cards run at the same time, and
  the shards of a card replay one after another on its current stream
  (they were captured on one side stream, whose cuBLAS workspace they
  share).

A shard's first capture follows one eager epoch on its card's side stream
(the one stream every capture on that card runs on), on a copy of its
block, with the generator's state put back afterwards and its launches
uncounted: it creates what a kernel creates on its first call on a card
(K1's prior table, the library's first launch, the stream's cuBLAS
workspace, which the process then keeps: 32 MiB a card). Capture runs in
"global" mode, so a forbidden call during capture (a copy from pageable
memory, a synchronization, ``.item()``) raises. A failed capture or replay
raises; nothing falls back to the eager runner.

``SteppedChunkRunner`` is the port of the same ``jit(scan)`` where K3 or
the plain path runs the main block. There the JAX leapfrog is a
``lax.while_loop`` over a traced count (``tensorbnn_tpu/sampler/hmc.py:
260-266``), one program for every L; a CUDA graph has no loop over a
count it reads, and a graph of a chunk would record (L + 1) x ~100
launches an epoch, one graph for every L and chunk length. So an epoch
(``gibbs.EpochParts``) is three graphs a chain shard: a head (the draws,
the first evaluation and half kick), a step (one leapfrog step, its index
a device counter) and a tail (the closing half kick, MH, the SJD, the
hyper block, dual averaging, the swap), and the host replays the head,
the step L times and the tail. The eager epoch runs the same three parts
in the same order, so the two are bit-equal. The three graphs of a card
share one memory pool, so K3's per-call workspace lives once in it.

Over a data axis above 1 the JAX package sums the likelihood's terms with
``lax.psum`` inside its compiled chunk; here the sum is a host-side gather
across cards (``DataPeers.sum``), and a torch graph lives on one card and
one pool. So each part is split at its sums (``SegmentedPart``): a graph
of the home's work up to a sum, a graph of each data peer's evaluation on
its own card, copies of the argument to the peers and of their parts back
issued by the host between them, and a graph of the home's work from the
sum on. The sum itself, the peers' order and every operation are the
eager epoch's, so the replays stay bit-equal to the eager mesh runner.

``StepGraph`` applies the same recipe (a warm-up on the side stream,
one capture, replays) to the step of a loop, a body that draws nothing
and reads nothing but its static buffers: MAP pretraining's optimizer
step, the body of the JAX package's jitted ``lax.scan`` over the batches
(``tensorbnn_tpu/training/pretrain.py:99-113``), captured once a call
and replayed a batch at a time (training/pretrain.py). A graph of the
whole epoch (~27,000 launches at the tutorial's 299 steps) took 1.7 s
to capture on an H100, a step 14 ms, and the step's replays ran an
epoch up to 7% faster (``chip_profile.py pretrain``).

``ForwardGraph`` is the port of the JAX ``Predictor``'s compiled forward
(``jax.jit(jax.vmap(apply))``, ``tensorbnn_tpu/predictor.py:84``, and its
sharded twin, ``:222-224``), which XLA compiles for each input shape at
its first call: a ``Predictor`` on a card, or on a mesh whose entries are
all cards (``predict_route``), captures its ensemble's forward once for
each key (the thinning and the input's shape; a mesh entry's block of
networks and of rows) after one eager run of it on the card's side
stream, and replays it at every later call of the key (predictor.py).
"""

from __future__ import annotations

import functools
import gc
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
from tensorbnn_tpu_torch.parallel.mesh import DATA_AXIS, data_sum, gather, \
    to_device
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochDraws, \
    EpochTrace, draw_epoch

#: the kernel wrappers whose ``LAUNCHES`` a replay adds its captured
#: launches to
COUNTED = (fused_mlp.fused_trajectory, fused_hyper.fused_hyper_trajectory,
           fused_mlp.fused_potential)


class GraphCounts:
    """What the graph runners and the Predictor's forward graphs
    (``ForwardGraph``) did since the last ``reset``: graphs captured, each
    capture's seconds (a chunk's warm-up epoch included), replays, warm-up
    epochs (or forwards) and, over a data axis above 1, the host's copies
    of a sum's argument to a peer and of a peer's part back to the home
    (``SegmentedPart``), one a peer and direction."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.captures = 0
        self.replays = 0
        self.warmups = 0
        self.copies = 0
        self.capture_seconds = []

    def as_dict(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "warmups": self.warmups, "copies": self.copies,
                "capture_ms": [1e3 * s for s in self.capture_seconds]}


COUNTS = GraphCounts()


def _entries(mesh, device) -> list:
    """The devices of a mesh's entries, or ``[device]`` without one."""
    return ([torch.device(device)] if mesh is None
            else [d for row in mesh.devices for d in row])


def predict_route(device, mesh) -> str:
    """Which route a ``Predictor.predict`` call takes, from the
    configuration alone: "graph" (a ``ForwardGraph`` a key, or a mesh
    entry and key) where the Predictor's ``device`` (no mesh) or every
    entry of the call's ``mesh`` is a CUDA card, else "eager". The forward
    draws nothing, so the cards may be of several kinds."""
    return ("graph" if all(d.type == "cuda" for d in _entries(mesh, device))
            else "eager")


def chunk_runner_kind(batched_main_traj, mesh, device,
                      workspace_bytes: int = 0) -> str:
    """Which runner a chunk takes, from the configuration alone: "graph"
    (``GraphChunkRunner``) where K1 runs the main block
    (``batched_main_traj``) and the mesh (if any) has a data axis of 1,
    "stepped" (``SteppedChunkRunner``) where K3 or the plain path runs it
    and ``stepped_fits``, else "eager". Either graph runner needs every
    entry of the mesh (None: no mesh, the chains on ``device``) on a CUDA
    device, the cards all of one kind (``card_kind``; a card that repeats
    is asked nothing). K1 is never built on a data mesh (it cannot sum
    over the peers mid-trajectory), so there it is "eager" here too.
    ``workspace_bytes`` is a K3 call's workspace on a chain shard's chains
    and a peer's rows (0 for the plain path)."""
    entries = _entries(mesh, device)
    if any(d.type != "cuda" for d in entries):
        return "eager"
    cards = {d.index for d in entries}
    if len(cards) > 1 and len({card_kind(i) for i in cards}) > 1:
        return "eager"
    if batched_main_traj is not None:
        data = 1 if mesh is None else mesh.shape[DATA_AXIS]
        return "graph" if data == 1 else "eager"
    return "stepped" if stepped_fits(workspace_bytes, cards) else "eager"


def k3_fits(workspace_bytes: int, cards) -> bool:
    """The driver's gate on K3, the counterpart of the JAX package's VMEM
    gate (``tensorbnn_tpu/ops/fused_mlp.py:1147-1155``): a K3 call's
    workspace (``workspace_bytes``, at a chain shard's chains and one
    chunk's or a data peer's rows) fits the memory of each card of
    ``cards`` (CUDA device indices; none on the CPU, which has no gate).
    Where it does not, the driver builds no K3 and the main block takes the
    plain path, chunked where ``data_chunk`` says so. At the surrogate's
    8-64-64-1 over 1M rows a call takes C x 1.028 GB unchunked (131.6 GB
    at 128 chains, over an 80 GB card) and C x 128.5 MB with
    ``data_chunk=125,000`` (16.45 GB at 128 chains)."""
    return all(workspace_bytes <= card_memory(i) for i in cards)


def stepped_fits(workspace_bytes: int, cards) -> bool:
    """The stepped runner's gate: a K3 call's workspace fits twice on each
    card of the mesh, once in the card's graph pool and once in the
    caching allocator (an eager call on another stream, the warm-up's,
    the driver's or the caller's, may hold it when a capture starts, and
    a capture cannot hand it back to the card). A card's pool holds one
    workspace at a time however many chain shards, data peers or row
    chunks it serves: each K3 call frees its workspace when it ends, and
    the card's graphs (home segments and peers' evaluations) are captured
    and replayed one after another in that one pool, so each capture
    reuses the last one's. The default-numerics surrogate on a 1x4 mesh of one
    H100 80GB (four peers of 250,000 rows, 8.23 GB of workspace each)
    reserved 25.95 GB on the stepped runner against 17.70 GB eager, one
    workspace more, at the same 8.24 GB peak allocated (``PERF.md``, the
    stepped runner over data meshes). The plain path (no workspace)
    always passes."""
    return workspace_bytes == 0 or k3_fits(2 * workspace_bytes, cards)


def card_memory(index) -> int:
    """A card's memory in bytes."""
    return torch.cuda.get_device_properties(index).total_memory


def card_kind(index: int) -> tuple:
    """What sets a draw's bits on a card besides the generator's state:
    torch's random kernels take their launch grid from the card's name and
    multiprocessor count."""
    props = torch.cuda.get_device_properties(index)
    return props.name, props.multi_processor_count


def whole_chunk(adjust_hypers: bool, batched_hyper_traj) -> bool:
    """Whether a graph holds the whole chunk (else one epoch): yes unless
    the hyper block runs the plain potential (it runs, without K2)."""
    return not adjust_hypers or batched_hyper_traj is not None


def leap_mode(leapfrog, per_epoch_leapfrog: bool) -> str:
    """The form of a chunk's leapfrog counts: "per_epoch" (a U-turn run's
    ``(n_epochs,)`` vector), "per_chain" (a ``(C,)`` vector) or
    "shared"."""
    if per_epoch_leapfrog:
        return "per_epoch"
    return "per_chain" if np.ndim(leapfrog) > 0 else "shared"


class StaticChunk:
    """``n`` epochs of ``epoch_fn`` over static buffers on the carry's
    device: ``fill`` writes a chunk's arguments into them, ``run`` runs the
    epochs from them (inside a capture, or eagerly), ``result`` gives
    copies of the new carry and of the traces with the SJD scaled.

    ``mode`` is ``leap_mode``'s; ``h`` the hyper dimension (None: no hyper
    block); ``tempered`` draws the swap coins; ``step_scale`` a ``(D,)``
    tensor whose shape the scale buffer takes (None: no scale). ``shard =
    (i, k)``: the body runs chain shard ``i`` of ``k`` (``carry`` its
    block), drawing the fleet's ``k`` blocks an epoch and keeping block
    ``i``; the buffers live on ``device`` (None: the carry's)."""

    def __init__(self, epoch_fn, carry: ChainState, n: int, mode: str,
                 h: Optional[int], tempered: bool,
                 step_scale: Optional[torch.Tensor] = None,
                 device=None, shard: tuple = (0, 1)):
        c = carry.theta.shape[0]
        dev = carry.theta.device if device is None else torch.device(device)
        self.epoch_fn, self.n, self.mode = epoch_fn, n, mode
        self.h, self.tempered, self.shard = h, tempered, shard
        self.carry = ChainState(*(f.to(dev, copy=True) for f in carry))
        self.eps = torch.empty(c, dtype=torch.float32, device=dev)
        self.leap = torch.empty(n if mode == "per_epoch" else c,
                                dtype=torch.int32, device=dev)
        self.scale = (None if step_scale is None
                      else torch.empty_like(step_scale, device=dev))
        self.trace = None

    def fill(self, carry: ChainState, step_size, leapfrog,
             step_scale: Optional[torch.Tensor] = None) -> None:
        """Writes the carry and the chunk's arguments into the buffers:
        ``step_size`` a float or a ``(C,)`` array, ``leapfrog`` an int, a
        ``(C,)`` array or (per-epoch) the ``(n,)`` counts; each takes the
        values the eager epoch gives K1 (float32 step sizes, int32
        counts)."""
        for dst, src in zip(self.carry, carry):
            dst.copy_(src)
        if np.ndim(step_size) > 0:
            self.eps.copy_(torch.as_tensor(np.asarray(step_size),
                                           dtype=self.eps.dtype))
        else:
            self.eps.fill_(float(step_size))
        self._fill_leap(leapfrog)
        if self.scale is not None:
            self.scale.copy_(step_scale)

    def _fill_leap(self, leapfrog) -> None:
        if self.mode == "shared":
            self.leap.fill_(int(leapfrog))
        else:
            self.leap.copy_(torch.as_tensor(
                np.asarray(leapfrog, np.int64).reshape(-1),
                dtype=torch.int32))

    def run(self, generator: Optional[torch.Generator]) -> None:
        """The body: ``n`` epochs from the static carry, each drawing from
        ``generator``; the traces stacked ``(n, C, ...)`` into
        ``self.trace`` and the new carry copied into the static one."""
        c, d = self.carry.theta.shape
        dtype, dev = self.carry.theta.dtype, self.carry.theta.device
        i, k = self.shard
        state, traces = self.carry, []
        for j in range(self.n):
            draws = draw_epoch(generator, c * k, d, self.h, dtype, dev,
                               self.tempered)
            if k > 1:
                draws = EpochDraws(*(None if f is None else
                                     f[i * c:(i + 1) * c] for f in draws))
            leap = (self.leap[j].expand(c) if self.mode == "per_epoch"
                    else self.leap)
            state, trace = self.epoch_fn(
                state, self.eps, leap, generator, draws=draws,
                leapfrog_dev=leap, step_scale=self.scale,
                scale_sjd=self.mode == "per_chain")
            traces.append(trace)
            draws = None
        self.trace = EpochTrace(*(None if f[0] is None else torch.stack(f)
                                  for f in zip(*traces)))
        for dst, src in zip(self.carry, state):
            dst.copy_(src)

    def result(self, leapfrog, trace: Optional[EpochTrace] = None):
        """A copy of the carry, and a copy of the body's trace (or
        ``trace``, a fresh one, as it is), the SJD divided by a shared or
        per-epoch ``leapfrog``'s square root as the eager epoch divides
        it."""
        own = trace is None
        trace = self.trace if own else trace
        sjd = trace.sjd
        if self.mode == "shared":
            sjd = sjd / math.sqrt(leapfrog)
        elif self.mode == "per_epoch":
            out = torch.empty_like(sjd)
            for j, n_leap in enumerate(np.asarray(leapfrog).reshape(-1)):
                torch.div(sjd[j], math.sqrt(int(n_leap)), out=out[j])
            sjd = out
        elif own:
            sjd = sjd.clone()
        if own:
            trace = EpochTrace(*(None if f is None else f.clone()
                                 for f in trace._replace(sjd=None)))
        return (ChainState(*(f.clone() for f in self.carry)),
                trace._replace(sjd=sjd))


_SIDE_STREAMS = {}


def _side_stream(device) -> torch.cuda.Stream:
    """The one side stream of ``device`` that every warm-up and capture
    runs on. torch gives each stream that runs a cuBLAS product a 32 MiB
    workspace and keeps it for the process, so a fresh stream a capture
    would hold one more each run; on one stream, warmed up before its
    first capture, the process holds one, outside any graph's pool."""
    device = torch.device(device)
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class CudaGraph:
    """``fn`` captured as a CUDA graph on ``device`` in "global" mode, the
    ``generator`` it draws from (None: it draws nothing) registered with
    it, its memory from ``pool`` (``new_pool``; None: a pool of its own);
    ``replay`` runs it on the device's current stream. ``warm_up`` runs a
    function eagerly on the device's side stream (torch's recipe before a
    first capture). ``open`` and ``close`` capture a graph whose body the
    caller runs in between (``SegmentedPart``'s segments, which split a
    function at its sums, so that a graph can end and the next begin
    inside it); ``splits`` says that this graph type can."""

    splits = True

    def __init__(self, fn, generator: Optional[torch.Generator], device,
                 pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            self._register(generator)
            with torch.cuda.graph(self.graph, pool=pool,
                                  stream=_side_stream(self.device),
                                  capture_error_mode="global"):
                fn()

    def _register(self, generator) -> None:
        # a generator's first registration puts the seed and offset its
        # graphs read on the current device: it must be the graph's
        if generator is not None and generator is not \
                torch.cuda.default_generators[self.device.index]:
            self.graph.register_generator_state(generator)

    @classmethod
    def open(cls, generator: Optional[torch.Generator], device,
             pool) -> "CudaGraph":
        """Begins capturing a graph on ``device``'s side stream, which the
        caller has made current there, without ``torch.cuda.graph``'s
        preamble (a synchronize, ``gc.collect`` and emptying the cache: up
        to 0.5 s a capture in a long process; a segmented part takes it
        once); ``close`` ends the capture. The garbage collector is off
        until then: a collection in the capture could destroy an
        unreachable graph, a call that a capture in "global" mode refuses,
        and the capture would fail (a Predictor's first capture after the
        graph runners' tests, on an H100)."""
        self = cls.__new__(cls)
        self.graph, self.device = torch.cuda.CUDAGraph(), torch.device(device)
        self.collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device):
                self._register(generator)
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="global")
        except BaseException:
            self._collect()
            raise
        return self

    def close(self) -> None:
        try:
            with torch.cuda.device(self.device):
                self.graph.capture_end()
        finally:
            self._collect()

    def _collect(self) -> None:
        if self.collecting:
            gc.enable()

    def abandon(self) -> None:
        """Ends a capture that failed; its own error is dropped for the
        one that made it fail."""
        try:
            self.close()
        except RuntimeError:
            pass

    @classmethod
    def segment(cls, fn, device, pool) -> "CudaGraph":
        """``fn`` (which draws nothing) captured on ``device``'s side stream
        by ``open`` and ``close``."""
        device = torch.device(device)
        with torch.cuda.device(device), torch.cuda.stream(
                _side_stream(device)):
            graph = cls.open(None, device, pool)
            try:
                fn()
            except BaseException:
                graph.abandon()
                raise
            graph.close()
        return graph

    @staticmethod
    def new_pool():
        """A memory pool that graphs captured and replayed in one order
        share (``torch.cuda.graph_pool_handle``)."""
        return torch.cuda.graph_pool_handle()

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()

    @staticmethod
    def warm_up(fn, device) -> None:
        with torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            side = _side_stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                fn()
            current.wait_stream(side)


def _static(value, device):
    """Uninitialized tensors shaped as ``value`` (a tensor or a tuple of
    them) on ``device``; anything else as it is."""
    if isinstance(value, tuple):
        return tuple(_static(v, device) for v in value)
    if torch.is_tensor(value):
        return torch.empty_like(value, device=device)
    return value


def _copy(dst, src) -> None:
    """``src`` (a tensor or a tuple of them) into ``dst`` of its shapes,
    ``non_blocking``: the host never waits, and a copy between cards
    orders itself after both cards' current streams."""
    if isinstance(src, tuple):
        for d, v in zip(dst, src):
            _copy(d, v)
    elif torch.is_tensor(src):
        dst.copy_(src, non_blocking=True)


class _SumPoint:
    """One ``peers.sum(fns, *args)`` of a ``SegmentedPart``, captured
    once: peer ``j``'s evaluation ``fns[j]`` a graph on its card
    (``graph(fn, device)``), reading the home's own ``args`` (peer 0, on
    the home card) or a static copy of them on its card (``inputs[j]``,
    j > 0), its outputs left where its graph wrote them (``outs[j]``), and
    a static copy of peer j's outputs on the home card (``parts[j]``, j >
    0). ``issue`` is the host's share of a replay; ``total`` the sum of
    the parts in peer order on the home (``data_sum``), which the next
    home segment opens with. The peers' graphs are captured in the order
    they replay (peer 0 last): graphs of one card share its pool, where a
    later capture may take what an earlier one freed, so a graph that
    replayed out of that order could overwrite another's outputs before
    they are read."""

    def __init__(self, peers, fns, args, graph):
        self.home, self.fns, self.src = peers.home, fns, args
        n = len(fns)
        self.inputs = [None] + [_static(args, d) for d in peers.devices[1:]]
        self.outs = [None] * n
        self.graphs = [None] * n
        for j in list(range(1, n)) + [0]:
            self.graphs[j] = graph(functools.partial(self._evaluate, j),
                                   peers.devices[j])
        # a graph's outputs are known once it is captured (the CPU tests'
        # stand-in captures nothing: then at its first replay)
        self.parts = [None] + [None if out is None else
                               _static(out, self.home)
                               for out in self.outs[1:]]
        COUNTS.captures += len(fns)

    def _evaluate(self, j: int) -> None:
        self.outs[j] = self.fns[j](*(self.src if j == 0 else
                                     self.inputs[j]))

    def issue(self, args=None) -> None:
        """Copies the argument to each other peer and replays its graph,
        replays peer 0's on the home (after the others are issued, so that
        on distinct cards all work at once) and copies each other peer's
        outputs to the home; ``args`` (the stand-in's rerun) replaces the
        captured argument. Nothing waits on the host."""
        if args is not None:
            self.src = args
        n = len(self.graphs)
        for j in range(1, n):
            _copy(self.inputs[j], self.src)
            self.graphs[j].replay()
        self.graphs[0].replay()
        for j in range(1, n):
            if self.parts[j] is None:
                self.parts[j] = _static(self.outs[j], self.home)
            _copy(self.parts[j], self.outs[j])
        COUNTS.replays += n
        COUNTS.copies += 2 * (n - 1)

    def total(self):
        return data_sum([self.outs[0]] + self.parts[1:], self.home)


class SegmentedPart:
    """A part ``fn`` of a chain shard's epoch (``SteppedChunk``'s head,
    step or tail) over a data axis above 1, captured as graphs split at
    its sums over the data peers (``peers``, a ``DataPeers`` of more than
    one peer): one torch graph lives on one card and one pool, and a sum
    needs each peer's work on its own card. While ``fn`` runs under
    capture, each ``peers.sum`` (its ``mode``) ends the home segment's
    capture, captures each peer's evaluation as a graph on its card, on
    that card's side stream and in its pool (``_SumPoint``), and begins the
    next home segment, which opens with the sum of the peers' parts. A
    part is then a list of actions that ``replay`` runs in order: replay a
    home segment, issue a sum (copies and the peers' replays), replay the
    next segment. It segments at every sum, also where the peers are all
    one card (a virtual mesh): one code path for repeated and distinct
    cards. The same operations run in the same order as in the eager
    epoch, and a copy does not change bits, so the two are bit-equal.

    ``generator`` (the head's) is registered with every home segment; the
    peers' graphs draw nothing. ``pool(device)`` is the card's pool, which
    every graph of the card shares. ``graph_type`` is ``CudaGraph`` or,
    in the CPU tests, a stand-in that cannot split a function (no
    ``splits``): it reruns the whole part at each replay, and each sum
    then goes through its point's static buffers, copies and peers'
    graphs as a real replay does. Counted in ``COUNTS`` beyond the part's
    own capture and replay: a home segment and the peers' graphs a sum,
    and the copies."""

    def __init__(self, fn, generator, peers, graph_type, pool):
        self.peers, self.graph_type, self.pool = peers, graph_type, pool
        self.generator, self.points, self.actions = generator, [], []
        self.current = None
        home = peers.home
        if not getattr(graph_type, "splits", False):
            self.actions = [graph_type(
                lambda: self._run(fn, self._rerun_sum), generator, home,
                pool=pool(home)).replay]
            return
        torch.cuda.synchronize(home)
        with torch.cuda.device(home), torch.cuda.stream(_side_stream(home)):
            self.current = graph_type.open(generator, home, pool(home))
            try:
                self._run(fn, self._split)
            except BaseException:
                if self.current is not None:
                    self.current.abandon()
                raise
            self._close()

    def _run(self, fn, mode) -> None:
        self.k = 0
        self.peers.mode = mode
        try:
            fn()
        finally:
            self.peers.mode = None

    def _close(self) -> None:
        self.current.close()
        self.actions.append(self.current.replay)
        self.current = None

    def _split(self, fns, args):
        """A sum under capture: (a) ends the home segment, (b)-(d) captures
        the peers' graphs and makes the static buffers of the copies, (e)
        begins the next home segment with the sum."""
        home = self.peers.home
        self._close()
        point = _SumPoint(self.peers, fns, args, lambda f, d: (
            self.graph_type.segment(f, d, self.pool(d))))
        self.points.append(point)
        self.actions.append(point.issue)
        self.current = self.graph_type.open(self.generator, home,
                                            self.pool(home))
        COUNTS.captures += 1
        return point.total()

    def _rerun_sum(self, fns, args):
        """A sum of the stand-in's rerun: the k-th sum's point (made at the
        first rerun) issued on this rerun's argument."""
        if self.k == len(self.points):
            self.points.append(_SumPoint(self.peers, fns, args, lambda f, d: (
                self.graph_type(f, None, d, pool=self.pool(d)))))
            COUNTS.captures += 1
        point = self.points[self.k]
        self.k += 1
        point.issue(args)
        return point.total()

    def replay(self) -> None:
        for action in self.actions:
            action()
        COUNTS.replays += len(self.points)


class StepGraph:
    """A loop whose steps replay one captured graph: ``run(step)`` runs the
    loop (an epoch), calling ``step`` for each of its steps; ``step`` is a
    body over static buffers that draws nothing. The first call runs the
    loop eagerly on ``device``'s side stream (the warm-up a first capture
    needs, and a real run of the loop), the second captures ``step`` with
    ``graph_type``, and from then on every step of every call is a replay.
    Counted in ``COUNTS``: the warm-up, the capture with its seconds, each
    replay. Pretraining runs its epochs on it (training/pretrain.py)."""

    def __init__(self, run, step, device, graph_type=CudaGraph):
        self.run, self.step = run, step
        self.device, self.graph_type = torch.device(device), graph_type
        self.warm, self.graph = False, None

    def __call__(self) -> None:
        if not self.warm:
            self.graph_type.warm_up(lambda: self.run(self.step), self.device)
            self.warm = True
            COUNTS.warmups += 1
            return
        if self.graph is None:
            t0 = time.perf_counter()
            self.graph = self.graph_type(self.step, None, self.device)
            COUNTS.captures += 1
            COUNTS.capture_seconds.append(time.perf_counter() - t0)
        self.run(self._replay)

    def _replay(self) -> None:
        self.graph.replay()
        COUNTS.replays += 1


class ForwardGraph:
    """``fn(x)``, a forward over tensors it reads in place (a Predictor's
    ensemble, or a mesh entry's block of it), captured on ``x``'s card for
    ``x``'s shape. ``warm`` makes it at a key's first call: ``fn(x)`` runs
    eagerly on the card's side stream (the warm-up a first capture needs;
    its output is that call's), then ``fn`` is captured over a static copy
    of ``x`` by ``graph_type.segment`` (``open`` and ``close``, without
    ``torch.cuda.graph``'s preamble) in ``pool``. A call copies its input
    into the static buffer and replays; the output it returns is the
    graph's own, which its next replay overwrites, and so may a replay of
    a graph captured before it in the same pool: a caller copies it out
    before either runs. Counted in ``COUNTS``: the warm-up, the capture
    with its seconds, each replay."""

    def __init__(self, fn, x: torch.Tensor, graph_type, pool):
        self.fn, self.x, self.out = fn, x.clone(), None
        if self.x.is_cuda:
            torch.cuda.synchronize(self.x.device)
        t0 = time.perf_counter()
        self.graph = graph_type.segment(self._body, self.x.device, pool)
        COUNTS.captures += 1
        COUNTS.capture_seconds.append(time.perf_counter() - t0)

    @classmethod
    def warm(cls, fn, x: torch.Tensor, graph_type, pool) -> tuple:
        """A key's first call: ``(graph, fn(x))``."""
        out = []
        graph_type.warm_up(lambda: out.append(fn(x)), x.device)
        COUNTS.warmups += 1
        return cls(fn, x, graph_type, pool), out[0]

    def _body(self) -> None:
        self.out = self.fn(self.x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.x.copy_(x)
        self.graph.replay()
        COUNTS.replays += 1
        return self.out


class _Captured:
    """One shard's graph for one key, its body and the launches it
    captured."""

    def __init__(self, graph, chunk: StaticChunk, launched: list,
                 generator):
        self.graph, self.chunk = graph, chunk
        self.launched, self.generator = launched, generator

    def replay(self) -> None:
        self.graph.replay()
        for fn, k in zip(COUNTED, self.launched):
            fn.LAUNCHES += k
        COUNTS.replays += 1


def _blocks(value, k: int) -> list:
    """A chain-major tensor, host array or scalar split into ``k`` blocks
    of chains in order (a scalar is every block's)."""
    if torch.is_tensor(value):
        return list(value.chunk(k))
    if np.ndim(value) > 0:
        return np.split(np.asarray(value), k)
    return [value] * k


class GraphChunkRunner:
    """``run_chunk(carry, step_size, leapfrog, n_epochs, generator,
    step_scale=None) -> (carry, trace)`` of parallel/chains.py through
    captured graphs (see the module docstring): chain shard ``i`` runs
    ``epoch_fns[i]`` on ``homes[i]`` (one shard without a mesh), a whole
    chunk a graph when ``whole``, else one epoch. ``h``, ``tempered`` as
    ``StaticChunk``'s; ``per_epoch_leapfrog`` as the runner's.
    ``graph_type`` captures and replays (``CudaGraph``; the CPU tests give
    a stand-in that reruns the body at each replay)."""

    runner = "graph"

    def __init__(self, epoch_fns, homes, *, h: Optional[int],
                 tempered: bool, per_epoch_leapfrog: bool, whole: bool,
                 graph_type=CudaGraph):
        self.epoch_fns = list(epoch_fns)
        self.homes = [torch.device(d) for d in homes]
        self.h, self.tempered = h, tempered
        self.per_epoch_leapfrog, self.whole = per_epoch_leapfrog, whole
        self.graph_type = graph_type
        self.graphs = {}
        self.warm = [False] * len(self.homes)
        self.generators = [None] * len(self.homes)

    def __call__(self, carry: ChainState, step_size, leapfrog,
                 n_epochs: int, generator: torch.Generator,
                 step_scale: Optional[torch.Tensor] = None):
        if carry.theta.dtype != torch.float32:
            raise ValueError(f"the graph runner takes K1's float32 state, "
                             f"got {carry.theta.dtype}")
        if generator is None:
            raise ValueError("the graph runner draws from the run's "
                             "torch.Generator, which it registers with "
                             "each graph; pass one")
        mode = leap_mode(leapfrog, self.per_epoch_leapfrog)
        n = n_epochs if self.whole else 1
        leaps = leapfrog
        if mode == "per_epoch":
            leaps = np.asarray(leapfrog, np.int64).reshape(n_epochs)
        # the counts the graphs' n epochs take first, a block a shard
        k = len(self.homes)
        firsts = ([leaps[:n]] * k if mode == "per_epoch"
                  else _blocks(leaps, k))
        blocks = [ChainState(*f) for f in zip(*(_blocks(f, k)
                                                for f in carry))]
        steps = _blocks(step_size, k)
        key = (n, tuple(carry.theta.shape), tuple(carry.eta.shape), mode,
               step_scale is not None)
        gens = self._generators(generator)
        entries = self.graphs.get(key)
        if entries is None or entries[0].generator is not generator:
            entries = self.graphs[key] = [
                self._capture(i, blocks[i], steps[i], firsts[i], n, mode,
                              gens[i], step_scale) for i in range(k)]
        state = generator.get_state()
        for g in gens[1:]:
            g.set_state(state)
        for entry, block, eps, leap in zip(entries, blocks, steps, firsts):
            entry.chunk.fill(block, eps, leap, step_scale)
        if self.whole:
            for entry in entries:
                entry.replay()
            return _gathered([e.chunk.result(leaps) for e in entries])
        rows = [None] * k
        for j in range(n_epochs):
            for i, entry in enumerate(entries):
                chunk = entry.chunk
                if mode == "per_epoch" and j:
                    chunk.leap.fill_(int(leaps[j]))
                entry.replay()
                rows[i] = _row(rows[i], EpochTrace(*(
                    None if f is None else f[0] for f in chunk.trace)), j,
                    n_epochs)
        return _gathered([e.chunk.result(leaps, r)
                          for e, r in zip(entries, rows)])

    def _generators(self, generator) -> list:
        """Each shard's generator: the run's for the first shard, and for
        every other one of its home card, made once a run generator."""
        if self.generators[0] is not generator:
            self.generators = [generator] + [torch.Generator(device=hd)
                                             for hd in self.homes[1:]]
        return self.generators

    def _capture(self, i: int, carry: ChainState, step_size, leapfrog,
                 n: int, mode: str, generator, step_scale) -> _Captured:
        """Captures ``n`` epochs of shard ``i``'s body for this key on its
        home (after the shard's warm-up epoch, the first time); the kernel
        counters read afterwards as they read before."""
        t0 = time.perf_counter()
        home, shard = self.homes[i], (i, len(self.homes))
        before = [fn.LAUNCHES for fn in COUNTED]
        try:
            if not self.warm[i]:
                self._warm_up(i, carry, step_size, leapfrog, mode, generator,
                              step_scale)
            chunk = StaticChunk(self.epoch_fns[i], carry, n, mode, self.h,
                                self.tempered, step_scale, home, shard)
            chunk.fill(carry, step_size, leapfrog, step_scale)
            mid = [fn.LAUNCHES for fn in COUNTED]
            graph = self.graph_type(lambda: chunk.run(generator), generator,
                                    home)
            launched = [fn.LAUNCHES - m for fn, m in zip(COUNTED, mid)]
        finally:
            for fn, b in zip(COUNTED, before):
                fn.LAUNCHES = b
        COUNTS.captures += 1
        COUNTS.capture_seconds.append(time.perf_counter() - t0)
        return _Captured(graph, chunk, launched, generator)

    def _warm_up(self, i: int, carry, step_size, leapfrog, mode, generator,
                 step_scale) -> None:
        """One eager epoch of shard ``i``'s body on its home's side stream,
        on a copy of its block; the generator's state is put back
        afterwards."""
        state = generator.get_state()
        home = self.homes[i]
        warm = StaticChunk(self.epoch_fns[i], carry, 1, mode, self.h,
                           self.tempered, step_scale, home,
                           (i, len(self.homes)))
        warm.fill(carry, step_size, leapfrog[:1] if mode == "per_epoch"
                  else leapfrog, step_scale)
        self.graph_type.warm_up(lambda: warm.run(generator), home)
        generator.set_state(state)
        self.warm[i] = True
        COUNTS.warmups += 1


def _row(rows, trace, j: int, n: int):
    """Copies one epoch's ``trace`` (a NamedTuple of ``(C, ...)`` fields
    or None) into row ``j`` of ``rows``, the chunk's ``(n, C, ...)``
    fields, made at the first epoch (None)."""
    if rows is None:
        rows = type(trace)(*(None if f is None else torch.empty(
            (n,) + f.shape, dtype=f.dtype, device=f.device) for f in trace))
    for dst, src in zip(rows, trace):
        if dst is not None:
            dst[j].copy_(src)
    return rows


class _Row(NamedTuple):
    """What the stepped runner copies out of an epoch's trace: theta, the
    trace's eta and ``(C,)`` float fields side by side, and the U-turn
    steps (or None)."""
    theta: torch.Tensor
    packed: torch.Tensor
    uturn: Optional[torch.Tensor]


class SteppedChunk(StaticChunk):
    """An epoch of a K3 or plain-path ``epoch_fn``'s parts
    (``gibbs.EpochParts``) over ``StaticChunk``'s buffers, as three
    bodies that each read and update static tensors, so that each can be
    captured once and replayed: ``head`` draws the epoch (the fleet's,
    keeping this shard's rows) and starts the main block into ``flight``;
    ``step`` runs one leapfrog step, which updates the state's ``q`` and
    ``v`` in place (its Kahan carries, U-turn steps and counter are copied
    back) and leaves the new value and gradient in ``evaluation``, the
    tail's input; ``tail`` ends the epoch, copies the new carry into the
    static one and leaves the epoch's ``_Row`` in ``trace``. The step size
    buffer takes the carry's dtype (the eager epoch's step is a float or a
    tensor of that dtype); the counts buffer is read for per-chain counts
    only (the host counts the others' steps), which the tail also divides
    the SJD by, as the eager epoch does."""

    def __init__(self, epoch_fn, carry: ChainState, mode: str,
                 h: Optional[int], tempered: bool,
                 step_scale: Optional[torch.Tensor] = None,
                 device=None, shard: tuple = (0, 1)):
        super().__init__(epoch_fn, carry, 1, mode, h, tempered, step_scale,
                         device, shard)
        self.parts = epoch_fn.parts
        self.eps = torch.empty_like(self.carry.theta[:, 0])
        self.flight = self.evaluation = None

    def _fill_leap(self, leapfrog) -> None:
        if self.mode == "per_chain":
            super()._fill_leap(leapfrog)

    def _counts(self) -> Optional[torch.Tensor]:
        return self.leap if self.mode == "per_chain" else None

    def head(self, generator: Optional[torch.Generator]) -> None:
        c, d = self.carry.theta.shape
        i, k = self.shard
        draws = draw_epoch(generator, c * k, d, self.h,
                           self.carry.theta.dtype, self.carry.theta.device,
                           self.tempered)
        if k > 1:
            draws = EpochDraws(*(None if f is None else f[i * c:(i + 1) * c]
                                 for f in draws))
        self.flight = self.parts.head(self.carry, self.eps, generator,
                                      draws=draws,
                                      leapfrog_dev=self._counts(),
                                      step_scale=self.scale)

    def step(self) -> None:
        new = self.parts.step(self.carry, self.flight)
        for dst, src in zip(self.flight.leap, new._replace(lp=None, g=None)):
            if src is not None and src is not dst:
                dst.copy_(src)
        self.evaluation = (new.lp, new.g)

    def skip(self) -> None:
        """An epoch of no step: the tail reads the head's evaluation."""
        start = (self.flight.leap.lp, self.flight.leap.g)
        if self.evaluation is None:
            self.evaluation = tuple(t.clone() for t in start)
        for dst, src in zip(self.evaluation, start):
            dst.copy_(src)

    def tail(self) -> None:
        lp, g = self.evaluation
        flight = self.flight._replace(leap=self.flight.leap._replace(
            lp=lp, g=g))
        carry, trace = self.parts.tail(self.carry, flight, self._counts())
        for dst, src in zip(self.carry, carry):
            dst.copy_(src)
        self.trace = _Row(trace.theta, torch.cat(
            [trace.eta] + [f[:, None] for f in (
                trace.sjd, trace.main_accept, trace.hyper_accept,
                trace.swap_accept) if f is not None], 1), trace.uturn)

    def epoch(self, generator, n_steps: int) -> None:
        """The bodies in turn, eagerly: an epoch of ``n_steps``."""
        self.head(generator)
        for _ in range(n_steps):
            self.step()
        if not n_steps:
            self.skip()
        self.tail()

    def unpack(self, rows: _Row) -> EpochTrace:
        """The chunk's ``EpochTrace`` from its rows of ``_Row``s."""
        h = self.carry.eta.shape[1]
        cols = [rows.packed[..., j].contiguous()
                for j in range(h, rows.packed.shape[-1])]
        return EpochTrace(rows.theta, rows.packed[..., :h].contiguous(),
                          *cols[:3], cols[3] if self.tempered else None,
                          rows.uturn)


class SteppedChunkRunner(GraphChunkRunner):
    """``run_chunk(carry, step_size, leapfrog, n_epochs, generator,
    step_scale=None) -> (carry, trace)`` of parallel/chains.py where K3 or
    the plain path runs the main block: three graphs a chain shard and key
    (``SteppedChunk``'s head, step and tail, captured once on the shard's
    home), and an epoch is a replay of the head, ``L`` replays of the step
    and one of the tail, ``L`` the shared count, the shard's largest
    per-chain count or a U-turn run's count of the epoch, from the host.
    The key is the carry's shapes and dtype, the counts' form and whether a
    step scale is given: neither ``L`` nor the chunk's length. Only the
    head draws, so only it registers the shard's generator. Each epoch's
    trace is copied out of the tail's outputs before the next head replays
    (a later capture in the pool may have reused an earlier one's
    temporaries). ``n_chains``: the fleet the workspace gate was decided
    for (None: no gate), which a chunk must carry.

    ``peers``: each chain shard's ``DataPeers`` (None, or one peer: no
    data axis). Over more than one peer each part is a ``SegmentedPart``,
    split at its sums over the peers, and the warm-up epoch runs each
    peer's evaluation on its own card's side stream (where K3 makes its
    tables and the stream its cuBLAS workspace). Every graph of a card
    (a shard's parts on its home, a peer's evaluations) takes the card's
    one memory pool (``pools``, by card), captured and replayed in one
    order."""

    runner = "stepped"

    def __init__(self, epoch_fns, homes, *, h: Optional[int],
                 tempered: bool, per_epoch_leapfrog: bool,
                 n_chains: Optional[int] = None, peers=None,
                 graph_type=CudaGraph):
        super().__init__(epoch_fns, homes, h=h, tempered=tempered,
                         per_epoch_leapfrog=per_epoch_leapfrog, whole=False,
                         graph_type=graph_type)
        if any(getattr(f, "parts", None) is None for f in self.epoch_fns):
            raise ValueError("the stepped runner replays the parts of a K3 "
                             "or plain-path epoch; K1 takes GraphChunkRunner")
        self.n_chains = n_chains
        self.peers = [p if p is not None and len(p) > 1 else None
                      for p in (peers or [None] * len(self.homes))]
        self.pools = {}

    def __call__(self, carry: ChainState, step_size, leapfrog,
                 n_epochs: int, generator: torch.Generator,
                 step_scale: Optional[torch.Tensor] = None):
        if generator is None:
            raise ValueError("the graph runner draws from the run's "
                             "torch.Generator, which it registers with "
                             "each graph; pass one")
        if self.n_chains is not None and carry.theta.shape[0] != \
                self.n_chains:
            raise ValueError(f"the stepped runner was built (and its "
                             f"workspace gate decided) for {self.n_chains} "
                             f"chains, got {carry.theta.shape[0]}")
        mode = leap_mode(leapfrog, self.per_epoch_leapfrog)
        k = len(self.homes)
        if mode == "per_epoch":
            leaps = np.asarray(leapfrog, np.int64).reshape(n_epochs)
            firsts = [leaps[:1]] * k
            counts = [[int(n) for n in leaps]] * k
        else:
            leaps = leapfrog
            firsts = _blocks(leapfrog, k)
            counts = [[int(np.max(b))] * n_epochs for b in firsts]
        blocks = [ChainState(*f) for f in zip(*(_blocks(f, k)
                                                for f in carry))]
        steps = _blocks(step_size, k)
        key = (tuple(carry.theta.shape), tuple(carry.eta.shape),
               carry.theta.dtype, mode, step_scale is not None)
        gens = self._generators(generator)
        entries = self.graphs.get(key)
        if entries is None or entries[0][0].generator is not generator:
            entries = self.graphs[key] = [
                self._capture(i, blocks[i], steps[i], firsts[i], mode,
                              gens[i], step_scale) for i in range(k)]
        state = generator.get_state()
        for g in gens[1:]:
            g.set_state(state)
        for graphs_i, block, eps, leap in zip(entries, blocks, steps,
                                              firsts):
            graphs_i[0].chunk.fill(block, eps, leap, step_scale)
        rows = [None] * k
        for j in range(n_epochs):
            for i, (head, step, tail) in enumerate(entries):
                head.replay()
                for _ in range(counts[i][j]):
                    step.replay()
                if not counts[i][j]:
                    head.chunk.skip()
                tail.replay()
                rows[i] = _row(rows[i], head.chunk.trace, j, n_epochs)
        return _gathered([e[0].chunk.result(leaps, e[0].chunk.unpack(r))
                          for e, r in zip(entries, rows)])

    def pool(self, card):
        """The memory pool of a card, made at its first graph."""
        card = torch.device(card)
        if card not in self.pools:
            self.pools[card] = self.graph_type.new_pool()
        return self.pools[card]

    def _capture(self, i: int, carry: ChainState, step_size, leapfrog,
                 mode: str, generator, step_scale) -> list:
        """Captures shard ``i``'s head, step and tail for this key on its
        home, in the card's pool, each split at its sums over the shard's
        data peers where it has several (after the shard's warm-up epoch,
        the first time); the kernel counters read afterwards as they read
        before."""
        t0 = time.perf_counter()
        home, shard, peers = self.homes[i], (i, len(self.homes)), \
            self.peers[i]
        before = [fn.LAUNCHES for fn in COUNTED]
        captured, seconds = [], []
        try:
            if not self.warm[i]:
                self._warm_up(i, carry, step_size, leapfrog, mode, generator,
                              step_scale)
            chunk = SteppedChunk(self.epoch_fns[i], carry, mode, self.h,
                                 self.tempered, step_scale, home, shard)
            chunk.fill(carry, step_size, leapfrog, step_scale)
            for body, gen in ((lambda: chunk.head(generator), generator),
                              (chunk.step, None), (chunk.tail, None)):
                mid = [fn.LAUNCHES for fn in COUNTED]
                if peers is None:
                    graph = self.graph_type(body, gen, home,
                                            pool=self.pool(home))
                else:
                    graph = SegmentedPart(body, gen, peers, self.graph_type,
                                          self.pool)
                captured.append(_Captured(
                    graph, chunk, [fn.LAUNCHES - m for fn, m in
                                   zip(COUNTED, mid)], generator))
                seconds.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
        finally:
            for fn, b in zip(COUNTED, before):
                fn.LAUNCHES = b
        COUNTS.captures += len(captured)
        COUNTS.capture_seconds.extend(seconds)
        return captured

    def _warm_up(self, i: int, carry, step_size, leapfrog, mode, generator,
                 step_scale) -> None:
        """One eager epoch of shard ``i``'s bodies, with one leapfrog step,
        on its home's side stream, each data peer's evaluations on its own
        card's side stream, on a copy of its block; the generator's state
        is put back afterwards."""
        state = generator.get_state()
        home, peers = self.homes[i], self.peers[i]
        warm = SteppedChunk(self.epoch_fns[i], carry, mode, self.h,
                            self.tempered, step_scale, home,
                            (i, len(self.homes)))
        warm.fill(carry, step_size, leapfrog, step_scale)
        if peers is not None:
            peers.mode = functools.partial(self._warm_sum, peers)
        try:
            self.graph_type.warm_up(lambda: warm.epoch(generator, 1), home)
        finally:
            if peers is not None:
                peers.mode = None
        generator.set_state(state)
        self.warm[i] = True
        COUNTS.warmups += 1

    def _warm_sum(self, peers, fns, args):
        """A sum of the warm-up epoch: each peer's part on its card's side
        stream, summed on the home as the eager sum does."""
        parts = []
        for fn, d in zip(fns, peers.devices):
            self.graph_type.warm_up(
                lambda: parts.append(fn(*to_device(args, d))), d)
        return data_sum(parts, peers.home)


def _gathered(results: list):
    """The shards' ``(carry, trace)`` pairs as the fleet's, in chain order
    on the first shard's device (one shard's as they are)."""
    carries, traces = zip(*results)
    return (ChainState(*(gather(list(f)) for f in zip(*carries))),
            EpochTrace(*(None if f[0] is None else gather(list(f), dim=1)
                         for f in zip(*traces))))
