"""The chunk runner as a captured CUDA graph.

Counterpart of the JAX package's compiled chunk: there a chunk of epochs
(one GP-adapter cycle) is ``jax.jit`` of a ``lax.scan`` over ``epoch_fn``
with ``n_epochs`` static (``tensorbnn_tpu/parallel/chains.py:207-228``,
``:272-274``), compiled once for each ``n_epochs`` and dispatched once.
Here a chunk is captured once for each key as a ``torch.cuda.CUDAGraph``
and replayed, so the host issues one launch where the eager runner issues
every kernel and glue operation of every epoch.

Where it applies (``graph_runner_applies``, decided from the configuration
when the runner is built): K1 runs the main block, the mesh is 1x1 and the
chains live on a CUDA device. The K3 and plain main blocks, a mesh with
more than one shard or data peer, and the CPU keep the eager runner
(parallel/chains.py).

A key is the graph's epochs, the carry's shape, the form of the leapfrog
counts (shared, per chain or per epoch) and whether a step scale is given;
the run's generator is registered with the graph, so another generator
captures anew. A graph holds the whole chunk, the port of ``jit(scan)``,
unless the hyper block runs the plain ``torch.func`` potential
(``whole_chunk``): that block issues ~6,300 launches an epoch at the JAX
bench's ``classification``, so a graph of its 60-epoch chunk would take as
long to capture as the chunk takes to run eagerly. There a graph holds one
epoch, replayed ``n_epochs`` times, each replay's trace copied into the
chunk's.

``StaticChunk`` is the body a graph captures. Every chunk argument enters
through its static buffers, which the runner fills before each replay: the
carry, the step size ``(C,)`` float32, the leapfrog counts (``(C,)`` int32,
or the ``(n,)`` per-epoch counts of a U-turn run, epoch j reading slot j)
and the step scale. Nothing of a chunk is baked into a graph as a Python
scalar, so a graph captured at one ``(eps, L)`` runs another. The body's
last operations copy the new carry into the static carry; the traces are
the graph's outputs, and the runner hands out copies of both.

Three things keep a replay bit-equal to the eager runner:

* the epochs draw inside the graph from the run's generator
  (``CUDAGraph.register_generator_state``), in ``draw_epoch``'s order: a
  replay draws what the eager runner draws and leaves the generator's state
  (which a checkpoint stores) where the eager run leaves it;
* the SJD of a shared or per-epoch count is divided after the replay by
  the count's square root as a Python float, the eager epoch's own
  operation (torch on CUDA multiplies by the float's float32 reciprocal,
  which a division by a device tensor does not reproduce); per-chain counts
  divide inside the graph, as the eager epoch does;
* the kernel wrappers count their launches in Python, so at capture: the
  runner takes the capture's counts back out and adds them at each replay,
  so the counters read as the eager runner's. ``COUNTS`` keeps the
  captures (with their seconds), replays and warm-up epochs.

A runner's first capture follows one eager epoch on the device's side
stream (the one stream every capture runs on), on a copy of the carry,
with the generator's state put back afterwards and its launches
uncounted: it creates what a kernel creates on its first call (K1's prior
table on the device, the library's first launch, the stream's cuBLAS
workspace, which the process then keeps: 32 MiB). Capture runs in
"global" mode, so a forbidden call during capture (a copy from pageable
memory, a synchronization, ``.item()``) raises. A failed capture or replay
raises; nothing falls back to the eager runner.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
from tensorbnn_tpu_torch.parallel.mesh import CHAIN_AXIS, DATA_AXIS
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochTrace, \
    draw_epoch

#: the kernel wrappers whose ``LAUNCHES`` a replay adds its captured
#: launches to
COUNTED = (fused_mlp.fused_trajectory, fused_hyper.fused_hyper_trajectory,
           fused_mlp.fused_potential)


class GraphCounts:
    """What the graph runners did since the last ``reset``: graphs
    captured, each capture's seconds (its warm-up epoch included), replays
    and warm-up epochs."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.captures = 0
        self.replays = 0
        self.warmups = 0
        self.capture_seconds = []

    def as_dict(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "warmups": self.warmups,
                "capture_ms": [1e3 * s for s in self.capture_seconds]}


COUNTS = GraphCounts()


def graph_runner_applies(batched_main_traj, mesh, device) -> bool:
    """Whether a chunk runs as a captured graph: K1 runs the main block
    (``batched_main_traj``), the mesh (None: no mesh) is 1x1 and the chains
    live on a CUDA ``device``."""
    one = mesh is None or (mesh.shape[CHAIN_AXIS], mesh.shape[DATA_AXIS]) \
        == (1, 1)
    return (batched_main_traj is not None and one
            and torch.device(device).type == "cuda")


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
    tensor whose shape the scale buffer takes (None: no scale)."""

    def __init__(self, epoch_fn, carry: ChainState, n: int, mode: str,
                 h: Optional[int], tempered: bool,
                 step_scale: Optional[torch.Tensor] = None):
        c = carry.theta.shape[0]
        dev = carry.theta.device
        self.epoch_fn, self.n, self.mode = epoch_fn, n, mode
        self.h, self.tempered = h, tempered
        self.carry = ChainState(*(f.clone() for f in carry))
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
                                           dtype=torch.float32))
        else:
            self.eps.fill_(float(step_size))
        if self.mode == "shared":
            self.leap.fill_(int(leapfrog))
        else:
            self.leap.copy_(torch.as_tensor(
                np.asarray(leapfrog, np.int64).reshape(-1),
                dtype=torch.int32))
        if self.scale is not None:
            self.scale.copy_(step_scale)

    def run(self, generator: Optional[torch.Generator]) -> None:
        """The body: ``n`` epochs from the static carry, each drawing from
        ``generator``; the traces stacked ``(n, C, ...)`` into
        ``self.trace`` and the new carry copied into the static one."""
        c, d = self.carry.theta.shape
        dtype, dev = self.carry.theta.dtype, self.carry.theta.device
        state, traces = self.carry, []
        for j in range(self.n):
            draws = draw_epoch(generator, c, d, self.h, dtype, dev,
                               self.tempered)
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
    run's ``generator`` registered with it; ``replay`` runs it on the
    current stream. ``warm_up`` runs a function eagerly on the side stream
    (torch's recipe before a first capture)."""

    def __init__(self, fn, generator: torch.Generator, device):
        self.graph = torch.cuda.CUDAGraph()
        device = torch.device(device)
        if generator is not torch.cuda.default_generators[device.index]:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, stream=_side_stream(device),
                              capture_error_mode="global"):
            fn()

    def replay(self) -> None:
        self.graph.replay()

    @staticmethod
    def warm_up(fn, device) -> None:
        current = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)


class _Captured:
    """One key's graph, its body and the launches it captured."""

    def __init__(self, graph, chunk: StaticChunk, launched: list,
                 generator):
        self.graph, self.chunk = graph, chunk
        self.launched, self.generator = launched, generator

    def replay(self) -> None:
        self.graph.replay()
        for fn, k in zip(COUNTED, self.launched):
            fn.LAUNCHES += k
        COUNTS.replays += 1


class GraphChunkRunner:
    """``run_chunk(carry, step_size, leapfrog, n_epochs, generator,
    step_scale=None) -> (carry, trace)`` of parallel/chains.py through
    captured graphs of ``epoch_fn`` (see the module docstring): a whole
    chunk a graph when ``whole``, else one epoch. ``h``, ``tempered`` as
    ``StaticChunk``'s; ``per_epoch_leapfrog`` as the runner's.
    ``graph_type`` captures and replays (``CudaGraph``; the CPU tests give
    a stand-in that reruns the body at each replay)."""

    runner = "graph"

    def __init__(self, epoch_fn, *, h: Optional[int], tempered: bool,
                 per_epoch_leapfrog: bool, whole: bool,
                 graph_type=CudaGraph):
        self.epoch_fn, self.h, self.tempered = epoch_fn, h, tempered
        self.per_epoch_leapfrog, self.whole = per_epoch_leapfrog, whole
        self.graph_type = graph_type
        self.graphs = {}
        self.warm = False

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
        # the counts the graph's n epochs take first
        first = leaps[:n] if mode == "per_epoch" else leaps
        key = (n, tuple(carry.theta.shape), tuple(carry.eta.shape), mode,
               step_scale is not None)
        entry = self.graphs.get(key)
        if entry is None or entry.generator is not generator:
            entry = self.graphs[key] = self._capture(
                carry, step_size, first, n, mode, generator, step_scale)
        chunk = entry.chunk
        chunk.fill(carry, step_size, first, step_scale)
        if self.whole:
            entry.replay()
            return chunk.result(leaps)
        rows = None
        for j in range(n_epochs):
            if mode == "per_epoch" and j:
                chunk.leap.fill_(int(leaps[j]))
            entry.replay()
            if rows is None:
                rows = EpochTrace(*(None if f is None else torch.empty(
                    (n_epochs,) + f.shape[1:], dtype=f.dtype,
                    device=f.device) for f in chunk.trace))
            for dst, src in zip(rows, chunk.trace):
                if dst is not None:
                    dst[j].copy_(src[0])
        return chunk.result(leaps, rows)

    def _capture(self, carry: ChainState, step_size, leapfrog, n: int,
                 mode: str, generator, step_scale) -> _Captured:
        """Captures ``n`` epochs of the body for this key (after the
        runner's warm-up epoch, the first time); the kernel counters read
        afterwards as they read before."""
        t0 = time.perf_counter()
        dev = carry.theta.device
        before = [fn.LAUNCHES for fn in COUNTED]
        try:
            if not self.warm:
                self._warm_up(carry, step_size, leapfrog, mode, generator,
                              step_scale)
            chunk = StaticChunk(self.epoch_fn, carry, n, mode, self.h,
                                self.tempered, step_scale)
            chunk.fill(carry, step_size, leapfrog, step_scale)
            mid = [fn.LAUNCHES for fn in COUNTED]
            graph = self.graph_type(lambda: chunk.run(generator), generator,
                                    dev)
            launched = [fn.LAUNCHES - m for fn, m in zip(COUNTED, mid)]
        finally:
            for fn, b in zip(COUNTED, before):
                fn.LAUNCHES = b
        COUNTS.captures += 1
        COUNTS.capture_seconds.append(time.perf_counter() - t0)
        return _Captured(graph, chunk, launched, generator)

    def _warm_up(self, carry, step_size, leapfrog, mode, generator,
                 step_scale) -> None:
        """One eager epoch of the body on a side stream, on a copy of the
        carry; the generator's state is put back afterwards."""
        state = generator.get_state()
        warm = StaticChunk(self.epoch_fn, carry, 1, mode, self.h,
                           self.tempered, step_scale)
        warm.fill(carry, step_size, leapfrog[:1] if mode == "per_epoch"
                  else leapfrog, step_scale)
        self.graph_type.warm_up(lambda: warm.run(generator),
                                carry.theta.device)
        generator.set_state(state)
        self.warm = True
        COUNTS.warmups += 1
