"""A tile-mesh chunk as one captured CUDA graph: the port's counterpart of
``jax.jit`` over a chunk (``climate_sim_tpu/parallel/halo.py:187-200``).

The JAX package compiles each chunk length of a sharded advance into one
device program over every device of its mesh, its passes, kernels and
``ppermute`` exchanges included, and its driver compiles every length a
run uses before the timed loop (``climate_sim_tpu/runtime/driver.py:531-557``).
The port dispatches a chunk from Python, pass by pass and tile by tile;
:class:`GraphedChunk` records one chunk of that dispatch once, as one CUDA
graph that spans every card of the process's tiles (:class:`CudaGraphs`),
and replays it with one host call.

The capture rule (:func:`capture_rule`) is decided from the mesh and its
transport, before anything is captured:

* captured: the tiles of this process lie on CUDA cards, one or several,
  and the tiles of other processes, if any, are reached over NCCL (whose
  point-to-point operations are recorded into the graph) from a rank of
  one card;
* eager: tiles on the CPU; a gloo transport, which stages every payload
  through the host and waits on it there; a rank of a multi-process run
  that holds several cards (NCCL's capture with several devices a rank
  is untried);
* eager everywhere inside :func:`disable_graphs`, the counterpart of
  ``jax.disable_jit()``.

Nothing falls back: a capture or a replay that fails raises the CUDA or
torch error.

A graph replays its launches on its own static tensors, so
:class:`GraphedChunk` keeps the functional contract of ``advance(chunk)``
(no call's result is overwritten by a later call) by copying the caller's
tiles into the static input (unless they already are that buffer) and
returning fresh copies of the static output: two field copies a chunk.

Each advance's chunks share one memory pool: they replay one after
another on one stream, and every tensor that outlives a replay (the static
input and output) stays held by its chunk.

The host-side counters (each kernel wrapper's ``launches``, and the
mesh's ``copies`` and ``rounds``; :class:`..parallel.halo.ChunkCounts`)
count what the chunk launched and moved: the warm-up and the capture count
nothing, and each replay adds what the captured chunk counted while it was
recorded.  That count is held to the graph itself at capture: the graph's
kernel nodes of the stencil kernel (read from the captured graph through
the CUDA driver) must equal the launches the wrappers counted, and lie on
every card of the chunk, or the capture raises.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import time
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..parallel.halo import CHUNK_KERNEL, ChunkCounts

Tiles = List[List[Optional[torch.Tensor]]]

_disabled = 0


@contextlib.contextmanager
def disable_graphs():
    """Within the block, every mesh advance built or called runs its
    chunks eagerly, pass by pass from Python (``jax.disable_jit()``'s
    counterpart); nests, and restores on every exit."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def graphs_disabled() -> bool:
    return _disabled > 0


def capture_rule(mesh) -> Optional[str]:
    """None when this process's chunks on ``mesh`` are captured, else why
    they stay eager (the words the driver's banner prints)."""
    if graphs_disabled():
        return "graphs disabled"
    devices = mesh.distinct_devices()
    if not devices:
        return "no tile in this process"
    if any(d.type != "cuda" for d in devices):
        return "tiles on the CPU"
    transport = mesh.transport
    if transport is None:
        return None
    if transport.kind != "nccl":
        return f"{transport.kind} transport, host-staged"
    if len(devices) > 1:
        return "a rank on several cards"
    return None


# The CUDA driver's graph node types and kernel-node parameters (cuda.h).
_NODE_KERNEL, _NODE_GRAPH = 0, 4


class _KernelNodeParams(ctypes.Structure):
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _check(status: int, what: str) -> None:
    if status:
        raise RuntimeError(f"CUDA driver error {status} in {what}")


def graph_kernel_names(driver, graph: int) -> collections.Counter:
    """The kernel nodes of a captured graph (a ``CUgraph`` handle), counted
    by (the kernel's symbol, the node's context: its card's ``CUcontext``),
    child graphs included, through the CUDA driver library ``driver``
    (``libcuda``)."""
    names: collections.Counter = collections.Counter()
    count = ctypes.c_size_t(0)
    _check(driver.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(count)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(driver.cuGraphGetNodes(ctypes.c_void_p(graph), nodes, ctypes.byref(count)),
           "cuGraphGetNodes")
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check(driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value == _NODE_GRAPH:
            child = ctypes.c_void_p()
            _check(driver.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node),
                                                        ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
            names.update(graph_kernel_names(driver, child.value))
        elif kind.value == _NODE_KERNEL:
            params = _KernelNodeParams()
            _check(driver.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                        ctypes.byref(params)),
                   "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            if params.func:
                _check(driver.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                       "cuFuncGetName")
            else:
                _check(driver.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                       "cuKernelGetName")
            names[(name.value.decode(), params.ctx)] += 1
    return names


def _card_context(driver, device: torch.device) -> int:
    """The ``CUcontext`` of a card (its primary context, the one the CUDA
    runtime and torch launch in)."""
    ctx = ctypes.c_void_p()
    with torch.cuda.device(device):
        _check(driver.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    return ctx.value


@contextlib.contextmanager
def _current(streams: Sequence[torch.cuda.Stream]):
    """Each of ``streams`` the current stream of its card within the block."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


def _release_pools(devices: Sequence[int], pool) -> None:
    for d in devices:
        torch._C._cuda_releasePool(d, pool)


@contextlib.contextmanager
def _routed(graph, devices: Sequence[torch.device], pool):
    """Within the block, this thread's allocations on each of ``devices``
    go to that card's pool of id ``pool``; each card's pool is held until
    ``graph`` is freed.  These are ``torch.cuda.use_mem_pool``'s calls,
    except that it releases the pool on exit, after which the allocator
    may hand a block the graph still reads to later work."""
    for d in devices:
        torch._C._cuda_beginAllocateCurrentThreadToPool(d.index, pool)
    weakref.finalize(graph, _release_pools, [d.index for d in devices], pool)
    try:
        yield
    finally:
        for d in devices:
            torch._C._cuda_endAllocateToPool(d.index, pool)


class Graph(NamedTuple):
    """A captured CUDA graph and the cards it spans (the first is the card
    of its capture stream, where it is launched)."""
    cuda: object
    devices: Tuple[torch.device, ...]


class CudaGraphs:
    """The capture primitive: ``torch.cuda``'s graphs, one graph over the
    cards of a chunk's tiles (one card or several)."""

    def pool(self):
        """A memory pool id for the captures of one advance, the same id on
        every card."""
        return torch.cuda.graph_pool_handle()

    def warm_up(self, devices: Sequence[torch.device], fn: Callable[[], object]) -> None:
        """``fn()`` once with a side stream current on every card (the
        recipe before a capture).  Its copies between cards enable peer
        access here, so none is enabled inside the capture."""
        sides = [torch.cuda.Stream(d) for d in devices]
        for d, s in zip(devices, sides):
            s.wait_stream(torch.cuda.current_stream(d))
        with _current(sides):
            fn()
        for d, s in zip(devices, sides):
            torch.cuda.current_stream(d).wait_stream(s)

    def capture(self, devices: Sequence[torch.device], fn: Callable[[], Tiles], pool):
        """(:class:`Graph`, ``fn()``'s result) with ``fn``'s work on every
        card recorded into one graph, kept uninstantiated until
        :meth:`instantiate` so that :meth:`kernel_nodes` can read it.

        The capture stream lives on the first card.  Every other card gets
        a stream that waits on an event recorded on it, which joins it to
        the capture, and is that card's current stream while ``fn`` runs
        (so a copy between cards records its events on captured streams);
        each is joined back before the capture ends.  ``torch.cuda.graph``
        sends the first card's allocations to ``pool``, :func:`_routed`
        the other cards'.  The capture errs only on this thread's unsafe
        calls, so a process group's watchdog thread may go on."""
        first, others = devices[0], tuple(devices[1:])
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.device(first), torch.cuda.graph(
                graph, pool=pool, stream=torch.cuda.Stream(first),
                capture_error_mode="thread_local"), _routed(graph, others, pool):
            capturing = torch.cuda.current_stream(first)
            joined = [torch.cuda.Stream(d) for d in others]
            for s in joined:
                s.wait_stream(capturing)
            with _current(joined):
                out = fn()
            for s in joined:
                capturing.wait_stream(s)
        return Graph(graph, (first, *others)), out

    def kernel_nodes(self, graph: Graph) -> collections.Counter:
        """The captured graph's kernel nodes, counted by (symbol, card);
        a node in no card's context of the graph counts under None."""
        driver = ctypes.CDLL("libcuda.so.1")
        cards = {_card_context(driver, d): d for d in graph.devices}
        nodes: collections.Counter = collections.Counter()
        for (name, ctx), n in graph_kernel_names(driver, graph.cuda.raw_cuda_graph()).items():
            nodes[(name, cards.get(ctx))] += n
        return nodes

    def instantiate(self, graph: Graph) -> None:
        graph.cuda.instantiate()

    def replay(self, graph: Graph) -> None:
        """One launch of the graph on the first card's current stream,
        after the work queued so far on every card's current stream (the
        copies into the static input among it); every card's current
        stream then waits for the launch (the copies out of the static
        output come after it)."""
        first, others = graph.devices[0], graph.devices[1:]
        launch = torch.cuda.current_stream(first)
        for d in others:
            launch.wait_stream(torch.cuda.current_stream(d))
        with torch.cuda.device(first):
            graph.cuda.replay()
        for d in others:
            torch.cuda.current_stream(d).wait_stream(launch)


CUDA_GRAPHS = CudaGraphs()


class _Captured(NamedTuple):
    graph: object
    signature: tuple
    inputs: Tiles         # the static input, which each call copies into
    outputs: Tiles        # the static output, which each replay overwrites
    delta: ChunkCounts    # what one replay adds to the counters
    kernel_nodes: collections.Counter  # the graph's kernel nodes by (symbol, card)
    seconds: float        # the warm-up and the capture, on the host's clock
    memory: Dict[torch.device, int]  # bytes each card's reserved memory grew


def _signature(tiles: Tiles):
    return tuple(tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                       for t in row) for row in tiles)


def _reserved(devices: Sequence[torch.device]) -> Dict[torch.device, int]:
    """The memory the allocator holds on each CUDA card of ``devices``, its
    cache emptied first (a capture's growth is then what it added)."""
    cards = [d for d in devices if d.type == "cuda"]
    if cards:
        torch.cuda.empty_cache()
    return {d: torch.cuda.memory_reserved(d) for d in cards}


class Pool:
    """One memory pool for the chunks of an advance, made at the first
    capture."""

    def __init__(self):
        self.handle = None


class GraphedChunk:
    """``body`` (tiles -> tiles, one chunk of a mesh advance) captured once,
    on the tile signature (shapes, dtypes, devices) of its first tiles: at
    :meth:`capture` (the driver's, before its timed loop) or else at the
    first call.  ``chunk`` is its step count; ``pool`` the memory pool it
    shares with the advance's other chunks.  The capture primitive is
    :data:`CUDA_GRAPHS` (a test stands a fake in for it on the CPU)."""

    def __init__(self, body: Callable[[Tiles], Tiles], mesh, chunk: int,
                 pool: Optional[Pool] = None):
        self.body, self.mesh, self.chunk = body, mesh, chunk
        self.pool = pool if pool is not None else Pool()
        self.graphs = CUDA_GRAPHS
        self.captured: Optional[_Captured] = None

    def capture(self, tiles: Tiles) -> _Captured:
        """Warm up and record the chunk on static copies of ``tiles`` (once),
        one graph over every card of the tiles; the counters stay as they
        were.  Raises when the graph's stencil kernel nodes differ from the
        launches its wrappers counted or miss a card, or when ``tiles``
        differ in signature from the captured chunk's."""
        sig = _signature(tiles)
        if self.captured is not None:
            if sig != self.captured.signature:
                raise ValueError(f"a {self.chunk}-step chunk captured for tiles"
                                 f" {self.captured.signature} was called on tiles {sig}")
            return self.captured
        devices = self.mesh.distinct_devices()
        held = _reserved(devices)
        t0 = time.perf_counter()
        before = ChunkCounts.read(self.mesh)
        inputs = [[None if t is None else t.clone() for t in row] for row in tiles]
        self.graphs.warm_up(devices, lambda: self.body(inputs))
        if self.pool.handle is None:
            self.pool.handle = self.graphs.pool()
        warm = ChunkCounts.read(self.mesh)
        graph, outputs = self.graphs.capture(devices, lambda: self.body(inputs),
                                             self.pool.handle)
        delta = ChunkCounts.read(self.mesh) - warm
        before.restore(self.mesh)
        nodes = self.graphs.kernel_nodes(graph)
        cards = collections.Counter()
        for (name, card), n in nodes.items():
            if CHUNK_KERNEL in name:
                cards[card] += n
        recorded = sum(cards.values())
        if recorded != delta.kernel_launches:
            raise RuntimeError(
                f"the captured {self.chunk}-step chunk holds {recorded} {CHUNK_KERNEL}"
                f" nodes, but its wrappers counted {delta.kernel_launches} launches")
        if recorded and set(cards) != set(devices):
            raise RuntimeError(
                f"the captured {self.chunk}-step chunk's {CHUNK_KERNEL} nodes lie on"
                f" {dict(cards)}, not on every card of its tiles {devices}")
        self.graphs.instantiate(graph)
        seconds = time.perf_counter() - t0
        memory = {d: n - held[d] for d, n in _reserved(devices).items()}
        self.captured = _Captured(graph, sig, inputs, outputs, delta, nodes, seconds, memory)
        return self.captured

    def __call__(self, tiles: Tiles) -> Tiles:
        """One replay of the chunk on ``tiles``; fresh output tiles."""
        done = self.capture(tiles)
        for row, static_row in zip(tiles, done.inputs):
            for t, static in zip(row, static_row):
                if t is not None and t is not static:
                    static.copy_(t)
        # Restored, then added to: whatever the primitive's replay counts
        # itself (nothing on the card), a replay counts its chunk's delta,
        # which the capture held to the graph's kernel nodes.
        counts = ChunkCounts.read(self.mesh)
        self.graphs.replay(done.graph)
        counts.restore(self.mesh)
        done.delta.add(self.mesh)
        return [[None if t is None else t.clone() for t in row] for row in done.outputs]
