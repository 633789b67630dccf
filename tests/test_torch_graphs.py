"""The port's captured mesh chunks (``climate_sim_tpu_torch.runtime.graphs``)
on the CPU: the bookkeeping around the CUDA graph, not the graph.

There is no card here, so a stand-in for ``torch.cuda``'s graphs
(:class:`FakeGraphs`) takes the capture primitive's place: its capture
runs the chunk once on the static input and keeps it, and its replay runs
it again and writes the result into the static output tensors, as a
replayed graph overwrites them.  Several cards are CPU devices of
distinct indices (``cpu:0`` .. ``cpu:3``, :data:`FAKE_CARDS`), which a mesh
counts as distinct devices while torch computes on the CPU.  With it, and
the capture rule forced to capture, the tests hold:

* the chunk lengths the driver captures before its timed loop to the set
  the JAX driver compiles for the same config (``advance(k)`` spied on in
  both);
* ``advance(chunk)`` cached per length;
* the capture rule on mesh and transport stand-ins;
* a chunk over several cards handed to the primitive with every card, in
  mesh order, and held to the JAX package's sharded run;
* the primitive itself (:class:`..runtime.graphs.CudaGraphs`) over a
  recording stand-in for ``torch.cuda`` (:class:`FakeCuda`): warm-up,
  fork, pools, join and the replay's waits on every card, in order;
* the counters (the kernel wrappers' launches, ``mesh.copies``) after
  warm-up, capture and N replays equal to the eager run's, and the tiles
  bit-identical;
* the functional contract: a later call never overwrites an earlier
  result;
* ``disable_graphs()`` restored on every exit.

On the CPU the wrappers take their plain versions and count nothing, so
the kernel entries that halo calls are wrapped to count a launch each.
"""

import collections
import contextlib
import ctypes
import dataclasses
import gc
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.config import merged_config as jmerged_config
from climate_sim_tpu.parallel import mesh as jmesh
from climate_sim_tpu.runtime import driver as jdriver

from climate_sim_tpu_torch.config import merged_config
from climate_sim_tpu_torch.convert import from_reference_sharded
from climate_sim_tpu_torch.ops import cuda_sharded
from climate_sim_tpu_torch.ops.init import gaussian_hotspot
from climate_sim_tpu_torch.ops.step import make_interior_step
from climate_sim_tpu_torch.parallel import halo
from climate_sim_tpu_torch.parallel.mesh import gather_field, make_mesh, shard_field
from climate_sim_tpu_torch.runtime import driver, graphs
from climate_sim_tpu_torch.runtime.distributed import Transport

from test_torch_kernel import make_cfgs
from test_torch_parallel import field, grid_for, jax_advance, port_advance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "configs", "bench_4096.yaml")
CPU = torch.device("cpu")
CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)
FAKE_CARDS = [torch.device("cpu", i) for i in range(4)]
BAND = "void climate::band_kernel<double>"


class FakeGraphs:
    """The capture primitive's stand-in on the CPU (see the module
    docstring); ``events`` records ("warm_up" | "pool" | "capture" |
    "instantiate" | "replay"), ``cards`` (event, the cards it was given)
    for each warm-up, capture and replay, ``pools`` the pool each capture
    was given.  A graph's kernel nodes are the stencil launches its
    wrappers counted while it was captured, dealt over its cards in turn."""

    def __init__(self):
        self.events, self.pools, self.cards = [], [], []

    def pool(self):
        self.events.append("pool")
        return object()

    def warm_up(self, devices, fn):
        self.events.append("warm_up")
        self.cards.append(("warm_up", tuple(devices)))
        fn()

    def capture(self, devices, fn, pool):
        self.events.append("capture")
        self.cards.append(("capture", tuple(devices)))
        self.pools.append(pool)
        before = sum(f.launches for f in halo._CHUNK_WRAPPERS)
        out = fn()
        launched = sum(f.launches for f in halo._CHUNK_WRAPPERS) - before
        return (fn, out, launched, tuple(devices)), out

    def kernel_nodes(self, graph):
        _, _, launched, devices = graph
        return collections.Counter((BAND, devices[i % len(devices)]) for i in range(launched))

    def instantiate(self, graph):
        self.events.append("instantiate")

    def replay(self, graph):
        self.events.append("replay")
        self.cards.append(("replay", graph[3]))
        fn, out, _, _ = graph
        for row, new_row in zip(out, fn()):
            for t, new in zip(row, new_row):
                if t is not None:
                    t.copy_(new)


@pytest.fixture
def fake_graphs(monkeypatch):
    """Mesh chunks on the CPU captured through :class:`FakeGraphs`."""
    fake = FakeGraphs()
    monkeypatch.setattr(graphs, "CUDA_GRAPHS", fake)
    monkeypatch.setattr(graphs, "capture_rule", lambda mesh: None)
    return fake


@pytest.fixture
def counting(monkeypatch):
    """Each kernel entry halo reaches counts one launch on its wrapper's
    ``launches`` (from 0, restored after the test) and runs the wrapper."""
    for fn in halo._CHUNK_WRAPPERS:
        monkeypatch.setattr(fn, "launches", 0)
    for module, name in ((halo, "sharded_tile_slab_multistep"),
                         (halo, "tile_region_multistep"),
                         (halo, "carrier_tile_slab_multistep"),
                         (cuda_sharded, "prepadded_kernel_step")):
        wrapper = getattr(module, name)

        def stand_in(*args, _wrapper=wrapper, **kw):
            _wrapper.launches += 1
            return _wrapper(*args, **kw)

        monkeypatch.setattr(module, name, stand_in)


def bench_cfg(nx, ny, **kw):
    cfg = merged_config(BENCH, ["--kernel=pallas", f"--nx={nx}", f"--ny={ny}"])
    return dataclasses.replace(cfg, **kw)


# path -> (builder on (cfg, mesh), nx, ny): every mesh builder, each
# through _make_chunk_advance, at a grid small enough for the CPU.
PATHS = {
    "slab": (lambda c, m: halo.build_sharded_multistep_advance(c, m, c.dt), 32, 24),
    "overlap": (lambda c, m: halo.build_sharded_overlap_advance(
        dataclasses.replace(c, out_every=4), m, c.dt), 48, 48),
    "carrier": (lambda c, m: halo.build_carrier_slab_advance(c, m, c.dt), 31, 29),
    "perstep_k2": (lambda c, m: halo.build_sharded_advance(
        c, m, c.dt, make_interior_step(c, c.dt)), 24, 16),
    "remainder_torch_ops": (lambda c, m: halo.build_padded_advance(
        dataclasses.replace(c, kernel="jnp"), m, c.dt), 25, 19),
}


def build(path, dtype=torch.float64, devices=(CPU,) * 4):
    """(advance, its 2x2 mesh of ``devices``, the IC's tiles) of ``path``."""
    builder, nx, ny = PATHS[path]
    cfg = bench_cfg(nx, ny)
    mesh = make_mesh(2, 2, list(devices))
    adv = builder(cfg, mesh)
    assert adv is not None, path
    u = gaussian_hotspot(cfg, dtype, CPU)
    tiles = adv.embed(u) if hasattr(adv, "embed") else shard_field(u, mesh)
    return adv, mesh, tiles


def counts(mesh):
    return ({fn.__name__: fn.launches for fn in halo._CHUNK_WRAPPERS},
            collections.Counter(mesh.copies), mesh.rounds)


def same_tiles(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for ra, rb in zip(a, b) for x, y in zip(ra, rb))


# --- the capture rule -------------------------------------------------------

def _mesh(devices, owners=None, rank=0, transport=None):
    mesh = make_mesh(2, 2, devices, owners, rank)
    mesh.transport = transport
    return mesh


@pytest.mark.parametrize("mesh, want", [
    (lambda: _mesh([CPU] * 4), "tiles on the CPU"),
    (lambda: _mesh([CPU] * 4, [0, 0, 1, 1], 0, Transport("gloo")), "tiles on the CPU"),
    (lambda: _mesh([CUDA0, CUDA0, CUDA1, CUDA1]), None),
    (lambda: _mesh([CUDA0] * 4, [0, 1, 2, 3], 1, Transport("gloo")),
     "gloo transport, host-staged"),
    (lambda: _mesh([CUDA0] * 4, [0, 0, 0, 0], 1), "no tile in this process"),
    (lambda: _mesh([CUDA0] * 4), None),
    (lambda: _mesh([CUDA0, CUDA1, CUDA0, CUDA1], [0, 1, 2, 3], 2, Transport("nccl")), None),
    (lambda: _mesh([CUDA0, CUDA1, CUDA0, CUDA1], [0, 0, 1, 1], 1, Transport("nccl")),
     "a rank on several cards"),
    (lambda: _mesh([CUDA0, CUDA1, CUDA0, CUDA1], [0, 0, 1, 1], 0, Transport("gloo")),
     "gloo transport, host-staged"),
], ids=["cpu", "cpu_gloo", "several_cards", "gloo_ranks", "no_tile", "one_card",
        "nccl_ranks", "nccl_rank_on_several_cards", "gloo_rank_on_several_cards"])
def test_capture_rule(mesh, want):
    """Eager for CPU tiles, gloo, and a rank of several processes that holds
    several cards; captured for one process's tiles on one card or several,
    and for NCCL ranks of one card; eager everywhere inside
    ``disable_graphs()``."""
    m = mesh()
    assert graphs.capture_rule(m) == want
    with graphs.disable_graphs():
        assert graphs.capture_rule(m) == "graphs disabled"


def test_capture_rule_names_the_path_in_the_banner():
    """The banner says which side of the rule a run took."""
    cfg = bench_cfg(32, 24)
    cpu_adv = halo.build_sharded_multistep_advance(cfg, _mesh([CPU] * 4), cfg.dt)
    assert driver._path_name(cpu_adv, CPU) == \
        "slab, K4 plain version, eager chunks (tiles on the CPU)"
    card_adv = halo.build_sharded_multistep_advance(cfg, _mesh([CUDA0] * 4), cfg.dt)
    assert card_adv.eager_why is None
    assert driver._path_name(card_adv, CUDA0) == \
        "slab, K4 CUDA kernel, chunks as CUDA graphs"
    with graphs.disable_graphs():
        off = halo.build_sharded_multistep_advance(cfg, _mesh([CUDA0] * 4), cfg.dt)
    assert driver._path_name(off, CUDA0).endswith("eager chunks (graphs disabled)")


def test_disable_graphs_restores_on_every_exit():
    assert not graphs.graphs_disabled()
    with graphs.disable_graphs():
        with graphs.disable_graphs():
            assert graphs.graphs_disabled()
        assert graphs.graphs_disabled()
    assert not graphs.graphs_disabled()
    with pytest.raises(RuntimeError, match="inside"):
        with graphs.disable_graphs():
            raise RuntimeError("inside")
    assert not graphs.graphs_disabled()


# --- caching ---------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
def test_advance_cached_per_length(path, fake_graphs):
    """``advance(chunk)`` is one object per length, graphed or eager, as
    JAX's ``lru_cache`` keeps one jitted program per length."""
    adv, _, tiles = build(path)
    assert adv.eager_why is None
    assert isinstance(adv(5), graphs.GraphedChunk)
    assert adv(5) is adv(5) and adv(5) is not adv(6)
    assert adv(5).chunk == 5
    with graphs.disable_graphs():
        eager = adv(5)
        assert not isinstance(eager, graphs.GraphedChunk)
        assert adv(5) is eager
    chunk = adv(3)
    assert chunk.capture(tiles) is chunk.capture(tiles)
    assert fake_graphs.events.count("capture") == 1


@pytest.mark.parametrize("path", ["slab", "carrier"])
def test_chunk_captures_once_and_refuses_another_signature(path, fake_graphs):
    """A chunk is captured once, on its first tiles' shapes, dtypes and
    devices; tiles of another signature raise instead of a second graph."""
    adv, _, tiles = build(path)
    fn = adv(3)
    fn(tiles)
    other = [[None if t is None else t.float() for t in row] for row in tiles]
    with pytest.raises(ValueError, match="3-step chunk captured for tiles"):
        fn(other)
    assert fake_graphs.events.count("capture") == 1


def test_chunks_of_an_advance_share_one_pool(fake_graphs):
    """Every length of an advance is captured into one memory pool, made
    at the first capture; another advance gets its own."""
    adv, _, tiles = build("slab")
    for chunk in (1, 7, 4):
        adv(chunk).capture(tiles)
    other, _, other_tiles = build("slab")
    other(2).capture(other_tiles)
    assert fake_graphs.events.count("pool") == 2
    first, *rest, last = fake_graphs.pools
    assert all(p is first for p in rest) and last is not first


# --- counters and results ----------------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("chunk", [1, 7])
def test_replays_count_and_compute_as_eager(path, chunk, counting, fake_graphs):
    """After warm-up, capture and N replays the launches, ``mesh.copies``
    and ``mesh.rounds`` equal N eager chunks', and every tile equals the
    eager run's bit for bit."""
    reps = 3
    adv, mesh, tiles = build(path)
    start = counts(mesh)
    with graphs.disable_graphs():
        eager = tiles
        for _ in range(reps):
            eager = adv(chunk)(eager)
    want = counts(mesh)
    if path != "remainder_torch_ops":
        assert sum(want[0].values()) > 0
    assert sum(want[1].values()) > 0

    for fn in halo._CHUNK_WRAPPERS:
        fn.launches = 0
    adv, mesh, tiles = build(path)
    assert counts(mesh) == start
    fn = adv(chunk)
    fn.capture(tiles)
    assert counts(mesh) == start, "warm-up and capture count nothing"
    assert fake_graphs.events == ["warm_up", "pool", "capture", "instantiate"]
    out = tiles
    for _ in range(reps):
        out = fn(out)
    assert counts(mesh) == want
    assert fake_graphs.events.count("replay") == reps
    assert same_tiles(out, eager)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_later_call_never_overwrites_an_earlier_result(path, fake_graphs):
    """Each call returns fresh tiles: neither the input nor an earlier
    result changes when the chunk is called again."""
    adv, _, tiles = build(path)
    fn = adv(4)
    first = fn(tiles)
    kept = [[None if t is None else t.clone() for t in row] for row in first]
    second = fn(first)
    third = fn(second)
    assert same_tiles(first, kept)
    assert not same_tiles(second, first) and not same_tiles(third, second)
    static = fn.capture(tiles)
    held = {s.data_ptr() for r in static.outputs + static.inputs for s in r if s is not None}
    assert all(t is None or t.data_ptr() not in held
               for res in (first, second, third) for row in res for t in row)


def test_static_input_is_not_copied_onto_itself(fake_graphs, monkeypatch):
    """The caller's tiles are copied into the static input unless they
    already are that buffer."""
    adv, _, tiles = build("slab")
    fn = adv(2)
    static = fn.capture(tiles)
    copies = []
    real = torch.Tensor.copy_
    monkeypatch.setattr(torch.Tensor, "copy_",
                        lambda self, src, *a, **kw: (copies.append(self.data_ptr()),
                                                     real(self, src, *a, **kw))[1])
    fn(static.inputs)
    inputs = {t.data_ptr() for row in static.inputs for t in row}
    assert not inputs & set(copies)
    copies.clear()
    fn(tiles)
    assert inputs <= set(copies)


def test_captured_chunk_raises_when_the_capture_fails(monkeypatch):
    """No fallback: a capture that fails raises out of the call."""

    class Refusing(FakeGraphs):
        def capture(self, device, fn, pool):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs, "CUDA_GRAPHS", Refusing())
    monkeypatch.setattr(graphs, "capture_rule", lambda mesh: None)
    adv, _, tiles = build("slab")
    with pytest.raises(RuntimeError, match="stream is capturing"):
        adv(3)(tiles)


@pytest.mark.parametrize("extra", [1, -1])
def test_capture_raises_when_the_graph_differs_from_the_count(extra, counting,
                                                             monkeypatch):
    """The launches a replay adds are held to the graph: a captured graph
    with more or fewer stencil kernel nodes than its wrappers counted
    raises at capture."""

    class Miscounting(FakeGraphs):
        def kernel_nodes(self, graph):
            return collections.Counter({(BAND, graph[3][0]): graph[2] + extra})

    monkeypatch.setattr(graphs, "CUDA_GRAPHS", Miscounting())
    monkeypatch.setattr(graphs, "capture_rule", lambda mesh: None)
    adv, mesh, tiles = build("slab")
    start = counts(mesh)
    with pytest.raises(RuntimeError, match=f"holds {4 + extra} band_kernel nodes, but its"
                                           " wrappers counted 4 launches"):
        adv(1)(tiles)
    assert counts(mesh) == start


# --- several cards -----------------------------------------------------------

@pytest.mark.parametrize("devices", [FAKE_CARDS, FAKE_CARDS[:2] * 2],
                         ids=["four_cards", "two_cards_twice"])
def test_chunk_over_several_cards_hands_the_primitive_every_card(devices, counting,
                                                                 fake_graphs):
    """The warm-up, the capture and every replay get every card of the
    mesh's tiles, each once, in mesh order, and the graph's stencil kernel
    nodes lie on each of them."""
    adv, _, tiles = build("slab", devices=devices)
    cards = tuple(dict.fromkeys(devices))
    fn = adv(3)
    fn(fn(tiles))
    assert fake_graphs.cards == [("warm_up", cards), ("capture", cards),
                                 ("replay", cards), ("replay", cards)]
    assert {card for _, card in fn.capture(tiles).kernel_nodes} == set(cards)


@pytest.mark.parametrize("where", ["first_card", "no_card"])
def test_capture_raises_when_kernel_nodes_miss_a_card(where, counting, monkeypatch):
    """A graph over four cards whose stencil kernel nodes all lie on one of
    them, or in a context of none of them, raises at capture though their
    number equals the launches counted; the counters stay as they were."""

    class OneCard(FakeGraphs):
        def kernel_nodes(self, graph):
            _, _, launched, devices = graph
            card = devices[0] if where == "first_card" else None
            return collections.Counter({(BAND, card): launched})

    monkeypatch.setattr(graphs, "CUDA_GRAPHS", OneCard())
    monkeypatch.setattr(graphs, "capture_rule", lambda mesh: None)
    adv, mesh, tiles = build("slab", devices=FAKE_CARDS)
    start = counts(mesh)
    with pytest.raises(RuntimeError, match="band_kernel nodes lie on .*, not on every card"):
        adv(2)(tiles)
    assert counts(mesh) == start


@pytest.mark.parametrize("path", ["slab", "overlap", "perstep"])
def test_graphed_chunk_over_fake_cards_matches_eager_and_jax(path, fake_graphs):
    """On a 2x2 mesh over four fake cards, an 11-step and a 5-step chunk,
    captured (through the stand-in) and replayed, equal the eager chunks bit
    for bit and lie within 1e-11 of the JAX package's sharded advance on
    four virtual devices (f64, bench BCs)."""
    nx, ny = grid_for(2, 2)
    jcfg, tcfg = make_cfgs(nx, ny, "MIX1", kernel="pallas", out_every=8, precision="f64")
    jm, tm = jmesh.make_mesh(2, 2, jax.devices()[:4]), make_mesh(2, 2, FAKE_CARDS)
    u = field(ny, nx, seed=14)
    ju = jax.device_put(jnp.asarray(u), jmesh.field_sharding(jm))
    _, tiles = from_reference_sharded(jconfig.config_to_dict(jcfg), u, tm)
    jadv, tadv = jax_advance(path, jcfg, jm), port_advance(path, tcfg, tm)
    graphed = eager = tiles
    for chunk in (11, 5):
        ju = jadv(chunk)(ju)
        assert isinstance(tadv(chunk), graphs.GraphedChunk)
        graphed = tadv(chunk)(graphed)
        with graphs.disable_graphs():
            eager = tadv(chunk)(eager)
    assert fake_graphs.cards[:2] == [("warm_up", tuple(FAKE_CARDS)),
                                     ("capture", tuple(FAKE_CARDS))]
    assert same_tiles(graphed, eager)
    np.testing.assert_allclose(gather_field(graphed, tm).numpy(), np.asarray(ju),
                               rtol=0, atol=1e-11)


class FakeCuda:
    """``torch.cuda``'s stream, graph and pool calls as
    :class:`graphs.CudaGraphs` makes them, recorded on the CPU in ``log``:
    ("wait", stream, the stream it waits on), ("body", {card: its current
    stream}), ("capture_begin", capture stream, pool, error mode),
    ("capture_end",), ("route" | "unroute" | "release", card),
    ("instantiate",) and ("replay", the stream launched on).  A stream is
    named "<n>@<card>", n counting the streams made; a card's default
    stream is "d@<card>".  ``device`` is the current card's index."""

    def __init__(self, monkeypatch):
        self.log, self.made, self.current, self.device = [], 0, {}, 0
        fake = self

        class Stream:
            def __init__(self, device=None, name=None):
                self.device = torch.device(device)
                if name is None:
                    fake.made += 1
                self.name = name or f"{fake.made}@{self.device.index}"

            def wait_stream(self, other):
                fake.log.append(("wait", self.name, other.name))

        def current_stream(device=None):
            i = fake.device if device is None else torch.device(device).index
            return fake.current.setdefault(i, Stream(torch.device("cuda", i), f"d@{i}"))

        @contextlib.contextmanager
        def stream(s):
            prev = current_stream(s.device)
            fake.current[s.device.index] = s
            try:
                yield
            finally:
                fake.current[s.device.index] = prev

        @contextlib.contextmanager
        def device(d):
            prev, fake.device = fake.device, torch.device(d).index
            try:
                yield
            finally:
                fake.device = prev

        class CUDAGraph:
            def __init__(self, keep_graph=False):
                assert keep_graph

            def instantiate(self):
                fake.log.append(("instantiate",))

            def replay(self):
                fake.log.append(("replay", current_stream().name))

            def raw_cuda_graph(self):
                return 1

        @contextlib.contextmanager
        def graph(g, pool=None, stream=None, capture_error_mode="global"):
            fake.log.append(("capture_begin", stream.name, pool, capture_error_mode))
            with device(stream.device), stream_ctx(stream):
                yield
            fake.log.append(("capture_end",))

        stream_ctx = stream
        for name, fn in (("Stream", Stream), ("current_stream", current_stream),
                         ("stream", stream), ("device", device), ("CUDAGraph", CUDAGraph),
                         ("graph", graph), ("graph_pool_handle", lambda: (0, 7))):
            monkeypatch.setattr(torch.cuda, name, fn)
        for name, what in (("_cuda_beginAllocateCurrentThreadToPool", "route"),
                           ("_cuda_endAllocateToPool", "unroute"),
                           ("_cuda_releasePool", "release")):
            monkeypatch.setattr(torch._C, name,
                                lambda d, pool, _what=what: fake.log.append((_what, d)))


def expected_primitive_log(n):
    """:class:`FakeCuda`'s log of ``CudaGraphs``' warm-up, capture,
    instantiation, replay and release over cards 0..n-1 (streams 1..n the
    warm-up's side streams, n+1 the capture stream on card 0, then one
    joined stream for each other card)."""
    others = range(1, n)
    side = {i: f"{i + 1}@{i}" for i in range(n)}
    joined = {0: f"{n + 1}@0", **{i: f"{n + 1 + i}@{i}" for i in others}}
    return [
        *(("wait", side[i], f"d@{i}") for i in range(n)),
        ("body", side),
        *(("wait", f"d@{i}", side[i]) for i in range(n)),
        ("capture_begin", joined[0], (0, 7), "thread_local"),
        *(("route", i) for i in others),
        *(("wait", joined[i], joined[0]) for i in others),
        ("body", joined),
        *(("wait", joined[0], joined[i]) for i in others),
        *(("unroute", i) for i in others),
        ("capture_end",),
        ("instantiate",),
        *(("wait", "d@0", f"d@{i}") for i in others),
        ("replay", "d@0"),
        *(("wait", f"d@{i}", "d@0") for i in others),
        *(("release", i) for i in others),
    ]


@pytest.mark.parametrize("n", [1, 3])
def test_cuda_graphs_fork_join_pool_and_wait_on_every_card(n, monkeypatch):
    """The capture primitive over n cards: the warm-up runs with a side
    stream current on every card, forked from and joined to its current
    stream; the capture stream lives on card 0, every other card's stream
    waits on it (joining the capture) and is that card's current stream
    while the body runs, that card's allocations routed to the pool of the
    advance's id until the body ends, and it is joined back before the
    capture ends; a replay launches on card 0's current stream after every
    card's current stream, and every card's then waits on it; the other
    cards' pools are released when the graph is freed, not before."""
    fake = FakeCuda(monkeypatch)
    cards = [torch.device("cuda", i) for i in range(n)]
    prim = graphs.CudaGraphs()

    def body():
        fake.log.append(("body", {d.index: torch.cuda.current_stream(d).name for d in cards}))
        return "out"

    prim.warm_up(cards, body)
    graph, out = prim.capture(cards, body, prim.pool())
    assert out == "out" and graph.devices == tuple(cards)
    prim.instantiate(graph)
    prim.replay(graph)
    assert not [e for e in fake.log if e[0] == "release"]
    del graph
    gc.collect()
    assert fake.log == expected_primitive_log(n)


def test_cuda_graphs_kernel_nodes_by_card(monkeypatch):
    """The primitive counts a graph's kernel nodes by symbol and card, the
    card told by the node's context (each card's current context while it
    is the current device); a node in another context counts under None."""
    fake = FakeCuda(monkeypatch)
    band = "climate::band_kernel<float>"
    driver_ = FakeDriver({1: [("kernel", 11, 0, band, 0x100), ("kernel", 12, 0, band, 0x101),
                              ("kernel", 13, 0, "elementwise_kernel", 0x101),
                              ("kernel", 14, 0, band, 0x102), ("kernel", 15, 0, band, 0x999)]},
                         current=lambda: 0x100 + fake.device)
    monkeypatch.setattr(ctypes, "CDLL", lambda name: driver_)
    cards = [torch.device("cuda", i) for i in range(3)]
    graph = graphs.Graph(torch.cuda.CUDAGraph(keep_graph=True), tuple(cards))
    assert graphs.CudaGraphs().kernel_nodes(graph) == collections.Counter({
        (band, cards[0]): 1, (band, cards[1]): 1, ("elementwise_kernel", cards[1]): 1,
        (band, cards[2]): 1, (band, None): 1})


class FakeDriver:
    """``libcuda``'s graph queries over ``graphs``: {handle: [node, ...]},
    a node ("kernel", func, kern, name, ctx), ("graph", child handle) or
    ("memcpy",); a node's handle is its (graph, index) packed in an int.
    ``fail`` names a call that returns an error.  ``current`` gives the
    context ``cuCtxGetCurrent`` reports."""

    def __init__(self, graphs_, fail=None, current=lambda: None):
        self.graphs, self.fail, self.current = graphs_, fail, current

    def cuCtxGetCurrent(self, ctx):
        ctx._obj.value = self.current()
        return 0

    def _node(self, handle):
        return self.graphs[handle.value >> 8][handle.value & 0xFF]

    def cuGraphGetNodes(self, graph, nodes, count):
        if self.fail == "cuGraphGetNodes":
            return 1
        listed = self.graphs[graph.value]
        if nodes is not None:
            for i in range(len(listed)):
                nodes[i] = (graph.value << 8) | i
        count._obj.value = len(listed)
        return 0

    def cuGraphNodeGetType(self, node, kind):
        kind._obj.value = {"kernel": 0, "memcpy": 1, "graph": 4}[self._node(node)[0]]
        return 0

    def cuGraphChildGraphNodeGetGraph(self, node, child):
        child._obj.value = self._node(node)[1]
        return 0

    def cuGraphKernelNodeGetParams_v2(self, node, params):
        _, func, kern, _, ctx = self._node(node)
        params._obj.func, params._obj.kern, params._obj.ctx = func, kern, ctx
        return 0

    def _name(self, handle, name, field):
        for listed in self.graphs.values():
            for node in listed:
                if node[0] == "kernel" and node[field] == handle.value:
                    name._obj.value = node[3].encode()
                    return 0
        return 500

    def cuFuncGetName(self, name, func):
        return self._name(func, name, 1)

    def cuKernelGetName(self, name, kern):
        return self._name(kern, name, 2)


def test_graph_kernel_names_walks_the_graph():
    """The kernel nodes of a captured graph by symbol and context, through
    child graphs, by function or (with none) by kernel handle; other nodes
    not counted."""
    band = "climate::band_kernel<float>"
    driver_ = FakeDriver({
        1: [("kernel", 11, 0, band, 0x100), ("memcpy",), ("graph", 2),
            ("kernel", 0, 13, band, 0x200)],
        2: [("kernel", 12, 0, "ncclDevKernel_SendRecv", 0x100), ("graph", 3)],
        3: [("kernel", 14, 0, band, 0x100)],
    })
    assert graphs.graph_kernel_names(driver_, 1) == collections.Counter(
        {(band, 0x100): 2, (band, 0x200): 1, ("ncclDevKernel_SendRecv", 0x100): 1})
    assert graphs.graph_kernel_names(driver_, 3) == collections.Counter({(band, 0x100): 1})


@pytest.mark.parametrize("fail, match", [
    ("cuGraphGetNodes", "CUDA driver error 1 in cuGraphGetNodes"),
    (None, "CUDA driver error 500 in cuFuncGetName"),
])
def test_graph_kernel_names_raises_on_a_driver_error(fail, match):
    """A driver call that fails raises with its status; the second case's
    function has no name the driver knows."""
    driver_ = FakeDriver({1: [("memcpy",), ("kernel", 98, 0, "x", 0x100)]}, fail)
    if fail is None:
        driver_._name = lambda handle, name, field: 500
    with pytest.raises(RuntimeError, match=match):
        graphs.graph_kernel_names(driver_, 1)


# --- the driver's pre-captured lengths ----------------------------------------

# (steps, out_every): steps < out_every, out_every not dividing steps, and
# spans longer than 256 steps (pieces of 256 and a remainder).
DRIVER_CASES = [(5, 10), (25, 10), (600, 600), (700, 300), (530, 265)]


def jax_compiled_lengths(steps, out_every, monkeypatch):
    """The lengths the JAX driver passes to ``advance(k)`` (its AOT-compile
    loop, driver.py:541-547) in a run of bench_4096 at 16² on one CPU
    device."""
    calls = []
    real = jdriver.prepare

    def spy_prepare(cfg, devices=None):
        u, adv, mesh, dt, clamped = real(cfg, devices)

        def spy(k):
            calls.append(k)
            return adv(k)

        return u, spy, mesh, dt, clamped

    monkeypatch.setattr(jdriver, "prepare", spy_prepare)
    cfg = jmerged_config(BENCH, ["--nx=16", "--ny=16", f"--steps={steps}",
                                 f"--out_every={out_every}", "--kernel=jnp"])
    jdriver.run_simulation(cfg, jax.devices()[:1], write_output=False)
    return calls


@pytest.mark.parametrize("steps, out_every", DRIVER_CASES)
def test_driver_captures_the_lengths_jax_compiles(steps, out_every, fake_graphs,
                                                  monkeypatch, capsys):
    """The port's driver captures exactly the chunk lengths the JAX driver
    compiles, each once, all before the first replay; the replays' field
    equals the eager run's bit for bit."""
    want = jax_compiled_lengths(steps, out_every, monkeypatch)
    assert len(want) == len(set(want))

    captured = []
    real_capture = graphs.GraphedChunk.capture

    def spy_capture(self, tiles):
        if self.captured is None:
            captured.append(self.chunk)
        return real_capture(self, tiles)

    monkeypatch.setattr(graphs.GraphedChunk, "capture", spy_capture)
    cfg = bench_cfg(24, 16, steps=steps, out_every=out_every)
    graphed = driver.run_simulation(cfg, [CPU] * 4, write_output=False)
    assert sorted(captured) == sorted(want) == driver.chunk_lengths(cfg)
    events = fake_graphs.events
    last_capture = max(i for i, e in enumerate(events) if e == "capture")
    assert "replay" not in events[:last_capture]
    assert events.count("replay") == sum(
        len(driver.span_pieces(k)) for k in driver.span_lengths(cfg))
    assert "path: slab, K4 plain version, chunks as CUDA graphs" in capsys.readouterr().out

    with graphs.disable_graphs():
        eager = driver.run_simulation(cfg, [CPU] * 4, write_output=False)
    assert torch.equal(graphed.u, eager.u)
    assert (graphed.timed_passes, graphed.warmup_passes) == \
        (eager.timed_passes, eager.warmup_passes)


def test_driver_launches_match_the_pass_schedule(counting, fake_graphs, capsys):
    """Through the driver with graphs: the eager warm-up pass and the
    replayed timed passes count K4 launches (timed + warm-up) x tiles, as
    the eager run does."""
    cfg = bench_cfg(32, 24, steps=600, out_every=300)
    res = driver.run_simulation(cfg, [CPU] * 4, write_output=False)
    out = capsys.readouterr().out
    assert "passes: timed=" in out
    want = (res.timed_passes + res.warmup_passes) * 4
    assert cuda_sharded.sharded_tile_slab_multistep.launches == want
    assert np.isfinite(res.u.numpy()).all()


def test_pyproject_names_the_port():
    """The port's console script, the counterpart of ``climate-sim-tpu``,
    and its optional dependency group."""
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)["project"]
    module, name = project["scripts"]["climate-sim-tpu-torch"].split(":")
    from climate_sim_tpu_torch.runtime import cli

    assert getattr(importlib.import_module(module), name) is cli.main
    assert project["optional-dependencies"]["torch"] == ["torch"]
