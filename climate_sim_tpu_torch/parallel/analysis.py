"""The exchange schedule of one pass: the port of the JAX package's
``parallel/analysis.py``.

The weak-scaling latency model, ``eff(L) = T_pass / (T_pass + n * L)``,
needs ``n``: how many exchange latencies a pass serializes.  Two numbers
answer it for the port:

* :func:`exchange_critical_depth`, what the dataflow allows: the longest
  chain of dependent exchanges in the pass (the JAX package's
  ``ppermute_critical_depth``; 2 on every path, x faces and then the
  x-extended rows, the reference's columns-then-full-rows chain,
  src/halo.cpp:28-46);
* :func:`exchange_batches`, what the port pays: the calls of
  :func:`.halo._deliver` that move a payload between two tiles.  Across
  ranks each is one batch of sends and receives that every rank waits on,
  so a rendezvous; the paths issue one per face shift, so more batches
  than rounds.

There is no jaxpr to walk, so both run one pass (``fn(tiles)``, typically
``advance(k)`` for k = steps per pass) on tiles of the CPU, where every
kernel wrapper takes its plain version and every step is a torch op.
:func:`exchange_critical_depth` carries a depth per tensor storage through
that pass (a ``TorchDispatchMode``) and adds one to each payload
:func:`.halo._deliver` moves between tiles; payloads of one round come
from sources of one depth, so they count once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from . import halo
from .mesh import Tiles

# Ops whose outputs take their inputs' shapes, never their values.
_SHAPE_ONLY = frozenset({
    "empty_like", "zeros_like", "ones_like", "full_like", "empty_strided",
    "new_empty", "new_empty_strided", "new_zeros", "new_ones", "new_full",
})


def _between_tiles(moves) -> bool:
    """True when a delivery moves at least one payload between two tiles."""
    return any(src != dst for src, dst, _ in moves)


@contextlib.contextmanager
def _swapped_deliver(wrap: Callable) -> Iterator[None]:
    """:func:`.halo._deliver` replaced by ``wrap(real)`` for the block and
    restored on every exit."""
    real = halo._deliver
    halo._deliver = wrap(real)
    try:
        yield
    finally:
        halo._deliver = real


@contextlib.contextmanager
def on_each_batch(callback: Callable[[], None]) -> Iterator[None]:
    """``callback()`` before each :func:`.halo._deliver` call that moves a
    payload between two tiles, for the block: one call for each
    rendezvous a rank pays (every rank walks the same moves, so each
    counts the same calls)."""
    def wrap(real):
        def deliver(parts, mesh, moves, out):
            if _between_tiles(moves):
                callback()
            real(parts, mesh, moves, out)

        return deliver

    with _swapped_deliver(wrap):
        yield


def exchange_batches(fn: Callable[[Tiles], Tiles], tiles: Tiles) -> int:
    """The number of :func:`.halo._deliver` calls in ``fn(tiles)`` that move
    at least one payload between two tiles (calls with nothing to move, a
    size-1 axis's, are not counted; ``Mesh.rounds`` counts them)."""
    n = [0]
    with on_each_batch(lambda: n.__setitem__(0, n[0] + 1)):
        fn(tiles)
    return n[0]


def _storage_key(t: torch.Tensor) -> Optional[Tuple[torch.device, int]]:
    ptr = t.untyped_storage().data_ptr()
    return (t.device, ptr) if ptr else None


class _DepthMode(TorchDispatchMode):
    """Each op's outputs take the largest depth of its inputs (0 for an op
    that reads only shapes); depths are kept per storage, so views and
    in-place writes share their storage's depth, and a storage freed and
    reused is overwritten by its new owner."""

    def __init__(self):
        super().__init__()
        self.depth: Dict[Tuple[torch.device, int], int] = {}
        self.deepest = 0

    def of(self, t: torch.Tensor) -> int:
        return self.depth.get(_storage_key(t), 0)

    def set(self, t: torch.Tensor, d: int) -> None:
        key = _storage_key(t)
        if key is not None:
            self.depth[key] = d
        self.deepest = max(self.deepest, d)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        d = 0
        if func.overloadpacket.__name__ not in _SHAPE_ONLY:
            d = max((self.of(t) for t in pytree.tree_leaves((args, kwargs))
                     if isinstance(t, torch.Tensor)), default=0)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.set(t, d)
        return out


def exchange_critical_depth(fn: Callable[[Tiles], Tiles], tiles: Tiles) -> int:
    """The longest chain of dependent exchanges in ``fn(tiles)``, one pass
    on CPU tiles.  Every payload :func:`.halo._deliver` moves between two
    tiles gets its own storage (a delivery on one device returns the
    source view itself, whose depth must not rise) at its source's depth
    plus one.  The pass's values are those of an unwatched pass."""
    mode = _DepthMode()

    def wrap(real):
        def deliver(parts, mesh, moves, out):
            real(parts, mesh, moves, out)
            for (sy, sx), (dy, dx), _ in moves:
                if (sy, sx) != (dy, dx) and mesh.is_local(dy, dx):
                    payload = out[dy][dx].clone()
                    mode.set(payload, mode.of(parts[sy][sx]) + 1)
                    out[dy][dx] = payload

        return deliver

    with _swapped_deliver(wrap), mode:
        fn(tiles)
    return mode.deepest
