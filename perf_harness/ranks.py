"""The ranks of a cell that spans several cards: rank 0 in this process,
ranks 1 .. n-1 in processes of their own (``spawn``), one a card, each
driven over a pipe.

:meth:`Ranks.do` runs one phase (a method of :class:`cell.Rank`) on every
rank at once and returns the results in rank order.  A rank that raises
sends its traceback back, and the phase raises it here.  :meth:`Ranks.close`
stops every process and waits for it, whatever happened.

With the traffic's output on, the group makes one fresh directory for the
run's snapshot files (``tempfile.mkdtemp``), which every rank's jobs write
into, and :meth:`Ranks.close` removes it with all it holds.
"""

from __future__ import annotations

import multiprocessing as mp
import shutil
import socket
import sys
import tempfile
import traceback
from typing import List

import cell

JOIN_S = 60.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve(conn, rank: int, world: int, config: dict, traffic: dict, seed: int,
           port: int, kind: str, out_dir) -> None:
    """A rank's process: run each phase rank 0 sends until it sends None."""
    sys.stdout = sys.stderr  # the result line is rank 0's alone
    try:
        me = cell.Rank(rank, world, config, traffic, seed, port, cell.rank_devices(kind, rank),
                       out_dir)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    conn.send(("ready", None))
    while True:
        msg = conn.recv()
        if msg is None:
            return
        name, args = msg
        try:
            conn.send(("ok", getattr(me, name)(*args)))
        except BaseException:
            conn.send(("error", traceback.format_exc()))


class Ranks:
    def __init__(self, world: int, config: dict, traffic: dict, seed: int,
                 kind: str = "cuda"):
        """``kind`` is the device type of every rank (cpu in tests: gloo)."""
        self.world = world
        port = free_port() if world > 1 else 0
        ctx = mp.get_context("spawn")
        self.procs, self.conns = [], []
        self.out_dir = (tempfile.mkdtemp(prefix="perf_harness_out_")
                        if traffic.get("output", False) else None)
        try:
            for r in range(1, world):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=_serve, args=(theirs, r, world, config, traffic,
                                                     seed, port, kind, self.out_dir),
                                daemon=True)
                p.start()
                self.procs.append(p)
                self.conns.append(mine)
            self.local = cell.Rank(0, world, config, traffic, seed, port,
                                   cell.rank_devices(kind, 0), self.out_dir)
            self._collect()
        except BaseException:
            self.close()
            raise

    def _collect(self) -> List[object]:
        out = []
        for r, conn in enumerate(self.conns, start=1):
            try:
                kind, value = conn.recv()
            except EOFError:
                raise RuntimeError(f"rank {r} exited") from None
            if kind == "error":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            out.append(value)
        return out

    def do(self, name: str, *args) -> List[object]:
        for conn in self.conns:
            conn.send((name, args))
        mine = getattr(self.local, name)(*args)
        return [mine] + self._collect()

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for p in self.procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self.conns:
            conn.close()
        if self.out_dir is not None:
            shutil.rmtree(self.out_dir, ignore_errors=True)
