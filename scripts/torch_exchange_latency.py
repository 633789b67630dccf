#!/usr/bin/env python3
"""Per-exchange-round latency between the port's ranks, measured directly.

The port's counterpart of ``scripts/exchange_latency.py``.  The
weak-scaling latency model, ``T_pass + n * L``, needs the latency L of one
exchange round between processes; this script times the per-step exchange
dataflow alone, on ranks of the port's multi-process runtime
(``climate_sim_tpu_torch/runtime/distributed.py``), one process a rank and
one tile a rank, over the transport ``make_transport`` picks: NCCL when
every rank has a card of its own, gloo through pinned host buffers when
ranks share a card, gloo on the CPU.

One iteration is the JAX script's dataflow at its payload shapes, each
shift through the port's ``halo._pshift``, so it pays the port's real
batches (one ``_deliver`` batch, a rendezvous, a shift): round 1 both x
faces, (my, 1) each; round 2 both (1, mx+2) rows, whose corner cells
carry round 1's result.  ``--load`` exchanges the tile's own faces
instead and runs the 0.2-weighted 5-point update on the tile: the
exchange under compute load.  The control does the same arithmetic with
every shift the identity.

It measures the eager rendezvous, the host's issue of each batch
included, so its shifts run under ``disable_graphs()`` (a captured
chunk would replay the batches with no host work between them).

Each rank times R and 2R iterations (best of ``--trials``; on the card
``torch.cuda.synchronize()`` before every clock read, since NCCL's
``wait()`` orders the streams but not the host); ``cost = (T(2R) - T(R))
/ R`` cancels the fixed overhead, and the control's cost is subtracted.
``rounds_per_iter`` is the JAX script's (one a mesh axis longer than 1),
``batches_per_iter`` the ``_deliver`` calls that moved a payload in one
iteration (``parallel/analysis.py``), what the port pays.

Usage (the parent spawns the ranks itself):
  python scripts/torch_exchange_latency.py --ranks 2 --mesh-y 1 --tile 4096
  python scripts/torch_exchange_latency.py --ranks 4 --mesh-y 2 --tile 4096 --load
Rank 0 prints one JSON line: the JAX script's keys (``ranks``, ``mesh``,
``tile``, ``iters``, ``load``, ``raw_s``, ``iter_cost_coll_s``,
``iter_cost_ctrl_s``, ``exchange_cost_per_iter_s``, ``rounds_per_iter``,
``per_round_s``) plus ``transport`` and ``batches_per_iter``.  Runs on
the card unless ``--device=cpu``; without one it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANK_TIMEOUT_S = 900


def _shift(mesh, coll: bool):
    """``halo._pshift`` on ``mesh`` (a cyclic shift along an axis), or the
    identity for the control."""
    from climate_sim_tpu_torch.parallel import halo

    def shift(parts, axis: str, s: int):
        return halo._pshift(parts, mesh, axis, s) if coll else parts

    return shift


def face_iter(cols, rows, mesh, coll: bool):
    """One iteration on the faces alone: (cols (my, 1), rows (1, mx+2)) of
    every local tile -> the next pair (O(perimeter) work, so the cost is
    the exchange's)."""
    from climate_sim_tpu_torch.parallel.halo import _tilewise

    shift = _shift(mesh, coll)
    h = 0.5
    gl = shift(cols, "x", +1)
    gr = shift(cols, "x", -1)
    col2 = _tilewise(mesh, lambda y, x: h * (gl[y][x] + gr[y][x]))

    def row_src(y, x):
        # the corner cells carry round 1's data, so round 2 chains on it
        r = rows[y][x].clone()
        r[:, :1] = col2[y][x][:1, :]
        r[:, -1:] = col2[y][x][-1:, :]
        return r

    src = _tilewise(mesh, row_src)
    gb = shift(src, "y", +1)
    gt = shift(src, "y", -1)
    return col2, _tilewise(mesh, lambda y, x: h * (gb[y][x] + gt[y][x]))


def loaded_iter(tiles, mesh, coll: bool):
    """One iteration under load: exchange each tile's own faces, x then y
    at the x-extended width, and run the 5-point update on the tile."""
    import torch

    from climate_sim_tpu_torch.parallel.halo import _tilewise

    shift = _shift(mesh, coll)
    gl = shift(_tilewise(mesh, lambda y, x: tiles[y][x][:, -1:]), "x", +1)
    gr = shift(_tilewise(mesh, lambda y, x: tiles[y][x][:, :1]), "x", -1)
    mid = _tilewise(mesh, lambda y, x: torch.cat([gl[y][x], tiles[y][x], gr[y][x]], dim=1))
    gb = shift(_tilewise(mesh, lambda y, x: mid[y][x][-1:, :]), "y", +1)
    gt = shift(_tilewise(mesh, lambda y, x: mid[y][x][:1, :]), "y", -1)

    def update(y, x):
        full = torch.cat([gb[y][x], mid[y][x], gt[y][x]], dim=0)
        c = full[1:-1, 1:-1]
        return 0.2 * (c + full[:-2, 1:-1] + full[2:, 1:-1] + full[1:-1, :-2]
                      + full[1:-1, 2:])

    return _tilewise(mesh, update)


def worker(a) -> int:
    """One rank's timings, every exchange eager (see the docstring)."""
    from climate_sim_tpu_torch.runtime.graphs import disable_graphs

    with disable_graphs():
        return _measure(a)


def _measure(a) -> int:
    import torch

    from climate_sim_tpu_torch.config import SimConfig
    from climate_sim_tpu_torch.parallel.analysis import exchange_batches
    from climate_sim_tpu_torch.parallel.halo import _tilewise
    from climate_sim_tpu_torch.parallel.mesh import make_mesh
    from climate_sim_tpu_torch.runtime import distributed

    distributed.maybe_init_distributed(
        SimConfig(distributed=f"127.0.0.1:{a.port},{a.ranks},{a.worker}"))
    try:
        if a.device == "cuda":
            devs = distributed.default_devices()
        else:
            devs = [torch.device("cpu")]
        py = a.mesh_y
        px = a.ranks // py
        owners, names, chips = zip(*distributed.global_devices(devs))
        mesh = make_mesh(px, py, names, owners, distributed.rank(), chips)
        mesh.transport = distributed.make_transport(mesh)
        my = mx = a.tile
        dev = devs[0]

        def ones(shape):
            return _tilewise(mesh, lambda y, x: torch.ones(shape, dtype=torch.float32,
                                                           device=dev))

        if a.load:
            state0 = ones((my, mx))

            def step(state, coll):
                return loaded_iter(state, mesh, coll)
        else:
            state0 = (ones((my, 1)), ones((1, mx + 2)))

            def step(state, coll):
                return face_iter(*state, mesh, coll)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def run(n, coll):
            state = state0
            for _ in range(n):
                state = step(state, coll)
            return state

        batches = exchange_batches(lambda s: step(s, True), state0)
        for coll in (True, False):  # warm up outside the timing
            run(a.iters, coll)
        sync()

        def timed(n, coll):
            best = float("inf")
            for _ in range(a.trials):
                distributed.bounded_sync("trial")
                sync()
                t0 = time.perf_counter()
                run(n, coll)
                sync()
                best = min(best, time.perf_counter() - t0)
            return best

        t = {(n, c): timed(n, c) for n in (a.iters, 2 * a.iters) for c in (True, False)}
        e_coll = (t[(2 * a.iters, True)] - t[(a.iters, True)]) / a.iters
        e_ctrl = (t[(2 * a.iters, False)] - t[(a.iters, False)]) / a.iters
        e = e_coll - e_ctrl
        rounds = (1 if px > 1 else 0) + (1 if py > 1 else 0)
        if distributed.rank() == 0:
            print(json.dumps({
                "ranks": a.ranks, "mesh": [py, px], "tile": a.tile,
                "iters": a.iters, "load": bool(a.load),
                "raw_s": {f"{'coll' if c else 'ctrl'}_{n}": round(v, 6)
                          for (n, c), v in t.items()},
                "iter_cost_coll_s": round(e_coll, 9),
                "iter_cost_ctrl_s": round(e_ctrl, 9),
                "exchange_cost_per_iter_s": round(e, 9),
                "rounds_per_iter": rounds,
                "per_round_s": round(e / max(1, rounds), 9),
                "transport": mesh.transport.describe(),
                "batches_per_iter": batches,
            }), flush=True)
        distributed.bounded_sync("done")
    finally:
        distributed.shutdown()
    return 0


def _read(f) -> str:
    f.seek(0)
    text = f.read()
    f.close()
    return text


def spawn(a) -> int:
    """Start the ranks, wait for them (killing this run's own processes,
    and only those, past RANK_TIMEOUT_S) and print rank 0's line."""
    import socket

    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # On the CPU one core a rank, as the JAX script pins its ranks; on the
    # card the ranks run unpinned, as the port's multi-process runs do.
    pin = a.device == "cpu" and shutil.which("taskset") is not None
    ncores = os.cpu_count() or 1
    # Files, not pipes: a rank blocked on a full pipe would never reach the
    # next rendezvous.
    outfiles = [tempfile.TemporaryFile(mode="w+") for _ in range(a.ranks)]
    errfiles = [tempfile.TemporaryFile(mode="w+") for _ in range(a.ranks)]
    procs = [
        subprocess.Popen(
            (["taskset", "-c", str(i % ncores)] if pin else [])
            + [sys.executable, os.path.abspath(__file__),
               f"--ranks={a.ranks}", f"--mesh-y={a.mesh_y}", f"--tile={a.tile}",
               f"--iters={a.iters}", f"--trials={a.trials}", f"--device={a.device}",
               f"--worker={i}", f"--port={port}"]
            + (["--load"] if a.load else []),
            cwd=REPO, env=env, stdout=outfiles[i], stderr=errfiles[i], text=True,
        )
        for i in range(a.ranks)
    ]
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:  # exact PIDs only, never by pattern
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    fail = timed_out
    if timed_out:
        print(f"the ranks outlasted {RANK_TIMEOUT_S} s and were killed", file=sys.stderr)
    for i, p in enumerate(procs):
        out, err = (_read(f) for f in (outfiles[i], errfiles[i]))
        if p.returncode != 0:
            print(f"rank {i} failed (exit {p.returncode}):\n{out[-2000:]}\n{err[-3000:]}",
                  file=sys.stderr)
            fail = True
        elif i == 0:
            sys.stdout.write(out)
    return 1 if fail else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mesh-y", type=int, default=1,
                    help="py; px = ranks//py (1D x-mesh by default)")
    ap.add_argument("--tile", type=int, default=4096,
                    help="per-rank tile extent (faces are width-1)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--load", action="store_true",
                    help="loaded variant: exchange the tile's own faces and run an"
                         " O(area) 5-point update per iteration")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.ranks % a.mesh_y:
        ap.error("--mesh-y must divide --ranks")
    if a.worker >= 0:
        return worker(a)
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("exchange_latency: --device=cuda but torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
    return spawn(a)


if __name__ == "__main__":
    raise SystemExit(main())
