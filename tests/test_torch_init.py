"""The port's preset IC on the CPU does not depend on torch's thread split.

``gaussian_hotspot`` must give the same bits for the whole field and for
any window of it (a tile equals the same slice of the whole field), with
any number of intra-op threads, in any process.  Fresh processes matter:
the fault this guards against (torch's CPU ``exp`` rounding one thread's
share of a block differently) showed in about one fresh process in fifty,
never twice in one process.  So the field and 2x2 tiles at odd offsets of
a 4001x4001 grid are built in several fresh processes with 4 threads, and
with 2 and 8, and held byte for byte to one build in this process on one
thread.  Those runs catch the fault only when it shows; a deterministic
check holds the CPU build away from torch's ``exp`` altogether and to
numpy's evaluation of the formula, bit for bit.
"""

import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.ops import init as ti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4001
# 2x2 tiles split at odd offsets: rows [0, 2001) | [2001, 4001), columns
# [0, 1999) | [1999, 4001).
WINDOWS = [(0, 2001, 0, 1999), (0, 2001, 1999, N), (2001, N, 0, 1999), (2001, N, 1999, N)]
DTYPES = ("float32", "float64")

BUILD = textwrap.dedent("""
    import hashlib, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(int(sys.argv[1]))
    from climate_sim_tpu_torch import config
    from climate_sim_tpu_torch.ops import init
    cfg = config.merged_config(None, ["--nx={n}", "--ny={n}"])
    for name in {dtypes!r}:
        dtype = getattr(torch, name)
        whole = init.gaussian_hotspot(cfg, dtype)
        tiles = [init.gaussian_hotspot(cfg, dtype, window=w) for w in {windows!r}]
        same = all(torch.equal(t, whole[w[0]:w[1], w[2]:w[3]]) for t, w in zip(tiles, {windows!r}))
        digest = hashlib.sha256(whole.numpy().tobytes())
        for t in tiles:
            digest.update(t.numpy().tobytes())
        print(name, torch.get_num_threads(), same, digest.hexdigest(), flush=True)
""").format(repo=REPO, n=N, dtypes=DTYPES, windows=WINDOWS)


def build_here(threads: int):
    """{dtype name: digest of the whole field and its tiles}, built in this
    process on ``threads`` intra-op threads (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        cfg = tconfig.merged_config(None, [f"--nx={N}", f"--ny={N}"])
        out = {}
        for name in DTYPES:
            dtype = getattr(torch, name)
            whole = ti.gaussian_hotspot(cfg, dtype)
            digest = hashlib.sha256(whole.numpy().tobytes())
            for w in WINDOWS:
                tile = ti.gaussian_hotspot(cfg, dtype, window=w)
                assert torch.equal(tile, whole[w[0]:w[1], w[2]:w[3]]), (name, w)
                digest.update(tile.numpy().tobytes())
            out[name] = digest.hexdigest()
        return out
    finally:
        torch.set_num_threads(before)


def test_preset_ic_is_bitwise_equal_across_threads_processes_and_tiles():
    want = build_here(1)
    # Six fresh processes at 4 threads, one at 2 and one at 8, four at a
    # time (each holds a few 4001² fields).
    threads = [4] * 6 + [2, 8]
    results = []
    for i in range(0, len(threads), 4):
        procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(t)], cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for t in threads[i:i + 4]]
        for t, p in zip(threads[i:i + 4], procs):
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            results.append((t, out))
    for t, out in results:
        lines = [ln.split() for ln in out.splitlines()]
        assert [ln[0] for ln in lines] == list(DTYPES)
        for name, got_threads, same, digest in lines:
            assert int(got_threads) == t
            assert same == "True", f"{name}: a tile is not the slice of the field ({t} threads)"
            assert digest == want[name], f"{name}: {t} threads differ from 1 thread"


def test_preset_ic_in_process_at_each_thread_count():
    """1, 2, 4 and 8 threads in this process give the same bits, and the
    caller's thread count is left as it was."""
    before = torch.get_num_threads()
    want = build_here(1)
    for threads in (2, 4, 8):
        assert build_here(threads) == want
    assert torch.get_num_threads() == before


@pytest.mark.parametrize("name", DTYPES)
def test_cpu_preset_ic_never_reaches_torch_exp(monkeypatch, name):
    """With ``torch.exp`` raising on CPU tensors, the field and a window of
    it still build, and equal numpy's single-threaded evaluation of
    ``A exp(-r^2 / (2 sigma^2))`` in the same coordinate dtype."""
    real_exp = torch.exp

    def exp(x, *args, **kwargs):
        if x.device.type == "cpu":
            raise AssertionError("torch.exp on a CPU tensor")
        return real_exp(x, *args, **kwargs)

    monkeypatch.setattr(torch, "exp", exp)
    monkeypatch.setattr(torch.Tensor, "exp", exp)
    dtype = getattr(torch, name)
    cfg = tconfig.merged_config(None, ["--nx=301", "--ny=257"])
    whole = ti.gaussian_hotspot(cfg, dtype)
    tile = ti.gaussian_hotspot(cfg, dtype, window=(17, 140, 33, 301))
    assert torch.equal(tile, whole[17:140, 33:301])

    ndt = np.dtype(name)
    Lx, Ly = cfg.nx * cfg.dx, cfg.ny * cfg.dy
    sig = cfg.ic.sigma_frac * min(Lx, Ly)
    xs = (np.arange(cfg.nx, dtype=ndt) + 0.5) * cfg.dx
    ys = (np.arange(cfg.ny, dtype=ndt) + 0.5) * cfg.dy
    r2 = (xs[None, :] - cfg.ic.xc_frac * Lx) ** 2 + (ys[:, None] - cfg.ic.yc_frac * Ly) ** 2
    want = cfg.ic.A * np.exp(-r2 / (2.0 * sig * sig))
    assert whole.dtype == dtype and whole.numpy().tobytes() == want.astype(ndt).tobytes()
