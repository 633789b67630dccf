"""The port's latency tools on the CPU, held to the JAX package's scripts.

* ``scripts/torch_exchange_latency.py``: gloo ranks on the CPU print the
  JAX script's JSON keys plus ``transport`` and ``batches_per_iter``, with
  JAX's ``rounds_per_iter``; its iterations, run on a CPU tile mesh, equal
  JAX's dataflow (``climate_sim_tpu.parallel.halo._pshift`` under
  ``shard_map`` on the virtual devices) bit for bit on the faces and
  within 1e-6 under ``--load``;
* ``scripts/torch_latency_bound.py``: the sleeps it injects a pass equal
  ``exchange_batches`` of the same pass, the depth it prints is 2, and its
  model's arithmetic;
* both scripts, and ``parallel/analysis.py``, where ``jax`` and
  ``climate_sim_tpu`` cannot be imported.

No assertion reads a wall time.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec

from climate_sim_tpu.parallel.halo import _pshift as jpshift
from climate_sim_tpu.parallel.mesh import make_mesh as jmake_mesh

from climate_sim_tpu_torch.parallel.analysis import exchange_batches
from climate_sim_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(*args)
    return rc, buf.getvalue()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card, and a card is present")


def jax_json_keys():
    """The keys of the JSON line ``scripts/exchange_latency.py`` prints."""
    with open(os.path.join(REPO, "scripts", "exchange_latency.py")) as f:
        src = f.read()
    block = src[src.index("print(json.dumps({"):src.index("}), flush=True)")]
    return [a or b for a, b in re.findall(r'^\s*"(\w+)":|, "(\w+)":', block, re.M)]


def test_the_jax_key_list_is_read_whole():
    assert jax_json_keys() == ["ranks", "mesh", "tile", "iters", "load", "raw_s",
                               "iter_cost_coll_s", "iter_cost_ctrl_s",
                               "exchange_cost_per_iter_s", "rounds_per_iter", "per_round_s"]


# ------------------------------------------------------- exchange latency


@pytest.mark.parametrize("ranks, mesh_y, load", [(2, 1, False), (4, 2, False), (4, 2, True)])
def test_exchange_latency_gloo_ranks_print_jax_keys(ranks, mesh_y, load):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_exchange_latency.py"),
         "--device=cpu", f"--ranks={ranks}", f"--mesh-y={mesh_y}", "--tile=32", "--iters=3",
         "--trials=1", *(["--load"] if load else [])],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == [*jax_json_keys(), "transport", "batches_per_iter"]
    px, py = ranks // mesh_y, mesh_y
    # JAX's formula, scripts/exchange_latency.py: one round a longer axis.
    assert out["rounds_per_iter"] == (1 if px > 1 else 0) + (1 if py > 1 else 0)
    assert out["mesh"] == [py, px] and out["load"] == load and out["ranks"] == ranks
    assert out["transport"] == "gloo (host-staged; tiles on the CPU)"
    # Each face shift is its own batch: two a longer axis, twice the rounds.
    assert out["batches_per_iter"] == 2 * out["rounds_per_iter"]
    assert set(out["raw_s"]) == {"coll_3", "ctrl_3", "coll_6", "ctrl_6"}


def test_exchange_latency_rejects_a_mesh_that_does_not_divide(capsys):
    with pytest.raises(SystemExit):
        load_script("torch_exchange_latency").main(["--device=cpu", "--ranks=3",
                                                     "--mesh-y=2"])
    assert "--mesh-y must divide --ranks" in capsys.readouterr().err


def jax_iterations(px, py, n, load, arrays):
    """The JAX script's ``one_iter`` / ``one_iter_loaded`` (with the
    exchange), n times under ``shard_map`` on a (py, px) mesh of the
    virtual devices."""
    mesh = jmake_mesh(px, py, jax.devices()[: px * py])

    def shift(face, axis_name, m, s):
        return jpshift(face, axis_name, m, s)

    def one_iter(col, row):
        h = jnp.float32(0.5)
        gl = shift(col, "x", px, +1)
        gr = shift(col, "x", px, -1)
        col2 = h * (gl + gr)
        row_src = row.at[:, :1].set(col2[:1, :]).at[:, -1:].set(col2[-1:, :])
        gb = shift(row_src, "y", py, +1)
        gt = shift(row_src, "y", py, -1)
        return col2, h * (gb + gt)

    def one_iter_loaded(u):
        gl = shift(u[:, -1:], "x", px, +1)
        gr = shift(u[:, :1], "x", px, -1)
        mid = jnp.concatenate([gl, u, gr], axis=1)
        gb = shift(mid[-1:, :], "y", py, +1)
        gt = shift(mid[:1, :], "y", py, -1)
        full = jnp.concatenate([gb, mid, gt], axis=0)
        c = full[1:-1, 1:-1]
        return jnp.float32(0.2) * (
            c + full[:-2, 1:-1] + full[2:, 1:-1] + full[1:-1, :-2] + full[1:-1, 2:])

    spec = PartitionSpec("y", "x")
    if load:
        body = lambda u: lax.fori_loop(0, n, lambda i, v: one_iter_loaded(v), u)  # noqa: E731
        specs = spec
    else:
        body = lambda c, r: lax.fori_loop(0, n, lambda i, s: one_iter(*s), (c, r))  # noqa: E731
        specs = (spec, spec)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs, out_specs=specs))
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)) for a in arrays]
    out = fn(*args)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def blocks(a, py, px):
    """A global array as the port's (py, px) grid of CPU tiles."""
    h, w = a.shape[0] // py, a.shape[1] // px
    return [[torch.from_numpy(np.ascontiguousarray(a[y * h:(y + 1) * h, x * w:(x + 1) * w]))
             for x in range(px)] for y in range(py)]


def unblock(tiles):
    return np.block([[t.numpy() for t in row] for row in tiles])


@pytest.mark.parametrize("px, py", [(2, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("load", [False, True])
def test_iterations_match_the_jax_dataflow(px, py, load):
    """Three iterations from seeded f32 faces (or tiles): the faces bit for
    bit, the loaded tiles within 1e-6."""
    script = load_script("torch_exchange_latency")
    rng = np.random.default_rng(7)
    my = mx = 8
    n = 3
    mesh = make_mesh(px, py, ["cpu"] * (px * py))
    if load:
        u = rng.random((my * py, mx * px)).astype(np.float32)
        want, = jax_iterations(px, py, n, True, [u])
        tiles = blocks(u, py, px)
        for _ in range(n):
            tiles = script.loaded_iter(tiles, mesh, True)
        np.testing.assert_allclose(unblock(tiles), want, rtol=0, atol=1e-6)
        return
    col = rng.random((my * py, px)).astype(np.float32)
    row = rng.random((py, (mx + 2) * px)).astype(np.float32)
    want_col, want_row = jax_iterations(px, py, n, False, [col, row])
    cols, rows = blocks(col, py, px), blocks(row, py, px)
    for _ in range(n):
        cols, rows = script.face_iter(cols, rows, mesh, True)
    assert np.array_equal(unblock(cols), want_col)
    assert np.array_equal(unblock(rows), want_row)


def test_the_control_exchanges_nothing():
    script = load_script("torch_exchange_latency")
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    tiles = [[torch.ones(8, 8) for _ in range(2)] for _ in range(2)]
    faces = ([[torch.ones(8, 1)] * 2] * 2, [[torch.ones(1, 10)] * 2] * 2)
    assert exchange_batches(lambda t: script.loaded_iter(t, mesh, False), tiles) == 0
    assert exchange_batches(lambda f: script.face_iter(*f, mesh, False), faces) == 0
    assert exchange_batches(lambda t: script.loaded_iter(t, mesh, True), tiles) == 4


# ---------------------------------------------------------- latency bound

BOUND_ARGS = ["--device=cpu", "--devices", "4", "--tile", "16", "--latencies-ms", "0", "1",
              "--passes", "2", "--trials", "1"]


def test_latency_bound_sleeps_once_a_batch():
    script = load_script("torch_latency_bound")
    rc, out = run_main(script.main, BOUND_ARGS)
    assert rc == 0, out
    assert "mesh x=2 y=2" in out
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    for path in script.PATHS:
        m = re.search(rf"^{path}: slope dT_pass/dL = \S+; injected sleeps a pass (\S+);"
                      rf" depth (\d+), batches (\d+)$", out, re.M)
        assert m, path
        cfg = script.path_cfg(path, 32, 32, 16)
        adv, tiles = script.build(path, cfg, mesh, torch.device("cpu"))
        want = exchange_batches(adv(adv.steps_per_pass), tiles)
        assert float(m.group(1)) == want == int(m.group(3))
        assert int(m.group(2)) == 2
        assert len(re.findall(rf"^{path}: L=", out, re.M)) == 2
    assert "batches 8" in out  # the staged carrier torus
    assert "model: no card figures" in out


def test_latency_bound_model_rows():
    script = load_script("torch_latency_bound")
    rc, out = run_main(script.main, [*BOUND_ARGS, "--hw-slab-gpts", "200",
                                     "--hw-overlap-gpts", "50", "--model-latency-us", "30"])
    assert rc == 0, out
    assert "rates --hw-slab-gpts / --hw-overlap-gpts: slab 200.00 Gpt/s" in out
    assert len(re.findall(r"L=   30.000 us: eff", out)) == 4  # 2 tiles x 2 paths
    with pytest.raises(SystemExit):
        script.main([*BOUND_ARGS, "--hw-slab-gpts", "200"])


def test_model_lines_arithmetic():
    script = load_script("torch_latency_bound")
    lines = script.model_lines([4096], {"slab": 200.0, "overlap": 50.0}, [100.0],
                               {"slab": (2, 4), "overlap": (1, 2)})
    t_slab = 8 * 4096 * 4096 / 200e9
    t_ovl = 8 * 4096 * 4096 / 50e9
    slab_row = next(ln for ln in lines if ln.strip().startswith("slab "))
    effs = [float(v) / 100 for v in re.findall(r"(\S+)% \(n = ", slab_row)]
    assert effs == pytest.approx([t_slab / (t_slab + 2e-4), t_slab / (t_slab + 4e-4)],
                                 abs=5e-5)
    depth_l, batch_l = (float(re.search(r"L\* = (\S+) us", ln).group(1))
                        for ln in lines if "breakeven" in ln)
    assert depth_l == pytest.approx((t_ovl - t_slab) * 1e6 / 1, abs=0.05)
    assert batch_l == pytest.approx((t_ovl - t_slab) * 1e6 / 2, abs=0.05)
    same = script.model_lines([4096], {"slab": 200.0, "overlap": 50.0}, [],
                              {"slab": (2, 4), "overlap": (2, 4)})
    assert sum("breakeven" in ln and "none, both paths serialize" in ln for ln in same) == 2


@pytest.mark.parametrize("name", ["torch_exchange_latency", "torch_latency_bound"])
def test_latency_tool_without_a_card_fails(name, no_card):
    rc, out = run_main(load_script(name).main, [])
    assert rc != 0 and "T_pass" not in out and "per_round_s" not in out


def test_no_latency_tool_imports_jax():
    """``parallel/analysis.py`` and both scripts imported, and their CPU
    paths run, where importing ``jax`` or ``climate_sim_tpu`` fails."""
    code = textwrap.dedent(f"""
        import contextlib, importlib.util, io, os, sys
        sys.modules["jax"] = None
        sys.modules["climate_sim_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import torch
        from climate_sim_tpu_torch.parallel.analysis import exchange_batches
        from climate_sim_tpu_torch.parallel.mesh import make_mesh
        mods = {{}}
        for name in ("torch_exchange_latency", "torch_latency_bound"):
            spec = importlib.util.spec_from_file_location(name, os.path.join({REPO!r}, "scripts", name + ".py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
        mesh = make_mesh(2, 2, ["cpu"] * 4)
        tiles = [[torch.ones(8, 8) for _ in range(2)] for _ in range(2)]
        n = exchange_batches(lambda t: mods["torch_exchange_latency"].loaded_iter(t, mesh, True), tiles)
        assert n == 4, n
        with contextlib.redirect_stdout(io.StringIO()):
            assert mods["torch_latency_bound"].main({BOUND_ARGS!r}) == 0
        assert not any(m == "jax" or m.split(".")[0] == "climate_sim_tpu"
                       for m in sys.modules if sys.modules[m] is not None)
        print("NO_JAX_OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stderr[-3000:]
