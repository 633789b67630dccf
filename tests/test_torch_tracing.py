"""The port's tracer (``climate_sim_tpu_torch/runtime/tracing.py``) on the
CPU: the off state costs no clock reading and no profiler annotation, not
in a span, a run or a K1 launch; spans nest with their parents, also in
threads; counters add up; ``collect()`` turns tracing off again however
its block ends; a run records each driver phase once, its loop the very
interval of ``timing:``; under ``torch.profiler`` and with
``profile_dir`` the spans are ``user_annotation`` events of the chrome
trace; ``k1.host_ns`` grows on K1's CUDA path (the stub library and
``cuda_like`` tensors of ``test_torch_coverage_gaps.py``) and never on the
plain path; ``k1.wide_launches`` and ``multistep_kernel_step.wide_launches``
advance only on launches of K1's wide body; each launch counts under the
name of its cut (``k1.cut.*``) and adds the window rows its blocks run with
the fixed y sides' selects (``k1.select_rows``, ``k1_select_rows``); and
``climate.library`` notes a build and a load.
"""

import contextlib
import io
import json
import os
import re
import sys
import threading

import pytest
import torch

from climate_sim_tpu_torch.config import merged_config
from climate_sim_tpu_torch.ops import _build
from climate_sim_tpu_torch.ops import cuda_stencil as tcs
from climate_sim_tpu_torch.runtime import tracing
from climate_sim_tpu_torch.runtime.driver import run_simulation

from test_torch_coverage_gaps import (  # noqa: F401  (fixtures)
    cuda_like,
    fake_toolkit,
    launch_env,
    make_cfg,
    needs_cc,
    recorded,
    stub,
    stub_library,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, "configs", "dev.yaml")
# The driver's spans of one call, in the order they close.
CALL_SPANS = ["climate.prepare", "climate.ic_stats", "climate.capture", "climate.warmup",
              "climate.loop", "climate.finish", "climate.call"]


def small_cfg(*extra):
    return merged_config(DEV, ["--nx=48", "--ny=32", "--steps=30", "--out_every=10",
                               "--kernel=pallas", *extra])


def quiet_run(cfg, devices=("cpu",)):
    """(RunResult, stdout) of one call of the driver."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = run_simulation(cfg, list(devices), write_output=False)
    return result, buf.getvalue()


@pytest.fixture
def forbidden(monkeypatch):
    """The tracer's clock, the profiler check, ``record_function``, the
    name of K1's cut counter and its count of select rows all raise:
    nothing may call them while tracing is off."""

    def boom(*args, **kw):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(tracing, "clock", boom)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(tcs, "k1_cut_counter", boom)
    monkeypatch.setattr(tcs, "k1_select_rows", boom)


def test_off_span_is_one_shared_noop(forbidden):
    assert not tracing.ON
    first, second = tracing.span("climate.a"), tracing.span("climate.b")
    assert first is second is tracing._OFF
    with first as s, second:
        s.at(1, 2)
        s.note("nothing")
    tracing.add("k1.host_ns", 5)
    with tracing.collect() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_off_run_reads_no_clock(forbidden):
    result, out = quiet_run(small_cfg())
    assert result.steps == 30 and "timing: total_max=" in out


def test_off_k1_launch_reads_no_clock(stub, forbidden):
    before = tcs.multistep_kernel_step.launches
    tcs.multistep_kernel_step(cuda_like(torch.rand(40, 100)), make_cfg(100, 40), 0.1, 3)
    assert tcs.multistep_kernel_step.launches == before + 1


def test_spans_nest_with_their_parents():
    with tracing.collect() as rec:
        with tracing.span("climate.a"):
            with tracing.span("climate.b"):
                with tracing.span("climate.c"):
                    pass
            with tracing.span("climate.d"):
                pass
        with tracing.span("climate.e"):
            pass
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["climate.c", "climate.b", "climate.d",
                                           "climate.a", "climate.e"]
    assert {n: s.parent for n, s in by.items()} == {
        "climate.a": None, "climate.b": "climate.a", "climate.c": "climate.b",
        "climate.d": "climate.a", "climate.e": None}
    a, b, c, d = by["climate.a"], by["climate.b"], by["climate.c"], by["climate.d"]
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= by["climate.e"].start_ns


def test_span_takes_the_callers_readings_and_a_note():
    with tracing.collect() as rec:
        with tracing.span("climate.x") as s:
            s.at(100, 350)
            s.note("built")
    (span,) = rec.spans
    assert (span.start_ns, span.end_ns, span.note) == (100, 350, "built")
    assert span.seconds == 250e-9
    assert rec.seconds() == {"climate.x": 250e-9}


def test_record_sums_seconds_by_name(monkeypatch):
    ticks = iter(range(0, 1000, 10))
    monkeypatch.setattr(tracing, "clock", lambda: next(ticks))
    with tracing.collect() as rec:
        for _ in range(3):
            with tracing.span("climate.y"):
                with tracing.span("climate.z"):
                    pass
    # each y: 0..30 ns with its z 10..20 ns inside
    assert rec.seconds() == {"climate.y": pytest.approx(90e-9),
                             "climate.z": pytest.approx(30e-9)}


def test_counters_add_up():
    with tracing.collect() as rec:
        tracing.add("k1.host_ns", 5)
        tracing.add("k1.host_ns", 7)
        tracing.add("other", 1)
    assert rec.counters == {"k1.host_ns": 12, "other": 1}
    tracing.add("k1.host_ns", 1)
    assert rec.counters["k1.host_ns"] == 12


def test_counters_from_many_threads_lose_no_add():
    threads, adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.collect() as rec:
            workers = [threading.Thread(target=lambda: [tracing.add("n", 1) for _ in range(adds)])
                       for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters == {"n": threads * adds}


def test_each_thread_has_its_own_parents():
    inside, release = threading.Event(), threading.Event()

    def other():
        with tracing.span("climate.other"):
            inside.set()
            release.wait(60)
            with tracing.span("climate.other_child"):
                pass

    with tracing.collect() as rec:
        with tracing.span("climate.main"):
            t = threading.Thread(target=other)
            t.start()
            assert inside.wait(60)
            with tracing.span("climate.main_child"):
                pass
            release.set()
            t.join(60)
            assert not t.is_alive()
    parents = {s.name: s.parent for s in rec.spans}
    assert parents == {"climate.main_child": "climate.main", "climate.other_child":
                       "climate.other", "climate.other": None, "climate.main": None}


def test_collect_turns_tracing_off_on_exit():
    with tracing.collect() as rec:
        assert tracing.ON and isinstance(rec, tracing.Record)
        assert tracing.span("climate.a") is not tracing._OFF
    assert not tracing.ON and tracing.span("climate.a") is tracing._OFF


def test_collect_turns_tracing_off_on_an_exception():
    with pytest.raises(ZeroDivisionError):
        with tracing.collect() as rec:
            with tracing.span("climate.a"):
                with tracing.span("climate.b"):
                    1 / 0
    assert not tracing.ON
    assert [(s.name, s.parent) for s in rec.spans] == [("climate.b", "climate.a"),
                                                       ("climate.a", None)]
    # no span is left open: the next one has no parent
    with tracing.collect() as again:
        with tracing.span("climate.c"):
            pass
    assert again.spans[0].parent is None


def test_collect_inside_collect_shares_the_outer_record():
    with tracing.collect() as outer:
        with tracing.collect() as inner:
            assert inner is outer
            with tracing.span("climate.a"):
                pass
        assert tracing.ON
        tracing.add("n", 1)
    assert not tracing.ON
    assert [s.name for s in outer.spans] == ["climate.a"] and outer.counters == {"n": 1}


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 4], ids=["single", "mesh2x2"])
def test_a_run_records_each_phase_once(devices):
    with tracing.collect() as rec:
        result, out = quiet_run(small_cfg(), devices)
    assert [s.name for s in rec.spans] == CALL_SPANS
    by = {s.name: s for s in rec.spans}
    call, loop = by["climate.call"], by["climate.loop"]
    assert all(by[n].parent == "climate.call" for n in CALL_SPANS[:-1])
    assert call.parent is None
    assert call.start_ns <= loop.start_ns <= loop.end_ns <= call.end_ns
    # the loop is the interval ``timing:`` measures, to the nanosecond
    assert loop.seconds == result.total_time
    (timing,) = re.findall(r"^timing: total_max=(\S+) s", out, re.M)
    assert float(timing) == pytest.approx(loop.seconds, rel=1e-5)
    assert rec.counters == {}  # the plain path counts no launch time
    assert (result.mesh_shape is None) == (len(devices) == 1)


def test_each_call_records_its_own_spans():
    with tracing.collect() as rec:
        quiet_run(small_cfg())
        quiet_run(small_cfg("--steps=20"))
    assert [s.name for s in rec.spans] == CALL_SPANS * 2
    loops = [s for s in rec.spans if s.name == "climate.loop"]
    assert loops[0].end_ns < loops[1].start_ns


def chrome_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_spans_are_annotations_of_the_profilers_trace(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.collect() as rec:
            quiet_run(small_cfg())
    events = chrome_events(prof, tmp_path)
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(tracing.PREFIX)}
    assert sorted(notes) == sorted(CALL_SPANS)
    loop, call = notes["climate.loop"], notes["climate.call"]
    assert call["ts"] <= loop["ts"] and loop["ts"] + loop["dur"] <= call["ts"] + call["dur"]
    # the loop's operators lie inside its annotation, on the same clock
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and loop["ts"] <= e["ts"] <= loop["ts"] + loop["dur"]]
    assert len(ops) > 10
    # the annotation and the span measure the same interval, about
    by = {s.name: s for s in rec.spans}
    assert loop["dur"] == pytest.approx(by["climate.loop"].seconds * 1e6, rel=0.2, abs=500)


def test_profile_dir_trace_holds_the_loop(tmp_path):
    result, out = quiet_run(small_cfg(f"--profile_dir={tmp_path}/prof"))
    assert not tracing.ON
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    # the profiler's warm-up step (the warm-up pass) is dropped, the loop kept
    assert names.count("climate.loop") == 1 and "climate.warmup" not in names
    # inside an outer collect() the call's spans go to the outer record
    with tracing.collect() as rec:
        quiet_run(small_cfg(f"--profile_dir={tmp_path}/prof2"))
    assert [s.name for s in rec.spans] == CALL_SPANS


def test_k1_host_ns_grows_on_the_cuda_path(stub):
    cfg, u = make_cfg(100, 40), cuda_like(torch.rand(40, 100))
    before = tcs.multistep_kernel_step.launches
    seen = []
    with tracing.collect() as rec:
        for _ in range(3):
            tcs.multistep_kernel_step(u, cfg, 0.1, 3)
            seen.append(rec.counters["k1.host_ns"])
    assert tcs.multistep_kernel_step.launches == before + 3
    assert 0 < seen[0] < seen[1] < seen[2]
    # k = 3 runs the wide body, which has its own counter, and its cut one;
    # y wraps, so no row selects
    cut = tcs.k1_cut_counter(40, 100, 3, torch.float32)
    assert set(rec.counters) == {"k1.host_ns", "k1.wide_launches", cut,
                                 "k1.select_rows"} and rec.spans == []
    assert rec.counters["k1.wide_launches"] == rec.counters[cut] == 3
    assert rec.counters["k1.select_rows"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_k1_wide_launches_count_only_the_wide_body(stub, dtype):
    """Passes up to WIDE_MAX_STEPS run the wide body (cpt > 1) and count in
    both counters; a deeper pass runs the one-column body and counts in
    neither; each launch's band (k1_geometry's) reaches the C interface."""
    cfg, u = make_cfg(100, 40), cuda_like(torch.rand(40, 100).to(dtype))
    launches = tcs.multistep_kernel_step.launches
    wide = tcs.multistep_kernel_step.wide_launches
    with tracing.collect() as rec:
        for k in (1, 3, 8, 9, 16, 32, 4):
            tcs.multistep_kernel_step(u, cfg, 0.1, k)
            geo = tcs.k1_geometry(40, 100, k, dtype)
            assert (geo.cpt > 1) == (k <= tcs.WIDE_MAX_STEPS)
            assert recorded(stub)[1][8:] == [geo.width, geo.rows, 0]  # 0: the stream
    assert tcs.multistep_kernel_step.launches == launches + 7
    assert tcs.multistep_kernel_step.wide_launches == wide + 4
    assert rec.counters["k1.wide_launches"] == 4


@pytest.mark.parametrize("dtype,name", [(torch.float32, "f32"), (torch.float64, "f64"),
                                        (torch.bfloat16, "bf16")])
def test_k1_cut_counters_name_the_cut_that_ran(stub, dtype, name):
    """Each launch adds 1 to the counter of its cut, whose name spells out
    k1_geometry's: dtype, k, columns a thread, block threads, bands,
    segments, rows; the same cut counts in one counter."""
    cfg, u = make_cfg(100, 40), cuda_like(torch.rand(40, 100).to(dtype))
    with tracing.collect() as rec:
        for k in (8, 8, 4, 16):
            tcs.multistep_kernel_step(u, cfg, 0.1, k)
    cuts = {k: tcs.k1_cut_counter(40, 100, k, dtype) for k in (8, 4, 16)}
    assert {c: n for c, n in rec.counters.items() if c.startswith("k1.cut.")} == {
        cuts[8]: 2, cuts[4]: 1, cuts[16]: 1}
    for k, cut in cuts.items():
        g = tcs.k1_geometry(40, 100, k, dtype)
        assert cut == (f"k1.cut.{name}.k{k}.c{g.cpt}.t{g.width // g.cpt}"
                       f".b{g.bands}.s{g.segments}.r{g.rows}")
    assert cuts[16].split(".")[4] == "c1" and cuts[8].split(".")[4] != "c1"


def test_k1_cut_counter_of_the_parity_grid():
    """4096² f64 at k = 8: two columns a thread, as the parity cell runs."""
    assert tcs.k1_cut_counter(4096, 4096, 8, torch.float64).startswith("k1.cut.f64.k8.c2.")


DTYPES = [torch.float32, torch.float64, torch.bfloat16]
D, N, P = "dirichlet", "neumann", "periodic"
# (left, right, bottom, top): the fixed y sides each class has
Y_FIXED = {"bottom": (P, P, D, P), "top": (D, N, P, N), "both": (D, D, D, D),
           "both_x_wrap": (P, P, D, N)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_sides", [(D, N), (P, P), (N, D)])
def test_k1_select_rows_zero_with_y_periodic(dtype, x_sides):
    """No fixed bottom or top side, no row selects, whatever the x sides,
    the cut and the body."""
    for shape in ((4096, 4096), (40, 100), (7, 300), (333, 241)):
        for k in (1, 3, 4, 8, 9, 16, 32):
            assert tcs.k1_select_rows(*shape, k, dtype, 0, 0) == 0


@pytest.mark.parametrize("dtype, k, bottom, top, both", [
    (torch.float64, 8, 480, 552, 552), (torch.float64, 4, 170, 221, 221),
    (torch.float32, 8, 396, 396, 396), (torch.float32, 4, 121, 121, 121),
    (torch.bfloat16, 8, 396, 396, 396)])
def test_k1_select_rows_of_the_parity_grid(dtype, k, bottom, top, both):
    """4096²: f64 at k = 8 (k1.cut.f64.k8.c2.t96.b24.s22.r187) runs 24 bands
    x (12 + 11) rows with both y sides fixed: the first segment's rows 6-17
    (row ny - 1 wraps to window row 7, row 0 is window row 8), the last's
    rows 174-184 of 185 (row ny - 1 at 176, row 0 at 177); the block-wide
    rule would have run 24 x (203 + 185) = 9312.  A bottom side alone ends
    the first span at 8 + 8 + 1 rounded up as well, and starts the last at
    177: 24 x (12 + 8).  f32 and bf16 share their cut."""
    assert tcs.k1_select_rows(4096, 4096, k, dtype, 1, 0) == bottom
    assert tcs.k1_select_rows(4096, 4096, k, dtype, 0, 2) == top
    assert tcs.k1_select_rows(4096, 4096, k, dtype, 1, 1) == both


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fixed", ["bottom", "top", "both"])
def test_k1_select_rows_follow_the_rule(dtype, fixed):
    """The rule on each block of the cut: from the first window row of a
    fixed side, rounded down to a multiple of 3, to KB + 1 rows past the
    last, rounded up, at most the window; the one-column body (k > 8)
    counts every window row of a block that holds a fixed side's row."""
    fb, ft = {"bottom": (1, 0), "top": (0, 2), "both": (3, 1)}[fixed]
    for ny, nx in ((40, 100), (333, 241), (7, 300), (4096, 4096)):
        for k in (1, 2, 3, 5, 8, 9, 16):
            g = tcs.k1_geometry(ny, nx, k, dtype)
            kb = next(b for b in (1, 2, 4, 8, 16, 32) if b >= k)
            want = 0
            for y0 in range(0, ny, g.rows):
                rows = min(g.rows, ny - y0) + 2 * k
                bits = [j for j in range(rows) if (fb and (y0 - k + j) % ny == 0)
                        or (ft and (y0 - k + j) % ny == ny - 1)]
                if bits and g.cpt == 1:
                    want += rows
                elif bits:
                    want += min(rows, -(-(bits[-1] + kb + 1) // 3) * 3) - bits[0] // 3 * 3
            assert tcs.k1_select_rows(ny, nx, k, dtype, fb, ft) == want * g.bands > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bc_class", list(Y_FIXED))
def test_k1_select_rows_counter_adds_each_launch(stub, bc_class, dtype):
    """Each traced launch adds its k1_select_rows, with the side codes the
    launch passed to the kernel."""
    cfg = make_cfg(100, 40, Y_FIXED[bc_class])
    u = cuda_like(torch.rand(40, 100).to(dtype))
    fb, ft = (tcs._fix_code(b, False) for b in (cfg.bc.bottom, cfg.bc.top))
    with tracing.collect() as rec:
        for k in (8, 8, 4, 16, 3):
            tcs.multistep_kernel_step(u, cfg, 0.1, k)
            assert recorded(stub)[1][6:8] == [fb, ft]
    want = sum(tcs.k1_select_rows(40, 100, k, dtype, fb, ft) for k in (8, 8, 4, 16, 3))
    assert rec.counters["k1.select_rows"] == want > 0


def test_k1_select_rows_counter_silent_while_tracing_is_off(stub):
    """A launch made with tracing off adds nothing: the record holds only
    the traced launch's rows."""
    cfg = make_cfg(100, 40, Y_FIXED["both"])
    u = cuda_like(torch.rand(40, 100))
    tcs.multistep_kernel_step(u, cfg, 0.1, 8)
    with tracing.collect() as rec:
        tcs.multistep_kernel_step(u, cfg, 0.1, 4)
    assert rec.counters["k1.select_rows"] == tcs.k1_select_rows(40, 100, 4, torch.float32, 1, 1)


def test_k1_wide_launches_absent_while_tracing_is_off(stub):
    cfg, u = make_cfg(100, 40), cuda_like(torch.rand(40, 100))
    wide = tcs.multistep_kernel_step.wide_launches
    tcs.multistep_kernel_step(u, cfg, 0.1, 8)
    assert tcs.multistep_kernel_step.wide_launches == wide + 1
    with tracing.collect() as rec:
        tcs.multistep_kernel_step(u, cfg, 0.1, 16)  # the one-column body
    assert "k1.wide_launches" not in rec.counters
    assert tcs.multistep_kernel_step.wide_launches == wide + 1
    # the k = 8 launch, made with tracing off, left no cut counter behind
    assert [c for c in rec.counters if c.startswith("k1.cut.")] == [
        tcs.k1_cut_counter(40, 100, 16, torch.float32)]


def test_k1_host_ns_never_on_the_plain_path():
    cfg = make_cfg(100, 40)
    wide = tcs.multistep_kernel_step.wide_launches
    with tracing.collect() as rec:
        out = tcs.multistep_kernel_step(torch.rand(40, 100), cfg, 0.1, 3)
    assert out.shape == (40, 100) and rec.counters == {}
    assert tcs.multistep_kernel_step.wide_launches == wide


@needs_cc
def test_library_span_notes_a_build_then_a_load(tmp_path, monkeypatch):
    with fake_toolkit(monkeypatch, tmp_path):
        with tracing.collect() as rec:
            built = _build.load_library()
            _build.load_library()  # cached: no second span
            _build.load_library.cache_clear()
            loaded = _build.load_library()
        _build.load_library.cache_clear()
        _build.load_library()  # tracing off: nothing recorded
    assert built.built and not loaded.built
    assert [(s.name, s.parent, s.note) for s in rec.spans] == [
        ("climate.library", None, "built"), ("climate.library", None, "loaded")]
    assert rec.spans[0].seconds >= built.seconds > 0
