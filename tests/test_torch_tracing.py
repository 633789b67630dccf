"""The port's tracer (``climate_sim_tpu_torch/runtime/tracing.py``) on the
CPU: the off state costs no clock reading and no profiler annotation, not
in a span, a run or a K1 launch; spans nest with their parents, also in
threads; counters add up; ``collect()`` turns tracing off again however
its block ends; a run records each driver phase once, its loop the very
interval of ``timing:``; under ``torch.profiler`` and with
``profile_dir`` the spans are ``user_annotation`` events of the chrome
trace; ``k1.host_ns`` grows on K1's CUDA path (the stub library and
``cuda_like`` tensors of ``test_torch_coverage_gaps.py``), the only
counter a launch adds, and never on the plain path; and
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
    """The tracer's clock, the profiler check and ``record_function`` all
    raise: nothing may call them while tracing is off."""

    def boom(*args, **kw):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(tracing, "clock", boom)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)


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
    assert set(rec.counters) == {"k1.host_ns"} and rec.spans == []


def test_k1_host_ns_never_on_the_plain_path():
    cfg = make_cfg(100, 40)
    with tracing.collect() as rec:
        out = tcs.multistep_kernel_step(torch.rand(40, 100), cfg, 0.1, 3)
    assert out.shape == (40, 100) and rec.counters == {}


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
