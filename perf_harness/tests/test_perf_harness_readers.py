"""The trace reduction and the per-layer readers on a synthetic trace: two
cards, a known busy span, a lost stencil event, the program's spans as
annotations; the readers of the program's spans and counters on what the
harness keeps of them; and the roofline share, which no implementation
that does the stencil's work can push past 100%."""

import math

import pytest

from harness_tiny import REPO

import layout  # noqa: E402
import roofline  # noqa: E402
import trace  # noqa: E402

CARD = "NVIDIA H100 80GB HBM3"
STENCIL = "band_kernel"
POINTS = 1_000_000
STEPS = 10


def kernel(name, ts, dur, device, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": device, "args": {"device": device}}


def host(name, ts, dur):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur,
            "pid": 99, "tid": 1}


def events():
    k = "void climate::band_kernel<float, float, 8>(...)"
    return [
        # card 0: three stencil events of the four launches (one lost), then
        # NCCL and a copy; busy 38 us, stencil 30 us
        kernel(k, 0, 10, 0), kernel(k, 12, 10, 0), kernel(k, 24, 10, 0),
        kernel("ncclDevKernel_SendRecv(ncclDevComm*)", 34, 6, 0),
        kernel("Memcpy DtoD (Device -> Device)", 40, 2, 0, cat="gpu_memcpy"),
        # card 1: four stencil events and a set; busy 45 us, stencil 40 us
        kernel(k, 0, 10, 1), kernel(k, 10, 10, 1), kernel(k, 25, 10, 1),
        kernel(k, 35, 10, 1),
        kernel("Memset (Device)", 20, 5, 1, cat="gpu_memset"),
        # the host: a launch, then a sync that covers card 0's two gaps
        host("cudaLaunchKernel", 0, 2), host("cudaStreamSynchronize", 9, 20),
        # a CPU-side event that is no device event
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 1, "dur": 1, "pid": 99},
    ]


def annotation(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 99, "tid": 1}


def spanned_events():
    """One card inside the program's spans: the call covers it all, its
    warm-up pass runs from 0 to 11 us and its loop from 11 to 45; the card
    is busy 0-10 (the warm-up pass), then 12-20, 22-30 and 34-40 inside the
    loop.  A launch covers the gap at 10-12, a sync the one at 20-22, no
    host call the one at 30-34."""
    k = "void climate::band_kernel<float, float, 8>(...)"
    return [
        annotation("climate.call", 0, 50), annotation("climate.warmup", 0, 11),
        annotation("climate.loop", 11, 34),
        kernel(k, 0, 10, 0), kernel(k, 12, 8, 0), kernel(k, 22, 8, 0),
        kernel("Memcpy DtoD (Device -> Device)", 34, 6, 0, cat="gpu_memcpy"),
        host("cudaLaunchKernel", 9, 2), host("cudaDeviceSynchronize", 19, 4),
        # an annotation that is not the program's names a gap as before
        annotation("ProfilerStep#1", 40, 20),
    ]


def summary(evs=None, launches=(4, 4), wall_us_a_step=6.0):
    cards = trace.card_summaries(evs or events(), STENCIL, "climate.")
    out = []
    for (dev, c), n in zip(sorted(cards.items()), launches):
        c.update(rank=dev, stencil_launches=n, points=POINTS)
        out.append(c)
    return {
        "card": CARD, "setup_s": 1.5,
        "config": {"precision": "f32"}, "traffic": {"out_every": 100},
        "window": {"wall_s": wall_us_a_step * 1e-6 * 1000, "steps": 1000, "jobs": 2,
                   "points": 4 * POINTS, "lines": ["timing: total_max=1 s"]},
        "trace": {"wall_s": 1.0, "steps": STEPS, "cards": out},
        # one rank's observed jobs: 5, 40 and 4 ms outside the loop, and
        # 24, 25 and 90 us a launch: medians 5 ms and 25 us
        "program": {"warmup": [observed(call=0.9, loop=0.01)],
                    "jobs": [[observed(call=0.615, loop=0.61, host_ns=2.4e8, launches=10000),
                              observed(call=0.65, loop=0.61, host_ns=2.5e8, launches=10000),
                              observed(call=0.614, loop=0.61, host_ns=9e8, launches=10000)]],
                    "trace": [observed(call=0.7, loop=0.69)]},
    }


def observed(call, loop, host_ns=None, launches=0):
    """What ``cell.observed`` keeps of one job of one rank."""
    return {"spans_s": {"climate.call": call, "climate.loop": loop, "climate.prepare": 1e-3},
            "span_counts": {"climate.call": 1, "climate.loop": 1, "climate.prepare": 1},
            "counters": {} if host_ns is None else {"k1.host_ns": host_ns,
                                                    "k1.wide_launches": launches},
            "k1_launches": launches}


def read(name, s):
    return layout.Layout(REPO).reader(name)(s)


def test_card_summaries():
    cards = trace.card_summaries(events(), STENCIL, "climate.")
    assert sorted(cards) == [0, 1]
    c0, c1 = cards[0], cards[1]
    assert (c0["busy_us"], c0["stencil_union_us"], c0["stencil_events"]) == (38, 30, 3)
    assert (c1["busy_us"], c1["stencil_union_us"], c1["stencil_events"]) == (45, 40, 4)
    assert c0["gaps"] == {"cudaStreamSynchronize": 4.0}
    assert c1["gaps"] == {}
    assert c0["ops"]["ncclDevKernel_SendRecv(ncclDevComm*)"] == 6


def test_device_idle_pct():
    # busy a step: card 0 (38 + 10 for the lost event) / 10, card 1 45 / 10;
    # wall a step 6 us
    assert read("device_idle_pct", summary()) == pytest.approx(100 * (0.2 + 0.25) / 2)


def test_stencil_roofline_pct():
    least = max(2 * 4 * POINTS / 3.35e12, 9 * POINTS * STEPS / 67e12)  # bytes bind here
    assert read("stencil_roofline_pct", summary()) == pytest.approx(
        100 * 2 * least / (2 * 40e-6))


def test_lost_events_do_not_raise_the_share():
    full = events()
    full.insert(3, kernel("void climate::band_kernel<float, float, 8>(...)", 50, 10, 0))
    assert read("stencil_roofline_pct", summary(full)) == pytest.approx(
        read("stencil_roofline_pct", summary()))


@pytest.mark.parametrize("steps,out_every,precision", [
    (10, 100, "f32"), (1000, 100, "f32"), (800, 8, "f64"), (100, 1, "bf16")])
def test_no_share_passes_100_for_work_done(steps, out_every, precision):
    """A card that does the work at its published peak, the faster of its
    two bounds unmet, takes the bound's time: the share is 100%, and any
    real kernel, slower, reads less."""
    nbytes, flops = roofline.stencil_work(POINTS, steps, out_every, precision)
    at_peak = roofline.bound_s(nbytes, flops, precision, CARD)[0]
    launches = 7

    def share(slower):
        evs = [kernel("band_kernel", i * 1e7, slower * at_peak * 1e6 / launches, 0)
               for i in range(launches)]
        s = summary(evs, launches=(launches,))
        s["trace"]["steps"], s["traffic"]["out_every"] = steps, out_every
        s["config"]["precision"] = precision
        return read("stencil_roofline_pct", s)

    assert share(1.0) == pytest.approx(100.0)
    assert share(1.01) < 100.0


def test_work_is_not_the_pass_schedule():
    # one read and one write of the field a span, whatever the passes
    assert roofline.stencil_work(10, 250, 100, "f32") == (2 * 4 * 10 * 3, 9 * 10 * 250)


def test_readers_find_nothing_without_a_trace():
    s = summary()
    s["trace"] = None
    for name in ("stencil_roofline_pct", "device_idle_pct"):
        assert read(name, s) is None


def test_end_to_end_readers():
    s = summary()
    assert read("gpoint_per_s", s) == pytest.approx(4 * POINTS * 1000 / 6e-3 / 1e9)
    assert read("setup_s", s) == 1.5


def test_breakdown():
    b = trace.breakdown(list(trace.card_summaries(events(), STENCIL, "climate.").values()))
    assert b["device_ops"][0] == ["void climate::band_kernel<float, float, 8>(...)",
                                  pytest.approx(70e-6)]
    assert b["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(4e-6)]]
    assert len(b["device_ops"]) <= trace.TOP
    assert not math.isnan(b["device_ops"][-1][1])


def test_program_spans_name_no_gap_and_bound_the_loop():
    cards = trace.card_summaries(spanned_events(), STENCIL, "climate.")
    c = cards[0]
    # gaps named by host calls, never by the program's annotations
    assert c["gaps"] == {"cudaLaunchKernel": 2.0, "cudaDeviceSynchronize": 2.0,
                         "(no host event)": 4.0}
    assert c["span_gaps"] == {"climate.warmup": 2.0, "climate.loop": 6.0}
    # the loop 11-45: busy 12-20, 22-30, 34-40
    assert (c["loop_us"], c["loop_busy_us"], c["loop_stencil_events"]) == (34, 22, 2)


def test_an_annotation_outside_the_program_still_names_a_gap():
    evs = spanned_events() + [kernel(STENCIL, 70, 5, 0)]
    c = trace.card_summaries(evs, STENCIL, "climate.")[0]
    # the gap at 40-70 begins in the loop's last 5 us
    assert c["gaps"]["ProfilerStep#1"] == 30.0
    assert c["span_gaps"] == {"climate.warmup": 2.0, "climate.loop": 36.0}


def test_loop_idle_pct():
    s = summary(spanned_events(), launches=(4,))
    # three stencil events of four launches: the lost one, the mean event
    # (26 / 3 us), fills the loop's busy time
    assert read("loop_idle_pct", s) == pytest.approx(100 * (1 - (22 + 26 / 3) / 34))
    s = summary(spanned_events(), launches=(3,))
    assert read("loop_idle_pct", s) == pytest.approx(100 * (1 - 22 / 34))
    # a trace that holds no loop span has no loop to read
    s = summary(events())
    assert read("loop_idle_pct", s) is None


def test_a_lost_stencil_event_in_the_loop_does_not_read_as_idle():
    whole = spanned_events()
    lost = [e for e in whole if not (e["cat"] == "kernel" and e["ts"] == 22)]
    full = summary(whole, launches=(3,))
    # the lost event's 8 us come back as the mean event, 9 us
    assert read("loop_idle_pct", summary(lost, launches=(3,))) == pytest.approx(
        read("loop_idle_pct", full) - 100 * 1 / 34)
    assert read("loop_idle_pct", summary(lost, launches=(3,))) < 100 * (1 - 14 / 34)


def test_program_readers_take_the_median_job():
    s = summary()
    assert read("call_overhead_ms", s) == pytest.approx(5.0)
    assert read("first_call_s", s) == 0.9
    assert read("launch_host_us", s) == pytest.approx(25.0)


def test_program_readers_take_the_ranks_together():
    s = summary()
    p = s["program"]
    # a second rank: 10 ms outside the loop and 1e8 ns of K1's host time in
    # each job, so the jobs read (2.4e8 + 1e8), (2.5e8 + 1e8) and
    # (9e8 + 1e8) ns over 20000 launches
    p["jobs"].append([observed(call=0.62, loop=0.61, host_ns=1.0e8, launches=10000)] * 3)
    p["warmup"].append(observed(call=1.2, loop=0.01))
    assert read("call_overhead_ms", s) == pytest.approx(10.0)  # the largest rank's
    assert read("first_call_s", s) == 1.2
    assert read("launch_host_us", s) == pytest.approx(3.5e8 / 20000 / 1e3)


@pytest.mark.parametrize("name", ["call_overhead_ms", "first_call_s", "launch_host_us",
                                  "loop_idle_pct"])
def test_program_readers_find_nothing_with_trace_0(name):
    s = summary()
    s["program"] = None
    s["trace"] = None
    assert read(name, s) is None


def test_without_a_k1_launch_launch_host_us_reads_nothing():
    s = summary()
    s["program"]["jobs"] = [[observed(call=0.6, loop=0.5)]]  # the CPU: no counter
    assert read("launch_host_us", s) is None
    s["program"]["jobs"] = [[observed(call=0.6, loop=0.5, host_ns=0, launches=0)]]
    assert read("launch_host_us", s) is None
