"""The trace reduction and the per-layer readers on a synthetic trace: two
cards, a known busy span, a lost stencil event; and the roofline share,
which no implementation that does the stencil's work can push past 100%."""

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


def summary(evs=None, launches=(4, 4), wall_us_a_step=6.0):
    cards = trace.card_summaries(evs or events(), STENCIL)
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
    }


def read(name, s):
    return layout.Layout(REPO).reader(name)(s)


def test_card_summaries():
    cards = trace.card_summaries(events(), STENCIL)
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
    b = trace.breakdown(list(trace.card_summaries(events(), STENCIL).values()))
    assert b["device_ops"][0] == ["void climate::band_kernel<float, float, 8>(...)",
                                  pytest.approx(70e-6)]
    assert b["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(4e-6)]]
    assert len(b["device_ops"]) <= trace.TOP
    assert not math.isnan(b["device_ops"][-1][1])
