"""The snapshot records a job writes, and their check: the harness's CDF-5
reader on a hand-built file and on the program's own; a tiny cell with its
output on, which runs correct with each record counted, and fails for each
fault of its snapshot path (a record dropped, one taken a span late, one
altered where it is written); the run's own directory, which no run leaves
behind, not even one stopped by an exception; and the cells with output
off, whose result line is as it was.  The readings at the real size come
from the card (the test marked ``gpu``)."""

import math
import os
import struct
import tempfile

import numpy as np
import pytest
import torch

from harness_tiny import FRAMES_STEPS, add_frames_cell, copy_layout, tiny_layout

import cdf5  # noqa: E402
import cell  # noqa: E402
import jobs  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402
from layout import Layout  # noqa: E402
from ranks import Ranks  # noqa: E402

import climate_sim_tpu_torch.runtime.driver as driver  # noqa: E402
from climate_sim_tpu_torch.io.snapshots import SnapshotWriter  # noqa: E402

SEED = 2**31 + 7001
CARD_SEEDS = (2**31 + 7101, 2**31 + 7102, 2**31 + 7103)
RECORDS = FRAMES_STEPS // 100


def _name(s):
    b = s.encode()
    return struct.pack(">Q", len(b)) + b + b"\0" * (-len(b) % 4)


def hand_built(u, t, u_type=cdf5.NC_DOUBLE):
    """A CDF-5 file by the specification: dimensions time (the record
    dimension), y and x; a text attribute; two record variables, ``u``
    (double, or float with ``u_type`` 5; time y x, with an attribute of
    its own) and ``t`` (float, time), so that records interleave."""
    n, ny, nx = u.shape
    head = b"CDF\x05" + struct.pack(">Q", n)
    head += struct.pack(">iQ", 0x0A, 3)
    for name, length in (("time", 0), ("y", ny), ("x", nx)):
        head += _name(name) + struct.pack(">Q", length)
    head += struct.pack(">iQ", 0x0C, 1) + _name("grid") + struct.pack(">iQ", 2, 5) + b"3 x 2\0\0\0"
    udt = ">f8" if u_type == cdf5.NC_DOUBLE else ">f4"
    usize, tsize = ny * nx * np.dtype(udt).itemsize, 4
    var_bytes = (len(_name("u")) + 8 + 3 * 8 + 4 + 8 + len(_name("scale")) + 4 + 8 + 8 + 4 + 8 + 8
                 + len(_name("t")) + 8 + 8 + 4 + 8 + 4 + 8 + 8)
    begin = len(head) + 4 + 8 + var_bytes
    head += struct.pack(">iQ", 0x0B, 2)
    head += _name("u") + struct.pack(">QQQQ", 3, 0, 1, 2)
    head += struct.pack(">iQ", 0x0C, 1) + _name("scale") + struct.pack(">iQ", 6, 1)
    head += struct.pack(">d", 2.5)
    head += struct.pack(">iQQ", u_type, usize, begin)
    head += _name("t") + struct.pack(">QQ", 1, 0) + struct.pack(">iQ", 0, 0)
    head += struct.pack(">iQQ", 5, tsize, begin + usize)
    assert len(head) == begin
    body = b"".join(u[i].astype(udt).tobytes() + t[i:i + 1].astype(">f4").tobytes()
                    for i in range(n))
    return head + body


def test_the_reader_on_a_hand_built_file(tmp_path):
    rng = np.random.default_rng(3)
    u, t = rng.standard_normal((3, 2, 3)), np.array([0.5, 1.5, 2.5], dtype=np.float32)
    path = tmp_path / "hand.nc"
    path.write_bytes(hand_built(u, t))
    f = cdf5.Cdf5File(str(path))
    assert f.numrecs == 3 and f.dims == [("time", None), ("y", 2), ("x", 3)]
    assert f.attrs == {"grid": "3 x 2"}
    assert f.variables["u"].nc_type == cdf5.NC_DOUBLE and f.shape("u") == (None, 2, 3)
    assert f.recsize == 2 * 3 * 8 + 4
    for i in range(3):
        got = f.record("u", i)
        assert got.dtype == np.float64 and np.array_equal(got, u[i])
        assert f.record("t", i) == t[i]
    with pytest.raises(ValueError):
        f.record("u", 3)
    path.write_bytes(hand_built(u, t)[:-30])  # the last record cut short
    with pytest.raises(ValueError):
        cdf5.Cdf5File(str(path)).record("u", 2)
    path.write_bytes(b"CDF\x02" + hand_built(u, t)[4:])
    with pytest.raises(ValueError):
        cdf5.Cdf5File(str(path))


@pytest.mark.parametrize("native", [True, False])
def test_the_reader_reads_the_programs_file(tmp_path, native):
    """The program's writer, native or its Python codec, against the
    frames it was given."""
    from climate_sim_tpu_torch.config import load_yaml_dict

    cfg = load_yaml_dict({"grid": {"nx": 7, "ny": 5}})
    frames = np.random.default_rng(4).standard_normal((3, 5, 7))
    with SnapshotWriter(str(tmp_path / "p.nc"), cfg, use_native=native) as w:
        for frame in frames:
            w.write(frame)
    f = cdf5.Cdf5File(str(tmp_path / "p.nc"))
    assert f.numrecs == 3 and f.shape("u") == (None, 5, 7)
    assert f.attrs["grid"] == "7 x 5"
    for i, frame in enumerate(frames):
        assert np.array_equal(f.record("u", i), frame)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The tiny layout with the output-on cell; the temporary directory is
    one of the test's own, to see what a run leaves in it."""
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    root = tmp_path / "root"
    harness = tiny_layout(str(root))
    add_frames_cell(str(root), harness)
    return Layout(str(root), harness)


def run_frames(tiny):
    return run.run_cell(tiny, "bench96.frames", SEED, 0.2, False, kind="cpu")


def left_behind():
    return os.listdir(tempfile.gettempdir())


def test_an_output_on_cell_runs_correct_with_every_record(tiny, monkeypatch):
    seen = {}
    real = tiny.read

    def keep(workload, kind, summary):
        seen.update(summary)
        return real(workload, kind, summary)

    monkeypatch.setattr(tiny, "read", keep)
    line = run_frames(tiny)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == seen["window"]["jobs"] + RECORDS
    assert line["checks"]["records"] == {"value": RECORDS, "limit": RECORDS}
    assert line["checks"]["max_err_rel"]["value"] < 1e-5
    assert list(line)[-1] == "checks"
    assert left_behind() == []


def _one_span_late(monkeypatch):
    """The snapshot view taken after the next span's launch, and copied
    when that span is done: each record holds the field one span later
    than its step.  The final field is untouched."""
    latest = {}
    real_prepare, real_fetch = driver.prepare, driver._HostCopier.fetch

    class Advance:
        def __init__(self, real):
            self.real = real

        def __getattr__(self, name):
            return getattr(self.real, name)

        def __call__(self, k):
            step = self.real(k)

            def run_span(u):
                latest["u"] = step(u)
                return latest["u"]
            return run_span

    def prepare(*a, **k):
        u, advance, *rest = real_prepare(*a, **k)
        return (u, Advance(advance), *rest)

    def fetch(self, regions, ready):
        for stream in self.streams:
            torch.cuda.synchronize(stream)
        return real_fetch(self, [(y0, x0, latest["u"]) for y0, x0, _ in regions], ready)

    monkeypatch.setattr(driver, "prepare", prepare)
    monkeypatch.setattr(driver._HostCopier, "fetch", fetch)


def _record_dropped(monkeypatch):
    """The writer drops the job's third record: the ones after it move up
    a place, and the file holds one record too few."""
    real = SnapshotWriter.write

    def write(self, u, step_index=None):
        if self.time_index == 2 and not getattr(self, "dropped", False):
            self.dropped = True
            return 2
        return real(self, u, step_index)

    monkeypatch.setattr(SnapshotWriter, "write", write)


def _record_altered(monkeypatch):
    """One value of the job's second record altered by 1.0 (at least half
    of any job's amplitude) where the writer takes it."""
    real = SnapshotWriter.write

    def write(self, u, step_index=None):
        u = np.array(u, dtype=np.float64)
        if self.time_index == 1:
            u[u.shape[0] // 2, u.shape[1] // 3] += 1.0
        return real(self, u, step_index)

    monkeypatch.setattr(SnapshotWriter, "write", write)


FAULTS = {"record_dropped": _record_dropped, "one_span_late": _one_span_late,
          "record_altered": _record_altered}


def checked(err):
    """{"job": [gaps], "record": [gaps]} from a run's ``check:`` lines."""
    out = {"job": [], "record": []}
    for line in err.splitlines():
        words = line.split()
        if line.startswith("check: ") and words[1] in out and "max_err_rel" in words:
            out[words[1]].append(float(words[words.index("max_err_rel") + 1]))
    return out


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_of_the_snapshot_path_fails(tiny, monkeypatch, capsys, fault):
    FAULTS[fault](monkeypatch)
    line = run_frames(tiny)
    limit = line["checks"]["max_err_rel"]["limit"]
    gaps = checked(capsys.readouterr().err)
    assert line["correct"] is False and line["attempted"] == len(gaps["job"]) + RECORDS
    # the final fields are right: the records alone fail
    assert max(gaps["job"]) < limit
    assert line["failed"] == sum(1 for e in gaps["record"] if not e <= limit) >= 1
    if fault == "record_dropped":
        assert line["checks"]["records"] == {"value": RECORDS - 1, "limit": RECORDS}
    assert left_behind() == []


def test_a_record_of_another_shape_fails_every_record(tiny, monkeypatch):
    """A writer one column wider than the grid: every record slot fails."""
    import dataclasses

    class Wider(SnapshotWriter):
        def __init__(self, path, cfg, use_native=True):
            super().__init__(path, dataclasses.replace(cfg, nx=cfg.nx + 1), use_native)

        def write(self, u, step_index=None):
            return super().write(np.concatenate([u, u[:, :1]], axis=1), step_index)

    monkeypatch.setattr(driver, "SnapshotWriter", Wider)
    line = run_frames(tiny)
    assert line["correct"] is False and line["failed"] == RECORDS
    assert line["checks"]["records"] == {"value": RECORDS, "limit": RECORDS}


@pytest.mark.parametrize("nc_type", [5, 6])
def test_a_record_of_another_type_fails_every_record(tiny, tmp_path, nc_type):
    """The check on a kept file built by hand: the job's records in
    double pass, the same in float fail, every slot."""
    w = tiny.workload("bench96.frames")
    config, traffic = tiny.config(w["config"]), tiny.traffic(w["traffic"])
    rank = cell.Rank(0, 1, config, traffic, SEED, 0, [torch.device("cpu")], str(tmp_path))
    (spot,) = jobs.hotspots(traffic, SEED, "window", 1)
    steps = cell.record_steps(traffic)
    fields = reference.evolve_separable_series([spot], rank.scheme, steps + [FRAMES_STEPS])
    u = np.stack([f.numpy() for (f,) in fields[:-1]])
    path = tmp_path / "kept.nc"
    path.write_bytes(hand_built(u, np.zeros(len(steps), np.float32), nc_type))
    rank.kept, rank.records = [(spot, fields[-1][0])], (str(path), steps)
    errs = rank.check()
    assert len(errs) == 1 + RECORDS and errs[0] < 1e-12
    if nc_type == cdf5.NC_DOUBLE:
        assert max(errs[1:]) < 1e-12 and rank.record_count() == (RECORDS, RECORDS)
    else:
        assert all(math.isnan(e) for e in errs[1:])


def test_a_run_stopped_by_an_exception_leaves_nothing_behind(tiny, monkeypatch):
    real = driver.run_simulation
    calls = []

    def stops(*a, **k):
        calls.append(1)
        if len(calls) == 3:  # the window's first job, after set-up's two
            raise RuntimeError("stopped")
        return real(*a, **k)

    monkeypatch.setattr(driver, "run_simulation", stops)
    with pytest.raises(RuntimeError, match="stopped"):
        run_frames(tiny)
    assert len(calls) == 3 and left_behind() == []


@pytest.mark.parametrize("workload", ["bench4096.single", "parity4096.f64"])
def test_an_output_off_cell_prints_the_line_it_printed(tiny, monkeypatch, workload):
    """No directory is made, nothing written, and the line has the keys and
    the check it had: one attempt a window job, the largest gap alone."""
    made = []
    real_mkdtemp = tempfile.mkdtemp
    monkeypatch.setattr(tempfile, "mkdtemp", lambda *a, **k: made.append(1) or real_mkdtemp(*a, **k))
    seen = {}
    real = tiny.read

    def keep(workload, kind, summary):
        seen.update(summary)
        return real(workload, kind, summary)

    monkeypatch.setattr(tiny, "read", keep)
    line = run.run_cell(tiny, workload, SEED, 0.2, False, kind="cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert list(line["checks"]) == ["max_err_rel"]
    assert line["correct"] is True and line["attempted"] == seen["window"]["jobs"]
    assert made == [] and left_behind() == []


@pytest.mark.gpu
def test_record_readings_on_the_card(tmp_path, monkeypatch):
    """``bench_4096`` at its own size, 1000-step jobs that write a record
    every 100 steps (the shipped ``configs/bench_4096.yaml``), on three
    seeds: the sound runs, the program's bf16 storage path (the control)
    and a snapshot taken one span late, each the largest gap over the
    job's final field and its ten records.  Printed (``-s``) for PERF.md."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tmp_path / "root"
    harness = copy_layout(str(root))
    name = add_frames_cell(str(root), harness, job_steps=1000, name="bench4096.frames")
    lay = Layout(str(root), harness)
    w = lay.workload(name)
    config, traffic = lay.config(w["config"]), lay.traffic(w["traffic"])

    def readings(precision=None):
        group = Ranks(1, config, traffic, SEED)
        try:
            return [cell.worst(group.do("probe", seed, precision)[0]) for seed in CARD_SEEDS]
        finally:
            group.close()

    sound, control = readings(), readings("bf16")
    _one_span_late(monkeypatch)
    late = readings()
    limit = config["limits"]["max_err_rel"]
    print(f"records: sound {sound} control {control} one span late {late} limit {limit}")
    assert max(sound) * 3 < min(late) and max(sound) * 3 < min(control)
