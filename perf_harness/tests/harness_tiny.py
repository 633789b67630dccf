"""A small copy of the benchmark's layout for the CPU tests: the real
``BENCHMARK.json``, metric readers and traffic, with each configuration's
grid and each job cut so that a whole cell runs in seconds on the CPU;
a cell over a 2x2 mesh of ranks, added as new files and entries alone,
to drive the harness's ranks (gloo on the CPU); and a cell with its
output on, to drive the snapshot files and their check."""

import json
import os
import shutil
import sys

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)
for p in (HARNESS, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

GRID = 96
JOB_STEPS = 1200
MESH_CELL = "mesh96.gloo4"
FRAMES_CELL = "bench96.frames"
FRAMES_STEPS = 400


def copy_layout(root: str) -> str:
    """Copy the benchmark's layout, as it is, under ``root``; returns its
    harness folder."""
    harness = os.path.join(root, "perf_harness")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(HARNESS, sub), os.path.join(harness, sub))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    return harness


def tiny_layout(root: str, grid: int = GRID, job_steps: int = JOB_STEPS) -> str:
    """Write the tiny layout under ``root``; returns its harness folder."""
    harness = copy_layout(root)
    for name in os.listdir(os.path.join(harness, "configs")):
        path = os.path.join(harness, "configs", name)
        with open(path) as f:
            c = json.load(f)
        c["grid"]["nx"] = c["grid"]["ny"] = grid
        with open(path, "w") as f:
            json.dump(c, f)
    for name in os.listdir(os.path.join(harness, "traffic")):
        path = os.path.join(harness, "traffic", name)
        with open(path) as f:
            t = json.load(f)
        t["job_steps"] = job_steps
        with open(path, "w") as f:
            json.dump(t, f)
    return harness


def add_mesh_cell(root: str, harness: str) -> str:
    """A cell of ``bench_4096``'s physics over a 2x2 mesh of four ranks,
    one tile each, whose hotspots cross the tiles' edges in x and y half
    way through a job; returns its name."""
    with open(os.path.join(harness, "configs", "bench_4096.json")) as f:
        cfg = json.load(f)
    cfg.update(name="mesh_96", layout={"ranks": 4, "mesh": {"x": 2, "y": 2}})
    with open(os.path.join(harness, "configs", "mesh_96.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(harness, "traffic", "bench4096.single.json")) as f:
        traffic = json.load(f)
    traffic.update(config="mesh_96", chips=4, why="four ranks",
                   ic=dict(traffic["ic"], xc_frac=[0.2, 0.3], yc_frac=[0.55, 0.65]))
    with open(os.path.join(harness, "traffic", f"{MESH_CELL}.json"), "w") as f:
        json.dump(traffic, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "mesh_96", "source": "a test", "reduced": [],
                             "file": "perf_harness/configs/mesh_96.json", "why": "a test"})
    bench["workloads"].append({"name": MESH_CELL, "config": "mesh_96", "traffic": MESH_CELL,
                               "chips": 4, "why": "a test"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return MESH_CELL


def add_frames_cell(root: str, harness: str, job_steps: int = FRAMES_STEPS,
                    name: str = FRAMES_CELL) -> str:
    """A cell of the layout's ``bench_4096`` with its output on: jobs of
    ``job_steps`` steps that write a record every 100, the hotspots
    ``bench4096.single``'s; returns its name."""
    with open(os.path.join(harness, "traffic", "bench4096.single.json")) as f:
        traffic = json.load(f)
    traffic.update(output=True, out_every=100, job_steps=job_steps, why="output on")
    with open(os.path.join(harness, "traffic", f"{name}.json"), "w") as f:
        json.dump(traffic, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": name, "config": "bench_4096",
                               "traffic": name, "chips": 1, "why": "a test"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return name
