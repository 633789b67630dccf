"""What the harness takes from the program under test, and nothing more:
its entry point (``runtime.driver.run_simulation``, the function that
``python -m climate_sim_tpu_torch`` calls), its config loader, the launch
counters of its stencil kernel wrappers and that kernel's name, and its
tracer (``runtime.tracing``): the spans and counters of the calls made
inside :func:`collect`, and the prefix of their names.

The program's log lines go to this process's standard error, so that the
harness's own result stays the last line of standard output.
"""

from __future__ import annotations

import contextlib
import io
import sys
import time
from typing import Iterator, List, Optional, Tuple

from reference import Hotspot


def sim_config(config: dict, traffic: dict, steps: int, spot: Hotspot, *,
               distributed: str = "", precision: Optional[str] = None,
               output_dir: str = "."):
    """The program's config for one job of a cell: the configuration file's
    grid, physics, time step, BCs, precision and mesh, the traffic's span
    and output (on or off; its file goes into ``output_dir``), and the
    job's hotspot."""
    from climate_sim_tpu_torch.config import load_yaml_dict

    layout = config.get("layout", {})
    root = {
        "grid": dict(config["grid"]),
        "physics": dict(config["physics"]),
        "time": {"dt": config["time"]["dt"], "steps": int(steps),
                 "out_every": int(traffic["out_every"])},
        "bc": dict(config["bc"]),
        "precision": precision or config["precision"],
        "output": {"enable": bool(traffic.get("output", False)), "dir": output_dir},
        "ic": {"mode": "preset", "preset": "gaussian_hotspot", "A": spot.A,
               "sigma_frac": spot.sigma_frac, "xc_frac": spot.xc_frac,
               "yc_frac": spot.yc_frac},
    }
    if layout.get("mesh"):
        root["mesh"] = {"x": int(layout["mesh"]["x"]), "y": int(layout["mesh"]["y"]),
                        "enable": True}
    if distributed:
        root["distributed"] = distributed
    return load_yaml_dict(root)


def run(cfg, devices) -> Tuple[object, List[str], float]:
    """One call of the entry point: (its RunResult, its log lines, the
    seconds from the call to its return on the host clock).  The call
    returns after it has synchronised every card it used."""
    from climate_sim_tpu_torch.runtime.driver import run_simulation

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        result = run_simulation(cfg, devices, write_output=True)
        wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}", file=sys.stderr)
    return result, lines, wall


def stencil_launches() -> int:
    """The stencil kernel's launches counted so far by every wrapper that
    launches it (a graph replay adds what its chunk counted at capture)."""
    from climate_sim_tpu_torch.ops.cuda_stencil import multistep_kernel_step
    from climate_sim_tpu_torch.parallel.halo import _CHUNK_WRAPPERS

    return multistep_kernel_step.launches + sum(fn.launches for fn in _CHUNK_WRAPPERS)


def k1_launches() -> int:
    """K1's launches counted so far by its own wrapper alone
    (``multistep_kernel_step``), apart from the mesh chunks' wrappers: what
    the counter ``k1.host_ns`` is summed over."""
    from climate_sim_tpu_torch.ops.cuda_stencil import multistep_kernel_step

    return multistep_kernel_step.launches


@contextlib.contextmanager
def collect() -> Iterator[object]:
    """The program's ``tracing.collect()``: tracing on for the block, which
    gets the record its spans and counters fill."""
    from climate_sim_tpu_torch.runtime import tracing

    with tracing.collect() as record:
        yield record


def prefix() -> str:
    """The prefix of the program's span names (``tracing.PREFIX``), which
    its spans' annotations carry in a profiler's trace."""
    from climate_sim_tpu_torch.runtime import tracing

    return tracing.PREFIX


def stencil_kernel() -> str:
    """The part of the stencil kernel's symbol that every variant holds."""
    from climate_sim_tpu_torch.parallel.halo import CHUNK_KERNEL

    return CHUNK_KERNEL


def leave() -> None:
    """Leave the program's process group, if it joined one."""
    from climate_sim_tpu_torch.runtime import distributed

    distributed.shutdown()
