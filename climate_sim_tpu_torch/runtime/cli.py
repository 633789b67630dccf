"""Command-line entry point of the PyTorch port.

    python -m climate_sim_tpu_torch [run] --config=cfg.yaml --nx=1024 --dt 0.05 ...

accepts ``--config=<yaml>`` / ``--config <yaml>`` plus any ``--key=value`` or
``--key value`` overrides understood by the config system (the same surface
as ``python -m climate_sim_tpu``).  The run gets every visible CUDA device
(one card: the single-device path, as the JAX CLI on one chip), or the CPU
when ``CLIMATE_SIM_PLATFORM=cpu``; without a card and without that
variable the run fails.

Multi-process, one rank per process, each on its own card
(``cuda:(local_rank % device_count)``; ranks may share a card):

    python -m climate_sim_tpu_torch --config=cfg.yaml --distributed=HOST:PORT,N,I
    torchrun --nproc_per_node=N -m climate_sim_tpu_torch --config=cfg.yaml --distributed=auto

Exit codes: 0 success, 2 bad configuration, 1 failed run.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence

from ..config import extract_config_path, merged_config
from . import distributed
from .driver import run_simulation


def cli_devices():
    """``[cpu]`` when ``CLIMATE_SIM_PLATFORM=cpu``, else None: every visible
    CUDA device (:func:`.driver.visible_cuda_devices`), or a rank's own
    card (:func:`.distributed.default_devices`)."""
    return ["cpu"] if os.environ.get("CLIMATE_SIM_PLATFORM") == "cpu" else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    args: List[str] = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "run":
        args = args[1:]
    # -h/--help and --version are honored ANYWHERE in argv: the override
    # parser is permissive about unknown flags, so a trailing --help must
    # not be swallowed into a full run.
    if any(a in ("-h", "--help") for a in args):
        print(__doc__)
        return 0
    if "--version" in args:
        from .. import __version__

        print(f"climate-sim-tpu {__version__} (PyTorch port)")
        return 0

    try:
        cfg_path = extract_config_path(args)
        cfg = merged_config(cfg_path, args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        run_simulation(cfg, cli_devices())
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
