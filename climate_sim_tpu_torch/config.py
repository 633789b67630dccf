"""Configuration system: dataclasses + YAML loader + CLI overrides.

TPU-native re-design of the reference config layer (reference: include/io.hpp:10-68,
src/io.cpp:30-376).  Behavioral parity:

* defaults match SimConfig defaults (io.hpp:21-39),
* YAML accepts nested blocks ``grid/physics/time/bc/output/ic`` *or* flat keys
  (io.cpp:88-147),
* ``bc:`` may be a scalar (applies to all four sides, io.cpp:127-129) or a
  per-side map (io.cpp:131-138),
* CLI overrides accept both ``--key=value`` and ``--key value`` forms
  (io.cpp:174-217) for the same key set (io.cpp:219-307),
* precedence is defaults < YAML < CLI (io.cpp:363-376),
* ``validate()`` raises on non-positive nx/ny/dx/dy/dt/steps and out_every < 1
  (io.cpp:58-69),
* BC aliases: dirichlet|fixed, neumann|noflux|zero-flux, periodic|period,
  case-insensitive (io.cpp:35-44).

Deliberate fixes over the reference (see docs/decisions.md):

* ``ic.file`` and ``ic.params.{...}`` spellings from configs/dev.yaml are
  accepted (the reference silently ignores them, io.cpp:149-167 vs
  configs/dev.yaml:13-18),
* ``--ic.var`` is actually applied (the reference parses it into CLIOverrides
  but never merges it),
* TPU-specific extras (precision, mesh, kernel selection) live in their own
  keys and default to sensible values so reference configs work verbatim.

This module is a copy of ``climate_sim_tpu/config.py`` (it needs only yaml),
so the PyTorch port parses and validates configs without importing the JAX
package.  The schema, the overrides and ``validate`` are the same; the tests
hold the copy to its original.  On the port, ``kernel=pallas`` and
``pallas_multistep`` select the hand-written CUDA kernel and ``auto`` selects
it iff the run's device is CUDA; ``profile_dir`` captures a
``torch.profiler`` trace.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import yaml


class BCType(enum.Enum):
    """Boundary-condition type for one side (reference: include/boundary.hpp:5)."""

    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"
    PERIODIC = "periodic"


_BC_ALIASES = {
    "dirichlet": BCType.DIRICHLET,
    "fixed": BCType.DIRICHLET,
    "neumann": BCType.NEUMANN,
    "noflux": BCType.NEUMANN,
    "zero-flux": BCType.NEUMANN,
    "periodic": BCType.PERIODIC,
    "period": BCType.PERIODIC,
}


def bc_from_string(s: str) -> BCType:
    """Parse a BC name with the reference's aliases (io.cpp:35-44)."""
    try:
        return _BC_ALIASES[s.strip().lower()]
    except KeyError:
        raise ValueError(f"Unknown BC type: {s}") from None


def bc_to_string(bc: BCType) -> str:
    return bc.value


@dataclass
class BCConfig:
    """Per-side boundary conditions (reference: include/boundary.hpp:7-12)."""

    left: BCType = BCType.DIRICHLET
    right: BCType = BCType.DIRICHLET
    bottom: BCType = BCType.DIRICHLET
    top: BCType = BCType.DIRICHLET

    def as_tuple(self) -> Tuple[BCType, BCType, BCType, BCType]:
        return (self.left, self.right, self.bottom, self.top)

    def describe(self) -> str:
        """The exact string written to NetCDF metadata (io.cpp:445-447)."""
        return (
            f"left={bc_to_string(self.left)} right={bc_to_string(self.right)}"
            f" bottom={bc_to_string(self.bottom)} top={bc_to_string(self.top)}"
        )


@dataclass
class ICConfig:
    """Initial-condition config (reference: include/io.hpp:10-19)."""

    mode: str = "preset"
    preset: str = "gaussian_hotspot"
    A: float = 1.0
    sigma_frac: float = 0.05
    xc_frac: float = 0.5
    yc_frac: float = 0.5
    path: str = ""
    var: str = "u"


@dataclass
class MeshConfig:
    """TPU device-mesh layout.  ``None`` axes are chosen automatically with a
    near-square factorization (the ``MPI_Dims_create`` analogue,
    reference: src/decomp.cpp:13)."""

    x: Optional[int] = None
    y: Optional[int] = None
    enable: bool = True  # shard across all local devices when > 1


@dataclass
class SimConfig:
    """Full simulation config (reference: include/io.hpp:21-39)."""

    nx: int = 256
    ny: int = 256
    dx: float = 1.0
    dy: float = 1.0

    D: float = 0.0
    vx: float = 0.0
    vy: float = 0.0

    dt: float = 0.1
    steps: int = 100
    out_every: int = 50

    bc: BCConfig = field(default_factory=BCConfig)

    output_prefix: str = "snap"
    # Fix over the reference: main.cpp:87 hardcodes "outputs/snapshots.nc" and
    # ignores output_prefix.  We keep the same default path but honor an
    # explicit output.path when given.
    output_path: Optional[str] = None
    output_dir: str = "outputs"
    output_enable: bool = True  # false: timing-only runs write no snapshots
    write_final: bool = False  # opt-in post-loop snapshot (decision log #5)

    ic: ICConfig = field(default_factory=ICConfig)

    # --- TPU-native extensions (no reference analogue) ---
    precision: str = "f32"  # f32 | f64 | bf16 (compute dtype)
    kernel: str = "auto"  # auto | jnp | pallas | pallas_multistep
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Reproduce the reference's actual periodic-BC behavior (a silent no-op
    # whose ghost cells stay 0 forever, i.e. numerically Dirichlet(0);
    # reference: boundary.cpp:23-53 has no Periodic branch and decomp.cpp:14
    # creates a non-periodic Cartesian communicator).
    strict_reference_compat: bool = False
    diagnostics_every: int = 0  # 0 = off; else print min/max/mean/L2 cadence
    debug_nans: bool = False
    profile_dir: str = ""  # non-empty: a torch.profiler trace of the timed loop there
    max_devices: int = 0  # 0 = all visible devices; else use the first N
    # Sharded passes: split interior/edge-band kernels so halo ppermutes
    # overlap interior compute (latency hiding for small tiles).
    # true/false force; "auto" (default) applies the measured policy:
    # enable iff the mesh crosses DCN granules AND the per-shard tile is
    # <= 1024² points.  Measured stitch premium on v5e by tile size
    # (docs/performance.md "When does overlap pay?"): -15.5% / +6% / -1.3%
    # at 256²/512²/1024², +46-63% at 2048²-4096² — so overlap only ever
    # pays where exchange latency dominates (DCN) and the stitch passes
    # are cheap (small tiles); on 4096² shards it HALVES throughput.
    halo_overlap: object = "auto"  # True | False | "auto"
    # Steps fused per kernel pass / halo exchange (0 = auto).  Larger k
    # trades halo-redundant compute for fewer, larger exchanges: per-step
    # exchange-latency cost scales as ~2L/k (docs/performance.md "Weak
    # scaling bounded by LATENCY").  Auto resolves to 16 on meshes that
    # cross DCN granules (halving the dominant latency term at ~zero
    # single-chip cost) and 8 otherwise (deeper passes measured slightly
    # slower on-chip — locality).
    steps_per_pass: int = 0
    # Multi-host: jax.distributed.initialize() before backend init.  "auto"
    # passes no arguments (TPU pods self-discover); otherwise
    # "coordinator:port,num_processes,process_id".
    distributed: str = ""

    def validate(self) -> None:
        """Raise on invalid values (reference: io.cpp:58-69)."""
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError("nx/ny must be > 0")
        if self.dx <= 0 or self.dy <= 0:
            raise ValueError("dx/dy must be > 0")
        if self.dt <= 0:
            raise ValueError("dt must be > 0")
        if self.steps <= 0:
            raise ValueError("steps must be > 0")
        if self.out_every < 1:
            raise ValueError("out_every must be >= 1")
        if self.precision not in ("f32", "f64", "bf16"):
            raise ValueError(f"precision must be f32|f64|bf16, got {self.precision}")
        if self.kernel not in ("auto", "jnp", "pallas", "pallas_multistep"):
            raise ValueError(f"unknown kernel: {self.kernel}")
        if self.max_devices < 0:
            raise ValueError("max_devices must be >= 0 (0 = all devices)")
        if self.halo_overlap not in (True, False, "auto"):
            raise ValueError(
                f"halo_overlap must be true|false|auto, got {self.halo_overlap!r}"
            )
        if not (0 <= self.steps_per_pass <= 32):
            raise ValueError("steps_per_pass must be in [0, 32] (0 = auto)")
        if (self.mesh.x is not None and self.mesh.x < 1) or (
            self.mesh.y is not None and self.mesh.y < 1
        ):
            raise ValueError("mesh.x/mesh.y must be >= 1 when set")

    def resolved_output_path(self) -> str:
        """Snapshot file path.  The reference hardcodes outputs/snapshots.nc
        and ignores output_prefix entirely (main.cpp:87); we keep that
        default but honor an explicit path or a non-default prefix
        (decision log #3)."""
        if self.output_path:
            return self.output_path
        if self.output_prefix and self.output_prefix != "snap":
            return f"{self.output_dir}/{self.output_prefix}.nc"
        return f"{self.output_dir}/snapshots.nc"


def _load_bc_node(cfg: SimConfig, node: Any) -> None:
    if isinstance(node, str):
        b = bc_from_string(node)
        cfg.bc.left = cfg.bc.right = cfg.bc.bottom = cfg.bc.top = b
    elif isinstance(node, dict):
        for side in ("left", "right", "bottom", "top"):
            if side in node:
                setattr(cfg.bc, side, bc_from_string(str(node[side])))
    else:
        raise ValueError(f"bad bc node: {node!r}")


def _load_ic_node(cfg: SimConfig, node: Dict[str, Any]) -> None:
    ic = cfg.ic
    if "mode" in node:
        ic.mode = str(node["mode"])
    if "preset" in node:
        ic.preset = str(node["preset"])
    # Accept both flat keys (the reference loader, io.cpp:149-167) and the
    # nested `params:` block that configs/dev.yaml actually uses.
    srcs = [node]
    if isinstance(node.get("params"), dict):
        srcs.append(node["params"])
    for src in srcs:
        for k in ("A", "sigma_frac", "xc_frac", "yc_frac"):
            if k in src:
                setattr(ic, k, float(src[k]))
    if "path" in node:
        ic.path = str(node["path"])
    elif "file" in node:  # dev.yaml spelling
        ic.path = str(node["file"])
    if "var" in node:
        ic.var = str(node["var"])


def _load_mesh_node(cfg: SimConfig, node: Any) -> None:
    if isinstance(node, dict):
        # None means "unset" (it is what config_to_dict emits for the
        # defaults), not a request for mesh shape 0.
        if node.get("x") is not None:
            cfg.mesh.x = int(node["x"])
        if node.get("y") is not None:
            cfg.mesh.y = int(node["y"])
        if "enable" in node:
            cfg.mesh.enable = bool(node["enable"])


def load_yaml_file(path: str, validate: bool = True) -> SimConfig:
    """Load a YAML config accepting nested blocks or flat keys (io.cpp:84-171).

    ``validate=False`` defers validation — used by :func:`merged_config` so a
    CLI flag can override an invalid YAML value before the check runs.
    """
    with open(path, "r") as f:
        root = yaml.safe_load(f) or {}
    return load_yaml_dict(root, validate=validate)


def load_yaml_dict(root: Dict[str, Any], validate: bool = True) -> SimConfig:
    cfg = SimConfig()

    def node(name):
        # A present-but-empty block (e.g. "grid:" with all entries commented
        # out) parses to None; treat it as absent like yaml-cpp's null nodes.
        v = root.get(name)
        return v if isinstance(v, dict) else root

    grid = node("grid")
    for k in ("nx", "ny"):
        if k in grid:
            cfg.__setattr__(k, int(grid[k]))
    for k in ("dx", "dy"):
        if k in grid:
            cfg.__setattr__(k, float(grid[k]))

    phys = node("physics")
    for k in ("D", "vx", "vy"):
        if k in phys:
            cfg.__setattr__(k, float(phys[k]))

    time = node("time")
    if "dt" in time:
        cfg.dt = float(time["dt"])
    if "steps" in time:
        cfg.steps = int(time["steps"])
    if "out_every" in time:
        cfg.out_every = int(time["out_every"])

    if "bc" in root:
        _load_bc_node(cfg, root["bc"])

    if "output" in root:
        out = root["output"]
        if isinstance(out, dict):
            if "prefix" in out:
                cfg.output_prefix = str(out["prefix"])
            if "path" in out:
                cfg.output_path = str(out["path"])
            if "dir" in out:
                cfg.output_dir = str(out["dir"])
            if "write_final" in out:
                cfg.write_final = bool(out["write_final"])
            if "enable" in out:
                cfg.output_enable = bool(out["enable"])
    else:
        # Flat spellings — config_to_dict emits these, so its output
        # round-trips through this loader.
        if "output_prefix" in root:
            cfg.output_prefix = str(root["output_prefix"])
        if root.get("output_path") is not None:
            cfg.output_path = str(root["output_path"])
        if "output_dir" in root:
            cfg.output_dir = str(root["output_dir"])
        if "output_enable" in root:
            cfg.output_enable = bool(root["output_enable"])
        if "write_final" in root:
            cfg.write_final = bool(root["write_final"])

    if "ic" in root and isinstance(root["ic"], dict):
        _load_ic_node(cfg, root["ic"])

    # TPU-native extensions
    if "precision" in root:
        cfg.precision = str(root["precision"])
    if "kernel" in root:
        cfg.kernel = str(root["kernel"])
    if "mesh" in root:
        _load_mesh_node(cfg, root["mesh"])
    if "strict_reference_compat" in root:
        cfg.strict_reference_compat = bool(root["strict_reference_compat"])
    if "diagnostics_every" in root:
        cfg.diagnostics_every = int(root["diagnostics_every"])
    if "debug_nans" in root:
        cfg.debug_nans = bool(root["debug_nans"])
    if "profile_dir" in root:
        cfg.profile_dir = str(root["profile_dir"])
    if "max_devices" in root:
        cfg.max_devices = int(root["max_devices"])
    if "halo_overlap" in root:
        cfg.halo_overlap = _coerce_tristate(root["halo_overlap"])
    if "steps_per_pass" in root:
        cfg.steps_per_pass = int(root["steps_per_pass"])
    if "distributed" in root:
        cfg.distributed = str(root["distributed"])

    # merged_config defers validation until after CLI overrides, so a CLI
    # flag can override an invalid YAML value (io.cpp:363-376 precedence);
    # direct callers get validated configs by default.
    if validate:
        cfg.validate()
    return cfg


# Keys the CLI override parser understands, with their coercion functions.
# Mirrors the reference's key set (io.cpp:219-307) plus TPU extensions.
_INT_KEYS = (
    "nx", "ny", "steps", "out_every", "mesh.x", "mesh.y", "diagnostics_every",
    "max_devices", "steps_per_pass",
)
_FLOAT_KEYS = (
    "dx",
    "dy",
    "D",
    "vx",
    "vy",
    "dt",
    "ic.A",
    "ic.sigma_frac",
    "ic.xc_frac",
    "ic.yc_frac",
)
_STR_KEYS = (
    "output.prefix",
    "output_prefix",
    "output.path",
    "output.dir",
    "ic.mode",
    "ic.preset",
    "ic.path",
    "ic.var",
    "precision",
    "kernel",
    "profile_dir",
    "distributed",
)
_BC_KEYS = ("bc.left", "bc.right", "bc.bottom", "bc.top", "bc")
_BOOL_KEYS = (
    "strict_reference_compat", "write_final", "debug_nans", "mesh.enable",
    "output.enable",
)
_TRISTATE_KEYS = ("halo_overlap",)  # true | false | auto


def _coerce_tristate(raw) -> object:
    """true/false/auto (bools pass through; strings use the bool aliases).
    Unrecognized strings RAISE rather than silently coercing to False —
    a typo like 'aato' must not force-disable the policy the user asked
    for (validate() cannot catch it: coercion runs first)."""
    if isinstance(raw, bool):
        return raw
    s = str(raw).strip().lower()
    if s == "auto":
        return "auto"
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"expected true|false|auto, got {raw!r}")


def parse_cli_overrides(args: Sequence[str]) -> Dict[str, Any]:
    """Parse ``--key=value`` / ``--key value`` overrides (io.cpp:180-310).

    Returns a flat ``{key: coerced value}`` dict.  Unknown ``--flags`` are
    ignored, matching the reference's permissive loop — but a one-line
    stderr warning is printed per ignored flag, so a typo like
    ``--step=100`` cannot silently run 100 default steps.  ``--config``
    is consumed separately (:func:`extract_config_path`) and never warns.
    """
    out: Dict[str, Any] = {}
    argv = list(args)
    i = 0

    def coerce(key: str, raw: str) -> Any:
        if key in _INT_KEYS:
            return int(raw)
        if key in _FLOAT_KEYS:
            return float(raw)
        if key in _BC_KEYS:
            return bc_from_string(raw)
        if key in _BOOL_KEYS:
            return raw.strip().lower() in ("1", "true", "yes", "on")
        if key in _TRISTATE_KEYS:
            return _coerce_tristate(raw)
        return raw

    known = (
        set(_INT_KEYS) | set(_FLOAT_KEYS) | set(_STR_KEYS) | set(_BC_KEYS)
        | set(_BOOL_KEYS) | set(_TRISTATE_KEYS)
    )

    # Flags handled elsewhere in the CLI stack: --config by
    # extract_config_path, help/version by runtime/cli.py.
    _external = {"config", "help", "version"}
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            body = a[2:]
            if "=" in body:
                key, raw = body.split("=", 1)
                if key in known:
                    out[key] = coerce(key, raw)
                elif key not in _external:
                    print(f"warning: ignored unknown flag --{key}",
                          file=sys.stderr)
            else:
                key = body
                if key in known and i + 1 < len(argv):
                    out[key] = coerce(key, argv[i + 1])
                    i += 1
                elif key in known:
                    print(f"warning: ignored flag --{key} (missing value)",
                          file=sys.stderr)
                elif key not in _external:
                    print(f"warning: ignored unknown flag --{key}",
                          file=sys.stderr)
        i += 1
    return out


def apply_overrides(cfg: SimConfig, overrides: Dict[str, Any]) -> None:
    """Apply flat CLI overrides onto a config (io.cpp:312-360)."""
    simple = {
        "nx", "ny", "dx", "dy", "D", "vx", "vy", "dt", "steps", "out_every",
        "output_prefix", "precision", "kernel", "strict_reference_compat",
        "write_final", "debug_nans", "diagnostics_every", "profile_dir",
        "distributed", "max_devices", "halo_overlap", "steps_per_pass",
    }
    for key, val in overrides.items():
        if key in simple:
            setattr(cfg, key, val)
        elif key == "bc":
            cfg.bc.left = cfg.bc.right = cfg.bc.bottom = cfg.bc.top = val
        elif key.startswith("bc."):
            setattr(cfg.bc, key[3:], val)
        elif key == "output.prefix":
            cfg.output_prefix = val
        elif key == "output.path":
            cfg.output_path = val
        elif key == "output.dir":
            cfg.output_dir = val
        elif key == "output.enable":
            cfg.output_enable = val
        elif key.startswith("ic."):
            setattr(cfg.ic, key[3:], val)
        elif key == "mesh.x":
            cfg.mesh.x = val
        elif key == "mesh.y":
            cfg.mesh.y = val
        elif key == "mesh.enable":
            cfg.mesh.enable = val


def extract_config_path(args: Sequence[str]) -> Optional[str]:
    """Find ``--config=path`` or ``--config path`` (reference: main.cpp:30-38)."""
    argv = list(args)
    path = None
    for i, a in enumerate(argv):
        if a.startswith("--config="):
            path = a[len("--config="):]
        elif a == "--config" and i + 1 < len(argv):
            path = argv[i + 1]
    return path


def merged_config(yaml_path: Optional[str], cli_args: Sequence[str]) -> SimConfig:
    """defaults < YAML < CLI, then validate (reference: io.cpp:363-376)."""
    if yaml_path:
        cfg = load_yaml_file(yaml_path, validate=False)
    else:
        cfg = SimConfig()
    apply_overrides(cfg, parse_cli_overrides(cli_args))
    cfg.validate()
    return cfg


def config_to_dict(cfg: SimConfig) -> Dict[str, Any]:
    """Round-trippable dict form (for logging / metadata)."""
    d = dataclasses.asdict(cfg)
    d["bc"] = {s: bc_to_string(getattr(cfg.bc, s)) for s in ("left", "right", "bottom", "top")}
    return d
