"""The card's published peaks and the least time a cell's stencil work
could take on it.

A frozen copy of the port's table (``DEVICE_PEAKS``, ``bound_s``), kept
here so that a change to the program cannot move the yardstick.  The work
is counted from the cell's grid and steps alone, never from how the
program schedules its passes: 9 operations a point and step (the
stencil's five products and four sums), and one read and one write of the
card's field for each ``out_every`` span (the least a run that hands the
field back at every span must move).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class Peaks(NamedTuple):
    bytes_per_s: float     # device memory
    f32_flop_per_s: float  # float32 outside the tensor cores
    f64_flop_per_s: float  # float64 outside the tensor cores


# Published peaks by ``torch.cuda.get_device_name()``; a card missing here
# has no figures, never another card's.
DEVICE_PEAKS = {
    # NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 3.35 TB/s,
    # FP32 67 TFLOP/s, FP64 34 TFLOP/s.
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12, 34e12),
}

FLOPS_PER_POINT_STEP = 9

# Bytes a value is stored in, by the configuration's precision; bf16 is a
# storage type whose steps compute in float32.
ITEMSIZE = {"f32": 4, "f64": 8, "bf16": 2}


def peaks(card: str) -> Peaks:
    if card not in DEVICE_PEAKS:
        raise ValueError(f"no published peaks for the card {card!r}; known: "
                         f"{sorted(DEVICE_PEAKS)}")
    return DEVICE_PEAKS[card]


def stencil_work(points: int, steps: int, out_every: int, precision: str) -> Tuple[float, float]:
    """(bytes, operations) of ``steps`` steps on ``points`` points."""
    spans = -(-steps // out_every)
    return 2.0 * ITEMSIZE[precision] * points * spans, float(FLOPS_PER_POINT_STEP * points * steps)


def bound_s(nbytes: float, flops: float, precision: str, card: str) -> Tuple[float, str]:
    """(least seconds, what sets it): the bytes over the memory rate or the
    operations over the precision's arithmetic rate, the longer."""
    p = peaks(card)
    t_bytes = nbytes / p.bytes_per_s
    t_ops = flops / (p.f64_flop_per_s if precision == "f64" else p.f32_flop_per_s)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
