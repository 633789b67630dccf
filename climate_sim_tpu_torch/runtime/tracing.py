"""The port's spans and counters: where a call's time goes, read by the
benchmark's per-layer metrics and carried by ``profile_dir``'s trace.

* :func:`span` ``(name)``: a context manager around one phase of the
  program.  A span records its name, its parent (the innermost span open
  in its thread) and its start and end on :data:`clock`
  (``time.perf_counter_ns``).
* :func:`add` ``(counter, n)``: adds ``n`` to a named counter.
* :func:`collect`: turns tracing on for its block and yields the
  :class:`Record` the spans and counters go to.  A :func:`collect` inside
  another yields the outer record.

Off, the default, costs nothing: :func:`span` returns one shared no-op
context that reads no clock, enters no profiler annotation and allocates
nothing, and a hot path reads the one module flag :data:`ON` before it
does anything else.  Tracing is on inside :func:`collect`, which the
driver also enters for a call with ``profile_dir`` set.

While a ``torch.profiler`` is recording (checked once as a span opens),
a span also enters ``torch.profiler.record_function(name)``, so it lies in
the profiler's chrome trace as a ``user_annotation`` event on the clock of
the card's kernels: that is how an idle gap of the card is put down to a
phase of the program.

The names (all under :data:`PREFIX`) and where the driver opens them:
``climate.call`` (``run_simulation``), ``climate.prepare``,
``climate.ic_stats``, ``climate.capture``, ``climate.warmup``,
``climate.loop`` (the interval ``timing: total_max`` measures),
``climate.finish``, and ``climate.library`` (the kernel library's build
or load, once a process; its note says which).  The counters
``k1.host_ns`` (K1's host nanoseconds a launch up to the C call) and
``k1.warp_bands`` (K1's launches in one-warp blocks) are K1's wrapper's
(``ops/cuda_stencil.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

PREFIX = "climate."

# Read by the hot path as ``tracing.ON``; set only by :func:`collect`.
ON = False
# Every reading the tracer takes.
clock = time.perf_counter_ns

_record: Optional["Record"] = None
_open = threading.local()  # .stack: this thread's open spans, innermost last


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span: times in ``clock`` nanoseconds."""

    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    note: str = ""

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Record:
    """What one :func:`collect` block recorded: the spans in the order they
    closed, and the counters."""

    spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)

    def seconds(self) -> Dict[str, float]:
        """Each span name's summed seconds."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out


class _Off:
    """The span while tracing is off: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def at(self, start_ns: int, end_ns: int) -> None:
        pass

    def note(self, text: str) -> None:
        pass


_OFF = _Off()


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "text", "record", "annotation")

    def __init__(self, name: str, record: "Record"):
        self.name, self.record = name, record
        self.end_ns: Optional[int] = None
        self.text = ""

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start_ns = clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = clock()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _stack().remove(self)
        self.record.spans.append(Span(self.name, self.parent, self.start_ns,
                                      end if self.end_ns is None else self.end_ns, self.text))
        return False

    def at(self, start_ns: int, end_ns: int) -> None:
        """Take the caller's own ``clock`` readings as the span's start and
        end, so that the span and the caller's timing agree."""
        self.start_ns, self.end_ns = start_ns, end_ns

    def note(self, text: str) -> None:
        """A word on what happened inside the span."""
        self.text = text


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str):
    """A context manager that records the phase ``name`` while tracing is
    on; off, the shared no-op."""
    record = _record
    if not ON or record is None:
        return _OFF
    return _Open(name, record)


def add(counter: str, n: int) -> None:
    """Add ``n`` to ``counter`` while tracing is on."""
    record = _record
    if not ON or record is None:
        return
    with record.lock:
        record.counters[counter] = record.counters.get(counter, 0) + n


@contextlib.contextmanager
def collect() -> Iterator[Record]:
    """Tracing on for the block; yields the record that fills during it.
    Inside another ``collect()`` it yields the outer record and leaves
    tracing on when it exits; the outermost turns it off, also on an
    exception."""
    global ON, _record
    if ON and _record is not None:
        yield _record
        return
    _record, ON = Record(), True
    try:
        yield _record
    finally:
        ON, _record = False, None
