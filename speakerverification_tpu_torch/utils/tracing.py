"""The program's spans, recorded while ``torch.profiler`` runs.

The profiler is the one switch: with none running, :func:`span` returns
one shared object that does nothing, and reading the profiler's flag is
the whole cost. With one running, a span records its name, its start and
end in ``time.time_ns()`` (the clock the profiler stamps its own events
with, so spans and device activity lie on one timeline), its thread, its
own id, the id of the span it opened inside (a stack per thread), a
trace id (the request or batch it belongs to, inherited from its parent
unless given) and its attributes. It also opens a range of its name in
the profiler's own trace (the profiler sees the ranges of the thread
that started it, and of every thread when started with
``_ExperimentalConfig(profile_all_threads=True)``). The range is a host
operation, as an ATen operator's is, and not
``torch.profiler.record_function``'s user annotation: the profiler mirrors
a user annotation on the device's timeline over the kernels launched
inside it, and that mirror would count as device activity in a trace's
busy time.

    with tracing.span("engine.forward", device=wave.device):
        out = model(wave)
    ...
    for s in tracing.spans():       # synchronises once, then reads
        print(s.name, s.ms, s.device_ms)

``device=`` (``True`` for the current CUDA device, or a device) also
records a CUDA event, from a pool, on the device's current stream at the
span's start and end; their elapsed time is read only by :func:`spans`,
so nothing synchronises while spans are recorded. That time is the
stream's, from the work queued before the span to the work queued in
it: where the host launches slower than the device runs, it holds the
stream's idle time too. Spans stay in memory until :func:`clear`."""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "enabled", "span", "record", "spans", "clear"]


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int                # time.time_ns()
    end_ns: int
    thread: int                  # threading.get_native_id()
    span_id: int
    parent: Optional[int]        # the enclosing span's id
    trace: Optional[int]         # the request or batch it belongs to
    attrs: dict
    device_ms: Optional[float] = None   # the stream's time, events

    @property
    def ms(self) -> float:
        """The span's host duration in milliseconds."""
        return (self.end_ns - self.start_ns) / 1e6


class _Null:
    """The span of a process that no profiler watches."""
    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def enabled() -> bool:
    """Whether a profiler runs (read anew on every call)."""
    return _profiler._is_profiler_enabled


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index a span's events go on, or None."""
    if device is False or device is None:
        return None
    if device is True:
        return (torch.cuda.current_device() if torch.cuda.is_available()
                else None)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device.index if device.index is not None \
        else torch.cuda.current_device()


class _Open:
    """A span being recorded: ``with`` it."""
    __slots__ = ("_rec", "name", "id", "parent", "trace", "attrs", "start",
                 "_cuda", "_events", "_range")

    def __init__(self, rec: "Recorder", name: str, trace, device,
                 attrs: dict):
        self._rec = rec
        self.name, self.trace, self.attrs = name, trace, attrs
        self.id = next(rec._ids)
        self.parent = None
        self._cuda = _cuda_index(device)
        self._events = None

    def __enter__(self):
        stack = self._rec._stack()
        if stack:
            self.parent = stack[-1].id
            if self.trace is None:
                self.trace = stack[-1].trace
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        if self._cuda is not None:
            self._events = self._rec._event_pair(self._cuda)
            self._events[0].record(torch.cuda.current_stream(self._cuda))
        self.start = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._cuda))
        self._range.__exit__(*exc)
        self._rec._stack().pop()
        self._rec._add((self.name, self.start, end, threading.get_native_id(),
                        self.id, self.parent, self.trace, self.attrs),
                       self._cuda, self._events)
        return False


def _columns() -> tuple:
    return tuple([] for _ in range(len(dataclasses.fields(Span)) - 1))


_ID = 4     # span_id's place among a Span's fields


class Recorder:
    """Spans of one process, in the order they ended. Their fields are
    kept in one list each (of strings, numbers and flat dicts, which the
    garbage collector does not track) until they are read, so that a long
    traced window leaves the collector no more objects to scan."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._fields = _columns()       # Span's fields but device_ms
        self._pending: list = []        # (span id, device index, events)
        self._device_ms: dict = {}      # span id -> ms
        self._pool: dict = {}           # device index -> free events

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event_pair(self, index: int) -> tuple:
        # an event takes its device from the stream it is first recorded
        # on, so each device has its own pool
        with self._lock:
            free = self._pool.setdefault(index, [])
            pair = [free.pop() if free else None for _ in range(2)]
        return tuple(e if e is not None else
                     torch.cuda.Event(enable_timing=True) for e in pair)

    def _add(self, fields: tuple, index, events) -> None:
        with self._lock:
            for column, value in zip(self._fields, fields):
                column.append(value)
            if events is not None:
                self._pending.append((fields[_ID], index, *events))

    def record(self, name: str, start_ns: int, end_ns: int, parent=None,
               trace=None, attrs=None) -> None:
        """A span whose two ends were stamped elsewhere (on two threads,
        say); ``parent`` defaults to the calling thread's open span."""
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1].id
            if trace is None:
                trace = stack[-1].trace
        self._add((name, int(start_ns), int(end_ns),
                   threading.get_native_id(), next(self._ids), parent, trace,
                   dict(attrs or {})), None, None)

    def spans(self) -> list:
        """Every span recorded, with its device time: one synchronise of
        each device that has events pending, then their elapsed times."""
        with self._lock:
            pending, self._pending = self._pending, []
        for index in sorted({p[1] for p in pending}):
            torch.cuda.synchronize(index)
        with self._lock:
            for span_id, _, start, end in pending:
                self._device_ms[span_id] = start.elapsed_time(end)
            records, device_ms = list(zip(*self._fields)), self._device_ms
        self._release(pending)
        return [Span(*fields, device_ms.get(fields[_ID]))
                for fields in records]

    def clear(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
            self._fields, self._device_ms = _columns(), {}
        self._release(pending)

    def _release(self, pending: list) -> None:
        with self._lock:
            for _, index, start, end in pending:
                self._pool.setdefault(index, []).extend((start, end))


_RECORDER = Recorder()


def span(name: str, *, trace=None, device=False, **attrs):
    """A context manager that records a span while a profiler runs, and
    does nothing otherwise (one shared object: nothing allocated, no
    clock read)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(_RECORDER, name, trace, device, attrs)


def record(name: str, start_ns: int, end_ns: int, parent=None, *,
           trace=None, **attrs) -> None:
    """Record a span stamped by the caller, while a profiler runs. It
    goes into the buffer only: the profiler's trace cannot take a range
    after the fact."""
    if _profiler._is_profiler_enabled:
        _RECORDER.record(name, start_ns, end_ns, parent, trace, attrs)


def spans() -> list:
    """The recorded :class:`Span` s (``device_ms`` None where no CUDA
    events were taken)."""
    return _RECORDER.spans()


def clear() -> None:
    """Drop every recorded span."""
    _RECORDER.clear()
