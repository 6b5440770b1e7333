"""The device check, and the port's tracer: spans in a tree and one registry
of counters, shared by the drivers, the dispatch entry points, the kernel
wrappers and the surface layer.

`resolve_device` turns a `device=` argument into a torch.device and raises
where CUDA is asked for but absent (the port never falls back to the CPU on
its own).

Recording. `stage_times()` records the calls made inside it. A call is a
tree of spans (`Span`) rooted at the span no other span was open around,
as a rule a driver's `call:<driver>`. Its children are the named stages
that `stage_end(name)` closes (`stage:<name>`: a stage runs from the
previous stage end, or from its parent's start if that is later) and the
spans that `span(name)` opens: `topology`, `gather`, `h2d`,
`dispatch:<entry>`, `kernel:<wrapper>`. A span that ran inside a stage is
that stage's child. Each span holds its name, its id, its parent's and its
call's, its host start and end (`perf_counter_ns`), the counts added while
it was the innermost span (a stage takes those of its parent since the
previous stage end), and, where asked for on a CUDA device, a pair of CUDA
events that are resolved only when `device_ms` is read. The block yields
the stage name -> wall ms dict, the device synchronised at each stage end.
`recorded_calls()` takes the recorded calls; `export_chrome(path)` writes
them as a Chrome trace.

Profiling. While a torch.profiler runs, each span of `span()` is a
`record_function` range `wol.<name>` and each stage end an instant range
`wol.stage:<name>`, so the profiler's trace puts every device operation on
the program's spans by correlation id.

Counters. `count(name, n)` adds to the process total (`total(name)`) and,
while recording, to the innermost span and its call. The kernel wrappers'
`.launches` and the plain versions' `.calls` (`kernel`, `plain`) and the
modules' `last_tier` (`serve_tier`, `tier_attr`) read the registry.

With no block open and no profiler running, a span or a stage end costs one
check: it creates no objects, events or ranges and never synchronises.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises (the
    port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch finds no CUDA device; "
            "pass device='cpu' to run the plain PyTorch version"
        )
    return dev


# --- counters ---------------------------------------------------------------

_totals: dict[str, int] = {}  # counter -> total for the process
_tiers: dict[str, str] = {}  # dispatch entry -> the tier that served it last


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`: to its process total and, while a
    call is recorded, to the innermost open span and to the call."""
    _totals[name] = _totals.get(name, 0) + n
    rec = _rec
    if rec is not None and rec.stack:
        top = rec.stack[-1].counts
        top[name] = top.get(name, 0) + n
        rec.call_counts[name] = rec.call_counts.get(name, 0) + n


def total(name: str) -> int:
    """The process total of the counter `name`."""
    return _totals.get(name, 0)


def totals() -> dict:
    """A copy of every counter's process total."""
    return dict(_totals)


def serve_tier(entry: str, tier: str) -> None:
    """Record that `tier` served the dispatch entry point `entry`: the
    counter `tier:<entry>:<tier>` and the entry's last tier."""
    _tiers[entry] = tier
    count(f"tier:{entry}:{tier}")


def tier_attr(entry: str, module: str):
    """A module `__getattr__` whose `last_tier` names the tier that served
    `entry` last ("none" before its first call)."""

    def __getattr__(name):
        if name == "last_tier":
            return _tiers.get(entry, "none")
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__


class _Counted:
    """A function whose calls or kernel launches a registry counter counts."""

    def __init__(self, fn, key: str):
        functools.update_wrapper(self, fn)
        self._fn, self._key = fn, key

    def _get(self) -> int:
        return total(self._key)

    def _set(self, value: int) -> None:  # a caller's reset of the count
        _totals[self._key] = int(value)


class _Kernel(_Counted):
    """A kernel wrapper: each call is a `kernel:<name>` span (CUDA events
    on the card); the wrapper counts `launches:<name>` where it launches."""

    launches = property(_Counted._get, _Counted._set)

    def __init__(self, fn):
        super().__init__(fn, f"launches:{fn.__name__}")
        self._span = f"kernel:{fn.__name__}"

    def __call__(self, *args, **kwargs):
        with span(self._span, device=True):
            return self._fn(*args, **kwargs)


class _Plain(_Counted):
    """A kernel's plain PyTorch version: each call counts `calls:<name>`."""

    calls = property(_Counted._get, _Counted._set)

    def __init__(self, fn):
        super().__init__(fn, f"calls:{fn.__name__}")

    def __call__(self, *args, **kwargs):
        count(self._key)
        return self._fn(*args, **kwargs)


def kernel(fn):
    """Decorator of a kernel wrapper (see `_Kernel`); `.launches` reads
    `launches:<name>`."""
    return _Kernel(fn)


def plain(fn):
    """Decorator of a plain version (see `_Plain`); `.calls` reads
    `calls:<name>`."""
    return _Plain(fn)


# --- spans ------------------------------------------------------------------

MAX_CALLS = 4096  # recorded calls kept until read; older ones are dropped

_ids = itertools.count(1)
_rec: "_Recording | None" = None  # the open `stage_times` block
_stage_ms: dict | None = None  # its stage dict
_calls: deque = deque(maxlen=MAX_CALLS)


class Span:
    """One span of a recorded call (times in ns of `perf_counter_ns`)."""

    __slots__ = ("name", "id", "parent", "call", "t0", "t1", "counts", "kids", "_events",
                 "_device_ms")

    def __init__(self, name: str, parent: "Span | None", t0: int):
        self.name, self.id, self.t0, self.t1 = name, next(_ids), t0, t0
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else self.id
        self.counts: dict = {}
        self.kids: list = []  # while open: children closed since the last stage end
        self._events = self._device_ms = None

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def device_ms(self) -> float | None:
        """Device time between the span's CUDA events, or None where it
        has none."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms, self._events = start.elapsed_time(end), None
        return self._device_ms


class Call:
    """A recorded call: its spans (the root first) and its counts."""

    __slots__ = ("root", "spans", "counts")

    def __init__(self, root: Span, spans: list, counts: dict):
        self.root, self.spans, self.counts = root, spans, counts

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def self_ms(self, span: Span) -> float:
        """The span's time less the part of it that its children cover."""
        covered, end = 0, span.t0
        for a, b in sorted((k.t0, k.t1) for k in self.spans if k.parent == span.id):
            a, b = max(a, end), min(b, span.t1)
            if b > a:
                covered, end = covered + b - a, b
        return (span.t1 - span.t0 - covered) * 1e-6


class _Recording:
    """The state of an open `stage_times` block."""

    def __init__(self):
        self.stack: list[Span] = []  # open spans, innermost last
        self.spans: list[Span] = []  # the current call's closed spans
        self.call_counts: dict = {}
        self.stage_ms: dict = {}
        self.boundary = time.perf_counter_ns()  # the last stage end

    def open(self, name: str, device: bool) -> Span:
        parent = self.stack[-1] if self.stack else None
        if parent is None:
            self.spans, self.call_counts = [], {}
        s = Span(name, parent, time.perf_counter_ns())
        if device and torch.cuda.is_initialized():
            s._events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            s._events[0].record()
        self.stack.append(s)
        return s

    def close(self, s: Span) -> None:
        if s._events is not None:
            s._events[1].record()
        s.t1 = time.perf_counter_ns()
        self.stack.remove(s)
        s.kids = []
        self.spans.append(s)
        if self.stack:
            self.stack[-1].kids.append(s)
        else:
            _calls.append(Call(s, [s] + self.spans[:-1], self.call_counts))
            self.spans, self.call_counts = [], {}

    def stage(self, name: str) -> None:
        _sync()
        now = time.perf_counter_ns()
        parent = self.stack[-1] if self.stack else None
        t0 = self.boundary if parent is None else max(self.boundary, parent.t0)
        self.stage_ms[name] = self.stage_ms.get(name, 0.0) + (now - t0) * 1e-6
        self.boundary = now
        if parent is None:
            return
        s = Span(f"stage:{name}", parent, t0)
        s.t1 = now
        s.counts, parent.counts = parent.counts, {}
        for k in parent.kids:
            if k.t0 >= t0:
                k.parent = s.id
        parent.kids = []
        self.spans.append(s)


class _NoSpan:
    """The span of the off path: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Open:
    """An open span: a recorded `Span`, a profiler range, or both."""

    __slots__ = ("name", "device", "rec", "span", "range")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(f"wol.{self.name}")
            self.range.__enter__()
        self.rec = _rec
        self.span = self.rec.open(self.name, self.device) if self.rec is not None else None
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            self.rec.close(self.span)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, device: bool = False):
    """A context manager around one span `name`; `device`: time it on the
    card too (a pair of CUDA events). Off the path, one shared no-op."""
    if _rec is None and not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Open(name, device)


def traced(name: str, device: bool = False):
    """Decorator: each call of the function runs inside `span(name, device)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, device):
                return fn(*args, **kwargs)

        return inner

    return wrap


def to_device(x, dtype=None, device=None) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)` inside an `h2d`
    span; counts the bytes handed to the device as `h2d_bytes` (none where
    `x` is a tensor there already)."""
    with span("h2d", device=True):
        t = torch.as_tensor(x, dtype=dtype, device=device)
        if not (torch.is_tensor(x) and x.device == t.device):
            count("h2d_bytes", t.nbytes)
    return t


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage_times():
    """Record the calls made inside the block (see the module docstring).
    Yields a dict to which each stage adds its wall time in ms at its end
    (host gather, H2D, masks, kernel stage, stats, D2H, savetxt, bootstrap;
    for `density_grid` grid setup, H2D, prep, kernel, D2H, marching
    tetrahedra), the CUDA device synchronised there."""
    global _rec, _stage_ms
    prev = _rec
    _sync()
    _rec = _Recording()
    _stage_ms = _rec.stage_ms
    try:
        yield _stage_ms
    finally:
        _rec = prev
        _stage_ms = prev.stage_ms if prev is not None else None


def stage_end(name: str) -> None:
    """End the stage `name` of the recorded call, and mark it on a running
    profiler."""
    if _rec is None and not _profiler._is_profiler_enabled:
        return
    if _rec is not None:
        _rec.stage(name)
    if _profiler._is_profiler_enabled:
        with torch.profiler.record_function(f"wol.stage:{name}"):
            pass


def recorded_calls() -> list[Call]:
    """Take the recorded calls, oldest first, and empty the buffer."""
    out = list(_calls)
    _calls.clear()
    return out


def export_chrome(path: str, calls: list | None = None, profiler_trace: str | None = None) -> int:
    """Write `calls` (default: `recorded_calls()`, which empties the buffer)
    as a Chrome trace that Perfetto and chrome://tracing open: one complete
    event per span, with its ids, counts and device ms as arguments, the
    named spans on one track and the stages on another. Times are the wall
    clock in us since `baseTimeNanoseconds`, torch.profiler's convention;
    with `profiler_trace`, the path of a trace that torch.profiler's
    `export_chrome_trace` wrote, the spans join its events on its time
    axis. Returns the number of spans written."""
    calls = recorded_calls() if calls is None else calls
    wall = time.time_ns() - time.perf_counter_ns()
    trace = {"traceEvents": []}
    if profiler_trace is not None:
        with open(profiler_trace) as f:
            trace = json.load(f)
    spans = [s for c in calls for s in c.spans]
    base = trace.get("baseTimeNanoseconds")
    if base is None:
        base = (min((s.t0 for s in spans), default=0) + wall) // 10**9 * 10**9
        trace["baseTimeNanoseconds"] = base
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": label}}
              for tid, label in ((1, "wol spans"), (2, "wol stages"))]
    for s in spans:
        args = {"id": s.id, "parent": s.parent, "call": s.call, "counts": s.counts}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"ph": "X", "cat": "wol", "name": s.name, "pid": pid,
                       "tid": 2 if s.name.startswith("stage:") else 1,
                       "ts": (s.t0 + wall - base) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
                       "args": args})
    trace["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(spans)
