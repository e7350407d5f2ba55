"""Tracing (the port of the JAX package's ``utils/profiler.py``) and the
port's spans.

- ``trace``: a ``torch.profiler`` trace (CPU and, on a card, CUDA
  activity) of a block, written as a Chrome trace JSON file into a
  directory (``write_trace``: no TensorBoard needed; open it in
  ``chrome://tracing`` or Perfetto), with the recorder's spans of the
  traced stretch merged in.
- ``StepTraceWindow``: the same for steps ``[start, start + n_steps)`` of a
  loop of train steps or eval batches, on ``torch.profiler``'s schedule,
  both edges fenced.
- ``enable_nan_checks``: raise at the first non-finite loss or gradient of
  a train step, naming the tensor (``check_finite``), with autograd's
  anomaly detection on.
- Spans: ``span`` (a block on one thread), ``record`` (a span measured
  elsewhere), ``spans`` (what the bounded recorder holds, device times
  resolved) and ``align`` (the spans on a trace's clock).

Spans and the trace context. ``torch.profiler`` records host ops only on
the thread that started it, and the serving path runs on threads of its
own (the batcher's dispatcher and completer, the engine's thread), so a
``record_function`` there never reaches the trace. The port records its
own spans instead, and decides once, on the thread that makes a request
or a call, whether the work is traced: it is when that thread is being
profiled (``torch.autograd``'s ``_profiler_enabled``: a ``--profile``
window, ``trace()``, the benchmark's traced stretch, an operator's own
profiler). The decision travels with the work: a request keeps it, a batch
is traced when one of its requests is, and the thread that runs a traced
batch holds a ``TraceContext`` (``activate``) that the spans under it
read. Untraced work pays that check and a bool per boundary and records
nothing. Set-up spans (``setup=True``: a bucket's warm-up, the first call
of a shape) are recorded always; they are few and bounded.

Each span has a name, its start and end on the recorder's clock (Unix
nanoseconds, the clock ``torch.profiler`` stamps its host events with:
``now_ns``), its thread, the ids of the requests it serves and its parent
span. A span opened on a profiled thread also opens a ``record_function``
of its name, so it appears in the profiler's trace beside the kernels;
``align`` maps the recorder's times onto a trace's by those copies.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

_NAN_CHECKS = False
_profiling = torch._C._autograd._profiler_enabled


def _sync():
    """Wait for every queued kernel when CUDA is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- the recorder -------------------------------------------------------------

_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """The recorder's clock: Unix nanoseconds (as ``torch.profiler``
    stamps host events), read from the monotonic ``perf_counter``."""
    return time.perf_counter_ns() + _OFFSET_NS


def to_ns(perf_s: float) -> int:
    """A ``time.perf_counter()`` reading on the recorder's clock."""
    return int(perf_s * 1e9) + _OFFSET_NS


@dataclass(slots=True, eq=False)
class Span:
    """One recorded span. ``thread`` is the name of the thread it ran on
    and ``tid`` that thread's native id (None for a request's own spans,
    which start on one thread and end on another); ``ids`` the requests it
    serves; ``anchored`` that a ``record_function`` copy of it is in the
    profiler's trace; ``device_ms`` the device time between its CUDA
    events, once the stream has passed them (``spans()``)."""
    name: str
    start_ns: int
    end_ns: int
    thread: str
    tid: int | None
    ids: tuple = ()
    parent: int | None = None
    span_id: int = 0
    setup: bool = False
    anchored: bool = False
    args: dict | None = None
    device_ms: float | None = None
    events: tuple | None = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """A ring of the last ``capacity`` spans; ``dropped`` counts the spans
    it pushed out."""

    def __init__(self, capacity: int = 100_000):
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, s: Span):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(s)

    def spans(self) -> list:
        """The spans held, oldest first. A span whose end event the stream
        has passed gets its ``device_ms``; the host never waits for one."""
        with self._lock:
            out = list(self._ring)
        for s in out:
            if s.events is not None and s.events[1].query():
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
        return out


RECORDER = Recorder()
_IDS = itertools.count(1)


def new_id() -> int:
    """A fresh id, for a request or for a span recorded later."""
    return next(_IDS)


def spans() -> list:
    """The process recorder's spans (``Recorder.spans``)."""
    return RECORDER.spans()


def record(name: str, start_ns: int, end_ns: int, ids=(), *, parent=None,
           span_id=None, thread=None, **args):
    """Store a span measured elsewhere, on this thread's name unless
    ``thread`` names a track of its own (with no native thread id). The
    caller has decided that the work is traced."""
    if thread is None:
        t = threading.current_thread()
        thread, tid = t.name, t.native_id
    else:
        tid = None
    RECORDER.add(Span(name, start_ns, end_ns, thread, tid, tuple(ids),
                      parent, span_id or next(_IDS), args=args or None))


# -- the trace context --------------------------------------------------------

@dataclass(frozen=True, slots=True)
class TraceContext:
    """Traced work on its way: the requests it serves and the span it
    runs under (on another thread, where it was handed over)."""
    ids: tuple = ()
    parent: int | None = None


_ROOT = TraceContext()
_local = threading.local()
_OFF = contextlib.nullcontext()


def current() -> TraceContext | None:
    """This thread's trace context: the one the work carried in, else a
    new one where the thread is being profiled; None where the work is not
    traced."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None and _profiling():
        return _ROOT
    return ctx


class _Activate:
    __slots__ = ("ctx", "prev")

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self.prev = getattr(_local, "ctx", None)
        _local.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _local.ctx = self.prev
        return False


def activate(ctx: TraceContext | None):
    """Run the block under ``ctx`` on this thread; None leaves the thread
    as it is."""
    return _OFF if ctx is None else _Activate(ctx)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Open:
    """An open span: its ``record_function`` copy on a profiled thread,
    its CUDA events with ``device``."""
    __slots__ = ("span", "rf", "device")

    def __init__(self, name, ids, ctx, profiled, setup, device, args):
        t = threading.current_thread()
        if ids is None:
            ids = ctx.ids if ctx is not None else ()
        self.span = Span(name, 0, 0, t.name, t.native_id, tuple(ids),
                         None, next(_IDS), setup, profiled, args or None)
        self.rf = (torch.autograd.profiler.record_function(name)
                   if profiled else None)
        self.device = device

    def __enter__(self):
        s = self.span
        st = _stack()
        ctx = getattr(_local, "ctx", None)
        s.parent = st[-1] if st else (ctx.parent if ctx else None)
        st.append(s.span_id)
        if self.device:
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        # stamped where the copy's own stamps are nearest: its enter
        # stamps first and then sets up, its exit tears down first
        s.start_ns = now_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return s

    def __exit__(self, *exc):
        s = self.span
        if self.device:
            s.events[1].record()
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        s.end_ns = now_ns()
        RECORDER.add(s)
        return False


def span(name: str, ids=None, *, setup: bool = False, device: bool = False,
         **args):
    """A span of the block on this thread, recorded when the work is
    traced (``current()``) or when it is a set-up span; otherwise a no-op.
    ``ids`` default to the trace context's; ``device`` adds a CUDA event
    pair on the current stream; ``args`` are kept with the span."""
    ctx = getattr(_local, "ctx", None)
    profiled = _profiling()
    if ctx is None and not profiled and not setup:
        return _OFF
    return _Open(name, ids, ctx, profiled, setup, device, args)


def no_stage(name):
    """The stage of untraced work: a no-op."""
    return _OFF


def stages(device):
    """``stage(name)`` for the steps of a traced call on ``device``: a
    span of this thread's trace context each, with CUDA events at its
    start and end on a CUDA device. No-ops where the thread holds no trace
    context, and always while ``torch.compile`` or ``torch.export``
    traces: the decision is made outside any captured graph."""
    if torch.compiler.is_compiling() or getattr(_local, "ctx", None) is None:
        return no_stage
    cuda = torch.device(device).type == "cuda"
    return lambda name: span(name, device=cuda)


def _shift_offsets(host_us, rec_ns):
    """Offsets (ns) of the best in-order match of one name's host events
    (µs) and recorded spans (ns): the shorter list slid along the longer,
    at the shift with the least spread."""
    h = np.sort(np.asarray(host_us, np.float64)) * 1e3
    r = np.sort(np.asarray(rec_ns, np.float64))
    short, long_, sign = (h, r, 1.0) if len(h) <= len(r) else (r, h, -1.0)
    best, best_spread = None, np.inf
    for k in range(len(long_) - len(short) + 1):
        off = sign * (long_[k:k + len(short)] - short)
        spread = np.median(np.abs(off - np.median(off)))
        if spread < best_spread:
            best, best_spread = off, spread
    return best


def align(host_events, recorded=None):
    """The recorder's spans on a trace's clock: ``[(name, start_us, end_us,
    span)]`` for ``recorded`` (default: ``spans()``), in the µs of
    ``host_events``, the trace's ``(name, start_us, end_us)`` host events.
    The offset is the median over the anchored spans (those with a
    ``record_function`` copy) matched in order with the host events of
    their name; None where no span matches."""
    recorded = spans() if recorded is None else recorded
    by_name = collections.defaultdict(list)
    for n, s, _ in host_events:
        by_name[n].append(s)
    anchors = collections.defaultdict(list)
    for s in recorded:
        if s.anchored and s.name in by_name:
            anchors[s.name].append(s.start_ns)
    if not anchors:
        return None
    # offsets from one of the stamps, which float64 holds to the ns
    base = min(min(a) for a in anchors.values())
    offs = np.concatenate([_shift_offsets(by_name[n], [t - base for t in a])
                           for n, a in anchors.items()])
    origin = base + int(round(float(np.median(offs))))
    return [(s.name, (s.start_ns - origin) / 1e3, (s.end_ns - origin) / 1e3,
             s) for s in recorded]


def _merge_spans(path: str):
    """Add the recorder's spans that fall in the stretch of the Chrome
    trace at ``path`` to the file: each thread's as complete events on
    that thread's track, a request's own (no thread) as async events keyed
    by its id. Anchored spans are there already, as their
    ``record_function`` copies; a trace with none of them gets nothing."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not xs:
        return
    on = align([(e["name"], e["ts"], e["ts"] + e["dur"]) for e in xs
                if e.get("cat") == "user_annotation"])
    if on is None:
        return
    lo = min(e["ts"] for e in xs)
    hi = max(e["ts"] + e["dur"] for e in xs)
    pid = os.getpid()
    named = {}
    for name, t0, t1, s in on:
        if s.anchored or t1 < lo or t0 > hi:
            continue
        args = {"ids": list(s.ids), "span_id": s.span_id,
                "parent": s.parent, **(s.args or {})}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        if s.tid is None:
            key = {"cat": "request", "name": name, "pid": pid,
                   "id": s.ids[0] if s.ids else s.span_id}
            events.append(dict(key, ph="b", ts=t0, args=args))
            events.append(dict(key, ph="e", ts=t1))
            continue
        named[s.tid] = s.thread
        events.append({"ph": "X", "cat": "span", "name": name, "pid": pid,
                       "tid": s.tid, "ts": t0, "dur": t1 - t0,
                       "args": args})
    for tid, thread in named.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": thread}})
    with open(path, "w") as f:
        json.dump(doc, f)


# -- traces -------------------------------------------------------------------

def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def write_trace(logdir: str):
    """A ``torch.profiler`` trace handler: each trace goes to
    ``<logdir>/trace_<pid>_<ms>.json`` (Chrome trace format), the
    recorder's spans merged in."""

    def handler(prof):
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        _merge_spans(path)

    return handler


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block into ``logdir``; both edges wait for the card."""
    _sync()
    with torch.profiler.profile(activities=_activities(),
                                on_trace_ready=write_trace(logdir)):
        try:
            yield
        finally:
            _sync()


def enable_nan_checks(enable: bool = True):
    """Turn the NaN checks of the train step on or off: with them,
    ``check_finite`` raises at the first non-finite loss or gradient, and
    autograd's anomaly detection names the backward op that made one."""
    global _NAN_CHECKS
    _NAN_CHECKS = bool(enable)
    torch.autograd.set_detect_anomaly(bool(enable))


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS


def check_finite(loss=None, model=None, step=None):
    """Raise ``FloatingPointError`` naming the loss, or the first parameter
    of ``model`` whose gradient holds a NaN or an infinity (each check
    reads a flag back from the device). The train step checks the loss
    before its backward pass and the gradients after it."""
    at = "" if step is None else f" at step {step}"
    if loss is not None and not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"non-finite loss{at}: "
                                 f"{float(loss.detach())}")
    for name, p in ([] if model is None else model.named_parameters()):
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            raise FloatingPointError(f"non-finite gradient of {name}{at}")


class StepTraceWindow:
    """Trace steps ``[start, start + n_steps)`` of a loop (train steps,
    eval batches) into ``logdir``.

    The loop calls ``step(i)`` at the TOP of iteration ``i`` and
    ``close()`` after it, in a ``finally`` clause, so a loop that raises or
    ends inside the window still writes its partial trace and leaves no
    profiler running. The window follows ``torch.profiler``'s schedule
    (wait ``start`` steps, record ``n_steps``), and both of its edges wait
    for the card, so the trace holds whole steps. ``start`` defaults to 1:
    step 0 (the first call's set-up) stays out.
    """

    def __init__(self, logdir: str, n_steps: int, start: int = 1,
                 logger=None):
        self.logdir = logdir
        self.n_steps = max(1, int(n_steps))
        self.start = int(start)
        self.logger = logger
        with warnings.catch_warnings():
            # no warm-up steps: the edge is fenced instead
            warnings.simplefilter("ignore", UserWarning)
            schedule = torch.profiler.schedule(
                wait=self.start, warmup=0, active=self.n_steps, repeat=1)
        self._prof = torch.profiler.profile(
            activities=_activities(), schedule=schedule,
            on_trace_ready=self._ready)
        self._prof.start()
        self._recording = False
        self._done = False

    def _ready(self, prof):
        write_trace(self.logdir)(prof)
        self._done = True
        if self.logger:
            self.logger.info("profiler trace (<= %d steps) written to %s",
                             self.n_steps, self.logdir)

    def step(self, i: int):
        if i == self.start or i == self.start + self.n_steps:
            _sync()                   # the window holds whole steps
        if i > 0 and self._prof is not None:
            self._prof.step()
        self._recording = self.start <= i < self.start + self.n_steps

    def close(self):
        """Write the trace if the loop ended inside the window; say so if
        it ended before the window began."""
        if self._prof is None:
            return
        if self._recording:
            _sync()
        prof, self._prof = self._prof, None
        prof.stop()
        if not self._done and self.logger:
            self.logger.warning(
                "profiler trace never started: the loop ended before step "
                "%d (steps 0..%d are left out as set-up)", self.start,
                self.start - 1)
