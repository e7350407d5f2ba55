"""Dynamic request batching for production serving.

Dispatching requests one by one leaves most of the device idle at small
batches, so a server must coalesce. ``DynamicBatcher`` implements the
standard policy:

  - collect queued requests until the batch reaches ``max_batch`` instances
    or ``max_wait_ms`` has elapsed since the oldest waiting request;
  - pad to the engine's bucket and dispatch — CUDA launches are async, so
    the host thread is free once the batch is enqueued; a group whose size falls badly between
    buckets is first split into bucket-aligned chunks when that reduces
    padded compute (``_chunks_for_buckets``);
  - keep up to ``in_flight`` dispatched batches pending and materialize
    results on a separate completer thread, so the device starts batch k+1
    while batch k's response bytes are still crossing back (the same
    windowed-in-flight pattern as core/validate.py's eval loop);
  - fan the materialized arrays back out to per-request futures.

Latency/throughput knobs: ``max_wait_ms`` bounds the queueing delay a
request can pay to help fill a batch (set ~= the per-batch step time;
tools/profile_serving.py measures it); ``in_flight`` >= 2 hides the
response round trip (diminishing returns beyond 3-4 — each slot pins one
batch's buffers in HBM).

Admission control: an unbounded queue has no failure mode except
unbounded latency. Production behavior is to shed instead: ``max_queued`` bounds the *instances* waiting in the queue
and ``submit`` raises ``QueueFullError`` (HTTP maps it to 503 +
Retry-After) once the bound is hit, so saturation costs the shed client
one fast round trip instead of costing every client a deep queue. A
request may also carry a ``timeout_s``: one already past its deadline at
DISPATCH time is completed with ``DeadlineExceededError`` instead of
paying device time for a response its client stopped waiting for.

Tracing (``utils/profiler.py``): a request submitted from a thread that is
being profiled is traced. It records ``serve.submit`` (around ``submit``,
on the client's thread), ``serve.queue`` (from ``submit`` to the start of
its batch's dispatch) and ``serve.request`` (from ``submit`` to its future
resolving). A batch holding a traced request records the dispatcher's
states, which tile that thread's time (``serve.idle``: waiting on an empty
queue; ``serve.collect``: holding requests, up to ``max_wait_ms``;
``serve.slot_wait``: waiting for an in-flight slot; ``serve.dispatch``:
concat, padding and ``engine.run``), and the completer's
(``serve.complete_idle``, ``serve.to_host``, ``serve.fanout``), each
listing the batch's traced request ids. ``stats()`` always counts the
queue wait's recent percentiles and the dispatcher's seconds per state.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from rsgnet_tpu_torch.serving.engine import ServingEngine, to_host
from rsgnet_tpu_torch.utils import profiler

_STOP = object()
_STATES = ("idle", "collect", "slot_wait", "dispatch")
_REQUESTS = "requests"      # the trace's track of the requests' own spans


class QueueFullError(RuntimeError):
    """Admission control: the batcher queue is at capacity — shed load.

    ``retry_after_s`` is the server's estimate of when capacity frees up
    (queued work / measured throughput when the engine is warm)."""

    def __init__(self, queued: int, capacity: int, retry_after_s: float):
        super().__init__(
            f"queue full: {queued} instances waiting >= max_queued "
            f"{capacity}; retry in ~{retry_after_s:.2f}s")
        self.queued = queued
        self.capacity = capacity
        self.retry_after_s = retry_after_s


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it reached the device; the
    batcher dropped it at dispatch time instead of computing a response
    nobody is waiting for."""


@dataclass
class _Pending:
    images: np.ndarray
    centers: np.ndarray
    scales: np.ndarray
    n: int
    future: Future
    deadline: float | None = None       # absolute perf_counter() time
    t_submit: float = field(default_factory=time.perf_counter)
    rid: int | None = None              # the request's id when traced


class DynamicBatcher:
    """Thread-safe request coalescing in front of a ``ServingEngine``.

    ``submit`` never blocks on the device: it enqueues and returns a
    ``concurrent.futures.Future`` resolving to ``(preds (n,K,2) float32,
    maxvals (n,K,1) float32)`` host arrays for that request's instances.
    """

    def __init__(self, engine: ServingEngine, max_batch: int | None = None,
                 max_wait_ms: float = 5.0, in_flight: int = 2,
                 max_queued: int | None = None):
        if in_flight < 1:
            raise ValueError("in_flight must be >= 1")
        if max_queued is not None and max_queued < 1:
            raise ValueError("max_queued must be >= 1 (or None: unbounded)")
        self.engine = engine
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queued = max_queued
        self._q: queue.Queue = queue.Queue()
        self._done_q: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(in_flight)
        self._closed = False
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_instances = 0
        self._n_rejected = 0            # shed at submit (queue full)
        self._n_expired = 0             # dropped at dispatch (deadline past)
        self._queued_n = 0              # instances currently in the queue
        self._latencies: list = []          # bounded, most recent first
        self._queue_waits: list = []        # the same window, queue wait
        self._state_s = dict.fromkeys(_STATES, 0.0)   # the dispatcher's
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="batcher-dispatch",
                                            daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           name="batcher-complete",
                                           daemon=True)
        self._dispatcher.start()
        self._completer.start()

    # -- client side ---------------------------------------------------------

    def submit(self, images, centers, scales,
               timeout_s: float | None = None) -> Future:
        """Enqueue one request (1..max_batch instances); returns a Future.

        ``timeout_s``: the client's patience. Past ``submit + timeout_s``
        the request is dropped at dispatch time (``DeadlineExceededError``
        on the future) rather than executed. Raises ``QueueFullError``
        when ``max_queued`` instances are already waiting.
        """
        if self._closed:
            raise RuntimeError("batcher is closed")
        if profiler.current() is None:
            return self._submit(images, centers, scales, timeout_s, None)
        rid = profiler.new_id()
        with profiler.span("serve.submit", ids=(rid,)):
            return self._submit(images, centers, scales, timeout_s, rid)

    def _submit(self, images, centers, scales, timeout_s, rid):
        n = self.engine.validate(images, centers, scales)
        if n > self.max_batch:
            raise ValueError(f"request has {n} instances > max_batch "
                             f"{self.max_batch}; split it client-side")
        deadline = (time.perf_counter() + timeout_s
                    if timeout_s is not None else None)
        p = _Pending(np.asarray(images), np.asarray(centers, np.float32),
                     np.asarray(scales, np.float32), n, Future(),
                     deadline=deadline, rid=rid)
        with self._lock:
            # bound on what is ALREADY waiting — never on the incoming
            # request's own size, so any legal (<= max_batch) request is
            # admittable on an idle server even when max_queued < max_batch
            # (the queue can overshoot by at most one request, standard
            # bounded-queue semantics)
            if (self.max_queued is not None
                    and self._queued_n >= self.max_queued):
                self._n_rejected += 1
                raise QueueFullError(self._queued_n, self.max_queued,
                                     self._retry_after_locked())
            self._n_requests += 1
            self._queued_n += n
        self._q.put(p)
        return p.future

    def submit_many(self, requests, timeout_s: float | None = None):
        """Atomically admit a GROUP of requests (e.g. one frame's
        over-max_batch chunk list): either every chunk enqueues or none
        does (``QueueFullError``), so a shed can never leave a frame's
        earlier chunks consuming device time for a response that will
        never be assembled. Admission uses the same already-waiting bound
        as ``submit`` — the group counts as one overshoot. Returns the
        futures in request order."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        requests = list(requests)
        if profiler.current() is None:
            return self._submit_many(requests, timeout_s, None)
        rids = tuple(profiler.new_id() for _ in requests)
        with profiler.span("serve.submit", ids=rids):
            return self._submit_many(requests, timeout_s, rids)

    def _submit_many(self, requests, timeout_s, rids):
        pendings = []
        deadline = (time.perf_counter() + timeout_s
                    if timeout_s is not None else None)
        for i, (images, centers, scales) in enumerate(requests):
            n = self.engine.validate(images, centers, scales)
            if n > self.max_batch:
                raise ValueError(f"request has {n} instances > max_batch "
                                 f"{self.max_batch}; split it client-side")
            pendings.append(_Pending(
                np.asarray(images), np.asarray(centers, np.float32),
                np.asarray(scales, np.float32), n, Future(),
                deadline=deadline, rid=rids[i] if rids else None))
        total = sum(p.n for p in pendings)
        with self._lock:
            if (self.max_queued is not None
                    and self._queued_n >= self.max_queued):
                self._n_rejected += len(pendings)
                raise QueueFullError(self._queued_n, self.max_queued,
                                     self._retry_after_locked())
            self._n_requests += len(pendings)
            self._queued_n += total
        for p in pendings:
            self._q.put(p)
        return [p.future for p in pendings]

    def _retry_after_locked(self) -> float:
        """Estimate (holding ``self._lock``) of when queue capacity frees:
        queued work / measured throughput. Falls back to the recent p50
        latency, then to max_wait — always a small positive number so a
        503's Retry-After is never zero or absurd."""
        cost = self.engine.bucket_cost
        if cost:
            per_instance = min(c / b for b, c in cost.items() if b > 0)
            est = self._queued_n * per_instance
        elif self._latencies:
            est = float(np.median(self._latencies[-50:]))
        else:
            est = self.max_wait_s
        return float(min(max(est, 0.05), 10.0))

    def predict(self, images, centers, scales, timeout: float | None = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking convenience wrapper: submit + result. ``timeout`` is
        both the host wait bound and the dispatch deadline — a request this
        caller has given up on is never sent to the device."""
        return self.submit(images, centers, scales,
                           timeout_s=timeout).result(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            qw = np.asarray(self._queue_waits, np.float64)
            out = {"requests": self._n_requests,
                   "batches": self._n_batches,
                   "instances": self._n_instances,
                   "rejected": self._n_rejected,
                   "expired": self._n_expired,
                   "queued_instances": self._queued_n,
                   "max_queued": self.max_queued,
                   "mean_batch_fill": (self._n_instances
                                       / max(self._n_batches, 1))}
        if lat.size:
            out["latency_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["latency_p95_ms"] = float(np.percentile(lat, 95) * 1e3)
        if qw.size:
            out["queue_wait_p50_ms"] = float(np.percentile(qw, 50) * 1e3)
            out["queue_wait_p95_ms"] = float(np.percentile(qw, 95) * 1e3)
        out["dispatcher_s"] = dict(self._state_s)
        out["engine"] = self.engine.stats()
        return out

    def close(self, timeout: float = 60.0):
        """Drain queued requests, stop both threads. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        self._dispatcher.join(timeout)
        self._completer.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher ------------------------------------------------------------

    def _take(self, block: bool = True, timeout: float | None = None):
        """Pop one queue item, keeping the queued-instance counter (the
        admission-control ledger) exact. Raises ``queue.Empty``."""
        item = self._q.get(block=block, timeout=timeout)
        if item is not _STOP:
            with self._lock:
                self._queued_n -= item.n
        return item

    def _expire(self, p) -> bool:
        """Deadline-aware dispatch: if ``p``'s deadline has passed, complete
        it with ``DeadlineExceededError`` (no device time spent) and return
        True."""
        if p.deadline is None:
            return False
        now = time.perf_counter()
        if now <= p.deadline:
            return False
        with self._lock:
            self._n_expired += 1
        p.future.set_exception(DeadlineExceededError(
            f"deadline passed before dispatch (queued "
            f"{now - p.t_submit:.3f}s)"))
        _resolved(p, error="expired")
        return True

    def _dispatch_loop(self):
        carry = None                    # request that overflowed last group
        stopping = False
        t_free = time.perf_counter()    # the end of the last dispatch
        while not stopping:
            if carry is not None:
                first, carry = carry, None
                t_first = t_free        # no idle: the carry was held
            else:
                first = self._take()
                if first is _STOP:
                    break
                t_first = time.perf_counter()
            if self._expire(first):
                continue                # back to idle from t_free
            group, total = [first], first.n
            deadline = first.t_submit + self.max_wait_s
            while total < self.max_batch:
                # greedy first: after a stall (all in-flight slots busy) the
                # deadline may already be past while the queue holds a full
                # batch — drain what is already here before giving up
                try:
                    nxt = self._take(block=False)
                except queue.Empty:
                    wait = deadline - time.perf_counter()
                    if wait <= 0:
                        break
                    try:
                        nxt = self._take(timeout=wait)
                    except queue.Empty:
                        break
                if nxt is _STOP:
                    stopping = True
                    break
                if self._expire(nxt):
                    continue
                if total + nxt.n > self.max_batch:
                    carry = nxt        # starts the next group
                    break
                group.append(nxt)
                total += nxt.n
            t_free = self._dispatch(group, total, t_free, t_first)
        # drain anything still queued (close() guarantees completion —
        # still-live requests run, already-expired ones complete as such)
        leftovers = [carry] if carry is not None else []
        while True:
            try:
                item = self._take(block=False)
            except queue.Empty:
                break
            if item is not _STOP:
                leftovers.append(item)
        leftovers = [p for p in leftovers if not self._expire(p)]
        while leftovers:
            group, total = [], 0
            while leftovers and total + leftovers[0].n <= self.max_batch:
                p = leftovers.pop(0)
                group.append(p)
                total += p.n
            now = time.perf_counter()
            self._dispatch(group, total, now, now)
        self._done_q.put(_STOP)

    def _chunks_for_buckets(self, group, total):
        """Split a coalesced group into bucket-aligned chunks (FIFO order
        kept, requests atomic) when the engine's MEASURED per-bucket costs
        say the split is faster than padding to the next bucket.

        The motivating case: a group of 102 singles over buckets {64, 256}
        pads 154 dead instances, where two 64-bucket dispatches do less
        work. But instance counting alone would over-split where small
        buckets cost nearly as much as large ones, so the decision uses
        ``engine.bucket_cost`` (timed by ``warmup()``). Without a cost table (warmup not run) the group is
        dispatched whole — the original, predictable behavior.

        Shape of the split: peel full copies of the largest bucket <= the
        group total, leave the remainder as ONE chunk; adopt the split only
        if the summed measured cost strictly beats the single dispatch.
        """
        cost = self.engine.bucket_cost
        if not cost or total in self.engine.buckets:
            return [(group, total)]
        lower = [b for b in self.engine.buckets if b <= total]
        if not lower:
            return [(group, total)]
        b_lo = lower[-1]
        chunks, rest, rest_total = [], list(group), total
        while rest_total >= b_lo and rest:
            prefix, s, i = [], 0, 0
            while i < len(rest) and s + rest[i].n <= b_lo:
                s += rest[i].n
                prefix.append(rest[i])
                i += 1
            if not prefix:                 # head alone overflows b_lo
                prefix, s, i = [rest[0]], rest[0].n, 1
            chunks.append((prefix, s))
            rest, rest_total = rest[i:], rest_total - s
        if rest:
            chunks.append((rest, rest_total))

        def c(n):
            b = self.engine.bucket_for(n)
            return cost.get(b, float("inf"))

        if len(chunks) > 1 and sum(c(s) for _, s in chunks) < c(total):
            return chunks
        return [(group, total)]

    def _dispatch(self, group, total, t_free, t_first):
        """Dispatch a collected group; the dispatcher was idle from
        ``t_free`` and collecting from ``t_first``. Returns the end of the
        last dispatch."""
        t = time.perf_counter()
        self._state_s["idle"] += t_first - t_free
        self._state_s["collect"] += t - t_first
        ids = tuple(g.rid for g in group if g.rid is not None)
        if ids:
            profiler.record("serve.idle", profiler.to_ns(t_free),
                            profiler.to_ns(t_first))
            profiler.record("serve.collect", profiler.to_ns(t_first),
                            profiler.to_ns(t), ids)
        for chunk, chunk_total in self._chunks_for_buckets(group, total):
            t = self._dispatch_one(chunk, chunk_total, t)
        return t

    def _dispatch_one(self, group, total, t0):
        """Wait for a slot (from ``t0``), then concat, pad and hand the
        chunk to the engine. Returns when the engine has it."""
        self._slots.acquire()          # bounds batches in flight
        t1 = time.perf_counter()
        waits = [t0 - g.t_submit for g in group]
        ids = tuple(g.rid for g in group if g.rid is not None)
        sid = profiler.new_id() if ids else None
        ctx = profiler.TraceContext(ids, sid) if ids else None
        try:
            if len(group) == 1:
                imgs, cs, ss = group[0].images, group[0].centers, \
                    group[0].scales
            else:
                imgs = np.concatenate([g.images for g in group])
                cs = np.concatenate([g.centers for g in group])
                ss = np.concatenate([g.scales for g in group])
            with profiler.activate(ctx):
                out = self.engine.run(imgs, cs, ss)   # async dispatch
        except BaseException as e:
            self._slots.release()
            for g in group:
                g.future.set_exception(e)
                _resolved(g, error=type(e).__name__)
            out = None
        t2 = time.perf_counter()
        self._state_s["slot_wait"] += t1 - t0
        self._state_s["dispatch"] += t2 - t1
        with self._lock:
            self._queue_waits.extend(waits)
            del self._queue_waits[:-1000]        # as the latencies' window
            if out is not None:
                self._n_batches += 1
                self._n_instances += total
        if ids:
            for g in group:
                if g.rid is not None:
                    profiler.record("serve.queue", profiler.to_ns(g.t_submit),
                                    profiler.to_ns(t0), (g.rid,),
                                    thread=_REQUESTS)
            profiler.record("serve.slot_wait", profiler.to_ns(t0),
                            profiler.to_ns(t1), ids)
            profiler.record("serve.dispatch", profiler.to_ns(t1),
                            profiler.to_ns(t2), ids, span_id=sid,
                            instances=total)
        if out is not None:
            self._done_q.put((group, out, ids))
        return t2

    # -- completer -------------------------------------------------------------

    def _complete_loop(self):
        t_free = time.perf_counter()
        while True:
            item = self._done_q.get()
            if item is _STOP:
                return
            t_got = time.perf_counter()
            group, (preds, maxvals), ids = item
            try:
                # blocks until the device finishes this batch
                preds, maxvals = to_host(preds), to_host(maxvals)
            except BaseException as e:
                self._slots.release()
                for g in group:
                    g.future.set_exception(e)
                    _resolved(g, error=type(e).__name__)
                t_free = time.perf_counter()
                continue
            self._slots.release()
            now = time.perf_counter()
            off = 0
            lats = []
            for g in group:
                g.future.set_result((preds[off:off + g.n],
                                     maxvals[off:off + g.n]))
                off += g.n
                lats.append(now - g.t_submit)
                _resolved(g)
            with self._lock:
                self._latencies.extend(lats)
                del self._latencies[:-1000]      # keep the most recent 1000
            t_done = time.perf_counter()
            if ids:
                profiler.record("serve.complete_idle", profiler.to_ns(t_free),
                                profiler.to_ns(t_got))
                profiler.record("serve.to_host", profiler.to_ns(t_got),
                                profiler.to_ns(now), ids)
                profiler.record("serve.fanout", profiler.to_ns(now),
                                profiler.to_ns(t_done), ids)
            t_free = t_done


def _resolved(p: _Pending, **args):
    """A traced request's ``serve.request`` span, as its future resolves."""
    if p.rid is not None:
        profiler.record("serve.request", profiler.to_ns(p.t_submit),
                        profiler.now_ns(), (p.rid,), thread=_REQUESTS,
                        instances=p.n, **args)
