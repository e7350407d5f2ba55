"""Device traces: ``torch.profiler`` over a short steady stretch, reduced to
the kernels' intervals, the host ops' intervals, the busy union and the
breakdown the result line carries."""
from __future__ import annotations

import time

import numpy as np


def busy_us(spans):
    """Union of (start, end) intervals, in their unit (the arithmetic of
    ``chip_smoke.py::_busy_us``)."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


class Trace:
    """One traced stretch: ``kernels`` and ``host`` as (name, start_us,
    end_us), ``wall_us`` from the first to the last event the stretch
    waited for, and ``units``, what the stretch completed (calls, steps
    or requests)."""

    def __init__(self, kernels, host, wall_us, units):
        self.kernels = kernels
        self.host = host
        self.wall_us = wall_us
        self.units = units

    def busy_us(self):
        return busy_us([(s, e) for _, s, e in self.kernels])

    def launches(self):
        """Kernels in the stretch (copies and fills left out)."""
        return sum(1 for n, _, _ in self.kernels
                   if not n.startswith(("Memcpy", "Memset")))

    def kernel_us(self, needle):
        """(total µs, launches) of the kernels whose name holds
        ``needle``."""
        hits = [e - s for n, s, e in self.kernels if needle in n]
        return sum(hits), len(hits)

    def breakdown(self, top=10):
        """The device ops that took most time, and the longest idle gaps
        named by the innermost host op running at each gap's middle."""
        by_name = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        spans = sorted((s, e) for _, s, e in self.kernels)
        gaps, cur = [], spans[0][1] if spans else 0.0
        for s, e in spans[1:]:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        # the longest gaps hold nearly all the idle time: name those
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:500]
        starts = np.asarray([h[1] for h in self.host])
        ends = np.asarray([h[2] for h in self.host])
        named = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inner = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (self.host[inner[np.argmin(ends[inner] - starts[inner])]][0]
                    if inner.size else "host: no op")
            named[name] = named.get(name, 0.0) + (g1 - g0)
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v / 1e6] for n, v in ops],
                "idle_gaps": [[n[:120], v / 1e6] for n, v in idle]}


class Summary:
    """What the harness and the readers take from a ``Trace`` made in
    another process: its busy time, wall, units, launches, breakdown and
    the busy time of the kernels matching given names."""

    def __init__(self, d):
        self.d = d
        self.wall_us = d["wall_us"]
        self.units = d["units"]

    @staticmethod
    def of(trace, needles=()):
        return {"busy_us": trace.busy_us(), "wall_us": trace.wall_us,
                "units": trace.units, "launches": trace.launches(),
                "breakdown": trace.breakdown(),
                "busy_of": {n: busy_us([(s, e) for k, s, e in trace.kernels
                                        if n in k.lower()])
                            for n in needles}}

    def busy_us(self):
        return self.d["busy_us"]

    def launches(self):
        return self.d["launches"]

    def breakdown(self):
        return self.d["breakdown"]

    def busy_of(self, needle):
        return self.d["busy_of"][needle]


def trace_stretch(torch, stretch):
    """Run ``stretch()`` (which returns the units it completed, after
    synchronizing the device) under ``torch.profiler`` with CPU and CUDA
    activities. Returns a ``Trace``, or None where the trace holds no
    device events (the profiler could not see the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = stretch()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and \
                e.device_type == DeviceType.CUDA:
            continue
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        (kernels if e.device_type == DeviceType.CUDA else host).append(span)
    if not kernels:
        return None
    return Trace(kernels, host, wall_us, units)
