"""The program's spans, for the readers of ``program_span`` metrics: the
recorder of ``rsgnet_tpu_torch.utils.profiler``, read once the cell's
run returns, put on the clock of its traced stretch (``align``, by the
spans' ``record_function`` copies in the trace), and the interval
arithmetic the readers share. A program without a recorder, or a stretch
whose trace holds no copy, gives None."""
from __future__ import annotations


def recorded(names):
    """The recorder's spans named in ``names``; None without a recorder."""
    try:
        from rsgnet_tpu_torch.utils.profiler import spans
    except ImportError:
        return None
    return [s for s in spans() if s.name in names]


def in_stretch(res, names):
    """``[(name, start_us, end_us, span)]`` of the spans named in
    ``names`` that overlap the traced stretch, on its trace's clock; None
    without a recorder, a trace or an anchor."""
    try:
        from rsgnet_tpu_torch.utils.profiler import align, spans
    except ImportError:
        return None
    tr = res.get("trace")
    if tr is None or not hasattr(tr, "host"):
        return None
    on = align(tr.host, spans())
    if on is None:
        return None
    events = tr.host + tr.kernels
    lo = min(s for _, s, _ in events)
    hi = max(e for _, _, e in events)
    return [a for a in on if a[0] in names and a[2] >= lo and a[1] <= hi]


def union(intervals):
    """Sorted disjoint (start, end) covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def kernel_gaps(trace):
    """The gaps between the trace's kernels: no kernel runs in them."""
    busy = union((s, e) for _, s, e in trace.kernels)
    return [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
