"""The share of the traced stretch's wall in which no kernel runs while
the program holds an admitted, unresolved request, in %: the union of the
``serve.request`` spans (``submit`` to the future resolving), on the
trace's clock, intersected with the gaps between the trace's kernels. At
most ``device_idle_pct.serve``; the rest of that idle is the traffic's.
Nothing when the program records no such span."""
from portbench import spans


def read(res):
    got = spans.in_stretch(res, {"serve.request"})
    if not got:
        return None
    tr = res["trace"]
    held = spans.union((s, e) for _, s, e, _ in got)
    return 100.0 * spans.overlap(held, spans.kernel_gaps(tr)) / tr.wall_us
