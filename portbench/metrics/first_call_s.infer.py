"""Seconds in the first call of each input shape (``pipeline.first_call``:
cuDNN's autotuning of the shape, to the device's end), set-up spans the
program always records. Nothing without them."""
from portbench import spans


def read(res):
    got = spans.recorded({"pipeline.first_call"})
    return sum(s.seconds for s in got) if got else None
