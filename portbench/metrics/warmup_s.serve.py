"""Seconds the serving engine spent warming its buckets: the sum of the
``serve.warmup`` spans (one a bucket, its warm call and timing repeats
inside), set-up spans the program always records. Nothing without them."""
from portbench import spans


def read(res):
    got = spans.recorded({"serve.warmup"})
    return sum(s.seconds for s in got) if got else None
