"""Instances dispatched over the bucket sizes dispatched, in %: from
``DynamicBatcher.stats()`` and ``ServingEngine.stats()`` over the window."""


def read(res):
    f = res["facts"]
    return 100.0 * f["instances"] / f["padded"] if f["padded"] else None
