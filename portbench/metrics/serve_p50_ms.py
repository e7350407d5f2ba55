"""Median latency of the window's requests, each from when it was due to
be sent until its future resolved, in ms."""


def read(res):
    return res["facts"]["serve_p50_ms"]
