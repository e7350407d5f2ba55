"""The hand-written CUDA kernels' operators (``dark_decode``,
``shear_warp``) and their shared launch counting.

Each kernel wrapper keeps ``launches``, the launches that ran on the card.
A launch made while a CUDA graph is captured runs only when the graph is
replayed: ``core/inference.py`` captures its graphs inside
``launch_tally``, which collects such launches instead of counting them,
and adds each graph's tally at every replay (``replayed``).
"""
from __future__ import annotations

import contextlib
import threading

_local = threading.local()


def count_launch(wrapper):
    """Count one launch of ``wrapper``'s kernel: now, or, inside
    ``launch_tally`` on this thread, at each replay of the graph being
    captured."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        wrapper.launches += 1
    else:
        tally.append(wrapper)


@contextlib.contextmanager
def launch_tally():
    """Collect the launches counted on this thread in the block (a CUDA
    graph's capture) into the list it yields, one wrapper a launch."""
    prev = getattr(_local, "tally", None)
    _local.tally = tally = []
    try:
        yield tally
    finally:
        _local.tally = prev


def replayed(tally):
    """Count the launches of one replay of a graph captured with
    ``tally``."""
    for wrapper in tally:
        wrapper.launches += 1
