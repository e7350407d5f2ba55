"""The share of the traced stretch's ``pipeline.call`` spans that replayed
CUDA graphs (the span's ``graph`` argument) instead of launching the call's
kernels one by one, in %. Reads every ``graph_replay_pct.<cell kind>``
metric. Nothing when no such span carries the argument."""
from portbench import spans


def read(res):
    got = spans.in_stretch(res, {"pipeline.call"}) or ()
    flags = [bool(sp.args["graph"]) for _, _, _, sp in got
             if sp.args and "graph" in sp.args]
    return 100.0 * sum(flags) / len(flags) if flags else None
