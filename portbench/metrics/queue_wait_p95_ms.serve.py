"""95th percentile of the traced stretch's ``serve.queue`` spans (a
request's wait from ``DynamicBatcher.submit`` to the start of its batch's
dispatch), in ms. Nothing when the program records no such span."""
import numpy as np

from portbench import spans


def read(res):
    got = spans.in_stretch(res, {"serve.queue"})
    if not got:
        return None
    return float(np.percentile([(e - s) / 1e3 for _, s, e, _ in got], 95))
