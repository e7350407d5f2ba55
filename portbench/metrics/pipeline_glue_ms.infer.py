"""Device milliseconds a traced call spends around the model: the
``pipeline.crop`` (or ``pipeline.normalize``), ``pipeline.flip`` and
``pipeline.decode`` spans of the traced stretch's ``pipeline.call`` spans
(everything but the forwards), from their CUDA events, over the calls.
Nothing when the program records no such span, or a stage's device time is
missing."""
from portbench import spans

GLUE = {"pipeline.crop", "pipeline.normalize", "pipeline.flip",
        "pipeline.decode"}


def read(res):
    calls = spans.in_stretch(res, {"pipeline.call"})
    if not calls:
        return None
    ids = {sp.span_id for _, _, _, sp in calls}
    glue = [sp for _, _, _, sp in spans.in_stretch(res, GLUE)
            if sp.parent in ids]
    if not glue or any(sp.device_ms is None for sp in glue):
        return None
    return sum(sp.device_ms for sp in glue) / len(ids)
