"""The ViT blocks' share of the card's bf16 peak: their FLOPs at the
call's batch counted from shapes (``reference/vitpose.py::
vit_blocks_flops``: 15.85 TFLOP for ViTPose-H at 64 crops), over the mean
device time of the traced stretch's ``vit.blocks`` spans (a forward's
blocks and last norm, from their CUDA events), over 989 TFLOP/s, in %.
Compute bounds the blocks: their least bytes (the bf16 weights read once,
the fp32 tokens in and out: 1.39 GB at 64 crops) take 0.42 ms at the HBM
peak, their FLOPs 16.0 ms at the bf16 peak. Nothing when the program
records no such span, or a span lacks its device time."""
from portbench import roofline, spans
from portbench.reference.vitpose import vit_blocks_flops


def read(res):
    got = spans.in_stretch(res, {"vit.blocks"})
    if not got or any(sp.device_ms is None for _, _, _, sp in got):
        return None
    mean_s = sum(sp.device_ms for _, _, _, sp in got) / len(got) / 1e3
    f = res["facts"]
    flops = vit_blocks_flops(f["cfg"]["model"], f["batch"])
    return 100.0 * flops / mean_s / roofline.PEAK_BF16_FLOPS
