"""The ViTPose call's share of the card's bf16 peak: the reference's FLOPs
of one crop's forward counted from shapes
(``reference/vitpose.py::vitpose_flops``: 251.7 GFLOP for ViTPose-H at
256x192), two forwards a box under flip-test, times the window's boxes
per second, over 989 TFLOP/s, in %."""
from portbench import roofline
from portbench.reference.vitpose import vitpose_flops


def read(res):
    f = res["facts"]
    per = vitpose_flops(f["cfg"]["model"]) * (2 if f["flip_test"] else 1)
    return 100.0 * per * f["images_per_s"] / roofline.PEAK_BF16_FLOPS
