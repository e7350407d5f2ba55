"""The whole call's or train step's share of the cards' bf16 peak: the
reference model's FLOPs per image (forward, two forwards under flip-test,
or forward and backward in training) times the window's images per second
over all ranks, over the ranks' cards x 989 TFLOP/s, in %. Reads every
``mfu_pct.<cell kind>`` metric."""
from portbench import roofline


def read(res):
    f = res["facts"]
    per = roofline.model_flops(f["cfg"]["model"], train=f.get("train", False))
    per *= 2 if f.get("flip_test") else 1
    return (100.0 * per * f["images_per_s"]
            / (f.get("world", 1) * roofline.PEAK_BF16_FLOPS))
