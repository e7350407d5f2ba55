"""DARK decode kernel (B1): its least time from bytes (each heatmap read
once; at (64, 17, 96, 72) 30.1 MB) at the HBM peak, over its mean device
time per launch in the trace, in %. Nothing when the trace holds no launch,
or not every launch the kernel's counter (``dark_decode.launches``) saw."""
from portbench import roofline


def read(res):
    total_us, launches = res["trace"].kernel_us("dark_decode_kernel")
    # the trace must hold every launch the kernel's own counter saw
    if not launches or launches != res["facts"]["kernel_launches"]:
        return None
    n, k, h, w = res["facts"]["dark_shape"]
    blur = res["facts"]["blur_kernel"]
    least_s = max(roofline.dark_decode_bytes(n, k, h, w)
                  / roofline.PEAK_HBM_BYTES,
                  roofline.dark_decode_flops(n, k, h, w, blur)
                  / roofline.PEAK_FP32_FLOPS)
    return 100.0 * least_s / (total_us / launches / 1e6)
