"""Shear-warp kernel (B2): the least time of the traced steps' warps from
bytes (fp32 output plus the source footprint their matrices reach; 104.2
MB at the 128 train shape) at the HBM peak, over the kernel's device time
in the trace, in %. Nothing when no launch was traced."""
from portbench import roofline


def read(res):
    total_us, launches = res["trace"].kernel_us("shear_warp_kernel")
    geo = res["facts"].get("shear")
    # one launch a traced step, as the kernel's own counter saw them
    if not launches or not geo or not \
            launches == len(geo) == res["facts"]["kernel_launches"]:
        return None
    least_s = sum(roofline.shear_warp_bytes(size, trans, out)[0]
                  for size, trans, out in geo) / roofline.PEAK_HBM_BYTES
    return 100.0 * least_s / (total_us / 1e6)
