"""The share of the traced stretch's eval BatchNorms that ran in the
program's ConvBN epilogue kernel (``convbn_epilogue_kernel``), in %: its
launches over those launches plus the launches of kernels whose names hold
``bn_fw_inf`` (cuDNN's inference BatchNorm) or ``batch_norm`` (ATen's).
Reads every ``bn_epilogue_pct.<cell kind>`` metric, from the device trace
alone. Nothing when the trace holds neither."""


def read(res):
    kernels = getattr(res.get("trace"), "kernels", None) or ()
    fused = plain = 0
    for name, _, _ in kernels:
        low = name.lower()
        if "convbn_epilogue" in low:
            fused += 1
        elif "bn_fw_inf" in low or "batch_norm" in low:
            plain += 1
    return 100.0 * fused / (fused + plain) if fused + plain else None
