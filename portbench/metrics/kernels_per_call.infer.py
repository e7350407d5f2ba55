"""CUDA kernels launched in the traced stretch over the calls it
completed."""


def read(res):
    tr = res["trace"]
    return tr.launches() / tr.units if tr.units else None
