"""The union of the NCCL kernels' device intervals over the union of all
kernels' in rank 0's traced steps, in %."""


def read(res):
    tr = res["trace"]
    busy = tr.busy_us()
    return 100.0 * tr.busy_of("nccl") / busy if busy else None
