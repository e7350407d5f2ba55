"""100 minus the union of the kernels' device intervals over the traced
stretch's wall time, in % (the arithmetic of chip_smoke.py::_busy_us).
Reads every ``device_idle_pct.<cell kind>`` metric."""


def read(res):
    tr = res["trace"]
    return 100.0 * (1.0 - tr.busy_us() / tr.wall_us)
