"""Share of their roofline the four per-flow CC kernels reach in the
traced sweep: the sum of their bounds (``roofline/cc_kernels.py``) over
the sum of their device time, per cent."""

from ccbench.roofline import cc_kernels as roof


def read(rec):
    device_s = roof.device_seconds(rec["kernel_s"])
    launches = sum(rec["launches"].get(k, 0) for k in roof.KERNELS)
    if device_s <= 0 or not launches:
        return None
    sh = rec["shapes"]
    bound_s = sum(rec["launches"].get(k, 0) * roof.bound_s(k, sh["R"], sh["F"])
                  for k in roof.KERNELS)
    return 100.0 * bound_s / device_s
