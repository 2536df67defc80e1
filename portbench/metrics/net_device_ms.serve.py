"""Device ms per volume inside the benchmark's span around the net's
calls (models/unet.py, models/layers.py)."""

from portbench.common.readout import NET_RANGE


def read(r):
    return r.per_unit_ms(r.trace.range_device_s(NET_RANGE))
