"""Device ms per volume launched inside the program's ``net`` ranges, one
a call of the net by the sliding window (ops/sliding_window.py;
models/unet.py, models/layers.py)."""


def read(r):
    return r.per_unit_ms(r.trace.range_device_s("net"))
