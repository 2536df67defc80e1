"""Device ms per train step inside the program's ``augment`` range
(ops/transforms.py, ops/warp.py)."""


def read(r):
    return r.per_unit_ms(r.trace.range_device_s("augment"))
