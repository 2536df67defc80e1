"""Device ms per train step inside torch's ``Optimizer.step#Adam.step``
range (train/state.py's optimizer, stepped by train/loop.py)."""


def read(r):
    return r.per_unit_ms(r.trace.range_device_s("Optimizer.step#Adam.step"))
