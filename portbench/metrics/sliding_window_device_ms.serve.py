"""Device ms per volume launched inside the program's ``patches`` and
``blend`` ranges (ops/sliding_window.py: the padding and the patch stack;
the Gaussian weights and the accumulation)."""


def read(r):
    return r.per_unit_ms(r.trace.range_device_s("patches") + r.trace.range_device_s("blend"))
