"""Device ms per volume launched inside the program's ``group_norm``
ranges: each GroupNorm of the net's conv blocks and the ReLU after it, one
fused call (models/layers.py ``norm_relu``; csrc/group_norm.cu's statistics
and apply kernels via ops/group_norm.py). A program without the range
reads nothing."""


def read(r):
    return r.per_unit_ms(r.trace.range_device_s("group_norm"))
