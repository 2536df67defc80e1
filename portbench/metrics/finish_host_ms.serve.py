"""Host ms per volume inside the program's ``finish`` range
(train/segmentation2d.py ``UNet2D._finish``: the fetched mask times 255,
and the NIfTI write where one is asked for)."""

from portbench.common.spans import host_s


def read(r):
    return r.per_unit_ms(host_s(r.trace, "finish"))
