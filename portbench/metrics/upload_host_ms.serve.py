"""Host ms per volume inside the program's ``upload`` range
(train/segmentation3d.py ``UNet3D._upload``: the pinned buffer, the host's
copy into it and the copy's launch)."""

from portbench.common.spans import host_s


def read(r):
    return r.per_unit_ms(host_s(r.trace, "upload"))
