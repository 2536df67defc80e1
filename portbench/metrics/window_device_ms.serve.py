"""Device ms per volume outside the net's span: the upload, the HU window,
the sliding window's patches and blend, the threshold and the fetch
(train/segmentation3d.py, ops/ct.py, ops/sliding_window.py)."""

from portbench.common.readout import NET_RANGE


def read(r):
    if not r.trace.range_count(NET_RANGE):
        return None
    return r.per_unit_ms(r.trace.device_total_s() - r.trace.range_device_s(NET_RANGE))
