"""Device ms per train step of the work launched, from whatever thread,
while the program's ``backward`` range is open (``loss.backward()`` in
train/segmentation2d.py ``UNet2D._update``): autograd's engine launches
the card's backward nodes from a thread of its own."""

from portbench.common.spans import launched_device_s


def read(r):
    return r.per_unit_ms(launched_device_s(r.trace, "backward"))
