"""Device ms per train step launched inside the program's ``net`` range,
the forward of ``UNet2D._update`` (train/segmentation2d.py; models/unet.py,
models/layers.py, with the keyed ``dropout`` ranges inside)."""


def read(r):
    return r.per_unit_ms(r.trace.range_device_s("net"))
