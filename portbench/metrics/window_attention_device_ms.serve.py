"""Device ms per volume launched inside the program's ``window_attention``
ranges, one a Swin block's attention core (models/swin_unetr.py
``WindowAttention``: from the partitioned q, k, v through the relative
position bias, the shift mask and the softmax to the output before the
projection), inside ``swin_encoder``. A program without the range reads
nothing."""


def read(r):
    return r.per_unit_ms(r.trace.range_device_s("window_attention"))
