"""Device ms per volume launched inside the program's ``swin_encoder``
ranges, one a call of Swin UNETR's encoder (models/swin_unetr.py: the
patch embedding, the four stages of shifted-window blocks and patch
merging, and the hidden states' LayerNorms), inside ``net``. A program
without the range reads nothing."""


def read(r):
    return r.per_unit_ms(r.trace.range_device_s("swin_encoder"))
