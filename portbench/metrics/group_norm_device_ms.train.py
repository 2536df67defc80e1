"""Device ms per train step of the fused GroupNorm+ReLU: the work launched
inside the forward's ``group_norm`` ranges (models/layers.py
``norm_relu``) and under its autograd backward node
(``_GroupNormReLUBackward``, on autograd's thread), csrc/group_norm.cu's
four kernels via ops/group_norm.py. A program without the forward range
reads nothing."""


def read(r):
    fwd = r.trace.range_device_s("group_norm")
    if fwd <= 0:
        return None
    return r.per_unit_ms(fwd + r.trace.range_device_s("GroupNormReLUBackward", contains=True))
