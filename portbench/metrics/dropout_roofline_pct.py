"""The keyed dropout (csrc/dropout.cu via ops/dropout.py) against its
byte bound: the bytes a step's dropout has to move (common/flops.py) at
the card's memory rate, over the device time of its launches in the
forward ``dropout`` ranges and under its autograd backward node."""


def read(r):
    nbytes = r.work.get("dropout_bytes")
    fwd = r.trace.range_device_s("dropout")
    bwd = r.trace.range_device_s("KeyedDropoutBackward", contains=True)
    if not nbytes or "hbm_tbs" not in r.peak or fwd <= 0 or bwd <= 0 or not r.units:
        return None
    bound_s = nbytes / (r.peak["hbm_tbs"] * 1e12)
    return 100.0 * bound_s * r.units / (fwd + bwd)
