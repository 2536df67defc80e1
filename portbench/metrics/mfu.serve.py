"""The whole unit's counted FLOPs over the traced window, per cent of the
configuration's dense peak (bf16 989, TF32 495 TFLOP/s on an H100 SXM)."""

from portbench.common.readout import mfu as read  # noqa: F401
