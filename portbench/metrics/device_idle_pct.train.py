"""Per cent of the traced window in which no operation ran on the device:
the window less the union of the device's activity."""

from portbench.common.readout import idle_pct as read  # noqa: F401
