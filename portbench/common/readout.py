"""What a per-layer metric's reader gets, and how readers are found: the
reader of metric ``<name>`` is ``metrics/<name>.py``, whose ``read(r)``
returns the metric's value or None where it finds nothing to read."""

from __future__ import annotations

import dataclasses
import importlib.util
from typing import Callable, Dict, Optional

from portbench.common.manifest import PKG
from portbench.common.trace import TraceSummary

NET_RANGE = "portbench.net"  # the benchmark's own span around the net's calls


@dataclasses.dataclass
class Readout:
    trace: TraceSummary
    units: int  # volumes or train steps completed in the traced window
    window_s: float
    peak: dict  # the card's peaks (common/peaks.py)
    precision: str  # the configuration's: "bf16" or "tf32"
    work: Dict[str, float]  # per unit: "flops", "dropout_bytes", ...

    def per_unit_ms(self, device_s: float) -> Optional[float]:
        return 1e3 * device_s / self.units if self.units and device_s > 0 else None


def reader(name: str) -> Callable[[Readout], Optional[float]]:
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def mfu(r: Readout) -> Optional[float]:
    """Per cent of the configuration's dense peak that the counted work
    over the traced window reaches."""
    flops = r.work.get("flops")
    if not flops or not r.units or r.window_s <= 0 or r.precision not in r.peak:
        return None
    return 100.0 * flops * r.units / r.window_s / (r.peak[r.precision] * 1e12)


def idle_pct(r: Readout) -> Optional[float]:
    """Per cent of the traced window in which no operation ran on the
    device."""
    busy = r.trace.busy_s()
    return None if busy <= 0 else 100.0 * (1.0 - busy / r.window_s)
