"""Tracing, timing and FLOP counting (counterpart of
:mod:`ich_tpu.utils.profiling`): a ``torch.profiler`` trace context, the
device time of a callable, the FLOPs of one call, and the dense peaks of
NVIDIA cards for a roofline or MFU denominator.

Work on a card is timed with CUDA events, since PyTorch returns before the
device finishes; work on the CPU with ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a card is present), written as a Chrome trace to
    ``<log_dir>/trace.json``; yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(x) -> Optional[torch.Tensor]:
    return next((leaf for leaf in tree_leaves(x) if isinstance(leaf, torch.Tensor)), None)


def sync(x) -> float:
    """Wait for the card that holds the first tensor of ``x`` (a tensor or
    a pytree of them) and return its first element as a float."""
    leaf = _first_tensor(x)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0])


# Dense peaks without sparsity at the board's full power limit, from
# NVIDIA's H100 Tensor Core GPU data sheet: TFLOP/s in bf16 (and fp16),
# TF32 and float32 outside the tensor cores, and device memory TB/s. The
# SXM5 part at 700 W (torch names it "NVIDIA H100 80GB HBM3"); the PCIe
# part at 350 W (half the data sheet's rates with sparsity).
PEAKS = (
    ("h100 pcie", {"bf16": 756.5, "tf32": 378.0, "fp32": 51.0, "hbm_tbs": 2.0}),
    ("h100 80gb hbm3", {"bf16": 989.0, "tf32": 495.0, "fp32": 67.0, "hbm_tbs": 3.35}),
)
PEAK_TFLOPS = [(key, peaks["bf16"]) for key, peaks in PEAKS]


def _peaks(device_name: str) -> Optional[dict]:
    name = device_name.lower()
    return next((peaks for key, peaks in PEAKS if key in name), None)


def peak_tflops(device_name: str, precision: str = "bf16") -> Optional[float]:
    """The dense peak TFLOP/s of the named card in ``precision`` ("bf16",
    "tf32" or "fp32"), or None for a card not in ``PEAKS``."""
    peaks = _peaks(device_name)
    return None if peaks is None else peaks[precision]


def peak_hbm_tbs(device_name: str) -> Optional[float]:
    """The device-memory rate of the named card in TB/s, or None."""
    peaks = _peaks(device_name)
    return None if peaks is None else peaks["hbm_tbs"]


def compiled_flops(fn: Callable, *args, **kwargs) -> float:
    """The FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over the operators it
    runs (the call runs, with its side effects; nothing is compiled: the
    name is the JAX package's, whose version reads XLA's cost analysis).
    A convolution counts every output position, padded border included."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _resolve(device, args) -> torch.device:
    if device is not None:
        return torch.device(device)
    leaf = _first_tensor(args)
    return leaf.device if leaf is not None else torch.device("cpu")


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2,
            device: str | torch.device | None = None) -> Dict[str, float]:
    """Mean seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls. ``device`` defaults to that of the first tensor in
    ``args`` (the CPU without one); on a card the calls are timed with
    CUDA events around the run, on the CPU with ``perf_counter``."""
    dev = _resolve(device, args)
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "per_sec": 1.0 / dt}
