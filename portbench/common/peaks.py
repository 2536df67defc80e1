"""Dense peaks of NVIDIA cards without sparsity at the board's full power
limit, from NVIDIA's H100 Tensor Core GPU data sheet: TFLOP/s in bf16,
TF32 and float32 outside the tensor cores, and device memory TB/s. A
copy of ``ich_tpu_torch/utils/profiling.py``'s ``PEAKS``, kept here so
that the yardstick does not move with the program."""

from __future__ import annotations

from typing import Optional

PEAKS = (
    ("h100 pcie", {"bf16": 756.5, "tf32": 378.0, "fp32": 51.0, "hbm_tbs": 2.0}),
    ("h100 80gb hbm3", {"bf16": 989.0, "tf32": 495.0, "fp32": 67.0, "hbm_tbs": 3.35}),
)


def peaks(device_name: str) -> Optional[dict]:
    """The named card's peaks, or None for a card not listed."""
    name = device_name.lower()
    return next((p for key, p in PEAKS if key in name), None)
