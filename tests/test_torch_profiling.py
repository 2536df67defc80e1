"""The port's profiling helpers (``ich_tpu_torch.utils.profiling``) on the
CPU, against the JAX package's ``ich_tpu.utils.profiling`` where both
compute the same thing. Their CUDA paths are tested in
``tests/test_torch_cuda.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ich_tpu.utils import profiling as jax_prof
from ich_tpu_torch.utils import profiling as prof

CONV_SHAPE, CONV_OUT = (2, 8, 32, 32), 16  # (N, C, H, W) -> 16 channels, 3x3 SAME
CONV_FLOPS = 2 * 2 * 32 * 32 * CONV_OUT * 8 * 9  # 2·N·H·W·Cout·Cin·9


def test_peak_tflops_by_card_name():
    assert prof.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert prof.peak_tflops("NVIDIA H100 80GB HBM3", "tf32") == 495.0
    assert prof.peak_tflops("NVIDIA H100 80GB HBM3", "fp32") == 67.0
    assert prof.peak_hbm_tbs("NVIDIA H100 80GB HBM3") == 3.35
    assert prof.peak_tflops("NVIDIA H100 PCIe") == 756.5
    assert ("h100 80gb hbm3", 989.0) in prof.PEAK_TFLOPS
    for unknown in ("NVIDIA GeForce RTX 4090", "TPU v5 lite", "cpu"):
        assert prof.peak_tflops(unknown) is None and prof.peak_hbm_tbs(unknown) is None


def _conv_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(CONV_SHAPE).astype(np.float32)
    w = rng.standard_normal((CONV_OUT, CONV_SHAPE[1], 3, 3)).astype(np.float32)
    return x, w


def test_compiled_flops_of_a_conv_is_exact():
    x, w = _conv_inputs()
    flops = prof.compiled_flops(F.conv2d, torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert flops == CONV_FLOPS == 4_718_592


def test_compiled_flops_against_xla_cost_analysis():
    """XLA's count of the same SAME conv leaves out the products with the
    zero padding at the border (4,524,032 on the CPU); FlopCounterMode
    counts every output position as 9·Cin products. So JAX's count is
    below the port's, by the border's share (4.1% at 32x32)."""
    x, w = _conv_inputs()
    conv = jax.jit(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW")))
    ref = jax_prof.compiled_flops(conv, jnp.asarray(x), jnp.asarray(w))
    port = prof.compiled_flops(F.conv2d, torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert ref == 4_524_032
    assert 0.95 * port <= ref < port


def test_time_fn_and_sync_on_the_cpu():
    x = torch.arange(16.0).reshape(4, 4)
    out = prof.time_fn(torch.matmul, x, x, iters=3, warmup=1)
    assert out["mean_s"] > 0 and out["per_sec"] == pytest.approx(1.0 / out["mean_s"])
    assert prof.time_fn(lambda: None, iters=2)["mean_s"] > 0  # no tensor: the CPU clock
    assert prof.sync({"a": x + 1, "b": [x]}) == 1.0
    assert prof.sync(x[1:]) == 4.0


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with prof.device_trace(str(tmp_path / "trace")) as p:
        (x @ x).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in p.key_averages())
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
