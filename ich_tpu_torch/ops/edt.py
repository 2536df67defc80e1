"""The separable min-plus EDT pass: CUDA kernel wrapper and plain version.

Counterpart of :mod:`ich_tpu.ops.pallas_edt`. One pass computes
``out[r, x] = min_j g[r, j] + (x - j)^2`` over the last axis; two passes
(W, then H) and a square root give the exact euclidean distance transform.

:func:`edt_pass_1d` launches ``csrc/edt_minplus.cu`` for a CUDA tensor and
runs :func:`edt_pass_1d_plain` for a CPU tensor; there is no other route. On
CUDA a failed build or launch raises.
"""

from __future__ import annotations

import torch

INF = 1e10  # site cost of a non-site pixel; distances saturate at sqrt(INF)

# Number of times edt_pass_1d launched the CUDA kernel in this process.
launches = 0

_PLAIN_CHUNK = 1 << 24  # elements of the (rows, n, n) broadcast per chunk


def edt_pass_1d_plain(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pass: the broadcast min of ``ich_tpu.ops.distance``
    (``_edt_1d_sq``), over row chunks so the (rows, n, n) intermediate stays
    bounded. Exact: every ``(x - j)^2`` is an integer below 2^24."""
    n = g.shape[-1]
    x = torch.arange(n, dtype=torch.float32, device=g.device)
    d2 = (x[:, None] - x[None, :]) ** 2  # d2[x, j]
    step = max(1, _PLAIN_CHUNK // max(1, n * n))
    outs = [
        torch.amin(gc[:, None, :] + d2, dim=-1) for gc in g.split(step, dim=0)
    ]
    return torch.cat(outs, dim=0) if outs else g.clone()


def edt_pass_1d(g: torch.Tensor) -> torch.Tensor:
    """One squared-EDT pass along the last axis of a ``(R, N)`` float32
    tensor: ``min_j g[r, j] + (x - j)^2``.

    A CPU tensor runs :func:`edt_pass_1d_plain`. A CUDA tensor launches the
    kernel on the current stream (no synchronisation) or raises."""
    if g.dim() != 2 or g.dtype != torch.float32:
        raise ValueError(f"edt_pass_1d wants (R, N) float32; got "
                         f"{tuple(g.shape)} {g.dtype}")
    if g.device.type == "cpu":
        return edt_pass_1d_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"edt_pass_1d: unsupported device {g.device}")
    if not g.is_contiguous():
        raise ValueError("edt_pass_1d wants a contiguous tensor")
    from ich_tpu_torch.kernels._build import load_library

    lib = load_library()
    rows, n = g.shape
    if n > lib.edt_minplus_max_n():
        raise ValueError(f"edt_pass_1d: N={n} > {lib.edt_minplus_max_n()}")
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.edt_minplus_pass(g.data_ptr(), out.data_ptr(), rows, n, stream)
    if err != 0:
        raise RuntimeError(f"edt_minplus_pass launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def distance_transform_edt_kernel(mask: torch.Tensor) -> torch.Tensor:
    """Distance from each pixel to the nearest ``mask == 0`` pixel of its
    ``(H, W)`` image, for a ``(..., H, W)`` mask (``pallas_edt.py:70-93``):
    one pass along W over all ``B*H`` rows, a transpose, one pass along H,
    then ``sqrt(min(., INF))``."""
    m = mask.to(torch.float32)
    g = torch.where(m > 0, INF, 0.0).to(torch.float32)
    lead, (h, w) = g.shape[:-2], g.shape[-2:]
    flat = g.reshape(-1, h, w)
    b = flat.shape[0]
    d2 = edt_pass_1d(flat.reshape(b * h, w)).reshape(b, h, w)
    d2 = d2.transpose(1, 2).contiguous().reshape(b * w, h)
    d2 = edt_pass_1d(d2).reshape(b, w, h).transpose(1, 2)
    return torch.sqrt(torch.clamp(d2, max=INF)).reshape(*lead, h, w)
