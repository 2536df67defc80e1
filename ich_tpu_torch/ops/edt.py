"""The exact EDT: CUDA kernel wrappers and their plain versions.

Counterpart of :mod:`ich_tpu.ops.pallas_edt`. One pass computes
``out[r, x] = min_j g[r, j] + (x - j)^2`` over the last axis; two passes
(W, then H) and a square root give the exact euclidean distance transform.

Two kernels in ``csrc/edt.cu``:

- the lower-envelope pass (Kernel A): :func:`edt_pass_1d` launches it on the
  rows of a tensor, and :func:`distance_transform_edt_kernel` on the columns
  of its images for the H pass; ``launches`` counts both;
- the W pass from the mask (Kernel B's first launch), the nearest site
  along each row; ``mask_launches`` counts it.

A CPU tensor runs the plain version (:func:`edt_pass_1d_plain`,
:func:`distance_transform_edt_plain`); a CUDA tensor launches the kernels,
and a failed build or launch raises. There is no other route.
"""

from __future__ import annotations

import torch

INF = 1e10  # site cost of a non-site pixel; distances saturate at sqrt(INF)

# Launches of the lower-envelope kernel (rows and columns) in this process.
launches = 0
# Launches of the W-pass kernel of distance_transform_edt_kernel.
mask_launches = 0

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


def _cuda_lib(t: torch.Tensor, name: str, n: int):
    """The kernel library for a CUDA tensor whose lines have length ``n``;
    raises for any other device or a length above the kernels' limit."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    from ich_tpu_torch.kernels._build import load_library

    lib = load_library()
    if n > lib.edt_max_n():
        raise ValueError(f"{name}: N={n} > {lib.edt_max_n()}")
    return lib


def _check(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def edt_pass_1d(g: torch.Tensor) -> torch.Tensor:
    """One squared-EDT pass along the last axis of a ``(R, N)`` float32
    tensor: ``min_j g[r, j] + (x - j)^2``.

    A CPU tensor runs :func:`edt_pass_1d_plain`. A CUDA tensor launches the
    lower-envelope kernel on the current stream (no synchronisation) or
    raises. Bit-equal to the plain version where every cost is an integer in
    [0, 2^34] (the EDT's costs); within one float32 ulp for other costs."""
    if g.dim() != 2 or g.dtype != torch.float32:
        raise ValueError(f"edt_pass_1d wants (R, N) float32; got "
                         f"{tuple(g.shape)} {g.dtype}")
    if g.device.type == "cpu":
        return edt_pass_1d_plain(g)
    if not g.is_contiguous():
        raise ValueError("edt_pass_1d wants a contiguous tensor")
    rows, n = g.shape
    lib = _cuda_lib(g, "edt_pass_1d", n)
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        _check(lib.edt_envelope_rows(g.data_ptr(), out.data_ptr(), rows, n, stream),
               "edt_envelope_rows")
    global launches
    launches += 1
    return out


def distance_transform_edt_plain(mask: torch.Tensor) -> torch.Tensor:
    """The plain composition of ``distance_transform_edt_pallas``
    (``pallas_edt.py:70-93``): the costs, one pass along W over all ``B*H``
    rows, a transpose, one pass along H, then ``sqrt(min(., INF))``."""
    m = mask.to(torch.float32)
    g = torch.where(m > 0, INF, 0.0).to(torch.float32)
    lead, (h, w) = g.shape[:-2], g.shape[-2:]
    b = g.reshape(-1, h, w).shape[0]
    d2 = edt_pass_1d_plain(g.reshape(b * h, w)).reshape(b, h, w)
    d2 = d2.transpose(1, 2).contiguous().reshape(b * w, h)
    d2 = edt_pass_1d_plain(d2).reshape(b, w, h).transpose(1, 2)
    return torch.sqrt(torch.clamp(d2, max=INF)).reshape(*lead, h, w)


def distance_transform_edt_kernel(mask: torch.Tensor) -> torch.Tensor:
    """Distance from each pixel to the nearest ``mask == 0`` pixel (more
    exactly, the nearest pixel where not ``mask > 0``) of its ``(H, W)``
    image, for a ``(..., H, W)`` mask; float32.

    A CPU tensor runs :func:`distance_transform_edt_plain`. A CUDA tensor
    takes two launches on the current stream: the W pass from the mask into
    the output, then the lower-envelope pass down its columns in place, with
    the square root; bit-equal to the plain composition."""
    if mask.dim() < 2:
        raise ValueError(f"distance_transform_edt_kernel wants (..., H, W); got "
                         f"{tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return distance_transform_edt_plain(mask)
    lead, (h, w) = mask.shape[:-2], mask.shape[-2:]
    lib = _cuda_lib(mask, "distance_transform_edt_kernel", max(h, w))
    m = mask.to(torch.float32).contiguous()
    b = m.numel() // max(1, h * w)
    out = torch.empty_like(m)
    if out.numel() == 0:
        return out
    global launches, mask_launches
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        _check(lib.edt_mask_rows(m.data_ptr(), out.data_ptr(), b * h, w, stream),
               "edt_mask_rows")
        mask_launches += 1
        _check(lib.edt_envelope_cols_sqrt(out.data_ptr(), b, h, w, stream),
               "edt_envelope_cols_sqrt")
        launches += 1
    return out.reshape(*lead, h, w)
