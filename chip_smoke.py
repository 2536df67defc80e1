"""On-card smoke test of the PyTorch port (``ich_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero before
its last line:

1. device: a CUDA card is required (no fallback to the CPU); prints its
   name and ``nvidia-smi``'s name and power limit;
2. build: compiles ``ich_tpu_torch/csrc/*.cu`` into ``build/ich_tpu_torch/``;
3. EDT kernel against its plain PyTorch version on the card, at the GAN
   config's 16x256x256 and at 4x512x512: squared passes bit-equal,
   distances within 1e-6, one 512^2 image against scipy within 1e-3, and
   ``discounted_l1_loss`` on the card against the CPU within rtol 1e-5;
4. main path: the full-width 2.5D net (UNet depth 5, top_filter 32,
   BatchNorm, midchannels_factor 2, float32) with seeded random weights
   serves three 512x512x40 head-CT NIfTIs through ``ich_tpu_torch.serve``,
   and the EDT leg runs ``discounted_l1_loss`` at the GAN shape; one volume
   is segmented again on the CPU and at least 99.99% of voxels must agree;
5. 3D path: the bench's net (3D UNet depth 4, top_filter 16, GroupNorm,
   midchannels_factor 2, bf16) with seeded random weights serves three
   512x512x64 head-CT NIfTIs through ``ich_tpu_torch.serve --mode 3d`` (64^3
   patches at overlap 0.5, 128 patches per call: the 64x512x512 volume of
   ``bench.py``); an identity network blends a 64x512x512 volume back to
   itself on the card and on the CPU (within 1e-4 of the input, 1e-6 of
   each other); a 64x128x128 crop in float32 (TF32 off) agrees with the CPU
   on at least 99.99% of voxels and within 1e-4 in probability; bf16 is
   held against float32 on the card; then warm latency, pipelined seconds
   per volume, peak device memory, FLOP rate and a profiler breakdown.

Each path is driven with the kernel launch counts set to 0 just before and
read just after. The line before the last is a JSON object with each
kernel's launches on the path that runs it (the 2.5D serve's EDT leg), its
error against the plain version and both times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np
import scipy.ndimage as ndi
import torch
from torch.utils.flop_counter import FlopCounterMode

from ich_tpu_torch import serve
from ich_tpu_torch.data import nifti
from ich_tpu_torch.kernels import _build
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import ct, edt
from ich_tpu_torch.ops import sliding_window as sw
from ich_tpu_torch.ops.losses import discounted_l1_loss
from ich_tpu_torch.ops.metrics import batch_binary_confusion_matrix, dice_from_counts
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.train.segmentation3d import UNet3D

SEED = 0
GAN_SHAPE = (16, 256, 256)  # configs/inpainting_gan.json: batch 16, size 256
BIG_SHAPE = (4, 512, 512)
VOL_SHAPE = (512, 512, 40)  # (H, W, Z) HU volume, as a head CT is stored
N_VOLS = 3
WINDOW = (50.0, 200.0)  # serve defaults --win-center / --win-width
NET = dict(depth=5, top_filter=32, midchannels_factor=2, norm="batch", p_dropout=0.0)
MIN_AGREEMENT = 0.9999
# bench.py:62-65 and scripts/serve.py:107-110; configs/unet3d_throughput.json
VOL3D_SHAPE = (512, 512, 64)  # (H, W, Z); transposed, bench.py's 64x512x512
NET3D = dict(depth=4, ndim=3, top_filter=16, midchannels_factor=2, norm="group",
             p_dropout=0.0)
PATCH3D = 64
CROP3D = (slice(0, 64), slice(192, 320), slice(192, 320))  # 9 patches of 64^3
H100_BF16_TFLOPS = 989.0  # dense, SXM, at 700 W (NVIDIA's data sheet)
DEV = "cuda"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, *args, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn(*args)`` over ``iters`` launches
    (CUDA events, after a warm-up)."""
    for _ in range(3):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- synthetic inputs ----------------------------------------------------------

def stroke_masks(rng: np.random.Generator, b: int, h: int, w: int) -> np.ndarray:
    """(b, h, w) float32 free-form brush-stroke masks, 1 inside a stroke, with
    the GAN config's mask ranges (configs/inpainting_gan.json "mask"):
    1-4 strokes of 5-15 vertices, segments 10-40 px, brush 10-25 px."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for _ in range(rng.integers(1, 5)):
            p = rng.uniform((0, 0), (h, w))
            radius = rng.uniform(10, 25) / 2
            for _ in range(rng.integers(5, 16)):
                ang = rng.uniform(0, 2 * np.pi)
                q = np.clip(p + rng.uniform(10, 40) * np.array([np.sin(ang), np.cos(ang)]),
                            0, (h - 1, w - 1))
                d = q - p
                t = np.clip(((yy - p[0]) * d[0] + (xx - p[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
                dist2 = (yy - p[0] - t * d[0]) ** 2 + (xx - p[1] - t * d[1]) ** 2
                out[i][dist2 <= radius**2] = 1.0
                p = q
    return out


def head_ct(rng: np.random.Generator, shape=VOL_SHAPE) -> np.ndarray:
    """(H, W, Z) float32 HU volume: air, an elliptic skull, brain with
    noise, and a few hyperdense bleeds."""
    h, w, z = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = ((yy - h / 2) / (0.42 * h)) ** 2 + ((xx - w / 2) / (0.36 * w)) ** 2
    vol = np.full(shape, -1000.0, np.float32)
    vol[r <= 1.0] = 1000.0  # skull
    brain = r <= 0.85
    vol[brain] = 35.0
    vol += rng.normal(0, 8, shape).astype(np.float32) * brain[..., None]
    zz = np.arange(z, dtype=np.float32)
    for _ in range(rng.integers(2, 5)):
        cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.35, 0.65) * w
        cz, rad = rng.uniform(0.3, 0.7) * z, rng.uniform(0.03, 0.08) * h
        blob = (((yy - cy) ** 2 + (xx - cx) ** 2)[..., None] / rad**2
                + ((zz - cz) / (z / 6)) ** 2) <= 1.0
        vol[blob & brain[..., None]] = rng.uniform(60, 85)
    return vol


def init_net(net: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: He-normal convs, zero conv biases, and
    BatchNorm / GroupNorm affine and BatchNorm running statistics away from
    their defaults."""
    convs = (torch.nn.Conv2d, torch.nn.Conv3d)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, convs + (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)):
                # a k2 s2 transposed conv feeds each output from in_channels taps
                fan_in = m.weight[0].numel() if isinstance(m, convs) else m.weight.shape[0]
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                m.bias.zero_()
            elif isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                    m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)


# -- phases ---------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s))")
    print(smi)
    return kind


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    print(open(f"{lib_path}.log").read().strip())


def phase_edt(rng: np.random.Generator) -> dict:
    dev = torch.device(DEV)
    launches0 = edt.launches
    max_err = 0.0
    dists = {}
    for shape in (GAN_SHAPE, BIG_SHAPE):
        b, h, w = shape
        masks = stroke_masks(rng, b, h, w)
        masks[0] = 1.0  # no site: distances saturate at sqrt(1e10)
        masks[1] = 0.0  # all sites: distances are 0
        m = torch.from_numpy(masks).to(dev)
        g = torch.where(m > 0, edt.INF, 0.0).reshape(b * h, w)
        k1, p1 = edt.edt_pass_1d(g), edt.edt_pass_1d_plain(g)
        gt = k1.reshape(b, h, w).transpose(1, 2).contiguous().reshape(b * w, h)
        k2, p2 = edt.edt_pass_1d(gt), edt.edt_pass_1d_plain(gt)
        torch.cuda.synchronize()
        check(torch.equal(k1, p1) and torch.equal(k2, p2),
              f"EDT squared passes differ from the plain version at {shape}")
        max_err = max(max_err, float((k1 - p1).abs().max()), float((k2 - p2).abs().max()))
        d = edt.distance_transform_edt_kernel(m)
        d_plain = torch.sqrt(torch.clamp(p2.reshape(b, w, h).transpose(1, 2), max=edt.INF))
        err = float((d - d_plain).abs().max())
        check(err <= 1e-6, f"EDT distances differ by {err} at {shape}")
        check(bool((d[0] == 1e5).all()) and bool((d[1] == 0).all()),
              "all-ones mask must saturate at 1e5 and all-zeros give 0")
        print(f"edt {shape}: passes torch.equal to plain, distance max err {err}")
        dists[shape] = (masks, d)
    masks, d = dists[BIG_SHAPE]
    err = float(np.abs(d[2].cpu().numpy() - ndi.distance_transform_edt(masks[2])).max())
    check(err <= 1e-3, f"EDT differs from scipy by {err} at 512^2")
    print(f"edt 512^2 vs scipy.ndimage.distance_transform_edt: max err {err}")

    b, h, w = GAN_SHAPE
    rec = rng.uniform(size=(b, h, w, 1)).astype(np.float32)
    im = rng.uniform(size=(b, h, w, 1)).astype(np.float32)
    mask = stroke_masks(rng, b, h, w)[..., None]
    args = [torch.from_numpy(a) for a in (rec, im, mask)]
    on_card = float(discounted_l1_loss(*[a.to(dev) for a in args]))
    on_cpu = float(discounted_l1_loss(*args))
    check(abs(on_card - on_cpu) <= 1e-5 * abs(on_cpu),
          f"discounted_l1_loss card {on_card} vs cpu {on_cpu}")
    print(f"discounted_l1_loss {GAN_SHAPE}: card {on_card!r} cpu {on_cpu!r}")
    check(edt.launches > launches0, "EDT launch counter did not move")

    g = torch.where(torch.from_numpy(dists[GAN_SHAPE][0]).to(dev) > 0, edt.INF, 0.0)
    g = g.reshape(b * h, w)
    ms = [cuda_ms(f, g) for f in (edt.edt_pass_1d, edt.edt_pass_1d_plain,
                                   edt.edt_pass_1d_plain, edt.edt_pass_1d)]
    kernel_ms, plain_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    print(f"edt pass ({b * h}, {w}): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}


def _calibrate_final_bias(net: torch.nn.Module, vol: np.ndarray) -> None:
    """Shift the final bias so that about a tenth of the middle slices'
    pixels score >= 0.5: random weights otherwise give an all-0 or all-1
    mask, whose Dice says nothing."""
    z = vol.shape[2]
    x = torch.from_numpy(vol[:, :, z // 2 - 8: z // 2 + 8]).to(DEV)
    x = ct.resize(ct.window_ct(torch.rot90(x, 1, dims=(0, 1)), *WINDOW), (256, 256, 16), order=1)
    net.use_final_activation = False
    with torch.inference_mode():
        logits = net(x.permute(2, 0, 1).unsqueeze(1).contiguous())
    net.use_final_activation = True
    q = float(torch.quantile(logits.flatten()[::7], 0.9))
    with torch.no_grad():
        net.final_conv.bias -= q


def phase_main(rng: np.random.Generator, work: str) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    watch, out = os.path.join(work, "watch"), os.path.join(work, "out")
    os.makedirs(watch)
    vols = []
    for i in range(N_VOLS):
        vols.append(head_ct(rng))
        nifti.save(os.path.join(watch, f"ct{i}.nii.gz"), vols[-1])

    net = UNet(**NET)
    init_net(net, torch.Generator().manual_seed(SEED))
    trainer = UNet2D(net, device=DEV)
    _calibrate_final_bias(trainer.unet, vols[0])
    model_fn = os.path.join(work, "model.pt")
    trainer.save_model(model_fn)

    edt.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.main(["--watch-dir", watch, "--output-dir", out, "--model", model_fn,
                "--size", "256", "--win-center", str(WINDOW[0]),
                "--win-width", str(WINDOW[1]), "--device", DEV, "--once"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    b, h, w = GAN_SHAPE
    rec, im = (torch.from_numpy(rng.uniform(size=(b, h, w, 1)).astype(np.float32)).to(DEV)
               for _ in range(2))
    mask = torch.from_numpy(stroke_masks(rng, b, h, w)[..., None]).to(DEV)
    loss = float(discounted_l1_loss(rec, im, mask))
    launches = edt.launches

    check(np.isfinite(loss), f"discounted_l1_loss not finite: {loss}")
    masks = []
    for i in range(N_VOLS):
        mask_fn = os.path.join(out, f"ct{i}_mask.nii.gz")
        check(os.path.exists(mask_fn) and os.path.exists(os.path.join(out, f"ct{i}.done")),
              f"ct{i}: mask or .done marker missing")
        m, _, _ = nifti.load(mask_fn)
        check(m.shape == VOL_SHAPE and m.dtype == np.uint8 and set(np.unique(m)) <= {0, 255},
              f"ct{i}: mask {m.shape} {m.dtype} {np.unique(m)[:4]}")
        masks.append(m)
    positive = float(np.mean(masks[0] == 255))
    check(0.0 < positive < 1.0, f"degenerate mask: positive share {positive}")

    # where a served volume's time goes: file decode, device path, file encode
    t0 = time.perf_counter()
    nifti.load(os.path.join(watch, "ct0.nii.gz"))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nifti.save(os.path.join(work, "mask.nii.gz"), masks[0])
    encode_s = time.perf_counter() - t0
    segvol_s = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        # warm-up: cuDNN picks its algorithms anew for each math mode
        trainer.segment_volume(vols[0], window=WINDOW, input_size=(256, 256))
        t0 = time.perf_counter()
        trainer.segment_volumes(iter(vols), window=WINDOW, input_size=(256, 256))
        torch.cuda.synchronize()
        segvol_s[tf32] = (time.perf_counter() - t0) / N_VOLS
    torch.backends.cudnn.allow_tf32 = False

    cpu = UNet2D(UNet(**NET), device="cpu")
    cpu.load_model(model_fn)
    ref = cpu.segment_volume(vols[0], window=WINDOW, input_size=(256, 256), return_pred=True)
    agree = float(np.mean(ref == masks[0]))
    tn, fp, fn, tp = batch_binary_confusion_matrix(
        torch.from_numpy(masks[0][None] > 0), torch.from_numpy(ref[None] > 0))
    dice = float(dice_from_counts(tp, fp, fn)[0])
    print(f"serve: {N_VOLS} volumes {VOL_SHAPE} in {serve_s!r} s = "
          f"{serve_s / N_VOLS!r} s/volume (first call: decode + segment + encode, "
          f"cuDNN TF32 off)")
    print(f"per volume: decode {decode_s!r} s, encode {encode_s!r} s; segment_volumes "
          f"without file I/O {segvol_s[False]!r} s (TF32 off), {segvol_s[True]!r} s "
          f"(cuDNN TF32 on, torch's default)")
    print(f"card vs cpu mask: agreement {agree:.6f}, dice {dice:.6f}, "
          f"positive share {positive:.4f}; discounted_l1_loss {loss!r}; "
          f"EDT launches on the main path {launches}")
    check(agree >= MIN_AGREEMENT, f"card/cpu voxel agreement {agree} < {MIN_AGREEMENT}")
    check(launches > 0, "the main path launched no EDT kernel")
    return {"launches": launches}


def _calibrate_final_bias_3d(net: torch.nn.Module, vol_dhw: np.ndarray) -> None:
    """The 3D net's counterpart of ``_calibrate_final_bias``: about a tenth
    of the voxels of four central 64^3 patches score >= 0.5."""
    p = PATCH3D
    d, h, w = vol_dhw.shape
    x = torch.from_numpy(vol_dhw[:p, h // 2 - p: h // 2 + p, w // 2 - p: w // 2 + p].copy())
    x = ct.window_ct(x.to(DEV), *WINDOW)
    x = x.reshape(p, 2, p, 2, p).permute(1, 3, 0, 2, 4).reshape(4, 1, p, p, p)
    net.use_final_activation = False
    with torch.inference_mode():
        logits = net(x)
    net.use_final_activation = True
    q = float(torch.quantile(logits.float().flatten()[::7], 0.9))
    with torch.no_grad():
        net.final_conv.bias -= q


def _probs(trainer: UNet3D, vol_dhw: np.ndarray) -> torch.Tensor:
    """Windowed sliding-window probabilities of a (D, H, W) HU volume, on
    the trainer's device."""
    x = ct.window_ct(torch.from_numpy(vol_dhw).to(trainer.device), *WINDOW)
    with torch.inference_mode():
        return sw.sliding_window_inference(trainer.unet, x, patch_size=trainer.patch_size,
                                           overlap=trainer.sw_overlap)[..., 0]


def _agreement(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Share of equal voxels and Dice of two boolean masks."""
    a, b = a.flatten().cpu(), b.flatten().cpu()
    agree = float((a == b).float().mean())
    tn, fp, fn, tp = batch_binary_confusion_matrix(a[None], b[None])
    return agree, float(dice_from_counts(tp, fp, fn)[0])


class _Annotated(torch.nn.Module):
    """The net inside a profiler range, so its device time can be told from
    the blend's."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.profiler.record_function("unet3d"):
            return self.net(x)


# aten ops by what they do in the 3D path, matched on the op's name
OP_GROUPS = (("conv", ("conv",)), ("group_norm", ("group_norm",)),
             ("relu", ("relu", "threshold", "clamp_min")), ("max_pool", ("max_pool",)),
             ("cat", ("aten::cat",)), ("copy", ("copy_", "to_copy")))


def _profile_summary(prof, wall_ms: float) -> str:
    """Device time of one profiled volume: busy share, the net's share and
    its op groups, the rest (blend, window, threshold, copies), and the top
    kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    ev = prof.key_averages()
    # the range's own device-side annotation is a span, not a kernel
    kernels = [e for e in ev if e.device_type == cuda and e.key != "unet3d"]
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        return "profile: no device time recorded"
    net_us = sum(e.device_time_total for e in ev if e.key == "unet3d" and e.device_type != cuda)
    groups = defaultdict(float)
    for e in ev:
        if e.device_type == cuda or e.key == "unet3d" or e.self_device_time_total <= 0:
            continue
        name = next((g for g, keys in OP_GROUPS if any(k in e.key for k in keys)), e.key)
        groups[name] += e.self_device_time_total
    ops = ", ".join(f"{k} {100 * v / total:.1f}%"
                    for k, v in sorted(groups.items(), key=lambda kv: -kv[1])[:10])
    top = ", ".join(f"{e.key[:70]} {100 * e.self_device_time_total / total:.1f}%"
                    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8])
    return (f"profile (bf16, one warm segment_volume): wall {wall_ms:.1f} ms, device "
            f"time {total / 1e3:.1f} ms (busy {100 * total / 1e3 / wall_ms:.1f}%), the net "
            f"{100 * net_us / total:.1f}% of it and the blend, window, threshold and copies "
            f"{100 * (total - net_us) / total:.1f}%\nprofile ops by device time: {ops}\n"
            f"profile top kernels: {top}")


def phase_3d(rng: np.random.Generator, work: str) -> None:
    watch, out = os.path.join(work, "watch"), os.path.join(work, "out")
    os.makedirs(watch)
    vols = []  # (D, H, W), as the 3D path takes them
    for i in range(N_VOLS):
        vol = head_ct(rng, VOL3D_SHAPE)
        nifti.save(os.path.join(watch, f"ct{i}.nii.gz"), vol)
        vols.append(np.ascontiguousarray(np.transpose(vol, (2, 0, 1))))
    patch = (PATCH3D,) * 3

    net = UNet(**NET3D, dtype=torch.bfloat16)
    init_net(net, torch.Generator().manual_seed(SEED + 1))
    trainer = UNet3D(net, patch_size=patch, device=DEV)
    _calibrate_final_bias_3d(trainer.unet, vols[0])
    model_fn = os.path.join(work, "model3d.pt")
    trainer.save_model(model_fn)

    # the path: serve --mode 3d, counts at 0 just before and read just after
    edt.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.main(["--watch-dir", watch, "--output-dir", out, "--model", model_fn,
                "--mode", "3d", "--depth", str(NET3D["depth"]),
                "--top-filter", str(NET3D["top_filter"]), "--patch", str(PATCH3D),
                "--win-center", str(WINDOW[0]), "--win-width", str(WINDOW[1]),
                "--device", DEV, "--once"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"edt_minplus_pass": edt.launches}

    masks = []
    for i in range(N_VOLS):
        mask_fn = os.path.join(out, f"ct{i}_mask.nii.gz")
        check(os.path.exists(mask_fn) and os.path.exists(os.path.join(out, f"ct{i}.done")),
              f"3d ct{i}: mask or .done marker missing")
        m, _, _ = nifti.load(mask_fn)
        check(m.shape == VOL3D_SHAPE and m.dtype == np.uint8 and set(np.unique(m)) <= {0, 255},
              f"3d ct{i}: mask {m.shape} {m.dtype} {np.unique(m)[:4]}")
        masks.append(m)
    positive = float(np.mean(masks[0] == 255))
    check(0.0 < positive < 1.0, f"3d: degenerate mask: positive share {positive}")
    served = float(np.mean(np.transpose(masks[0], (2, 0, 1))
                           == trainer.segment_volume(vols[0], window=WINDOW)))
    check(served >= MIN_AGREEMENT, f"3d: served mask vs UNet3D.segment_volume {served}")
    t0 = time.perf_counter()
    nifti.load(os.path.join(watch, "ct0.nii.gz"))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nifti.save(os.path.join(work, "mask3d.nii.gz"), masks[0])
    encode_s = time.perf_counter() - t0
    print(f"serve --mode 3d: {N_VOLS} volumes {VOL3D_SHAPE} in {serve_s!r} s = "
          f"{serve_s / N_VOLS!r} s/volume (first call); per volume: decode {decode_s!r} s, "
          f"encode {encode_s!r} s; positive share {positive:.4f}; agreement with "
          f"UNet3D.segment_volume {served:.6f}; port kernel launches on the 3D path "
          f"{launches}")

    # blend geometry at full size: an identity network, card and CPU
    x = torch.from_numpy(rng.uniform(size=vols[0].shape).astype(np.float32))
    on_card = sw.sliding_window_inference(lambda p: p, x.to(DEV), patch_size=patch,
                                          overlap=0.5)[..., 0].cpu()
    on_cpu = sw.sliding_window_inference(lambda p: p, x, patch_size=patch, overlap=0.5)[..., 0]
    err_cc, err_id = float((on_card - on_cpu).abs().max()), float((on_card - x).abs().max())
    print(f"blend identity {tuple(x.shape)}: card vs cpu max err {err_cc!r}, "
          f"vs input {err_id!r}")
    check(err_cc <= 1e-6 and err_id <= 1e-4, "3d: identity blend is off")
    del x, on_card, on_cpu

    # float32 card vs CPU on a crop (the whole volume is too slow on the CPU)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {}
    for dev in (DEV, "cpu"):
        f32[dev] = UNet3D(UNet(**NET3D), patch_size=patch, device=dev)
        f32[dev].unet.load_state_dict(trainer.get_state_dict())
    crop = np.ascontiguousarray(vols[0][CROP3D])
    p_card, p_cpu = _probs(f32[DEV], crop).cpu(), _probs(f32["cpu"], crop)
    err = float((p_card - p_cpu).abs().max())
    agree, dice = _agreement(p_card >= 0.5, p_cpu >= 0.5)
    print(f"3d float32 crop {crop.shape} card (TF32 off) vs cpu: probability max err "
          f"{err!r}, mask agreement {agree:.6f}, dice {dice:.6f}")
    check(err <= 1e-4 and agree >= MIN_AGREEMENT, "3d: float32 card and cpu disagree")

    # bf16 against float32, on the card, whole volume
    p_bf16, p_f32 = _probs(trainer, vols[0]), _probs(f32[DEV], vols[0])
    agree, dice = _agreement(p_bf16 >= 0.5, p_f32 >= 0.5)
    print(f"3d bf16 vs float32 (TF32 off) on the card {vols[0].shape}: probability max diff "
          f"{float((p_bf16 - p_f32).abs().max())!r}, mask agreement {agree:.6f}, dice {dice:.6f}")
    del f32, p_bf16, p_f32
    torch.backends.cudnn.allow_tf32 = True  # torch's default, the serve's setting
    torch.backends.cuda.matmul.allow_tf32 = False

    # warm times in bf16 (one warm-up call first)
    trainer.segment_volume(vols[0], window=WINDOW)
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for v in vols:
        t0 = time.perf_counter()
        trainer.segment_volume(v, window=WINDOW)
        lat.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    trainer.segment_volumes(iter(vols), window=WINDOW)
    torch.cuda.synchronize()
    pipe_s = (time.perf_counter() - t0) / N_VOLS
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    n_patches = len(sw.make_patch_coords(vols[0].shape, patch, 0.5))
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        trainer.unet(torch.zeros((1, 1) + patch, device=DEV))
    flops = fc.get_total_flops() * n_patches
    tflops = flops / min(lat) / 1e12
    print(f"3d bf16 warm: segment_volume latency {lat!r} s; segment_volumes pipelined "
          f"{pipe_s!r} s/volume; peak device memory {peak_gb:.2f} GiB "
          f"(max_memory_allocated); network {flops / 1e12:.2f} TFLOP per volume "
          f"({n_patches} patches) = {tflops:.1f} TFLOP/s at the best latency, "
          f"{100 * tflops / H100_BF16_TFLOPS:.2f}% of the dense bf16 peak; "
          f"nvidia-smi after: {smi}")

    trainer.unet = _Annotated(trainer.unet)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.segment_volume(vols[1], window=WINDOW)
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(_profile_summary(prof, wall_ms))


def main() -> None:
    kind = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    edt_row = phase_edt(rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        main_row = phase_main(rng, work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3d_") as work:
        phase_3d(rng, work)
    kernels = [{
        "name": "edt_minplus_pass", "route": "cuda",
        "source": "ich_tpu_torch/csrc/edt_minplus.cu",
        "replaces": "ich_tpu/ops/pallas_edt.py:27",
        "launches": main_row["launches"], **edt_row,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
