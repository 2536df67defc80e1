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
   is segmented again on the CPU and at least 99.99% of voxels must agree.

The line before the last is a JSON object with each kernel's launches on the
main path, its error against the plain version and both times; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import scipy.ndimage as ndi
import torch

from ich_tpu_torch import serve
from ich_tpu_torch.data import nifti
from ich_tpu_torch.kernels import _build
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import ct, edt
from ich_tpu_torch.ops.losses import discounted_l1_loss
from ich_tpu_torch.ops.metrics import batch_binary_confusion_matrix, dice_from_counts
from ich_tpu_torch.train.segmentation2d import UNet2D

SEED = 0
GAN_SHAPE = (16, 256, 256)  # configs/inpainting_gan.json: batch 16, size 256
BIG_SHAPE = (4, 512, 512)
VOL_SHAPE = (512, 512, 40)  # (H, W, Z) HU volume, as a head CT is stored
N_VOLS = 3
WINDOW = (50.0, 200.0)  # serve defaults --win-center / --win-width
NET = dict(depth=5, top_filter=32, midchannels_factor=2, norm="batch", p_dropout=0.0)
MIN_AGREEMENT = 0.9999
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
    BatchNorm affine and running statistics away from their defaults."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                # a k2 s2 transposed conv feeds each output from in_channels taps
                fan_in = m.weight[0].numel() if isinstance(m, torch.nn.Conv2d) \
                    else m.weight.shape[0]
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                m.bias.zero_()
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
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


def main() -> None:
    kind = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    edt_row = phase_edt(rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        main_row = phase_main(rng, work)
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
