"""Probes of the keyed dropout on one card: a diagnostic record beside
``PERF.md`` §6, not a module of the port and not tested.

    python docs/torch_dropout/probes.py hostcost
        host microseconds a call of the keyed and the parent's dropout
        paths, forward and backward, and of setting a step's keys
    python docs/torch_dropout/probes.py step
        one warm ``train2d_bs16`` step (configs/unet2d.json, TF32 on) with
        the parent's dropout and with the kernel, in turns, under
        torch.profiler: wall, device time, busy share, top host ops and
        the dropout kernels' device time
    python docs/torch_dropout/probes.py launches
        each keyed dropout launch of one warm step: its tensor's shape and
        strides, and its device time
    python docs/torch_dropout/probes.py gc
        phase 16 (d)-(e) on a 3M-object Python heap, with the time spent
        in the cyclic GC, then after ``gc.freeze()``
    python docs/torch_dropout/probes.py times TREE LABEL
        warm step times (5 runs) of ``train2d_bs16`` and of the study's
        fine-tune step (d4 f16 mcf1, dropout 0.1, 64^2, batch 16) through
        TREE's own package and ``chip_smoke.py``; a parent against change
        comparison unpacks the parent with ``git archive`` and runs one
        process a tree in turns (P C C P P C C P)
    python docs/torch_dropout/probes.py split
        phase 16 (e)'s turns (10 pairs of 15 warm ``train2d_bs16`` steps,
        the parent's dropout against the kernel) with each turn's host
        time in the step calls, its device span between CUDA events, and
        its wall time, as medians a step; and the process's threads
    python docs/torch_dropout/probes.py build
        seconds to build ``csrc/*.cu`` from nothing, in turns (S P P S):
        one ``nvcc`` run over every source (S) and ``kernels/_build.
        compile_shared``'s one process a source, then a link (P)

Each needs a CUDA card and, but for ``build``, builds the kernels first
(``chip_smoke``'s phases 1-2). The parent's dropout is ``chip_smoke.ParentDropout`` with
``chip_smoke.parent_set_dropout`` swapped in.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _setup(tree: str = ROOT):
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    cs.phase_device()
    cs.phase_build()
    return cs


def _trainer(cs, work: str):
    """The ``train2d_bs16`` trainer, its state, batches and Dropout
    blocks, warm."""
    import torch
    from ich_tpu_torch.models.layers import Dropout

    cfg = cs.load_train_cfg(work)
    fold = cs.synthetic_ich_slices(n_slices=64, size=cfg["data"]["size"], n_volumes=4, seed=0)
    torch.backends.cudnn.allow_tf32 = True
    t = cs._trainer(cfg, cs.DEV, batch_size=16,
                    augment_fn=cs.build_pipeline(cfg["data"]["augmentation"]["train"]))
    state = t._train_state(4)
    batches = list(t._batches(fold.device_cache(cs.DEV), np.arange(64).reshape(4, 16)))
    t.unet.train()
    for i in range(5):
        t._train_step(state, batches[i % 4], cs.K(i))
    torch.cuda.synchronize()
    blocks = [b for b in (*t.unet.down_block, t.unet.bottleneck_block)
              if isinstance(b.dropout, Dropout)]
    return t, state, batches, blocks


def hostcost() -> None:
    cs = _setup()
    import torch
    from ich_tpu_torch.experiments.supervised2d import build_unet_from_cfg
    from ich_tpu_torch.kernels import _build
    from ich_tpu_torch.models.layers import set_dropout_keys
    from ich_tpu_torch.ops import dropout as D
    from ich_tpu_torch.utils import rng

    lib = _build.load_library()
    x = torch.randn(2, 8, 4, 4, device="cuda")
    g = torch.randn(2, 8, 4, 4, device="cuda")
    y = torch.empty_like(x)
    key = (0, 1, 12345)
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = (x.data_ptr(), y.data_ptr(), 0, 2, 8, 16, 128, 16, 1, *key, 0, 0.5, 0.5,
            torch.cuda.current_stream().cuda_stream)
    xg = x.clone().requires_grad_()
    net = build_unet_from_cfg({"depth": 5, "top_filter": 32, "p_dropout": 0.5}, device="cuda")
    k = rng.prng_key(3)

    def us(f, n=3000):
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    res = {
        "raw ctypes call": us(lambda: lib.keyed_dropout(*args)),
        "_launch": us(lambda: D._launch(x, key, 0.5, 0)),
        "keyed_dropout (no grad)": us(lambda: D.keyed_dropout(x, key, 0.5)),
        "parent forward (no grad)": us(
            lambda: x * torch.empty_like(x).bernoulli_(0.5, generator=gen).div_(0.5)),
        "F.dropout": us(lambda: torch.nn.functional.dropout(x, 0.5, True)),
        "keyed fwd+bwd": us(lambda: D.keyed_dropout(xg, key, 0.5).backward(g), 1000),
        "parent fwd+bwd": us(lambda: (xg * torch.empty_like(xg).bernoulli_(
            0.5, generator=gen).div_(0.5)).backward(g), 1000),
        "set_dropout_keys d5": us(lambda: set_dropout_keys(net, k), 500),
        "parent generator": us(lambda: torch.Generator(device="cuda").manual_seed(12345), 500),
    }
    for name, v in res.items():
        print(f"host us a call: {name}: {v:.2f}")
    print(cs.card_name_and_power())


def step() -> None:
    cs = _setup()
    import torch

    with tempfile.TemporaryDirectory() as work:
        t, state, batches, blocks = _trainer(cs, work)
        keyed = [b.dropout for b in blocks]
        parent = [cs.ParentDropout(b.dropout.p) for b in blocks]
        mod = sys.modules[cs.UNet2D.__module__]
        change_set = mod.set_dropout_keys
        cuda = torch.autograd.DeviceType.CUDA
        for p in (True, False, True, False):
            for b, k, q in zip(blocks, keyed, parent):
                b.dropout = q if p else k
            mod.set_dropout_keys = cs.parent_set_dropout if p else change_set
            for i in range(5):
                t._train_step(state, batches[i % 4], cs.K(i))
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(5):
                    t._train_step(state, batches[i % 4], cs.K(i))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 5
            ev = prof.key_averages()
            dev = sum(e.self_device_time_total for e in ev if e.device_type == cuda) / 1e3 / 5
            host = sorted(((e.key, e.self_cpu_time_total / 5, e.count / 5) for e in ev
                           if e.device_type != cuda), key=lambda r: -r[1])[:14]
            kern = [(e.key, e.self_device_time_total / 5, e.count / 5) for e in ev
                    if e.device_type == cuda and any(
                        n in e.key for n in ("bernoulli", "distribution", "quad_kernel",
                                             "stream_kernel", "elementwise"))]
            label = "P" if p else "C"
            print(f"step {label}: wall {wall:.3f} ms, device {dev:.3f} ms "
                  f"({100 * dev / wall:.1f}% busy); top host ops (us a step, calls): "
                  + "; ".join(f"{k[:40]} {v:.0f} {c:.0f}" for k, v, c in host))
            print(f"step {label} kernels (us a step, launches): "
                  + "; ".join(f"{k[:50]} {v:.1f} {c:.0f}" for k, v, c in kern))
        mod.set_dropout_keys = change_set
        for b, k in zip(blocks, keyed):
            b.dropout = k


def split() -> None:
    import threading

    cs = _setup()
    import torch

    with tempfile.TemporaryDirectory() as work:
        t, state, batches, blocks = _trainer(cs, work)
        keyed = [b.dropout for b in blocks]
        parent = [cs.ParentDropout(b.dropout.p) for b in blocks]
        mod = sys.modules[cs.UNet2D.__module__]
        change_set = mod.set_dropout_keys
        n = cs.DROPOUT_TURN_STEPS
        rows = {True: [], False: []}
        for i in range(2 * cs.DROPOUT_PAIRS):
            p = (i % 4) in (0, 3)  # P C C P ...
            for b, k, q in zip(blocks, keyed, parent):
                b.dropout = q if p else k
            mod.set_dropout_keys = cs.parent_set_dropout if p else change_set
            for j in range(2):
                t._train_step(state, batches[j % 4], cs.K(j))
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            host = 0.0
            t0 = time.perf_counter()
            e0.record()
            for j in range(n):
                h = time.perf_counter()
                t._train_step(state, batches[j % 4], cs.K(j))
                host += time.perf_counter() - h
            e1.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rows[p].append((host * 1e3 / n, e0.elapsed_time(e1) / n, wall * 1e3 / n))
        mod.set_dropout_keys = change_set
        for b, k in zip(blocks, keyed):
            b.dropout = k
    for p in (True, False):
        a = np.array(rows[p])
        print(f"split {'P' if p else 'C'}: ms a step, medians of {len(a)} turns: host "
              f"{np.median(a[:, 0])!r}, device span {np.median(a[:, 1])!r}, wall "
              f"{np.median(a[:, 2])!r}; turns (host, device, wall): {a.round(3).tolist()}")
    print(f"threads: {[th.name for th in threading.enumerate()]}")
    print(cs.card_name_and_power())


def launches() -> None:
    cs = _setup()
    import torch
    from ich_tpu_torch.ops import dropout as D

    log = []
    orig = D._launch

    def logged(x, key, rate, offset):
        log.append((tuple(x.shape), x.stride()))
        return orig(x, key, rate, offset)

    with tempfile.TemporaryDirectory() as work:
        t, state, batches, _ = _trainer(cs, work)
        D._launch = logged
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t._train_step(state, batches[0], cs.K(9))
                torch.cuda.synchronize()
        finally:
            D._launch = orig
    ks = sorted((e for e in prof.events() if "quad_kernel" in e.name or "stream_kernel" in e.name),
                key=lambda e: e.time_range.start)
    for (shape, stride), e in zip(log, ks):
        print(f"launch {shape} strides {stride}: {e.name[:45]} {e.device_time_total:.1f} us")


def gc_probe() -> None:
    cs = _setup()
    spent = [0.0, None]

    def cb(phase, info):
        if phase == "start":
            spent[1] = time.perf_counter()
        elif spent[1] is not None:
            spent[0] += time.perf_counter() - spent[1]

    gc.callbacks.append(cb)
    with tempfile.TemporaryDirectory() as work:
        for label in ("small heap", "3M-object heap", "3M-object heap, frozen"):
            if label == "3M-object heap":
                junk = [[i] for i in range(3_000_000)]  # a long-lived process's heap
            if label.endswith("frozen"):
                gc.freeze()
            spent[0] = 0.0
            cs._dropout_steps(work)
            print(f"gc {label}: {spent[0]!r} s in the GC over (d)-(e)")
    del junk


def times(tree: str, label: str) -> None:
    cs = _setup(os.path.abspath(tree))
    import torch
    from ich_tpu_torch.experiments import label_efficiency_study as study
    from ich_tpu_torch.experiments.supervised2d import build_unet_from_cfg
    from ich_tpu_torch.train.segmentation2d import UNet2D

    torch.backends.cudnn.allow_tf32 = True

    def timed(name, t, size, n_steps):
        fold = cs.synthetic_ich_slices(n_slices=4 * t.batch_size, size=size, n_volumes=4,
                                       seed=cs.SEED)
        state = t._train_state(4)
        batches = list(t._batches(fold.device_cache(cs.DEV),
                                  np.arange(4 * t.batch_size).reshape(4, t.batch_size)))
        t.unet.train()
        for i in range(5):
            t._train_step(state, batches[i % 4], cs.K(i))
        torch.cuda.synchronize()
        out = []
        for _ in range(5):
            t0 = time.perf_counter()
            for i in range(n_steps):
                t._train_step(state, batches[i % 4], cs.K(i))
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) / n_steps * 1e3)
        print(f"{label} {name}: ms a warm step, 5 runs of {n_steps}: {out}", flush=True)

    with tempfile.TemporaryDirectory() as work:
        cfg = cs.load_train_cfg(work)
        aug = cs.build_pipeline(cfg["data"]["augmentation"]["train"])
        timed("train2d_bs16", cs._trainer(cfg, cs.DEV, batch_size=16, augment_fn=aug),
              cfg["data"]["size"], 30)
        s = study.base_cfg(work, "scratch")
        tr = s["train"]
        t = UNet2D(build_unet_from_cfg(s["net"], seed=0, device=cs.DEV), n_epoch=1,
                   batch_size=tr["batch_size"], lr=tr["lr"], lr_scheduler=tr["lr_scheduler"],
                   lr_scheduler_kwargs=tr["lr_scheduler_kwargs"], loss_fn=tr["loss_fn"],
                   loss_fn_kwargs=tr["loss_fn_kwargs"], seed=0,
                   augment_fn=cs.build_pipeline(s["data"]["augmentation"]["train"]),
                   device=cs.DEV)
        timed("le_study_step_bs16_64px", t, s["data"]["size"], 100)
    print(cs.card_name_and_power())


def build() -> None:
    from pathlib import Path

    sys.path.insert(0, ROOT)
    from ich_tpu_torch.kernels import _build

    nvcc, srcs = _build._nvcc(), _build._sources()
    for serial in (True, False, False, True):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            if serial:
                _build._run_all([[nvcc, *_build.NVCC_FLAGS, *map(str, srcs), "-o",
                                  os.path.join(d, "lib.so")]], None)
            else:
                _build.BUILD_DIR = Path(d)
                _build.build()
            label = "one nvcc over all sources" if serial else "one nvcc a source, then a link"
            print(f"build {label}: {time.perf_counter() - t0!r} s ({len(srcs)} sources)",
                  flush=True)


if __name__ == "__main__":
    cmd, rest = sys.argv[1], sys.argv[2:]
    {"hostcost": hostcost, "step": step, "launches": launches, "gc": gc_probe,
     "times": times, "build": build, "split": split}[cmd](*rest)
