"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and weights from the seed, the program's objects, every
shape warmed) is timed from the process's start to the window's; the
window drives the cell's timed path for ``--seconds``; then the program's
state is freed and the plain reference judges what the window produced.
With ``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the cell's per-layer metrics instead of its end-to-end ones. The
last lines on standard error, and the line's last key, are the numbers
compared with their limits. A cell of four cards runs one process a card:
the driver's set-up starts the others (``common/ranks.py``), and this
process, rank 0, measures; ``device.count`` is the size of the group that
ran, and a run whose count is not its cell's ``chips`` raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def process_start() -> float:
    """The epoch time at which this process started (the kernel's record;
    the interpreter's first statement where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ich_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole: ``ich_tpu_torch`` is not ``ich_tpu``)."""
    return sorted({m.partition(".")[0] for m in sys.modules} & set(FORBIDDEN))


def checks_of(readings: dict, limits: dict) -> dict:
    """Each number compared beside its limit, in the order of the limits."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def is_correct(attempted: int, failed: int, checks: dict) -> bool:
    """``correct``: work was attempted, none of it failed, and every number
    compared is finite and within its limit."""
    return (failed == 0 and attempted > 0
            and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                    for c in checks.values()))


def measure(cell: dict, seed: int, seconds: float, trace: bool, device: str,
            started: float, bench: dict) -> dict:
    """One run of ``cell``; the result line as a dict, or raises."""
    import torch

    from portbench.common import manifest
    from portbench.common.peaks import peaks
    from portbench.common.readout import Readout, reader
    from portbench.common.trace import TraceSummary

    t_import = time.time() - started
    driver = manifest.driver(cell).Driver(cell, seed, device)
    if trace:
        driver.annotate()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - started
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        win = driver.window(seconds)
        if on_card:
            torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of the JAX stack or package loaded: {found}")

    name = cell["name"]
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name() if on_card else "cpu",
                "count": 0, "memory_peak_bytes": 0}
    metrics, extra = {}, {}
    if trace:
        summary = TraceSummary(prof)
        card = peaks(dev_info["kind"]) or {}
        r = Readout(summary, win["units"], win["seconds"], card,
                    cell["config_data"]["precision"], driver.work())
        for m in manifest.per_layer(bench, name):
            value = reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = summary.busy_s()
        dev_info["window_s"] = win["seconds"]
        extra["breakdown"] = summary.breakdown()
        del summary, prof
    else:
        values = {**win["metrics"], "setup_s": setup_s}
        for m in manifest.end_to_end(bench, name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    t_read = time.time() - started
    # a multi-card cell's group (common/ranks.py), which free() closes: the
    # cards it ran on, and the fullest one's peak, reported by every rank
    group = getattr(driver, "ranks", None)
    driver.free()
    count, group_peak = (group.world, group.peak_bytes) if group else (1, 0)
    if count != cell["chips"]:
        raise RuntimeError(f"{name} asks for {cell['chips']} cards and ran on {count}")
    dev_info["count"] = count
    dev_info["memory_peak_bytes"] = int(max(peak_bytes, group_peak))
    readings = driver.check()
    print(f"seconds from the process's start: imports {t_import:.2f}, "
          f"set-up done {setup_s:.2f}, window and its reading done {t_read:.2f}, "
          f"check done {time.time() - started:.2f}", file=sys.stderr)
    checks = checks_of(readings, cell["limits"])
    correct = is_correct(win["attempted"], win["failed"], checks)
    return {"correct": bool(correct), "attempted": win["attempted"], "failed": win["failed"],
            "metrics": metrics, "device": dev_info, **extra, "checks": checks}


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.common import manifest

    bench = manifest.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell = manifest.cell(args.workload)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", started, bench)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
