"""The readings that the limits of a cell's comparison are set from, on the
card at the cell's own size: the program's on each seed, the control's
(the nearest lower precision in the program's place) and the planted
faults' on the first few. One JSON line per seed. The benchmark's own
runs do not run this.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --control 3 --seconds 5

Each seed runs a window of ``--seconds`` at the cell's own load first (a
training cell: to the end of the epoch under way), so that what is
compared is drawn as a run draws it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def faults(driver) -> dict:
    """Readings of the faults this cell can have, planted in the reference
    put in the program's place (training: half of the batch left out, the
    mean over the rest; a step that leaves the state unchanged reads 1 by
    construction) or in the served answers (a mask altered where it is
    produced)."""
    from portbench.common.training import against

    if driver.unit == "steps":
        return {"half_batch": against(driver.reference(driver.record, half_batch=True),
                                      driver.reference(driver.record))}
    altered = {}
    for n, k, mask in driver.kept:
        m = np.array(mask)
        m.reshape(-1)[:: 4099] ^= 255  # one voxel in 4099 flipped
        altered[n] = (k, m)
    return {"altered_answer": driver._judge(altered)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from portbench.common import manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = manifest.cell(args.workload)
    mod = manifest.driver(cell)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        d = mod.Driver(cell, seed, "cuda")
        d.window(args.seconds)
        d.free()
        line = {"workload": args.workload, "seed": seed, "program": d.check(detail=True)}
        if i < args.control:
            line["control"] = d.control()
            line["faults"] = faults(d)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
