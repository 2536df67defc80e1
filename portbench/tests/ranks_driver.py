"""A driver for the tests of ``common/ranks.py``: each of the cell's
``chips`` ranks sums, over the group, a tensor drawn from the seed and its
rank (on the CPU, then moved to the rank's device); rank 0 judges the sum
against the sum of the draws. ``traffic``: ``n``, the tensor's length,
``timeout_s``, the group's, and for planted faults ``world``, the ranks
started where it is not the cell's ``chips``, and ``plant``, a module
name each helper rank puts into ``sys.modules`` after its sum."""

import sys
import time
import types

import torch

from portbench.common.ranks import Ranks


def draw(seed: int, rank: int, n: int) -> torch.Tensor:
    return torch.randn(n, generator=torch.Generator().manual_seed(seed + rank),
                       dtype=torch.float64)


def helper(mesh, seed: int, traffic: dict) -> None:
    from ich_tpu_torch.parallel.mesh import all_reduce_

    all_reduce_(draw(seed, mesh.rank, traffic["n"]).to(mesh.device), mesh)
    if "plant" in traffic:
        sys.modules[traffic["plant"]] = types.ModuleType(traffic["plant"])


class NeverJoins:
    """Unpickled by a helper rank before it joins its group: blocks there."""

    def __reduce__(self):
        return time.sleep, (3600,)


class Driver:
    unit = "sums"

    def __init__(self, cell: dict, seed: int, device):
        self.seed, self.n = seed, cell["traffic"]["n"]
        self.world = cell["traffic"].get("world", cell["chips"])
        self.ranks = Ranks(self.world, device, helper, args=(seed, cell["traffic"]),
                           timeout_s=cell["traffic"]["timeout_s"])

    def window(self, seconds: float) -> dict:
        from ich_tpu_torch.parallel.mesh import all_reduce_

        t0 = time.perf_counter()
        mesh = self.ranks.mesh
        self.got = all_reduce_(draw(self.seed, 0, self.n).to(mesh.device), mesh).cpu()
        return {"units": 1, "attempted": 1, "failed": 0, "seconds": time.perf_counter() - t0,
                "metrics": {}}

    def free(self) -> None:
        self.ranks.close()

    def check(self, detail: bool = False) -> dict:
        want = sum(draw(self.seed, r, self.n) for r in range(self.world))
        return {"sum_gap": float((self.got - want).abs().max())}
