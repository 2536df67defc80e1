"""The other ranks of a cell that asks for more than one card.

One process a card: rank 0 is the process that measures (it alone times,
traces, prints and judges), and :class:`Ranks` starts ranks 1 to
``world - 1`` with ``torch.multiprocessing`` (spawn). Every rank joins the
group through ``ich_tpu_torch.parallel.mesh.init_distributed``, with a
file rendezvous in a fresh directory under the temporary directory and a
finite timeout, and then marks itself joined in a second file store,
which rank 0 waits on: NCCL's group is set up lazily, so joining returns
before the others have. Each helper rank then runs ``helper(mesh,
*args)``, a function at the top level of the driver's module, and as it
returns reports the peak of its card's memory and whether its process
holds a module of the JAX stack or package (``run.forbidden_modules``,
which rank 0 applies to itself). The driver keeps the group as
``self.ranks`` and closes it in ``free()``; ``world`` is the group's size,
which the run reports as its count of cards. A helper that fails, holds
such a module, or does not join or end within the timeout makes the run
raise, and any helper left at exit is killed.
"""

from __future__ import annotations

import atexit
import shutil
import sys
import tempfile
import time
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist

TIMEOUT_S = 120.0  # to join the group, and for each collective after it


def _device(kind: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if kind == "cuda" else torch.device(kind)


def _join(rank: int, world: int, kind: str, rdv: str, timeout_s: float):
    from ich_tpu_torch.parallel.mesh import init_distributed

    return init_distributed(device=_device(kind, rank), init_method=f"file://{rdv}/group",
                            world_size=world, rank=rank, timeout=timedelta(seconds=timeout_s))


def _joined(rdv: str):
    """The store in which each helper rank marks itself joined."""
    return dist.FileStore(f"{rdv}/joined", -1)


def _report(mesh, found: list) -> tuple[int, bool]:
    """The largest peak of device memory over the ranks, and whether any
    rank found ``found`` non-empty (every rank calls it)."""
    from ich_tpu_torch.parallel.mesh import all_reduce_

    own = torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda" else 0
    t = torch.tensor([own, int(bool(found))], dtype=torch.int64, device=mesh.device)
    peak, any_found = all_reduce_(t, mesh, op=dist.ReduceOp.MAX).tolist()
    return int(peak), bool(any_found)


def _helper(i: int, helper: Callable, world: int, kind: str, rdv: str, timeout_s: float,
            args: tuple) -> None:
    """Rank ``i + 1``: join, run ``helper(mesh, *args)``, report the peak and
    any module of the JAX stack or package loaded, leave with the others,
    and raise where there was one."""
    from portbench.run import forbidden_modules

    mesh = _join(i + 1, world, kind, rdv, timeout_s)
    _joined(rdv).set(f"rank{mesh.rank}", "1")
    helper(mesh, *args)
    found = forbidden_modules()
    msg = f"rank {mesh.rank}: modules of the JAX stack or package loaded: {found}"
    if found:  # before the report, after which rank 0 may end this process
        print(msg, file=sys.stderr, flush=True)  # spawn keeps a helper's traceback to itself
    _report(mesh, found)
    dist.destroy_process_group()
    if found:
        raise RuntimeError(msg)


class Ranks:
    """Rank 0's handle on a group of ``world`` processes, one a card of
    ``device``'s kind (``cpu``: gloo, for tests); ``mesh`` is rank 0's.
    Construction returns once every rank has joined, and raises (with
    every helper ended) where one has not joined within ``timeout_s``.
    ``world`` is the group's size as it was formed."""

    def __init__(self, world: int, device, helper: Callable, args: tuple = (),
                 timeout_s: float = TIMEOUT_S):
        kind = torch.device(device).type
        self.timeout_s, self.peak_bytes = timeout_s, 0
        self.dir = tempfile.mkdtemp(prefix="portbench-ranks-")
        self.ctx = torch.multiprocessing.start_processes(
            _helper, args=(helper, world, kind, self.dir, timeout_s, args), nprocs=world - 1,
            join=False, start_method="spawn")
        atexit.register(self._end)
        try:
            self.mesh = _join(0, world, kind, self.dir, timeout_s)
            self.world = self.mesh.size
            _joined(self.dir).wait([f"rank{r}" for r in range(1, world)],
                                   timedelta(seconds=timeout_s))
        except BaseException:
            self._end()
            raise

    def close(self) -> None:
        """Wait for every helper to return (they report their peaks, kept
        as ``peak_bytes`` with rank 0's), and leave the group with them;
        raises where a helper failed, held a module of the JAX stack or
        package, or outlasts the timeout."""
        try:
            failed = [p.exitcode for p in self.ctx.processes if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"a helper rank exited with {failed}")
            self.peak_bytes, found = _report(self.mesh, [])  # rank 0's is run.measure's
            dist.destroy_process_group()  # NCCL's waits for every rank's
            if found:
                raise RuntimeError("a helper rank loaded modules of the JAX stack or package "
                                   "(named on its standard error)")
            deadline = time.monotonic() + self.timeout_s
            while not self.ctx.join(timeout=1.0):  # raises where a helper failed
                if time.monotonic() > deadline:
                    raise RuntimeError(f"a helper rank did not end within {self.timeout_s} s")
        finally:
            self._end()

    def _end(self) -> None:
        """Kill any helper still running and remove the rendezvous. A group
        still joined after a failure is destroyed on gloo; on NCCL, whose
        destroy would wait for the killed ranks, it is left to this
        process's exit, which aborts it."""
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        if dist.is_initialized() and dist.get_backend() == "gloo":
            dist.destroy_process_group()
        shutil.rmtree(self.dir, ignore_errors=True)
        atexit.unregister(self._end)
