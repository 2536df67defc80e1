"""Preemption-aware training (graceful SIGTERM checkpointing), copied from
``ich_tpu/utils/preemption.py`` (importing ``ich_tpu`` imports jax).

The fit loop listens for SIGTERM (``install()`` is called by
:func:`ich_tpu_torch.train.loop.fit`): when one arrives, the current epoch
finishes, a checkpoint is written, and training returns cleanly
(resumable). SIGINT is NOT intercepted by default — an interactive Ctrl-C
should raise KeyboardInterrupt immediately; pass
``install(signals=(SIGTERM, SIGINT))`` to opt in.

The flag stays set after ``fit`` returns (a preempted process is about to
be killed, and later ``fit`` calls in the same process must not silently
train for one epoch each and report success) — callers check
:func:`requested` after training and abort their pipeline; :func:`reset`
re-arms for tests and long-lived servers.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)

_requested = threading.Event()
_installed: set = set()


def _handler(signum, frame):
    logger.warning("Signal %s received: checkpointing at epoch boundary.", signum)
    _requested.set()


def install(signals=(signal.SIGTERM,)) -> None:
    """Install the graceful-preemption handler (main thread only).
    Idempotent per signal; later calls may ADD signals."""
    for s in signals:
        if s in _installed:
            continue
        try:
            signal.signal(s, _handler)
            _installed.add(s)
        except ValueError:  # not in main thread (e.g. under some runners)
            logger.debug("preemption handler not installed (non-main thread)")
            return


def requested() -> bool:
    return _requested.is_set()


def requested_global(mesh=None) -> bool:
    """The preemption flag agreed across the ranks of ``mesh`` (an
    :class:`ich_tpu_torch.parallel.Mesh`; ``None``: this process's flag). A
    SIGTERM lands on one process: every rank must take the checkpoint-and-
    stop branch at the same epoch boundary, or the ranks that go on into
    the next epoch's collectives wait for the ones that stopped. The flag
    is all-reduced with MAX."""
    if mesh is None:
        return _requested.is_set()
    import torch
    import torch.distributed as dist

    flag = torch.tensor([float(_requested.is_set())], device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(flag.item() > 0)


def reset() -> None:
    _requested.clear()
