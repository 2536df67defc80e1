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


def requested_global() -> bool:
    """The preemption flag agreed across processes. The port trains on one
    process, so this is :func:`requested`; agreement across processes comes
    with multi-GPU training."""
    return _requested.is_set()


def reset() -> None:
    _requested.clear()
