"""Host-side epoch loop with crash-resume (counterpart of
:mod:`ich_tpu.train.loop`).

Resume from the checkpoint, one log line per epoch, a checkpoint every
``checkpoint_freq`` epochs, and the SIGTERM stop after a checkpoint. The
step losses stay on the device and are fetched once per epoch.

Each step gets the JAX loop's key, ``fold_in(fold_in(prng_key(seed),
epoch), batch)`` (:mod:`ich_tpu_torch.utils.rng`), from which its draws
come, so a resumed run replays the uninterrupted one and the draws equal
the JAX package's.

Under ``torch.profiler`` each step's key shows as a ``keys`` range, and the
epoch's end (its mean loss fetched, which waits for the epoch's work, the
hook, the checkpoint and the preemption poll) as ``epoch_end``.
"""

from __future__ import annotations

import logging
import time
from datetime import timedelta
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ich_tpu_torch.parallel.mesh import all_reduce_mean
from ich_tpu_torch.train import checkpoint as ckpt
from ich_tpu_torch.train.state import TrainState
from ich_tpu_torch.utils import preemption, rng

logger = logging.getLogger(__name__)


def fit(
    state: TrainState,
    train_step: Callable[[TrainState, Any, torch.Tensor], Any],  # (state, batch, key) -> loss(es)
    batches_fn: Callable[[int], Iterable],  # epoch -> iterable of batches
    n_epoch: int,
    epoch_hook: Callable[[TrainState, int, Optional[np.ndarray], float], list],
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_freq: int = 10,
    name: str = "model",
    mesh=None,
) -> Tuple[list, float]:
    """Run the training loop on ``state`` in place; returns (history,
    wall_time).

    ``train_step`` returns a 0-d loss tensor or a tuple of them; their
    epoch means are taken on the device and fetched once.
    ``epoch_hook(state, epoch, mean_losses, epoch_time) -> history_row``
    owns validation and the epoch's log line; ``mean_losses`` is a numpy
    scalar or vector (None for an epoch without batches).

    With a ``mesh`` (:class:`ich_tpu_torch.parallel.Mesh`) every rank runs
    the loop: the epoch means are averaged over the ranks (each rank's step
    loss is its slice's mean, so this is the global mean and every rank
    logs the same history), the single-file checkpoint is written by rank 0
    and the directory store by every rank (:func:`ich_tpu_torch.train.
    checkpoint.save_checkpoint_auto`), every rank resumes from the same
    checkpoint, and the preemption flag is agreed over the ranks.
    """
    preemption.install()  # so that the requested() poll below can fire
    n_epoch_finished, history = 0, []
    if checkpoint_path:
        restored = ckpt.load_checkpoint_auto(checkpoint_path, mesh)
        if restored is not None:
            saved_state, n_epoch_finished, history = restored
            state.load_state_dict(saved_state)
            logger.info("Checkpoint loaded with %d epoch finished.", n_epoch_finished)
        else:
            logger.info("No Checkpoint found. Training from beginning.")

    logger.info("Start training the %s.", name)
    root_key = rng.prng_key(seed)
    start_time = time.time()

    for epoch in range(n_epoch_finished, n_epoch):
        losses, epoch_start = [], time.time()
        epoch_key = rng.fold_in(root_key, epoch)
        for b, batch in enumerate(batches_fn(epoch)):
            with torch.profiler.record_function("keys"):
                key = rng.fold_in(epoch_key, b)
            loss = train_step(state, batch, key)
            losses.append(torch.stack(loss) if isinstance(loss, (tuple, list)) else loss)
        with torch.profiler.record_function("epoch_end"):
            mean_losses = None
            if losses:
                mean = torch.stack(losses).mean(dim=0)
                if mesh is not None:
                    mean = all_reduce_mean(mean, mesh)
                mean_losses = mean.cpu().numpy()

            history.append(epoch_hook(state, epoch, mean_losses, time.time() - epoch_start))
            saved = False
            if checkpoint_path and (epoch + 1) % checkpoint_freq == 0:
                ckpt.save_checkpoint_auto(checkpoint_path, state.state_dict(), epoch + 1,
                                          history, mesh)
                logger.info("\tCheckpoint saved.")
                saved = True
            if preemption.requested_global(mesh):
                if checkpoint_path and not saved:
                    ckpt.save_checkpoint_auto(checkpoint_path, state.state_dict(), epoch + 1,
                                              history, mesh)
                logger.warning("Preemption requested: checkpointed after epoch %d, stopping.",
                               epoch + 1)
                break

    wall = time.time() - start_time
    logger.info("Finished training %s in %s", name, timedelta(seconds=int(wall)))
    return history, wall
