"""Checkpoints, weights export and cross-task weight transfer (counterpart
of :mod:`ich_tpu.train.checkpoint`).

- ``save_params`` / ``load_params``: a module's ``state_dict`` through
  ``torch.save``, read back with ``torch.load(weights_only=True)``.
- ``save_checkpoint`` / ``load_checkpoint``: one file holding ``{epoch,
  model, optimizer, step, history}``, written atomically (``fsync``, then
  ``os.replace``); a missing file means a fresh start, the reference's
  resume (``UNet2D.py:109-121``).
- ``save_checkpoint_auto`` / ``load_checkpoint_auto``: a path ending in a
  separator takes the directory store of
  :mod:`ich_tpu_torch.train.checkpoint_sharded` (every rank writes its
  part), any other the single file (rank 0 writes);
- ``transfer_weights``: the reference's key-intersection ``state_dict``
  update (``UNet2D.py:316-337``) with strict shapes, which raises when
  nothing matches;
- ``freeze_mask``: the parameters a frozen transfer keeps fixed.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import torch

from ich_tpu_torch.parallel.mesh import barrier

logger = logging.getLogger(__name__)


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a ``state_dict`` (moved to the CPU) to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``state_dict`` written by :func:`save_params` onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(path: str, state: Dict[str, Any], epoch: int, history: list) -> None:
    """Atomic single-file checkpoint of ``state`` (``{"model", "optimizer",
    "step"}``, as :meth:`ich_tpu_torch.train.state.TrainState.state_dict`
    gives it), the number of finished epochs and the history rows."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"epoch": int(epoch), **state, "history": history}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())  # the rename only helps once the data is durable
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[Tuple[Dict[str, Any], int, list]]:
    """(state, epoch, history) from :func:`save_checkpoint`'s file, tensors
    on the CPU, or None if there is no file."""
    if not os.path.exists(path):
        return None
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: payload[k] for k in ("model", "optimizer", "step")}
    return state, int(payload["epoch"]), payload["history"]


def is_sharded_path(path: str) -> bool:
    """A path that ends in a separator selects the directory store of
    :mod:`ich_tpu_torch.train.checkpoint_sharded`; any other path the
    single file."""
    return path.endswith("/") or path.endswith(os.sep)


def save_checkpoint_auto(path: str, state: Dict[str, Any], epoch: int, history: list,
                         mesh=None) -> None:
    """The directory store (every rank of ``mesh`` writes) or the single
    file (rank 0 writes, then every rank waits at a barrier)."""
    if is_sharded_path(path):
        from ich_tpu_torch.train import checkpoint_sharded

        checkpoint_sharded.save_checkpoint_sharded(path, state, epoch, history, mesh)
        return
    if mesh is None or mesh.rank == 0:
        save_checkpoint(path, state, epoch, history)
    if mesh is not None:
        barrier(mesh)


def load_checkpoint_auto(path: str, mesh=None) -> Optional[Tuple[Dict[str, Any], int, list]]:
    """(state, epoch, history) from either store, or None; every rank reads
    the same checkpoint."""
    if is_sharded_path(path):
        from ich_tpu_torch.train import checkpoint_sharded

        return checkpoint_sharded.load_checkpoint_sharded(path, mesh)
    return load_checkpoint(path)


def transfer_weights(
    target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor], verbose: bool = False,
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Copy every entry of ``source`` whose key exists in ``target`` with
    the same shape; return (new target, transferred keys). Other keys are
    left as they are. A transfer that moves nothing is a config error (for
    example an encoder and a net built with different widths) and raises."""
    new = dict(target)
    moved = [k for k, v in source.items()
             if k in target and tuple(target[k].shape) == tuple(v.shape)]
    for k in moved:
        new[k] = source[k]
    if verbose:
        logger.info("%d matching weight keys found on %d to be transferred (%d target keys).",
                    len(moved), len(source), len(target))
    if not moved and source:
        raise ValueError(
            f"transfer_weights: none of the {len(source)} source keys matched the target "
            f"(by key and shape) — the architectures are incompatible; check "
            f"depth/top_filter/midchannels_factor.")
    return new, moved


def freeze_mask(param_names: Iterable[str], frozen_keys: Iterable[str]) -> Set[str]:
    """The parameters to keep fixed: the names in ``param_names`` (a
    module's ``named_parameters`` keys) among ``frozen_keys`` (the keys a
    transfer moved, buffers included). The JAX package returns the
    complement as a boolean pytree for ``optax``; the trainers here leave
    these parameters out of the optimizer (the reference's
    ``requires_grad=False``, ``Contrastive.py:227-253``)."""
    frozen = set(frozen_keys)
    return {k for k in param_names if k in frozen}
