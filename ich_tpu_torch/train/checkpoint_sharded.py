"""Directory checkpoints through ``torch.distributed.checkpoint`` (DCP), the
counterpart of :mod:`ich_tpu.train.checkpoint_orbax`.

The single-file store (:mod:`ich_tpu_torch.train.checkpoint`) writes the
whole state from one process. Here every rank of the mesh takes part: DCP
plans the write collectively and spreads the tensors over the ranks'
files (a tensor that every rank holds is written once), and a restore
reads what each rank needs at whatever world size it runs, so a
checkpoint saved by N ranks restores at N/2 or 1.

Layout of ``path/``: ``state/`` (DCP files holding the state's tensors,
keyed by their nested dict path joined with ``/``) and ``meta.json`` (the
epoch, the history and the state's other leaves, such as the optimizer's
``param_groups``). A path segment of digits is read back as an int key
(the optimizer's per-parameter state).

Crash safety, as in the JAX package: the new state is written to
``state.new`` before the old ``state`` is removed, and its meta to
``meta.json.new`` before any swap; the loader falls back to ``state.new``
and prefers ``meta.json.new``, so a crash at any point leaves one complete
checkpoint whose epoch matches its state. The swap runs on rank 0 between
barriers. A missing directory restores as ``None`` (a fresh start).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed.checkpoint as dcp

from ich_tpu_torch.parallel.mesh import Mesh, barrier

_META = "meta.json"
_STATE = "state"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Tuple[dict, dict]:
    """(tensors, other leaves) of a nested dict, keyed by ``a/b/c`` paths."""
    tensors, other = {}, {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) and v:
            t, o = _flatten(v, key + "/")
            tensors.update(t)
            other.update(o)
        elif isinstance(v, torch.Tensor):
            tensors[key] = v.detach()
        else:
            other[key] = v
    return tensors, other


def _unflatten(flat: Dict[str, Any]) -> Dict[Any, Any]:
    out: Dict[Any, Any] = {}
    for key, v in flat.items():
        parts = [int(p) if p.isdigit() else p for p in key.split("/")]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _sync(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        barrier(mesh)


def _is_lead(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.rank == 0


def save_checkpoint_sharded(path: str, state: Dict[str, Any], epoch: int, history: list,
                            mesh: Optional[Mesh] = None) -> None:
    """Write ``state`` (a nested dict of tensors and JSON values, such as
    :meth:`ich_tpu_torch.train.state.TrainState.state_dict`) under
    ``path/state`` and ``path/meta.json``. Every rank of ``mesh`` calls it
    with the same keys; without a mesh one process writes alone."""
    path = os.path.abspath(path)
    state_dir = os.path.join(path, _STATE)
    new_dir = state_dir + ".new"
    meta_new = os.path.join(path, _META + ".new")
    if _is_lead(mesh):
        os.makedirs(path, exist_ok=True)
        if os.path.exists(new_dir):
            if not os.path.exists(state_dir):
                # a crash between removing state and the swap: state.new is
                # the only complete checkpoint, so promote it, do not delete it
                os.replace(new_dir, state_dir)
                if os.path.exists(meta_new):
                    os.replace(meta_new, os.path.join(path, _META))
            else:
                shutil.rmtree(new_dir)  # left by an interrupted save
                if os.path.exists(meta_new):
                    os.remove(meta_new)
    _sync(mesh)
    tensors, other = _flatten(state)
    dcp.save(tensors, checkpoint_id=new_dir, no_dist=mesh is None,
             process_group=None if mesh is None else mesh.group)
    _sync(mesh)  # every rank's files are written before the swap
    if _is_lead(mesh):
        with open(meta_new + ".tmp", "w") as f:
            json.dump({"epoch": int(epoch), "history": history, "other": other}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(meta_new + ".tmp", meta_new)
        if os.path.exists(state_dir):
            shutil.rmtree(state_dir)
        os.replace(new_dir, state_dir)
        os.replace(meta_new, os.path.join(path, _META))
    _sync(mesh)


def load_checkpoint_sharded(path: str, mesh: Optional[Mesh] = None
                            ) -> Optional[Tuple[Dict[str, Any], int, list]]:
    """(state, epoch, history) with the tensors on the CPU, or None when
    there is no complete checkpoint under ``path``. Every rank of ``mesh``
    calls it; any world size reads any checkpoint."""
    path = os.path.abspath(path)
    state_dir = os.path.join(path, _STATE)
    meta_fn = os.path.join(path, _META)
    if not os.path.isdir(state_dir) and os.path.isdir(state_dir + ".new"):
        state_dir += ".new"  # a crash between the write and the swap
    if os.path.exists(meta_fn + ".new"):
        meta_fn += ".new"  # written before any swap: it describes the surviving state
    if not (os.path.isdir(state_dir) and os.path.exists(meta_fn)):
        return None
    md = dcp.FileSystemReader(state_dir).read_metadata().state_dict_metadata
    tensors = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in md.items()}
    dcp.load(tensors, checkpoint_id=state_dir, no_dist=mesh is None,
             process_group=None if mesh is None else mesh.group)
    with open(meta_fn) as f:
        meta = json.load(f)
    return _unflatten({**meta["other"], **tensors}), int(meta["epoch"]), meta["history"]
