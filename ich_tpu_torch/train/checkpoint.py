"""Weights export (counterpart of ``save_params``/``load_params`` in
:mod:`ich_tpu.train.checkpoint`): a module's ``state_dict`` through
``torch.save``, read back with ``torch.load(weights_only=True)``."""

from __future__ import annotations

import os
from typing import Dict

import torch


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a ``state_dict`` (moved to the CPU) to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``state_dict`` written by :func:`save_params` onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
