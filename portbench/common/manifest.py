"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, one
``workloads/<cell>.json`` per cell and one ``configs/<config>.json`` per
configuration, and the modules of a cell's driver and net, found by
name."""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import List

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's workload file, with its configuration under
    ``config_data`` and its traffic's parameters under ``traffic``."""
    w = load_json(PKG / "workloads" / f"{name}.json")
    w["config_data"] = load_json(PKG / "configs" / f"{w['config']}.json")
    w["traffic_name"] = w["traffic"]
    w["traffic"] = load_json(PKG / "traffic" / f"{w['traffic']}.json")
    return w


def driver(cell: dict):
    """The module of the cell's timed path, ``drivers/<driver>.py``."""
    return importlib.import_module(f"portbench.drivers.{cell['driver']}")


def net(net_cfg: dict):
    """The module of a configuration's net, ``nets/<arch>.py``: ``arch``
    names it, and without one it is the U-Net."""
    return importlib.import_module(f"portbench.nets.{net_cfg.get('arch', 'unet')}")


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics read in this cell: those that list it, and
    those without a list whose end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]
