"""A second net's cells are new files only: in a copy of the checkout,
``second_net/`` adds a net (``nets/`` and ``reference/``), a configuration
that names it, a traffic mix and a cell on each of the ``serve3d`` and
``train3d`` drivers, and ``BENCHMARK.json`` gains their entries and their
names in the lists of the metrics they report. No other file of the copy
differs from the tree. Both cells' tiny runs print the contract's line
with ``correct`` true, and a fault the driver already knows makes each
come out not correct."""

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.common.manifest import PKG, ROOT

NEW = PKG / "tests" / "second_net"
CONFIG = {"name": "convnet3d_gn", "source": "a test's own net",
          "file": "portbench/configs/convnet3d_gn.json", "reduced": [],
          "why": "a second net on the existing drivers"}
CELLS = {  # cell -> (driver, the metrics it joins, the fault that has to fail it)
    "serve3d_convnet": ("serve3d", ["volumes_per_s", "volume_latency_p90_s", "mfu.serve"],
                        "altered"),
    "train3d_convnet": ("train3d", ["train_mvox_per_s", "mfu.train"], "half_batch"),
}
SCRIPT = """
import json, sys, time
import pytest
from portbench.common import manifest
from portbench.run import measure
from portbench.tests.test_portbench_run import FAULTS
from portbench.tests.tiny import tiny_cell

cell, fault = sys.argv[1:]
for planted in (None, fault):
    with pytest.MonkeyPatch.context() as mp:
        if planted:
            FAULTS[planted](mp)
        r = measure(tiny_cell(cell), 2**31 + 7, 0.5, False, "cpu", time.time(),
                    manifest.benchmark())
    print(json.dumps(r), flush=True)
"""


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _add(tmp: Path) -> dict:
    """Copy the checkout's benchmark to ``tmp``, add the second net's files
    and entries, and return the manifest as it was."""
    shutil.copytree(PKG, tmp / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    (tmp / "ich_tpu_torch").symlink_to(ROOT / "ich_tpu_torch")
    for p in NEW.rglob("*"):
        if p.is_file() and p.suffix in (".py", ".json"):
            dst = tmp / "portbench" / p.relative_to(NEW)
            assert not dst.exists()
            shutil.copy(p, dst)
    before = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(before)
    bench["configs"].append(CONFIG)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for cell, (_, joins, _) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": CONFIG["name"],
                                   "traffic": "volumes3_16x64x64", "chips": 1,
                                   "why": "a second net's tiny cell"})
        for m in joins:
            metrics[m]["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return before


def test_a_second_nets_cells_are_new_files_only(tmp_path):
    before = _add(tmp_path)
    tree, copied = _files(PKG), _files(tmp_path / "portbench")
    added = {k for k in copied if k not in tree}
    assert added == {p.relative_to(NEW) for p in NEW.rglob("*")
                     if p.is_file() and p.suffix in (".py", ".json")}
    assert all(copied[k] == v for k, v in tree.items())
    # the manifest differs by the new entries alone
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert bench["configs"].pop() == CONFIG
    assert [w.pop("name") for w in bench["workloads"][-len(CELLS):]] == list(CELLS)
    del bench["workloads"][-len(CELLS):]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in CELLS]
    assert bench == before

    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    for cell, (driver, _, fault) in CELLS.items():
        assert json.loads((tmp_path / "portbench" / "workloads" / f"{cell}.json").read_text())[
            "driver"] == driver
        out = subprocess.run([sys.executable, "-c", SCRIPT, cell, fault], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        sound, faulty = (json.loads(line) for line in out.stdout.splitlines()[-2:])
        assert list(sound) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
        assert sound["correct"] and sound["attempted"] > 0, sound["checks"]
        assert not faulty["correct"], faulty["checks"]
