"""``BENCHMARK.json`` and the files it names, against the benchmark's
contract: names and units from the allowed characters, every cell on one
card or four (four for at most a quarter of the cells, or one) and found
by its files, every per-layer metric read by a reader of its own in cells
that report the metric it moves."""

import copy
import re

import pytest

from portbench.common import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell of run_seconds + 60 s, 180 s a cell
    # to compile, 1200 s spare, within 12 hours, up to 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(names) == len(set(names))
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    assert all(m["better"] in ("lower", "higher") for m in BENCH["end_to_end"] + BENCH["per_layer"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


def cards_within_the_contract(bench: dict) -> bool:
    """Every cell asks for 1 card or 4, and at most a quarter of the cells
    (rounded down), or one, for 4."""
    chips = [w["chips"] for w in bench["workloads"]]
    return set(chips) <= {1, 4} and chips.count(4) <= max(1, len(chips) // 4)


def test_cells_ask_for_one_card_or_four():
    assert cards_within_the_contract(BENCH)


@pytest.mark.parametrize("one,four,ok", [(3, 1, True), (3, 2, False), (7, 2, True),
                                         (7, 3, False), (0, 1, True), (0, 2, False)])
def test_four_card_cells_within_the_contract(one, four, ok):
    """On an in-memory copy of the manifest with ``one`` one-card cells
    and ``four`` four-card cells."""
    bench = copy.deepcopy(BENCH)
    w = bench["workloads"][0]
    bench["workloads"] = ([{**w, "name": f"one_{i}", "chips": 1} for i in range(one)]
                          + [{**w, "name": f"four_{i}", "chips": 4} for i in range(four)])
    assert cards_within_the_contract(bench) is ok
    bench["workloads"][-1]["chips"] = 2
    assert not cards_within_the_contract(bench)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree_with_the_manifest(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = manifest.cell(cell)
    assert (c["config"], c["traffic_name"], c["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert (manifest.PKG / "drivers" / f"{c['driver']}.py").exists()
    assert (manifest.PKG / "nets" / f"{c['config_data']['net'].get('arch', 'unet')}.py").exists()
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert conf["file"] == f"portbench/configs/{c['config']}.json"
    assert c["config_data"]["reduced"] == conf["reduced"]
    assert c["config_data"]["precision"] in ("bf16", "tf32")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(cell):
    e2e = {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(BENCH, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader_and_moves_what_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert (manifest.PKG / "metrics" / f"{metric}.py").exists()
    assert m["moves"] in {x["name"] for x in BENCH["end_to_end"]}
    for cell in m["workloads"]:
        assert m["moves"] in {x["name"] for x in manifest.end_to_end(BENCH, cell)}
    if metric.endswith("_roofline_pct") or "mfu" in metric:
        assert m["unit"] == "%"


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
