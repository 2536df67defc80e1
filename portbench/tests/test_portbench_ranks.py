"""``common/ranks.py`` at world 2 over gloo on the CPU, through a whole run
of a test-only driver (``ranks_driver.py``): the line's ``device.count``
is the size of the group that ran, the group's sum equals the sum of
every rank's draw; a helper rank that never joins ends the run within the
timeout, with an error, and leaves no process behind; a driver that
starts fewer ranks than its cell's ``chips``, and a helper rank that
loads a module of the JAX package, each make the run raise."""

import multiprocessing
import sys
import time

import pytest

from portbench.common import manifest
from portbench.run import measure
from portbench.tests import ranks_driver

BENCH = manifest.benchmark()
SEED = 2**31 + 77


def run(**traffic):
    cell = {"name": "allreduce_w2", "driver": "allreduce", "chips": 2,
            "config_data": {"precision": "tf32"},
            "traffic": {"n": 4099, "timeout_s": 60.0, **traffic}, "limits": {"sum_gap": 0.0}}
    return measure(cell, SEED, 0.1, False, "cpu", time.time(), BENCH)


@pytest.fixture(autouse=True)
def allreduce_driver(monkeypatch):
    monkeypatch.setitem(sys.modules, "portbench.drivers.allreduce", ranks_driver)


def test_two_ranks_sum_what_each_drew():
    r = run()
    assert r["device"]["count"] == 2
    assert r["correct"] and r["checks"] == {"sum_gap": {"value": 0.0, "limit": 0.0}}
    assert not multiprocessing.active_children()


def test_a_helper_that_never_joins_ends_the_run_with_an_error():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        run(stall=ranks_driver.NeverJoins(), timeout_s=5.0)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()


def test_fewer_ranks_than_the_cells_chips_make_the_run_raise():
    with pytest.raises(RuntimeError, match="asks for 2 cards and ran on 1"):
        run(world=1)
    assert not multiprocessing.active_children()


def test_a_helper_that_loads_the_jax_package_makes_the_run_raise(capfd):
    with pytest.raises(RuntimeError, match="JAX stack or package"):
        run(plant="ich_tpu.fake")
    assert "['ich_tpu']" in capfd.readouterr().err
    assert not multiprocessing.active_children()
