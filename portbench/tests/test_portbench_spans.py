"""``common/spans.py`` and the readers of the program's ranges on
synthetic traces (times in ns): host time with nested instances counted
once, a launch from another thread charged by its time to ``backward``,
idle time clipped to a range, and nothing read where the program has no
such range."""

import pytest

from portbench.common import spans
from portbench.common.readout import Readout, reader
from portbench.common.trace import TraceSummary

MS = 1_000_000
MAIN, ENGINE = 1, 2  # the main thread, autograd's device thread

NEW_READERS = ("upload_host_ms.serve", "finish_host_ms.serve", "sliding_window_device_ms.serve",
               "forward_device_ms.serve", "forward_device_ms.train",
               "backward_device_ms.train", "epoch_end_idle_ms.train")


def summary(cpu, device, launch):
    """A ``TraceSummary`` of the given host events (name, thread, start,
    end), device operations (name, start, end, correlation id) and launch
    records (correlation id -> (thread, start))."""
    s = TraceSummary.__new__(TraceSummary)
    s.cpu, s.device, s._launch, s._busy = list(cpu), list(device), dict(launch), None
    return s


def readout(trace, units=2):
    return Readout(trace, units, 1.0, {}, "bf16", {})


def test_host_time_counts_nested_instances_once():
    t = summary([("upload", MAIN, 0, 10 * MS), ("upload", MAIN, 2 * MS, 5 * MS),
                 ("aten::to", MAIN, 3 * MS, 4 * MS), ("upload", MAIN, 20 * MS, 25 * MS),
                 ("finish", MAIN, 30 * MS, 42 * MS)], [], {})
    assert spans.host_s(t, "upload") == pytest.approx(0.015)
    assert spans.host_s(t, "finish") == pytest.approx(0.012)
    assert spans.host_s(t, "fetch") == 0
    assert reader("upload_host_ms.serve")(readout(t)) == pytest.approx(7.5)
    assert reader("finish_host_ms.serve")(readout(t)) == pytest.approx(6.0)


def test_a_launch_from_another_thread_is_charged_by_its_time_to_backward():
    cpu = [("net", MAIN, 0, 10 * MS), ("cudaLaunchKernel", MAIN, 1 * MS, 2 * MS),
           ("backward", MAIN, 20 * MS, 40 * MS),
           ("cudaLaunchKernel", ENGINE, 25 * MS, 26 * MS),
           ("cudaLaunchKernel", ENGINE, 45 * MS, 46 * MS)]
    device = [("conv_fprop", 3 * MS, 9 * MS, 1), ("conv_wgrad", 27 * MS, 38 * MS, 2),
              ("adam", 47 * MS, 48 * MS, 3)]
    launch = {1: (MAIN, 1 * MS), 2: (ENGINE, 25 * MS), 3: (ENGINE, 45 * MS)}
    t = summary(cpu, device, launch)
    assert spans.launched_device_s(t, "backward") == pytest.approx(0.011)
    assert t.range_device_s("backward") == 0  # the same-thread charge misses it
    assert spans.launched_device_s(t, "net") == pytest.approx(0.006)
    r = readout(t)
    assert reader("backward_device_ms.train")(r) == pytest.approx(5.5)
    assert reader("forward_device_ms.train")(r) == pytest.approx(3.0)


def test_idle_time_is_clipped_to_the_range():
    cpu = [("epoch_end", MAIN, 100 * MS, 200 * MS), ("epoch_end", MAIN, 300 * MS, 310 * MS)]
    device = [("a", 50 * MS, 120 * MS, 1), ("b", 130 * MS, 140 * MS, 2),
              ("c", 135 * MS, 150 * MS, 3), ("d", 190 * MS, 305 * MS, 4),
              ("e", 400 * MS, 500 * MS, 5)]
    t = summary(cpu, device, {})
    # [100, 200]: busy 100-120, 130-150, 190-200, so idle 50; [300, 310]: busy 300-305, idle 5
    assert spans.idle_within_s(t, "epoch_end") == pytest.approx(0.055)
    assert reader("epoch_end_idle_ms.train")(readout(t)) == pytest.approx(27.5)


def test_the_serve_readers_charge_their_ranges():
    cpu = [("patches", MAIN, 0, 2 * MS), ("net", MAIN, 2 * MS, 4 * MS),
           ("portbench.net", MAIN, 2 * MS, 4 * MS), ("blend", MAIN, 4 * MS, 5 * MS)]
    device = [("stack", 10 * MS, 11 * MS, 1), ("conv", 11 * MS, 31 * MS, 2),
              ("blend", 31 * MS, 34 * MS, 3), ("threshold", 34 * MS, 35 * MS, 4)]
    launch = {1: (MAIN, 1 * MS), 2: (MAIN, 3 * MS), 3: (MAIN, 4 * MS + 1), 4: (MAIN, 6 * MS)}
    r = readout(summary(cpu, device, launch), units=1)
    assert reader("sliding_window_device_ms.serve")(r) == pytest.approx(4.0)
    assert reader("forward_device_ms.serve")(r) == pytest.approx(20.0)
    assert reader("forward_device_ms.serve")(r) == reader("net_device_ms.serve")(r)


@pytest.mark.parametrize("name", NEW_READERS)
def test_nothing_is_read_where_the_program_has_no_such_range(name):
    """A program without the ranges (the parent of the change that named
    them) reads None, and nothing raises."""
    cpu = [("augment", MAIN, 0, 2 * MS), ("cudaLaunchKernel", MAIN, 1 * MS, 2 * MS),
           ("portbench.net", MAIN, 3 * MS, 5 * MS)]
    device = [("warp", 2 * MS, 3 * MS, 1)]
    assert reader(name)(readout(summary(cpu, device, {1: (MAIN, 1 * MS)}))) is None
