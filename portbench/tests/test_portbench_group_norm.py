"""The readers of the fused GroupNorm+ReLU's device time on synthetic
traces (times in ns): the forward's ``group_norm`` ranges on the main
thread, the backward node on autograd's, and nothing read where the
program has no such range."""

import pytest

from portbench.common.readout import reader
from portbench.tests.test_portbench_spans import ENGINE, MAIN, MS, readout, summary


def _trace(with_range=True):
    name = "group_norm" if with_range else "aten::group_norm"
    cpu = [("net", MAIN, 0, 10 * MS), (name, MAIN, 1 * MS, 3 * MS),
           ("cudaLaunchKernel", MAIN, 2 * MS, 2 * MS + 1),
           ("cudaLaunchKernel", MAIN, 4 * MS, 4 * MS + 1),
           ("autograd::engine::evaluate_function: _GroupNormReLUBackward", ENGINE,
            20 * MS, 24 * MS),
           ("_GroupNormReLUBackward", ENGINE, 20 * MS, 23 * MS),
           ("cudaLaunchKernel", ENGINE, 21 * MS, 21 * MS + 1),
           ("cudaLaunchKernel", ENGINE, 26 * MS, 26 * MS + 1)]
    device = [("apply_kernel", 5 * MS, 8 * MS, 1), ("conv", 8 * MS, 18 * MS, 2),
              ("grad_x_kernel", 30 * MS, 35 * MS, 3), ("wgrad", 35 * MS, 45 * MS, 4)]
    launch = {1: (MAIN, 2 * MS), 2: (MAIN, 4 * MS), 3: (ENGINE, 21 * MS), 4: (ENGINE, 26 * MS)}
    return readout(summary(cpu, device, launch))


def test_the_readers_charge_the_range_and_the_backward_node():
    r = _trace()
    assert reader("group_norm_device_ms.serve")(r) == pytest.approx(1.5)  # 3 ms over 2 units
    assert reader("group_norm_device_ms.train")(r) == pytest.approx(4.0)  # (3 + 5) ms over 2


@pytest.mark.parametrize("name", ["group_norm_device_ms.serve", "group_norm_device_ms.train"])
def test_nothing_is_read_where_the_program_has_no_group_norm_range(name):
    """The parent of the fused kernels runs torch's ``aten::group_norm``
    and opens no ``group_norm`` range: None, and nothing raises."""
    assert reader(name)(_trace(with_range=False)) is None
