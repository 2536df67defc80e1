"""The four-card training cell ``train2d_bs128_dp4`` at a tiny size on the
CPU, four ranks over gloo: the cell comes out correct, each fault planted
in the plain data-parallel step (BatchNorm over each shard alone, the
gradients summed, the last shard left out of the mean) comes out not
correct, and the plain step over four shards is the plain step of one
rank over their union."""

import copy
import multiprocessing

import pytest
import torch
import torch.distributed as dist

from portbench.common import manifest
from portbench.common.ranks import Ranks
from portbench.common.training import judge
from portbench.drivers import train2d_dp
from portbench.reference import data_parallel
from portbench.run import checks_of, is_correct
from portbench.tests.tiny import tiny_cell

CELL = "train2d_bs128_dp4"
SEED = 2**31 + 123


@pytest.fixture(scope="module")
def driver():
    d = train2d_dp.Driver(tiny_cell(CELL), SEED, "cpu")
    d.window(0.5)
    d.free()
    return d


def _correct(d, readings) -> bool:
    return is_correct(1, 0, checks_of(readings, d.cell["limits"]))


def test_the_cell_comes_out_correct(driver):
    readings = driver.check()
    assert _correct(driver, readings), readings
    assert not multiprocessing.active_children()


@pytest.fixture(scope="module")
def planted(driver):
    refs = driver.references(driver.record, [(False, p) for p in data_parallel.PLANTS])
    return dict(zip(data_parallel.PLANTS, refs))


@pytest.mark.parametrize("plant", data_parallel.PLANTS)
def test_a_planted_fault_comes_out_not_correct(driver, planted, plant):
    readings = judge(driver.record, planted[plant], driver.lr_of)
    assert not _correct(driver, readings), readings
    assert not multiprocessing.active_children()


def _states(cell):
    net_cfg = cell["config_data"]["net"]
    arch = manifest.net(net_cfg)
    w = arch.make_weights(net_cfg, torch.Generator().manual_seed(1), "cpu")
    bufs = arch.running_stats(net_cfg, "cpu")
    return ({k: v.clone() for k, v in w.items()}, {k: v.clone() for k, v in bufs.items()},
            {**{k: v.clone() for k, v in w.items()}, **{k: v.clone() for k, v in bufs.items()}})


def test_four_shards_take_the_step_of_their_union(tmp_path):
    from ich_tpu_torch.parallel.mesh import make_mesh

    cell = tiny_cell(CELL)
    plain = [(False, None)]
    ranks = Ranks(4, "cpu", train2d_dp._reference, args=(cell, SEED, plain))
    try:
        four = train2d_dp._reference(ranks.mesh, cell, SEED, plain, _states(cell))[0]
    finally:
        ranks.close()
    union = copy.deepcopy(cell)
    union["config_data"]["train"]["batch_size"] *= 4
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/group", world_size=1,
                            rank=0)
    try:
        one = train2d_dp._reference(make_mesh("cpu"), union, SEED, plain, _states(cell))[0]
    finally:
        dist.destroy_process_group()
    b = cell["config_data"]["train"]["batch_size"]
    for part in ("first", "window"):
        a, u = four[part], one[part]
        assert torch.allclose(a["terms"], u["terms"][:b], rtol=1e-5, atol=1e-6)
        for k in u["grads"]:
            assert torch.allclose(a["grads"][k], u["grads"][k], rtol=1e-4, atol=1e-7), k
        # a conv bias under BatchNorm has a gradient of rounding alone, which
        # Adam scales to a full step of either sign (as the check's
        # change_gap leaves out), and the running means after it follow
        # it; every other parameter moves alike
        norms = {k: float(g.norm()) for k, g in u["grads"].items()}
        median = sorted(norms.values())[len(norms) // 2]
        for k in u["grads"]:
            if norms[k] >= 1e-3 * median:
                assert torch.allclose(a["after"][k], u["after"][k], rtol=1e-4, atol=1e-6), k
