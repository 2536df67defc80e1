"""Cells cut to a size that a CPU test holds: the same drivers, traffic
generators and comparisons as the benchmark's runs, at small shapes. The
net's module says how its net is cut (``tiny``) and the patch edge it
takes (``TINY_PATCH``); the driver's module cuts the traffic and the
inference or training sizes around that edge (``tiny``)."""

from portbench.common import manifest

SETUP_STEPS = 4  # set-up's warm epoch in both tiny training cells


def tiny_cell(name: str) -> dict:
    c = manifest.cell(name)
    net_cfg = c["config_data"]["net"]
    net = manifest.net(net_cfg)
    net_cfg.update(net.tiny(net_cfg))
    manifest.driver(c).tiny(c, net.TINY_PATCH)
    return c
