"""Cells cut to a size that a CPU test holds: the same drivers, traffic
generators and comparisons as the benchmark's runs, at small shapes."""

from portbench.common import manifest

SETUP_STEPS = 4  # set-up's warm epoch in both tiny training cells


def tiny_cell(name: str) -> dict:
    c = manifest.cell(name)
    cfg = c["config_data"]
    if c["driver"] == "serve3d":
        cfg["net"].update(depth=3)
        cfg["inference"].update(patch_size=[16, 16, 16], sw_batch_size=32)
        c["traffic"].update(pool=3, volume_shape=[16, 64, 64])
    elif c["driver"] == "train3d":
        cfg["net"].update(depth=3)
        cfg["train"].update(patch_size=[16, 16, 16], batch_size=4, steps_per_epoch=4)
        c["traffic"].update(volumes=3, volume_shape=[16, 64, 64])
    else:
        cfg["net"].update(depth=3, top_filter=4)
        cfg["data"]["slice_shape"] = [32, 32]
        cfg["train"]["batch_size"] = 8
        c["traffic"].update(slices=32)
    return c
