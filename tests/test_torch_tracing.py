"""The port's ``torch.profiler`` ranges on its serve and train paths, on
the CPU: the ranges a tiny served volume records and their order, the
ranges each step and each epoch of tiny training runs record, and that
they lie side by side: none of the program's ranges opens inside another,
apart from the keyed ``dropout`` inside ``net``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ich_tpu_torch.data.core import VolumeDataset3D
from ich_tpu_torch.data.synthetic import synthetic_ich_slices
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops.transforms import build_pipeline
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.train.segmentation3d import UNet3D

torch.set_num_threads(2)

# every range the program opens on these paths
RANGES = ("upload", "patches", "net", "blend", "fetch", "finish", "keys", "augment", "sample",
          "dropout", "loss", "backward", "epoch_end")
NESTED = {("net", "dropout")}  # (outer, inner) pairs allowed
WINDOW = (50.0, 200.0)
PATCH = (8, 8, 8)
STEPS, EPOCHS = 2, 2
TRAIN = dict(n_epoch=EPOCHS, batch_size=2, lr=1e-3, loss_fn="BinaryDiceLoss",
             loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2}, seed=0, device="cpu")
AUGMENT = {"Translate": {"low": -0.1, "high": 0.1}, "HFlip": {"p": 0.5}}
# one volume of the 3D serve: its enqueued work, then its fetch and finish
SERVED = [("upload", "patches", "net", "net", "blend"), ("fetch", "finish")]


def _ranges(run):
    """(name, thread, start ns, end ns) of the program's ranges that
    ``run()`` records, in the order they open (an outer range before an
    inner one that opens with it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = ((e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events())
    return sorted((e for e in events if e[0] in RANGES), key=lambda r: (r[2], -r[3]))


def _hu_volume(seed, shape=(8, 16, 16)):
    return np.random.default_rng(seed).uniform(-100, 300, shape).astype(np.float32)


def _serve3d(overlap=0.5):
    """A tiny 3D serve: 9 patches of 8^3 over an 8x16x16 volume in two
    calls of the net (5 + 4), on the coset path at overlap 0.5, on the
    general path (its stride 5 does not divide 8) at overlap 0.3."""
    torch.manual_seed(0)
    net = UNet(depth=2, ndim=3, top_filter=4, midchannels_factor=1, norm="group",
               p_dropout=0.0)
    return UNet3D(net, patch_size=PATCH, sw_overlap=overlap, sw_batch_size=5, device="cpu")


def _segment_volume(overlap):
    t = _serve3d(overlap)
    return lambda: t.segment_volume(_hu_volume(0), window=WINDOW)


def _predict_volume():
    t = _serve3d()
    return lambda: t.predict_volume(_hu_volume(0) / 300)


def _segment_volumes(depth):
    t = _serve3d()
    return lambda: t.segment_volumes([_hu_volume(1), _hu_volume(2)], window=WINDOW,
                                     return_preds=True, pipeline_depth=depth)


def _serve2p5d():
    torch.manual_seed(0)
    net = UNet(depth=2, top_filter=4, midchannels_factor=1, norm="batch", p_dropout=0.0)
    t = UNet2D(net, batch_size=4, device="cpu")
    vol = np.random.default_rng(3).uniform(-100, 300, (16, 16, 6)).astype(np.float32)
    return lambda: t.segment_volume(vol, window=WINDOW, input_size=(16, 16), return_pred=True)


def _train2d():
    torch.manual_seed(0)
    net = UNet(depth=2, top_filter=4, midchannels_factor=1, norm="batch", p_dropout=0.5)
    ds = synthetic_ich_slices(n_slices=2 * STEPS, size=16, n_volumes=2, seed=1)
    trainer = UNet2D(net, augment_fn=build_pipeline(AUGMENT), **TRAIN)
    return lambda: trainer.train(ds.device_cache("cpu"))


def _train3d(on_device_sampling):
    torch.manual_seed(0)
    net = UNet(depth=2, ndim=3, top_filter=4, midchannels_factor=1, norm="group",
               p_dropout=0.5)
    rng = np.random.default_rng(2)
    vols = [rng.uniform(0, 1, (12, 16, 16)).astype(np.float32) for _ in range(2)]
    masks = [(v > 0.8).astype(np.float32) for v in vols]
    ds = VolumeDataset3D(vols, masks, np.arange(2, dtype=np.int32))
    trainer = UNet3D(net, patch_size=PATCH, steps_per_epoch=STEPS,
                     on_device_sampling=on_device_sampling, **TRAIN)
    return lambda: trainer.train(ds)


# case -> (a maker of what it runs, the ranges it records in order)
SERVE = {
    "segment_volume_coset": (lambda: _segment_volume(0.5), SERVED[0] + SERVED[1]),
    "segment_volume_general": (lambda: _segment_volume(0.3), (
        "upload", "patches", "net", "blend", "patches", "net", "blend", "blend", "fetch",
        "finish")),
    "predict_volume": (_predict_volume, SERVED[0] + ("fetch",)),
    "segment_volumes_depth1": (lambda: _segment_volumes(1), 2 * (SERVED[0] + SERVED[1])),
    "segment_volumes_depth2": (lambda: _segment_volumes(2), 2 * SERVED[0] + 2 * SERVED[1]),
    "segment_volume_2p5d": (_serve2p5d, ("fetch", "finish")),
}
# case -> (a maker of what it runs, the ranges of a step other than the
# keyed dropout's, in order); ``keys`` at each of its sites: fit's
# fold_in, the device sampler's split, the step's split, the Dropouts' keys
TRAINS = {
    "train2d": (_train2d, ("keys", "keys", "augment", "keys", "net", "loss", "backward")),
    "train3d_device_sampler": (lambda: _train3d(True),
                               ("keys", "keys", "sample", "keys", "keys", "net", "loss",
                                "backward")),
    "train3d_host_sampler": (lambda: _train3d(False),
                             ("keys", "sample", "keys", "keys", "net", "loss", "backward")),
}

_recorded = {}


def recorded(case):
    """The ranges of ``case``, recorded once a test process."""
    if case not in _recorded:
        make = SERVE[case][0] if case in SERVE else TRAINS[case][0]
        _recorded[case] = _ranges(make())
    return _recorded[case]


@pytest.mark.parametrize("case", list(SERVE))
def test_a_served_volume_records_its_ranges_in_order(case):
    assert tuple(name for name, *_ in recorded(case)) == SERVE[case][1]


@pytest.mark.parametrize("case", list(TRAINS))
def test_training_records_its_ranges_each_step_and_each_epoch(case):
    """Each step its ranges (``keys``, ``net`` and ``backward`` among
    them), each epoch its steps and then one ``epoch_end``."""
    names = tuple(name for name, *_ in recorded(case) if name != "dropout")
    assert names == EPOCHS * (STEPS * TRAINS[case][1] + ("epoch_end",))


@pytest.mark.parametrize("case", list(SERVE) + list(TRAINS))
def test_no_range_opens_inside_another(case):
    ranges = recorded(case)
    inside = set()
    for i, (outer, tid, s, t) in enumerate(ranges):
        for inner, tid2, s2, t2 in ranges[i + 1:]:
            if s2 >= t:
                break
            if tid2 == tid and t2 <= t:
                inside.add((outer, inner))
    assert inside <= NESTED, inside


@pytest.mark.parametrize("case", list(TRAINS))
def test_the_keyed_dropout_opens_inside_net(case):
    ranges = recorded(case)
    nets = [(s, t) for name, _, s, t in ranges if name == "net"]
    drops = [(s, t) for name, _, s, t in ranges if name == "dropout"]
    assert drops and all(any(a <= s and t <= b for a, b in nets) for s, t in drops)
